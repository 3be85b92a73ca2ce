"""CUDA wrapper of the fused quantize → packed-weight integer matmul.

Replaces ``repro/kernels/fused_matmul.py::fused_quantize_matmul``. The
kernel (``csrc/fused_matmul.cu``) quantizes each activation row inside
the matmul and contracts the codes on the int8 tensor cores against the
packed 2/4/8-bit codes of a ``PackedWeight`` directly; see the source for
its design and bound. Two output forms: the JAX signature's (int32
accumulator, row scales) (:func:`launch`), and the serving path's
dequantized product written into a strided output at a column offset
(:func:`launch_dequant`). The grid and the K split are a block plan
(bm, bn, kb): the kernel registry's for the shape (``registry.plan``,
from the heuristic :func:`plan` unless a plan file or ``autotune`` pinned
another) or the caller's ``plan=``. Every plan gives the same bits.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build, split_k
from repro_torch.kernels.common import cdiv, k_slice_lengths
from repro_torch.kernels.registry import get_registry

#: Launches of the CUDA kernel since the last reset (see ops.launch_counts).
launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
#: ctypes signatures of the C entries (checked against the source by the tests).
ARGTYPES = [_P, _I, _P] + [_I] * 11 + [_P] * 5
FUSED_DEQUANT_MATMUL_ARGTYPES = [_P, _I, _P] + [_I] * 11 + [_P, _I, _P, _P, _I, _I, _P, _P, _P]
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_Y_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

SMS = 132      # streaming multiprocessors of an H100 SXM
KT = 64        # K codes per tile: a K slice is a whole number of them
TILES = ((32, 128), (64, 128), (64, 256))   # the (bm, bn) tiles the kernel has


class Plan(NamedTuple):
    """Rows and columns per block, K codes per slice, and the grid (N
    tiles, K slices, M tiles). Block (x, y, z) owns rows [z·bm, (z+1)·bm),
    columns [x·bn, (x+1)·bn) and K codes [y·kb, (y+1)·kb), clipped to
    (M, N, K)."""
    bm: int
    bn: int
    kb: int
    grid: Tuple[int, int, int]

    @property
    def tiles(self) -> int:
        """Output tiles: one split counter each."""
        return self.grid[0] * self.grid[2]

    @property
    def blocks(self) -> Tuple[int, int, int]:
        """(bm, bn, kb): the plan as the registry and plan files hold it."""
        return self.bm, self.bn, self.kb


@functools.lru_cache(maxsize=4096)
def plan_from(M: int, K: int, N: int, blocks: Tuple[int, ...]) -> Plan:
    """The plan of block shape ``blocks`` = (bm, bn, kb) at (M, K, N): one
    of :data:`TILES`, K slices of kb codes, a whole number of K tiles.
    Raises ValueError for blocks the kernel cannot take."""
    if len(blocks) != 3 or tuple(blocks[:2]) not in TILES or blocks[2] <= 0 or blocks[2] % KT:
        raise ValueError(f"fused_matmul: no kernel for blocks {tuple(blocks)} (tiles "
                         f"{TILES}, K slices a positive multiple of {KT})")
    bm, bn, kb = blocks
    return Plan(bm, bn, kb, (cdiv(N, bn), cdiv(K, kb), cdiv(M, bm)))


def plan(M: int, K: int, N: int) -> Plan:
    """32 x 128 tiles up to M = 32 (decode, prefill chunks), 64 x 256 for
    a large prefill (M >= 512, N >= 4096: every N tile re-reads and
    re-quantizes its rows, so wider tiles halve that work), else 64 x
    128. K is split into whole tiles until about two blocks per SM are in
    flight (decode is bound by the weight bytes, so every SM should stream
    its share). The product is exact in integers, so the plan changes no
    bit of the result."""
    bm, bn = (32, 128) if M <= 32 else (64, 256) if M >= 512 and N >= 4096 else (64, 128)
    n_tiles, m_tiles, k_tiles = cdiv(N, bn), cdiv(M, bm), cdiv(K, KT)
    want = min(max(cdiv(2 * SMS, n_tiles * m_tiles), 1), k_tiles)
    return plan_from(M, K, N, (bm, bn, cdiv(k_tiles, want) * KT))


def candidates(M: int, K: int, N: int) -> List[Tuple[int, int, int]]:
    """The blocks ``registry.autotune`` tries: every tile, K in 1, 2, 4, ...
    slices. The products are exact integers, summed over the slices in
    slice order, so none changes a bit of either output form."""
    kbs = k_slice_lengths(K, KT)
    return [(bm, bn, kb) for bm, bn in TILES for kb in kbs]


def _plan(M: int, K: int, N: int, blocks, backend) -> Plan:
    if blocks is None:
        blocks = get_registry().plan("fused_matmul", (M, K, N), backend)
    return plan_from(M, K, N, tuple(blocks))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("fused_matmul")
    lib.fused_quantize_matmul.argtypes = ARGTYPES
    lib.fused_dequant_matmul.argtypes = FUSED_DEQUANT_MATMUL_ARGTYPES
    for fn in (lib.fused_quantize_matmul, lib.fused_dequant_matmul):
        fn.restype = _I
    return lib


def _check(x: torch.Tensor, w_packed: torch.Tensor, w_bits: int, a_bits: int,
           w_plane_lo: int):
    if x.dtype not in _X_DTYPES or x.ndim != 2:
        raise ValueError(f"x must be (M, K) float32 or bfloat16, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if w_packed.dtype != torch.int8 or w_packed.ndim != 2:
        raise ValueError("w_packed must be (K*bits/8, N) int8")
    if w_bits not in (2, 4, 8) or not 2 <= a_bits <= 8:
        raise ValueError(f"unsupported precision w{w_bits}a{a_bits}")
    if not 0 <= 2 * w_plane_lo < w_bits:
        raise ValueError(f"w_plane_lo={w_plane_lo} keeps no plane of w{w_bits}")
    m, k = x.shape
    if w_packed.shape[0] * 8 != k * w_bits:
        raise ValueError(f"packed rows {w_packed.shape[0]} do not hold K={k} "
                         f"codes at {w_bits} bits")
    if not (x.is_cuda and w_packed.device == x.device):
        raise ValueError("fused_quantize_matmul kernel needs CUDA tensors on one device")
    return x.contiguous(), w_packed.contiguous(), m, k, w_packed.shape[1]


def launch(x: torch.Tensor, w_packed: torch.Tensor, *, w_bits: int,
           a_bits: int, act_signed: bool, w_plane_lo: int, plan=None, backend=None):
    """(M, K) float32 or bfloat16 CUDA activations × (K·w_bits/8, N) int8
    packed codes → ((M, N) int32 accumulator, (M, 1) float32 scales).
    ``plan``: blocks (bm, bn, kb), else the registry's for ``backend``."""
    global launches
    x, w_packed, m, k, n = _check(x, w_packed, w_bits, a_bits, w_plane_lo)
    p = _plan(m, k, n, plan, backend)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    acc = torch.empty((m, n), dtype=torch.int32, device=x.device)
    scales = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    part, part_p, ctr_p = split_k.scratch(p.grid, m, n, x.device, stream)
    rc = _lib().fused_quantize_matmul(
        x.data_ptr(), _X_DTYPES[x.dtype], w_packed.data_ptr(), m, k, n, w_bits, a_bits,
        int(act_signed), w_plane_lo, p.bm, p.bn, p.kb, p.grid[1], scales.data_ptr(),
        acc.data_ptr(), part_p, ctr_p, stream)
    build.check(rc, "fused_quantize_matmul")
    launches += 1
    return acc, scales


def launch_dequant(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor,
                   out: torch.Tensor, *, col: int = 0, w_bits: int, a_bits: int,
                   act_signed: bool, w_plane_lo: int,
                   x_scales: Optional[torch.Tensor] = None, plan=None,
                   backend=None) -> torch.Tensor:
    """``out[:, col:col + N] = ((acc · xs) · (scale · 4**w_plane_lo))`` in
    out's dtype (float32 or bfloat16), each product rounded to float32 in
    that order. ``x_scales``: the rows' (M, 1) scales from an earlier call
    on the same x at the same activation precision (the row pass is then
    skipped). ``plan`` as in :func:`launch`. Returns the rows' scales."""
    global launches
    x, w_packed, m, k, n = _check(x, w_packed, w_bits, a_bits, w_plane_lo)
    if out.dtype not in _Y_DTYPES or out.ndim != 2 or out.stride(1) != 1:
        raise ValueError(f"out must be (M, >= N) float32 or bfloat16 with unit column "
                         f"stride, got {out.dtype} {tuple(out.shape)}")
    if out.shape[0] != m or not 0 <= col <= out.shape[1] - n or out.device != x.device:
        raise ValueError(f"out {tuple(out.shape)} has no (M={m}, N={n}) block at column {col}")
    scale = scale.reshape(-1).to(torch.float32).contiguous()
    if scale.numel() != n or scale.device != x.device:
        raise ValueError(f"scale must hold N={n} per-column values on {x.device}")
    ready = x_scales is not None
    if ready:
        if (x_scales.shape != (m, 1) or x_scales.dtype != torch.float32
                or not x_scales.is_contiguous() or x_scales.device != x.device):
            raise ValueError("x_scales must be a contiguous (M, 1) float32 tensor on x's device")
    else:
        x_scales = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    p = _plan(m, k, n, plan, backend)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    part, part_p, ctr_p = split_k.scratch(p.grid, m, n, x.device, stream)
    y = out.data_ptr() + col * out.element_size()
    rc = _lib().fused_dequant_matmul(
        x.data_ptr(), _X_DTYPES[x.dtype], w_packed.data_ptr(), m, k, n, w_bits, a_bits,
        int(act_signed), w_plane_lo, p.bm, p.bn, p.kb, p.grid[1], x_scales.data_ptr(),
        int(ready), scale.data_ptr(), y, _Y_DTYPES[out.dtype], out.stride(0), part_p,
        ctr_p, stream)
    build.check(rc, "fused_dequant_matmul")
    launches += 1
    return x_scales
