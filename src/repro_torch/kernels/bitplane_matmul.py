"""CUDA wrapper of the unfused integer matmul of activation codes by
packed weight codes.

Replaces ``repro/kernels/bitplane_matmul.py::bitplane_matmul``: (M, K)
int8 activation codes × 2/4/8-bit weight codes read packed (``w_bits=8``:
the (K, N) codes themselves) → the exact (M, N) int32 product
(``csrc/bitplane_matmul.cu``, on the int8 tensor cores). Two output
forms: the JAX signature's int32 product (:func:`launch`), and the Table
III path's dequantized product ``(acc · xs) · ws`` written into a strided
output at a column offset (:func:`launch_dequant`). The grid and the K
split are a block plan (bm, 128, kb): the kernel registry's for the
shape (``registry.plan``, from the heuristic :func:`plan` unless a plan
file or ``autotune`` pinned another) or the caller's ``plan=``. Every
plan gives the same bits.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Tuple

import torch

from repro_torch.kernels import build, split_k
from repro_torch.kernels.common import cdiv, k_slice_lengths
from repro_torch.kernels.registry import get_registry

#: Launches of the CUDA kernel since the last reset (see ops.launch_counts).
launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
#: ctypes signature of the C entry (checked against its source by the tests).
ARGTYPES = [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P]
BITPLANE_DEQUANT_MATMUL_ARGTYPES = [_P, _P] + [_I] * 8 + [_P, _P, _P, _I, _I, _P, _P, _P]
_Y_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

SMS = 132      # streaming multiprocessors of an H100 SXM
BN = 128       # output columns per block
KT = 128       # K codes per shared tile: a K slice is a whole number of them
ROWS = (32, 64, 128)   # the rows per block the kernel has


class Plan(NamedTuple):
    """Rows per block, K codes per slice, and the grid (N tiles, K
    slices, M tiles). Block (x, y, z) owns rows [z·bm, (z+1)·bm), columns
    [x·BN, (x+1)·BN) and K codes [y·kb, (y+1)·kb), clipped to (M, N, K)."""
    bm: int
    kb: int
    grid: Tuple[int, int, int]

    @property
    def single_slice(self) -> bool:
        """One K slice: the kernel stores every element of the output, so
        the int32 entry need not zero it (a split adds slices atomically)."""
        return self.grid[1] == 1

    @property
    def blocks(self) -> Tuple[int, int, int]:
        """(bm, BN, kb): the plan as the registry and plan files hold it."""
        return self.bm, BN, self.kb


@functools.lru_cache(maxsize=4096)
def plan_from(M: int, K: int, N: int, blocks: Tuple[int, ...]) -> Plan:
    """The plan of block shape ``blocks`` = (bm, BN, kb) at (M, K, N): bm
    one of :data:`ROWS`, K slices of kb codes, a whole number of K tiles.
    Raises ValueError for blocks the kernel cannot take."""
    if (len(blocks) != 3 or blocks[0] not in ROWS or blocks[1] != BN or blocks[2] <= 0
            or blocks[2] % KT):
        raise ValueError(f"bitplane_matmul: no kernel for blocks {tuple(blocks)} (rows "
                         f"{ROWS}, {BN} columns, K slices a positive multiple of {KT})")
    bm, _, kb = blocks
    return Plan(bm, kb, (cdiv(N, BN), cdiv(K, kb), cdiv(M, bm)))


def plan(M: int, K: int, N: int) -> Plan:
    """32, 64 or 128 rows per block by M; K split into whole tiles until
    about two blocks per SM are in flight (decode is bound by the weight
    bytes, so every SM should stream its share). The product is exact in
    integers, so the plan changes no bit of the result."""
    bm = 32 if M <= 32 else 64 if M <= 64 else 128
    n_tiles, m_tiles, k_tiles = cdiv(N, BN), cdiv(M, bm), cdiv(K, KT)
    want = min(max(cdiv(2 * SMS, n_tiles * m_tiles), 1), k_tiles)
    return plan_from(M, K, N, (bm, BN, cdiv(k_tiles, want) * KT))


def candidates(M: int, K: int, N: int) -> List[Tuple[int, int, int]]:
    """The blocks ``registry.autotune`` tries: every row count, K in 1, 2,
    4, ... slices. The products are exact integers (a split adds its
    slices' int32 partials), so none changes a bit of either entry."""
    kbs = k_slice_lengths(K, KT)
    return [(bm, BN, kb) for bm in ROWS for kb in kbs]


def _plan(M: int, K: int, N: int, blocks, backend) -> Plan:
    if blocks is None:
        blocks = get_registry().plan("bitplane_matmul", (M, K, N), backend)
    return plan_from(M, K, N, tuple(blocks))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("bitplane_matmul")
    lib.bitplane_matmul.argtypes = ARGTYPES
    lib.bitplane_dequant_matmul.argtypes = BITPLANE_DEQUANT_MATMUL_ARGTYPES
    for fn in (lib.bitplane_matmul, lib.bitplane_dequant_matmul):
        fn.restype = _I
    return lib


def _check(x_codes: torch.Tensor, w_packed: torch.Tensor, w_bits: int, a_bits: int,
           w_plane_lo: int):
    if x_codes.dtype != torch.int8 or x_codes.ndim != 2:
        raise ValueError(f"x_codes must be (M, K) int8, got {x_codes.dtype} "
                         f"{tuple(x_codes.shape)}")
    if w_packed.dtype != torch.int8 or w_packed.ndim != 2:
        raise ValueError("w_packed must be (K*bits/8, N) int8")
    if w_bits not in (2, 4, 8) or not 2 <= a_bits <= 8:
        raise ValueError(f"unsupported precision w{w_bits}a{a_bits}")
    if not 0 <= 2 * w_plane_lo < w_bits:
        raise ValueError(f"w_plane_lo={w_plane_lo} keeps no plane of w{w_bits}")
    m, k = x_codes.shape
    if w_packed.shape[0] * 8 != k * w_bits:
        raise ValueError(f"packed rows {w_packed.shape[0]} do not hold K={k} "
                         f"codes at {w_bits} bits")
    if not (x_codes.is_cuda and w_packed.device == x_codes.device):
        raise ValueError("bitplane_matmul kernel needs CUDA tensors on one device")
    return x_codes.contiguous(), w_packed.contiguous(), m, k, w_packed.shape[1]


def launch(x_codes: torch.Tensor, w_packed: torch.Tensor, *, w_bits: int,
           a_bits: int, act_signed: bool, w_plane_lo: int, plan=None,
           backend=None) -> torch.Tensor:
    """(M, K) int8 CUDA codes × (K·w_bits/8, N) int8 packed codes →
    (M, N) int32. ``plan``: blocks (bm, BN, kb), else the registry's for
    ``backend``."""
    global launches
    x_codes, w_packed, m, k, n = _check(x_codes, w_packed, w_bits, a_bits, w_plane_lo)
    p = _plan(m, k, n, plan, backend)
    alloc = torch.empty if p.single_slice else torch.zeros
    acc = alloc((m, n), dtype=torch.int32, device=x_codes.device)
    rc = _lib().bitplane_matmul(
        x_codes.data_ptr(), w_packed.data_ptr(), m, k, n, w_bits, a_bits, int(act_signed),
        w_plane_lo, p.bm, p.kb, p.grid[1], acc.data_ptr(),
        torch.cuda.current_stream(x_codes.device).cuda_stream)
    build.check(rc, "bitplane_matmul")
    launches += 1
    return acc


def launch_dequant(x_codes: torch.Tensor, w_packed: torch.Tensor, x_scales: torch.Tensor,
                   scale: torch.Tensor, out: torch.Tensor, *, col: int = 0, w_bits: int,
                   a_bits: int, plan=None, backend=None) -> None:
    """``out[:, col:col + N] = (acc · x_scales) · scale`` in out's dtype
    (float32 or bfloat16): acc the exact int32 product of the (M, K)
    signed int8 codes and the (K·w_bits/8, N) packed codes (every weight
    plane: the Table III route's leaves), each product rounded to
    float32 in that order, then one rounding. ``x_scales`` is the rows'
    (M, 1) float32 scales (``pack_quant.launch``), ``scale`` the N
    columns' float32 scales ((N,) or (1, N), unit stride). Nothing is
    cast or copied: any other input raises. ``plan`` as in :func:`launch`."""
    global launches
    if not (x_codes.is_contiguous() and w_packed.is_contiguous()):
        raise ValueError("bitplane_dequant_matmul takes contiguous codes and packed weights")
    x_codes, w_packed, m, k, n = _check(x_codes, w_packed, w_bits, a_bits, 0)
    if out.dtype not in _Y_DTYPES or out.ndim != 2 or out.stride(1) != 1:
        raise ValueError(f"out must be (M, >= N) float32 or bfloat16 with unit column "
                         f"stride, got {out.dtype} {tuple(out.shape)}")
    if out.shape[0] != m or not 0 <= col <= out.shape[1] - n or out.device != x_codes.device:
        raise ValueError(f"out {tuple(out.shape)} has no (M={m}, N={n}) block at column {col}")
    if (x_scales.shape != (m, 1) or x_scales.dtype != torch.float32
            or not x_scales.is_contiguous() or x_scales.device != x_codes.device):
        raise ValueError("x_scales must be a contiguous (M, 1) float32 tensor on x's device")
    if (scale.dtype != torch.float32 or scale.numel() != n or scale.shape[-1] != n
            or scale.stride(-1) != 1 or scale.device != x_codes.device):
        raise ValueError(f"scale must hold N={n} float32 values with unit stride on "
                         f"{x_codes.device}")
    p = _plan(m, k, n, plan, backend)
    stream = torch.cuda.current_stream(x_codes.device).cuda_stream
    part, part_p, ctr_p = split_k.scratch(p.grid, m, n, x_codes.device, stream)
    y = out.data_ptr() + col * out.element_size()
    rc = _lib().bitplane_dequant_matmul(
        x_codes.data_ptr(), w_packed.data_ptr(), m, k, n, w_bits, a_bits, p.bm, p.kb,
        p.grid[1], x_scales.data_ptr(), scale.data_ptr(), y, _Y_DTYPES[out.dtype],
        out.stride(0), part_p, ctr_p, stream)
    build.check(rc, "bitplane_dequant_matmul")
    launches += 1
