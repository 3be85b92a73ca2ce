"""CUDA wrapper of the batch-invariant bf16 product ``y = x @ W``.

Not a port of a Pallas kernel (the JAX package leaves rwkv6's dense
products to XLA): a row's bits never depend on how many rows share its
product (``csrc/dense_matmul.cu``). The summation order is :func:`plan`,
a function of (K, N) alone: S slices of whole K tiles, each a chain of
k16 tensor-core steps from zero, folded ((p0 + p1) + p2) + ... in fp32.
The tile plan (:func:`tiles`) may follow M, since every plan runs those
same chains: the kernel registry holds it as blocks (bm,) per (M, K, N)
and may pin another from a plan file or ``autotune``; S is never part of
a plan. rwkv6 runs every dense product of its row path through it
on the card, which makes static batches and solo prefill, and so static
and continuous serving, agree bitwise. A second entry stores the fp32
sums unrounded (``out_dtype=torch.float32``, ``dense_matmul_f32``):
Griffin's RG-LRU gate projections, which JAX computes in float32, run
it with the same order.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import cdiv
from repro_torch.kernels.registry import get_registry

#: Launches of the CUDA kernel since the last reset (see ops.launch_counts).
launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
#: ctypes signature of the C entries (checked against their source by the
#: tests): ``dense_matmul`` and ``dense_matmul_f32``.
ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
DENSE_MATMUL_F32_ARGTYPES = ARGTYPES
#: The C entry storing each output dtype.
_ENTRIES = {torch.bfloat16: "dense_matmul", torch.float32: "dense_matmul_f32"}

SMS = 132       # streaming multiprocessors of an H100 SXM
KT = 128        # K elements per tile: a slice is a whole number of them
STRIP_N = 32    # columns of a strip, the unit the K split is sized by
DECODE = 16     # rows of a split decode block (16 x 128, one K slice each)
WIDE = 128      # rows and columns of a wide tile (the prefill tiling)


def plan(K: int, N: int) -> int:
    """S, the number of K slices: about two blocks per SM at decode if each
    32-column strip of N took S of them (S = 4 for 2560 or 8960 → 2560,
    1 for 2560 → 8960 and the 65 536-wide head, 20 for 2560 → 64), each
    slice a whole number of K tiles and none empty. It never reads M: a
    row's summation order is the same at every batch size."""
    k_tiles = cdiv(K, KT)
    want = min(max(cdiv(2 * SMS, cdiv(N, STRIP_N)), 1), k_tiles)
    return cdiv(k_tiles, cdiv(k_tiles, want))


def slice_k(K: int, N: int) -> int:
    """K elements per slice of :func:`plan` (the last one may be shorter)."""
    return cdiv(cdiv(K, KT), plan(K, N)) * KT


def tiles(M: int, K: int, N: int) -> int:
    """Rows per block: 128 × 128 wide tiles once they fill half the SMs;
    at decode (M <= 16) with K split, 16 × 128 blocks, one per K slice;
    else 64 × 32 strips. Wide tiles and strips walk all slices in one
    block. Every tiling gives the same bits."""
    if M > 64 and cdiv(M, WIDE) * cdiv(N, WIDE) >= SMS // 2:
        return WIDE
    if M <= DECODE and plan(K, N) > 1:
        return DECODE
    return 64


def launch_plan(M: int, K: int, N: int) -> Tuple[int, int, int]:
    """(S, slice length, rows per block) as :func:`launch` passes them
    under the heuristic tiling: the summation order from (K, N), the
    tiling from (M, K, N)."""
    return plan(K, N), slice_k(K, N), tiles(M, K, N)


def check_blocks(M: int, K: int, N: int, blocks: Tuple[int, ...]) -> int:
    """The rows per block of blocks ``(bm,)`` at (M, K, N): 16 (split
    decode, only where :func:`plan` splits K), 64 or 128. Raises
    ValueError for blocks the kernel cannot take; a K split is not a
    block plan."""
    if len(blocks) != 1 or blocks[0] not in (DECODE, 64, WIDE) or (
            blocks[0] == DECODE and plan(K, N) == 1):
        raise ValueError(f"dense_matmul: no tiling {tuple(blocks)} at K={K}, N={N} (one "
                         f"of (64,), ({WIDE},), and ({DECODE},) where K is split)")
    return blocks[0]


def candidates(M: int, K: int, N: int) -> List[Tuple[int]]:
    """The tilings ``registry.autotune`` tries. Every tiling runs the same
    chains in the same order, so none changes a bit; the K split S stays
    :func:`plan`'s (it sets each row's summation order)."""
    return [(bm,) for bm in (DECODE, 64, WIDE) if bm != DECODE or plan(K, N) > 1]


@functools.lru_cache(maxsize=None)
def _fn(entry: str = "dense_matmul"):
    fn = getattr(build.load("dense_matmul"), entry)
    fn.argtypes = ARGTYPES
    fn.restype = _I
    return fn


def launch(x: torch.Tensor, w: torch.Tensor, *, plan=None, backend=None,
           out_dtype=torch.bfloat16) -> torch.Tensor:
    """x (M, K) and w (K, N) bfloat16 on one CUDA device → (M, N) in
    ``out_dtype``: bfloat16 (rounded once) or float32 (the fp32 sums of
    the same order). ``plan``: the tiling (bm,), else the registry's for
    ``backend``."""
    global launches
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"dense_matmul expects x (M, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.shape[0] % 8 or w.shape[1] % 8:
        raise ValueError(f"K and N must be multiples of 8, got {tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"dense_matmul kernel takes bfloat16, got {x.dtype}, {w.dtype}")
    if out_dtype not in _ENTRIES:
        raise ValueError(f"dense_matmul stores bfloat16 or float32, not {out_dtype}")
    if not (x.is_cuda and w.device == x.device):
        raise ValueError("dense_matmul kernel needs CUDA tensors on one device")
    x, w = x.contiguous(), w.contiguous()
    M, K = x.shape
    N = w.shape[1]
    if plan is None:
        plan = get_registry().plan("dense_matmul", (M, K, N), backend)
    bm = check_blocks(M, K, N, tuple(plan))
    S, sk, _ = launch_plan(M, K, N)       # the summation order: (K, N) alone
    y = torch.empty((M, N), dtype=out_dtype, device=x.device)
    part = (torch.empty((S, M, N), dtype=torch.float32, device=x.device)
            if S > 1 and bm == DECODE else None)
    entry = _ENTRIES[out_dtype]
    rc = _fn(entry)(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                    0 if part is None else part.data_ptr(), M, K, N, S, sk, bm,
                    torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, entry)
    launches += 1
    return y


class DenseMatmul(torch.autograd.Function):
    """:func:`launch` with its gradient. The backward's products, dX = dY
    W^T and dW = X^T dY, are plain large products that the JAX package
    leaves to XLA: ``torch.matmul`` in x's dtype, or in float32 for the
    float32 store (then cast to x's dtype)."""

    @staticmethod
    def forward(ctx, x, w, out_dtype, backend):
        ctx.save_for_backward(x, w)
        return launch(x, w, backend=backend, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if g.dtype == x.dtype:
            dx, dw = g @ w.T, x.T @ g
        else:
            dx = (g @ w.to(g.dtype).T).to(x.dtype)
            dw = (x.to(g.dtype).T @ g).to(w.dtype)
        return dx, dw, None, None
