"""CUDA wrapper of the grouped bf16 expert product ``ye[e] = xe[e] @ W[e]``.

Not a port of a Pallas kernel: the JAX package's ``_expert_ffn``
(``repro/models/moe.py:41-55``) leaves it to XLA's ``einsum("ecd,edf->
ecf")``, which multiplies every expert's whole capacity buffer. The
kernel (``csrc/expert_matmul.cu``) runs ``dense_matmul``'s block routine
(``csrc/dense_tile.cuh``) once an expert, with that expert's row count
read on the device: row r < min(counts[e], cap) is bitwise
``dense_matmul`` of the row alone against W[e] (the slice plan of (K, N),
:func:`repro_torch.kernels.dense_matmul.plan`), rows past the count are
zeros, and a block whose rows all lie past its count reads no weight.
So a decode step reads only the experts its rows were routed to, and a
row's bits never follow the capacity its batch gave the buffer.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels import dense_matmul as _dense

#: Launches of the CUDA kernel since the last reset (see ops.launch_counts).
launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
#: ctypes signature of the C entry ``expert_matmul`` (checked against its
#: source by the tests).
ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]


def launch_plan(cap: int, K: int, N: int):
    """(S, slice length, rows per block): the summation order from (K, N)
    alone, as ``dense_matmul`` sums a row; the tiling from cap: 64 × 32
    strips up to cap = 64 (a decode step's buffers), 128 × 128 wide tiles
    above. Both walk every K slice in one block, in dense_matmul's order:
    no tiling changes a bit."""
    return _dense.plan(K, N), _dense.slice_k(K, N), _dense.WIDE if cap > 64 else 64


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("expert_matmul").expert_matmul
    fn.argtypes = ARGTYPES
    fn.restype = _I
    return fn


def launch(xe: torch.Tensor, w: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """xe (E, cap, K) and w (E, K, N) bfloat16, counts (E,) integer, all on
    one CUDA device → (E, cap, N) bfloat16. Rows at or past an expert's
    count are zeros; the counts are never read on the host."""
    global launches
    if xe.ndim != 3 or w.ndim != 3 or xe.shape[0] != w.shape[0] or xe.shape[2] != w.shape[1]:
        raise ValueError(f"expert_matmul expects xe (E, cap, K) and w (E, K, N), got "
                         f"{tuple(xe.shape)} and {tuple(w.shape)}")
    E, cap, K = xe.shape
    N = w.shape[2]
    if K % 8 or N % 8:
        raise ValueError(f"K and N must be multiples of 8, got {K}, {N}")
    if xe.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"expert_matmul kernel takes bfloat16, got {xe.dtype}, {w.dtype}")
    if counts.shape != (E,):
        raise ValueError(f"counts must be ({E},), got {tuple(counts.shape)}")
    if not (xe.is_cuda and w.device == xe.device and counts.device == xe.device):
        raise ValueError("expert_matmul kernel needs CUDA tensors on one device")
    xe, w = xe.contiguous(), w.contiguous()
    counts = counts.to(torch.int32).contiguous()
    S, sk, bm = launch_plan(cap, K, N)
    y = torch.empty((E, cap, N), dtype=torch.bfloat16, device=xe.device)
    rc = _fn()(xe.data_ptr(), w.data_ptr(), y.data_ptr(), counts.data_ptr(), E, cap, K, N,
               S, sk, bm, torch.cuda.current_stream(xe.device).cuda_stream)
    build.check(rc, "expert_matmul")
    launches += 1
    return y
