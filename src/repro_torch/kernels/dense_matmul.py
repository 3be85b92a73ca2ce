"""CUDA wrapper of the batch-invariant bf16 product ``y = x @ W``.

Not a port of a Pallas kernel (the JAX package leaves rwkv6's dense
products to XLA): one tile plan for every M and K walked in order, so a
row's bits never depend on how many rows share its product
(``csrc/dense_matmul.cu``). rwkv6 runs every dense product of its row
path through it on the card, which makes static batches and solo
prefill, and so static and continuous serving, agree bitwise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: Launches of the CUDA kernel since the last reset (see ops.launch_counts).
launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
#: ctypes signature of the C entry (checked against its source by the tests).
ARGTYPES = [_P, _P, _P, _I, _I, _I, _P]


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("dense_matmul").dense_matmul
    fn.argtypes = ARGTYPES
    fn.restype = _I
    return fn


def launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) and w (K, N) bfloat16 on one CUDA device → (M, N) bfloat16."""
    global launches
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"dense_matmul expects x (M, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.shape[0] % 8 or w.shape[1] % 8:
        raise ValueError(f"K and N must be multiples of 8, got {tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"dense_matmul kernel takes bfloat16, got {x.dtype}, {w.dtype}")
    if not (x.is_cuda and w.device == x.device):
        raise ValueError("dense_matmul kernel needs CUDA tensors on one device")
    x, w = x.contiguous(), w.contiguous()
    M, K = x.shape
    N = w.shape[1]
    y = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    rc = _fn()(x.data_ptr(), w.data_ptr(), y.data_ptr(), M, K, N,
               torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "dense_matmul")
    launches += 1
    return y
