"""CUDA wrapper of the per-row activation quantizer.

Replaces ``repro/kernels/pack_quant.py::quantize_rows``: (M, K) float32
or bfloat16 rows → int8 codes (unsigned 8-bit codes wrapped, 255 as -1)
and (M, 1) float32 scales, bitwise the JAX kernel's on the rows as
float32 (``csrc/quantize_rows.cu``: one read of each row up to K =
16 384, held in registers; longer rows are read twice).
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
ARGTYPES = [_P, _I, _I, _I, _I, _I, _P, _P, _P]
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("quantize_rows").quantize_rows
    fn.argtypes = ARGTYPES
    fn.restype = _I
    return fn


def launch(x: torch.Tensor, *, bits: int, signed: bool):
    """(M, K) float32 or bfloat16 CUDA rows → ((M, K) int8 codes, (M, 1)
    float32 scales)."""
    global launches
    if x.dtype not in _X_DTYPES or x.ndim != 2:
        raise ValueError(f"x must be (M, K) float32 or bfloat16, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not 2 <= bits <= 8:
        raise ValueError(f"unsupported activation bits {bits}")
    if not x.is_cuda:
        raise ValueError("quantize_rows kernel needs a CUDA tensor")
    x = x.contiguous()
    m, k = x.shape
    codes = torch.empty((m, k), dtype=torch.int8, device=x.device)
    scales = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    rc = _fn()(x.data_ptr(), _X_DTYPES[x.dtype], m, k, bits, int(signed), codes.data_ptr(),
               scales.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "quantize_rows")
    launches += 1
    return codes, scales
