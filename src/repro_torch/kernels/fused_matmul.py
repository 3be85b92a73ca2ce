"""CUDA wrapper of the fused quantize → packed-weight integer matmul.

Replaces ``repro/kernels/fused_matmul.py::fused_quantize_matmul``. The
kernel (``csrc/fused_matmul.cu``) quantizes each activation row in its
K-loop prologue and contracts against the packed 2/4/8-bit codes of a
``PackedWeight`` directly; see the source for its design and bound.
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
ARGTYPES = [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P]


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("fused_matmul").fused_quantize_matmul
    fn.argtypes = ARGTYPES
    fn.restype = _I
    return fn


def launch(x: torch.Tensor, w_packed: torch.Tensor, *, w_bits: int,
           a_bits: int, act_signed: bool, w_plane_lo: int):
    """(M, K) float32 CUDA activations × (K·w_bits/8, N) int8 packed codes
    → ((M, N) int32 accumulator, (M, 1) float32 scales)."""
    global launches
    if x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError(f"x must be (M, K) float32, got {x.dtype} {tuple(x.shape)}")
    if w_packed.dtype != torch.int8 or w_packed.ndim != 2:
        raise ValueError("w_packed must be (K*bits/8, N) int8")
    if w_bits not in (2, 4, 8):
        raise ValueError(f"unsupported weight bits {w_bits}")
    m, k = x.shape
    if w_packed.shape[0] * 8 != k * w_bits:
        raise ValueError(f"packed rows {w_packed.shape[0]} do not hold K={k} "
                         f"codes at {w_bits} bits")
    if not (x.is_cuda and w_packed.device == x.device):
        raise ValueError("fused_quantize_matmul kernel needs CUDA tensors on one device")
    x = x.contiguous()
    w_packed = w_packed.contiguous()
    n = w_packed.shape[1]
    acc = torch.zeros((m, n), dtype=torch.int32, device=x.device)
    scales = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _fn()(x.data_ptr(), w_packed.data_ptr(), m, k, n, w_bits, a_bits,
               int(act_signed), w_plane_lo, scales.data_ptr(), acc.data_ptr(),
               stream)
    build.check(rc, "fused_quantize_matmul")
    launches += 1
    return acc, scales
