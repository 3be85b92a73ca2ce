"""CUDA wrapper of the RG-LRU: Griffin's gates and recurrence in one pass.

Replaces no Pallas kernel: the JAX package computes it with XLA
(``repro/models/griffin.py::_rglru_coeffs`` and ``_rglru_scan``, an
associative scan). One thread per (row, channel) walks the positions in
order (``csrc/rglru.cu``), so a row's h never depends on its padded length
or batch, two calls with the carry are bitwise one, and the decode step
is this kernel at T = 1. The plain version is ``ref.rglru_scan_ref``.
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
ARGTYPES = [_P] * 10 + [_I] * 4 + [_P]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("rglru").rglru
    fn.argtypes = ARGTYPES
    fn.restype = _I
    return fn


def launch(ga, gi, y, a_bias, i_bias, lam, h0=None, lengths=None):
    """ga, gi (B, T, W) float32; y (B, T, W) float32 or bfloat16; a_bias,
    i_bias, lam (W,); h0 (B, W) or None; lengths (B,) or None → (h (B, T,
    W) float32, h at each row's lengths - 1 (B, W) float32)."""
    global launches
    B, T, W = ga.shape
    if gi.shape != ga.shape or y.shape != ga.shape or T < 1:
        raise ValueError(f"rglru: ga, gi and y must share one (B, T >= 1, W) shape, got "
                         f"{tuple(ga.shape)}, {tuple(gi.shape)}, {tuple(y.shape)}")
    if ga.dtype != torch.float32 or gi.dtype != torch.float32 or y.dtype not in _DTYPES:
        raise ValueError(f"rglru: float32 gate projections and float32 or bfloat16 y, "
                         f"got {ga.dtype}, {gi.dtype}, {y.dtype}")
    if any(t.shape != (W,) for t in (a_bias, i_bias, lam)) or (
            h0 is not None and h0.shape != (B, W)):
        raise ValueError(f"rglru: biases and lambda must be ({W},) and h0 ({B}, {W})")
    tensors = [ga, gi, y, a_bias, i_bias, lam] + ([h0] if h0 is not None else [])
    if not all(t.is_cuda and t.device == ga.device for t in tensors):
        raise ValueError("rglru kernel needs CUDA tensors on one device")
    ga, gi, y = ga.contiguous(), gi.contiguous(), y.contiguous()
    a_bias, i_bias, lam = (t.to(torch.float32).contiguous() for t in (a_bias, i_bias, lam))
    h0 = None if h0 is None else h0.to(torch.float32).contiguous()
    if lengths is not None:
        lengths = torch.as_tensor(lengths).to(device=ga.device,
                                              dtype=torch.int32).reshape(B).contiguous()
    h = torch.empty((B, T, W), dtype=torch.float32, device=ga.device)
    h_last = torch.empty((B, W), dtype=torch.float32, device=ga.device)
    rc = _fn()(ga.data_ptr(), gi.data_ptr(), y.data_ptr(), a_bias.data_ptr(),
               i_bias.data_ptr(), lam.data_ptr(), 0 if h0 is None else h0.data_ptr(),
               0 if lengths is None else lengths.data_ptr(), h.data_ptr(),
               h_last.data_ptr(), B, T, W, _DTYPES[y.dtype],
               torch.cuda.current_stream(ga.device).cuda_stream)
    build.check(rc, "rglru")
    launches += 1
    return h, h_last
