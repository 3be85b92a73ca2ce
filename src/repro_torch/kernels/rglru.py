"""CUDA wrapper of the RG-LRU: Griffin's gates and recurrence in one pass.

Replaces no Pallas kernel: the JAX package computes it with XLA
(``repro/models/griffin.py::_rglru_coeffs`` and ``_rglru_scan``, an
associative scan). Each (row, channel) folds the positions in order, one
lane per channel (``csrc/rglru.cu``), so a row's h never depends on its
padded length, batch or tiling, two calls with the carry are bitwise one,
and the decode step computes the same element. A prompt (T > 1) streams
through the ``rglru`` entry, tiled by :func:`plan`; the step (T = 1) has
its own kernel, ``rglru_step``. The plain version is ``ref.rglru_scan_ref``.

Training adds the ``rglru_bwd`` entry (``csrc/rglru_bwd.cu``): :class:`RGLRU`
returns h alone and its backward walks t in reverse over the saved h
(:func:`launch_bwd`; plain version ``ref.rglru_scan_bwd_ref``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import aligned16

#: Launches of the CUDA kernels since the last reset (see
#: ops.launch_counts): ``launches`` counts both entries, ``step_launches``
#: the T = 1 step's share; ``bwd_launches`` the backward entry's calls
#: (two kernels each).
launches = 0
step_launches = 0
bwd_launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
#: ctypes signatures of the C entries (checked against their source by the tests).
ARGTYPES = [_P] * 10 + [_I] * 6 + [_P]
RGLRU_STEP_ARGTYPES = [_P] * 8 + [_I] * 3 + [_P]
RGLRU_BWD_ARGTYPES = [_P] * 17 + [_I] * 6 + [_P]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: (channel tile, gate warps) pairs the prefill kernel instantiates.
PLANS = ((32, 16), (64, 16), (64, 8))


def plan(B: int, W: int, sms: int):
    """(channel tile, gate warps) of the prefill kernel for B rows of W
    channels on a card of ``sms`` streaming multiprocessors: 64-channel
    tiles where their blocks fill at least 15/16 of the SMs, else 32
    (B = 1 at W = 4096 on the H100's 132: 128 blocks); 8 gate warps where
    two blocks share an SM (B = 4: 256 blocks), else 16. Only the tiling
    and the warps depend on the plan, never an element's arithmetic or its
    fold order."""
    if W % 8:
        raise ValueError(f"rglru: the prefill kernel's tensor copies need 16-byte rows, "
                         f"so W must be a multiple of 8, got {W}")
    blocks = B * -(-W // 64)
    if blocks < sms * 15 // 16:
        return 32, 16
    return 64, 8 if blocks > sms else 16


#: (channel tile, gate warps) pairs the backward kernel instantiates (as
#: many output warps as gate warps).
BWD_PLANS = ((32, 8), (64, 4), (64, 8))


def plan_bwd(B: int, W: int, sms: int):
    """(channel tile, gate warps) of the backward kernel for B rows of W
    channels on ``sms`` streaming multiprocessors: 64-channel tiles where
    their blocks fill at least 15/16 of the SMs, else 32 (B = 1 at W =
    4096 on the H100's 132: 128 blocks); 4 gate and 4 output warps where
    two blocks share an SM (B = 8: 512 blocks), else 8 each. Only the
    tiling and the warps depend on the plan, never an element's arithmetic
    or the order of a sum."""
    if W % 8:
        raise ValueError(f"rglru_bwd: the kernel's tensor copies need 16-byte rows, so W "
                         f"must be a multiple of 8, got {W}")
    blocks = B * -(-W // 64)
    if blocks < sms * 15 // 16:
        return 32, 8
    return 64, 4 if blocks > sms else 8


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("rglru")
    lib.rglru.argtypes = ARGTYPES
    lib.rglru_step.argtypes = RGLRU_STEP_ARGTYPES
    lib.rglru.restype = lib.rglru_step.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_fn():
    fn = build.load("rglru_bwd").rglru_bwd
    fn.argtypes = RGLRU_BWD_ARGTYPES
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def sms(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index``, the plan's input."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(ga, gi, y, a_bias, i_bias, lam, h0):
    """Raise ValueError for inputs the kernels do not take."""
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


def launch(ga, gi, y, a_bias, i_bias, lam, h0=None, lengths=None):
    """ga, gi (B, T, W) float32; y (B, T, W) float32 or bfloat16; a_bias,
    i_bias, lam (W,); h0 (B, W) or None; lengths (B,) or None → (h (B, T,
    W) float32, h at each row's lengths - 1 (B, W) float32). At T = 1 the
    step kernel runs and h at lengths - 1 is a view of h."""
    global launches, step_launches
    _check(ga, gi, y, a_bias, i_bias, lam, h0)
    B, T, W = ga.shape
    ga, gi, y = ga.contiguous(), gi.contiguous(), y.contiguous()
    a_bias, i_bias, lam = (t.to(torch.float32).contiguous() for t in (a_bias, i_bias, lam))
    h0 = None if h0 is None else h0.to(torch.float32).contiguous()
    h = torch.empty((B, T, W), dtype=torch.float32, device=ga.device)
    stream = torch.cuda.current_stream(ga.device).cuda_stream
    h0_ptr = 0 if h0 is None else h0.data_ptr()
    if T == 1:
        rc = _lib().rglru_step(ga.data_ptr(), gi.data_ptr(), y.data_ptr(), a_bias.data_ptr(),
                               i_bias.data_ptr(), lam.data_ptr(), h0_ptr, h.data_ptr(), B, W,
                               _DTYPES[y.dtype], stream)
        build.check(rc, "rglru_step")
        launches += 1
        step_launches += 1
        return h, h[:, 0]
    tile, warps = plan(B, W, sms(ga.device.index or 0))
    if any(t.data_ptr() % 16 for t in (ga, gi, y)):
        raise ValueError("rglru: the prefill kernel's tensor copies need ga, gi and y at "
                         "16-byte aligned addresses")
    if lengths is not None:
        lengths = torch.as_tensor(lengths).to(device=ga.device,
                                              dtype=torch.int32).reshape(B).contiguous()
    h_last = torch.empty((B, W), dtype=torch.float32, device=ga.device)
    rc = _lib().rglru(ga.data_ptr(), gi.data_ptr(), y.data_ptr(), a_bias.data_ptr(),
                      i_bias.data_ptr(), lam.data_ptr(), h0_ptr,
                      0 if lengths is None else lengths.data_ptr(), h.data_ptr(),
                      h_last.data_ptr(), B, T, W, _DTYPES[y.dtype], tile, warps, stream)
    build.check(rc, "rglru")
    launches += 1
    return h, h_last


def launch_bwd(ga, gi, y, a_bias, i_bias, lam, h0, h, dh):
    """The gradients of :func:`launch`'s h (B, T, W) for dh (B, T, W) from
    the inputs and the saved h → (dga, dgi (B, T, W) float32, dy in y's
    dtype, d a_bias, d i_bias, d lam (W,) float32, dh0 (B, W) float32 or
    None without h0)."""
    global bwd_launches
    _check(ga, gi, y, a_bias, i_bias, lam, h0)
    B, T, W = ga.shape
    if h.shape != ga.shape or dh.shape != ga.shape or not (h.is_cuda and dh.is_cuda):
        raise ValueError(f"rglru_bwd: h and dh must be CUDA ({B}, {T}, {W}), got "
                         f"{tuple(h.shape)}, {tuple(dh.shape)}")
    tile, warps = plan_bwd(B, W, sms(ga.device.index or 0))
    ga, gi, y = (aligned16(t) for t in (ga, gi, y))
    h, dh = (aligned16(t.to(torch.float32)) for t in (h, dh))
    a_bias, i_bias, lam = (t.to(torch.float32).contiguous() for t in (a_bias, i_bias, lam))
    h0 = None if h0 is None else h0.to(torch.float32).contiguous()
    dga, dgi, dy = torch.empty_like(ga), torch.empty_like(gi), torch.empty_like(y)
    dab, dib, dlam = (torch.empty((W,), dtype=torch.float32, device=ga.device)
                      for _ in range(3))
    dh0 = None if h0 is None else torch.empty_like(h0)
    scratch = torch.empty(3 * B * W, dtype=torch.float32, device=ga.device)
    rc = _bwd_fn()(ga.data_ptr(), gi.data_ptr(), y.data_ptr(), a_bias.data_ptr(),
                   i_bias.data_ptr(), lam.data_ptr(), 0 if h0 is None else h0.data_ptr(),
                   h.data_ptr(), dh.data_ptr(), dga.data_ptr(), dgi.data_ptr(), dy.data_ptr(),
                   dab.data_ptr(), dib.data_ptr(), dlam.data_ptr(),
                   0 if dh0 is None else dh0.data_ptr(), scratch.data_ptr(), B, T, W,
                   _DTYPES[y.dtype], tile, warps,
                   torch.cuda.current_stream(ga.device).cuda_stream)
    build.check(rc, "rglru_bwd")
    bwd_launches += 1
    return dga, dgi, dy, dab, dib, dlam, dh0


class RGLRU(torch.autograd.Function):
    """:func:`launch` with its gradient, returning h alone (the caller
    takes h_last as a slice of it, so its gradient reaches h once): the
    backward is :func:`launch_bwd` over the saved h."""

    @staticmethod
    def forward(ctx, ga, gi, y, a_bias, i_bias, lam, h0):
        h, _ = launch(ga, gi, y, a_bias, i_bias, lam, h0)
        ctx.save_for_backward(ga, gi, y, a_bias, i_bias, lam, h0, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        ga, gi, y, a_bias, i_bias, lam, h0, h = ctx.saved_tensors
        dga, dgi, dy, dab, dib, dlam, dh0 = launch_bwd(ga, gi, y, a_bias, i_bias, lam, h0,
                                                       h, dh)
        return (dga, dgi, dy, dab.to(a_bias.dtype), dib.to(i_bias.dtype), dlam.to(lam.dtype),
                dh0)
