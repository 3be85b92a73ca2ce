"""CUDA wrapper of the RWKV-6 chunked recurrence.

Replaces ``repro/kernels/wkv6.py::wkv6`` with the state carried in and
out, as ``repro/models/rwkv6.py::wkv6_chunked`` carries it
(``csrc/wkv6.cu``). A prompt runs in three launches: each chunk's decay
and state increment (a block per chunk, head and row), the state pass
over the chunks in order, then each chunk's outputs from the state
entering it (a block per chunk, head and row). A decode step (T = 1) is
one launch of its own shape. Chunk boundaries sit at absolute
positions.

Training adds the ``wkv6_bwd`` entry (``csrc/wkv6_bwd.cu``), bound here
as the forward is: :class:`WKV6` runs the forward keeping the state
entering each chunk (the scratch its pass kernel fills), and its backward
walks those chunks in reverse from the state's gradient
(:func:`launch_bwd`). The plain version of the backward is
``ref.wkv6_chunked_bwd_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import aligned16

#: Launches of the CUDA kernel since the last reset (see ops.launch_counts):
#: ``launches`` the forward's kernels, ``bwd_launches`` the backward entry's
#: calls (four kernels each).
launches = 0
bwd_launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
#: ctypes signatures of the C entries (checked against their source by the tests).
ARGTYPES = [_P] * 9 + [_I] * 7 + [_P]
BWD_ARGTYPES = [_P] * 15 + [_I] * 7 + [_P]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DIM = 64


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("wkv6").wkv6
    fn.argtypes = ARGTYPES
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_fn():
    fn = build.load("wkv6_bwd").wkv6_bwd
    fn.argtypes = BWD_ARGTYPES
    fn.restype = _I
    return fn


def _check(r, k, v, w, u, state, chunk):
    """Raise ValueError for inputs the kernels do not take."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    if k.shape != r.shape or w.shape != r.shape or v.shape[:3] != (B, T, H):
        raise ValueError(f"wkv6: r/k/w must be (B, T, H, K) and v (B, T, H, V); got "
                         f"{tuple(r.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(w.shape)}")
    if u.shape != (H, K) or state.shape != (B, H, K, V):
        raise ValueError(f"wkv6: u must be ({H}, {K}) and state ({B}, {H}, {K}, {V})")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"wkv6: r/k/v must share float32 or bfloat16, got "
                         f"{r.dtype}, {k.dtype}, {v.dtype}")
    if not (0 < K <= _MAX_DIM and 0 < V <= _MAX_DIM and K % 4 == 0 and V % 4 == 0
            and 0 < chunk <= _MAX_DIM):
        raise ValueError(f"wkv6: K and V must be multiples of 4 and, with the chunk, "
                         f"lie in 1..{_MAX_DIM}; got {K}, {V}, {chunk}")
    tensors = (r, k, v, w, u, state)
    if not all(t.is_cuda and t.device == r.device for t in tensors):
        raise ValueError("wkv6 kernel needs CUDA tensors on one device")


def launch(r, k, v, w, u, state, *, chunk: int, states: bool = False):
    """r/k (B, T, H, K), v (B, T, H, V) in one dtype (float32 or
    bfloat16, read as they are); w (B, T, H, K), u (H, K) and state (B,
    H, K, V) float32 → (out (B, T, H, V) float32, new state). With
    ``states`` also the state entering each chunk, (B, H, ceil(T /
    chunk), K, V) float32 (a view of the scratch at T > 1, of the carried
    state at T = 1)."""
    global launches
    _check(r, k, v, w, u, state, chunk)
    B, T, H, K = r.shape
    V = v.shape[-1]
    # The kernel loads 4 elements at once: rows start 16-byte aligned.
    r, k, v, w = (aligned16(t) for t in (r, k, v, w.to(torch.float32)))
    u, state = (t.to(torch.float32).contiguous() for t in (u, state))
    out = torch.empty((B, T, H, V), dtype=torch.float32, device=r.device)
    new = torch.empty_like(state)
    # Each chunk's decay (K) and state increment (K, V), then the state
    # entering it in place of the increment.
    scratch = (torch.empty(B * H * -(-T // chunk) * (K + K * V), dtype=torch.float32,
                           device=r.device) if T > 1 else None)
    rc = _fn()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
               state.data_ptr(), out.data_ptr(), new.data_ptr(),
               0 if scratch is None else scratch.data_ptr(), B, T, H, K, V,
               int(chunk), _DTYPES[r.dtype],
               torch.cuda.current_stream(r.device).cuda_stream)
    build.check(rc, "wkv6")
    launches += 0 if T == 0 else 1 if T == 1 else 3   # a prompt runs three kernels
    if not states:
        return out, new
    nc = -(-T // chunk)
    starts = (state.reshape(B, H, 1, K, V) if scratch is None
              else scratch[B * H * nc * K:].view(B, H, nc, K, V))
    return out, new, starts


def launch_bwd(r, k, v, w, u, states, dout, dstate=None, *, chunk: int):
    """The gradients of :func:`launch`'s (out, new state) for dout (B, T,
    H, V) and dstate (B, H, K, V) or None (zero), from the inputs and the
    chunk-start states ``states`` the forward kept → (dr, dk, dv in r's
    dtype, dw (B, T, H, K), du (H, K), dstate_in (B, H, K, V)), float32
    otherwise."""
    global bwd_launches
    B, T, H, K = r.shape
    V = v.shape[-1]
    _check(r, k, v, w, u, states[:, :, 0], chunk)
    nc = -(-T // chunk)
    if T < 1 or B < 1 or states.shape != (B, H, nc, K, V) or dout.shape != (B, T, H, V) or (
            dstate is not None and dstate.shape != (B, H, K, V)):
        raise ValueError(f"wkv6_bwd: states must be ({B}, {H}, {nc}, {K}, {V}), dout "
                         f"({B}, {T}, {H}, {V}) and dstate ({B}, {H}, {K}, {V}) or None, "
                         f"T >= 1")
    extra = (dout,) + (() if dstate is None else (dstate,))
    if not all(t.is_cuda and t.device == r.device for t in extra):
        raise ValueError("wkv6_bwd kernel needs CUDA tensors on one device")
    # The kernel loads 4 elements at once: rows start 8- or 16-byte aligned.
    r, k, v = (aligned16(t) for t in (r, k, v))
    w, u = (t.to(torch.float32).contiguous() for t in (w, u))
    states, dout = (aligned16(t.to(torch.float32)) for t in (states, dout))
    dstate = None if dstate is None else aligned16(dstate.to(torch.float32))
    dr, dk, dv = torch.empty_like(r), torch.empty_like(k), torch.empty_like(v)
    dw = torch.empty_like(w)
    du = torch.empty((H, K), dtype=torch.float32, device=r.device)
    dstate_in = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    scratch = torch.empty(B * H * nc * (K * V + 2 * K), dtype=torch.float32, device=r.device)
    rc = _bwd_fn()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                   states.data_ptr(), dout.data_ptr(),
                   0 if dstate is None else dstate.data_ptr(), dr.data_ptr(), dk.data_ptr(),
                   dv.data_ptr(), dw.data_ptr(), du.data_ptr(), dstate_in.data_ptr(),
                   scratch.data_ptr(), B, T, H, K, V, int(chunk), _DTYPES[r.dtype],
                   torch.cuda.current_stream(r.device).cuda_stream)
    build.check(rc, "wkv6_bwd")
    bwd_launches += 1
    return dr, dk, dv, dw, du, dstate_in


class WKV6(torch.autograd.Function):
    """:func:`launch` with its gradient: the forward keeps the chunk-start
    states its pass kernel stores, and the backward is :func:`launch_bwd`
    over them (nothing of the forward runs again)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state, chunk):
        out, new, starts = launch(r, k, v, w, u, state, chunk=chunk, states=True)
        ctx.save_for_backward(r, k, v, w, u, starts)
        ctx.chunk = chunk
        return out, new

    @staticmethod
    def backward(ctx, dout, dstate):
        r, k, v, w, u, starts = ctx.saved_tensors
        dr, dk, dv, dw, du, dstate_in = launch_bwd(r, k, v, w, u, starts, dout, dstate,
                                                    chunk=ctx.chunk)
        return dr, dk, dv, dw.to(w.dtype), du.to(u.dtype), dstate_in, None
