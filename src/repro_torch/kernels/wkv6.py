"""CUDA wrapper of the RWKV-6 chunked recurrence.

Replaces ``repro/kernels/wkv6.py::wkv6`` with the state carried in and
out, as ``repro/models/rwkv6.py::wkv6_chunked`` carries it
(``csrc/wkv6.cu``). A prompt runs in three launches: each chunk's decay
and state increment (a block per chunk, head and row), the state pass
over the chunks in order, then each chunk's outputs from the state
entering it (a block per chunk, head and row). A decode step (T = 1) is
one launch of its own shape. Chunk boundaries sit at absolute
positions.
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
ARGTYPES = [_P] * 9 + [_I] * 7 + [_P]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DIM = 64


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("wkv6").wkv6
    fn.argtypes = ARGTYPES
    fn.restype = _I
    return fn


def launch(r, k, v, w, u, state, *, chunk: int):
    """r/k (B, T, H, K), v (B, T, H, V) in one dtype (float32 or
    bfloat16, read as they are); w (B, T, H, K), u (H, K) and state (B,
    H, K, V) float32 → (out (B, T, H, V) float32, new state)."""
    global launches
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
    # The kernel loads 4 elements at once: rows start 16-byte aligned.
    r, k, v, w = (_aligned(t) for t in (r, k, v, w.to(torch.float32)))
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
    return out, new
