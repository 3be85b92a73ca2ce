"""CUDA wrapper of the flash-attention forward of whole-prompt prefill.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` together
with the GQA dispatch of ``repro/kernels/ops.py::flash_attention``: q
(B, Tq, NQ, H) attends k/v (B, Tk, NKV, H) under causal, prefix-LM and
window masks and a query-position offset (``csrc/flash_attention.cu``).
JAX computes the prefix-LM mask outside its Pallas kernel (XLA code in
``repro.models.common.chunked_attention``); the port runs every
whole-prompt mask through this one kernel, so prefill and decode rows
sum in one order. Under autograd :class:`FlashAttention` runs this
kernel forward and the ``flash_attention_bwd`` kernel backward.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import HEAD_DIMS

#: Launches of the CUDA kernel since the last reset (see ops.launch_counts).
launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: ctypes signature of the C entry (checked against its source by the tests).
ARGTYPES = [_P] * 4 + [_I] * 12 + [_F, _P]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("flash_attention").flash_attention
    fn.argtypes = ARGTYPES
    fn.restype = _I
    return fn


def launch(q, k, v, *, causal: bool, window: int, q_offset: int,
           prefix_len: int = 0) -> torch.Tensor:
    """q (B, Tq, NQ, H), k/v (B, Tk, NKV, H) on one CUDA device, float32
    or bfloat16 each → (B, Tq, NQ, H) in q's dtype. Under ``causal``,
    keys < ``prefix_len`` are visible to every query (prefix-LM)."""
    global launches
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError("flash_attention expects q (B, T, NQ, H) and k/v "
                         "(B, S, NKV, H) of one shape")
    B, Tq, NQ, H = q.shape
    _, Tk, NKV, _ = k.shape
    if k.shape[0] != B or k.shape[3] != H or NQ % NKV:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not match "
                         "(NQ must be a multiple of NKV)")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise ValueError(f"q and k/v must be float32 or bfloat16, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if H not in HEAD_DIMS:
        raise ValueError(f"head dim {H} is not one of the kernel's {HEAD_DIMS}")
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs CUDA tensors on one device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Tq, Tk,
               NQ, NKV, H, _DTYPES[q.dtype], _DTYPES[k.dtype], int(causal),
               int(window), int(q_offset), int(prefix_len), H ** -0.5,
               torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention")
    launches += 1
    return out


class FlashAttention(torch.autograd.Function):
    """:func:`launch` with its gradient: the backward is the
    ``flash_attention_bwd`` kernel over the saved q, k, v and output (the
    log-sum-exp is recomputed there, so the forward runs unchanged)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, prefix_len):
        out = launch(q, k, v, causal=causal, window=window, q_offset=q_offset,
                     prefix_len=prefix_len)
        ctx.save_for_backward(q, k, v, out)
        ctx.mask = dict(causal=causal, window=window, q_offset=q_offset,
                        prefix_len=prefix_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.kernels import flash_attention_bwd

        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd.launch(q, k, v, out, dout, **ctx.mask)
        return dq, dk, dv, None, None, None, None
