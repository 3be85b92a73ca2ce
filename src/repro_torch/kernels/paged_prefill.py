"""CUDA wrapper of the paged chunked-prefill attention kernel.

Replaces ``repro/kernels/paged_prefill.py::paged_prefill_attention``: a
chunk of one row's prompt attends causally over [pool-resident prefix ++
chunk], and the chunk's K/V is written into its destination pool blocks
in place (quantize-on-write for an int8 pool); ``store=False`` writes
nothing and attends what the pool already holds. See
``csrc/paged_prefill.cu`` for how the read/write race is avoided.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import (_DTYPES, check_block_size,
                                                 check_heads, check_pool)

#: Launches of the CUDA kernel since the last reset (see ops.launch_counts).
launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: ctypes signature of the C entry (checked against its source by the tests).
ARGTYPES = [_P] * 9 + [_I] * 11 + [_F, _F, _P]


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("paged_prefill").paged_prefill
    fn.argtypes = ARGTYPES
    fn.restype = _I
    return fn


def launch(q, k_new, v_new, pool_k, pool_v, blocks, start: int, length: int,
           k_scale=None, v_scale=None, softcap: float = 0.0, store: bool = True):
    """q (1, Lc, NQ, H); k_new/v_new (1, Lc, NKV, H); pools written in
    place unless ``store`` is False. Returns (attn (1, Lc, NQ, H), pool_k, pool_v, k_scale, v_scale)."""
    global launches
    quant = check_pool(q, pool_k, pool_v, k_scale, v_scale)
    _, Lc, NQ, H = q.shape
    nb, bs, NKV, _ = pool_k.shape
    check_heads(NQ, NKV, H)
    check_block_size(bs)
    if k_new.shape != (1, Lc, NKV, H) or v_new.shape != k_new.shape:
        raise ValueError(f"k_new/v_new must be (1, {Lc}, {NKV}, {H})")
    q = q.contiguous()
    k_new = k_new.to(q.dtype).contiguous()
    v_new = v_new.to(q.dtype).contiguous()
    blk = blocks.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    null = 0
    rc = _fn()(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
               pool_k.data_ptr(), pool_v.data_ptr(),
               k_scale.data_ptr() if quant else null,
               v_scale.data_ptr() if quant else null,
               blk.data_ptr(), out.data_ptr(), Lc, NQ, NKV, H, bs, blk.shape[0],
               int(start), int(length), _DTYPES[q.dtype], int(quant), int(store),
               H ** -0.5, softcap,
               torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "paged_prefill")
    launches += 1
    return out, pool_k, pool_v, k_scale, v_scale
