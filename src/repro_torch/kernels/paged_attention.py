"""CUDA wrapper of the paged flash-decode attention kernel.

Replaces ``repro/kernels/paged_attention.py::paged_attention``: one query
token per row attends the paged KV pool through its block table, with
in-kernel dequantization of an int8 pool (``csrc/paged_attention.cu``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: Launches of the CUDA kernel since the last reset (see ops.launch_counts).
launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: ctypes signature of the C entry (checked against its source by the tests).
ARGTYPES = [_P] * 8 + [_I] * 8 + [_F, _F, _P]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("paged_attention").paged_attention
    fn.argtypes = ARGTYPES
    fn.restype = _I
    return fn


def check_pool(q, pool_k, pool_v, k_scale, v_scale):
    """Shared dtype/layout checks of the paged kernels' operands."""
    if q.dtype not in _DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    quant = k_scale is not None
    want = torch.int8 if quant else q.dtype
    if pool_k.dtype != want or pool_v.dtype != want:
        raise ValueError(f"pool must be {want} for q {q.dtype} "
                         f"({'int8' if quant else 'unquantized'} pool)")
    tensors = [q, pool_k, pool_v] + ([k_scale, v_scale] if quant else [])
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged kernels need CUDA tensors on one device")
    if not all(t.is_contiguous() for t in tensors[1:]):
        raise ValueError("pool planes must be contiguous (they are written "
                         "or read in place)")
    if quant and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise ValueError("scale planes must be float32")
    return quant


def launch(q, pool_k, pool_v, block_table, q_pos, k_scale=None, v_scale=None,
           softcap: float = 0.0) -> torch.Tensor:
    """q (B, 1, NQ, H); pools (num_blocks, bs, NKV, H); block_table
    (B, max_blocks) int32; q_pos (B,) → (B, 1, NQ, H) in q's dtype."""
    global launches
    quant = check_pool(q, pool_k, pool_v, k_scale, v_scale)
    B, _, NQ, H = q.shape
    nb, bs, NKV, _ = pool_k.shape
    if NQ % NKV or NQ // NKV > 16:
        raise ValueError(f"query heads {NQ} must be a multiple (<= 16x) of "
                         f"KV heads {NKV}")
    q = q.contiguous()
    table = block_table.to(device=q.device, dtype=torch.int32).contiguous()
    pos = torch.as_tensor(q_pos).to(device=q.device, dtype=torch.int32).reshape(B)
    out = torch.empty_like(q)
    null = 0
    rc = _fn()(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
               k_scale.data_ptr() if quant else null,
               v_scale.data_ptr() if quant else null,
               table.data_ptr(), pos.contiguous().data_ptr(), out.data_ptr(),
               B, NQ, NKV, H, bs, table.shape[1], _DTYPES[q.dtype], int(quant),
               H ** -0.5, softcap,
               torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "paged_attention")
    launches += 1
    return out
