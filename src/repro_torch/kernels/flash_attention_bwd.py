"""CUDA wrapper of the flash-attention backward (``csrc/flash_attention_bwd.cu``).

Replaces no Pallas kernel: the JAX package differentiates its XLA
attention (``repro.models.common.chunked_attention``) and none of its
Pallas kernels has a VJP. The port's whole-prompt attention is the flash
kernel, so training needs its gradient as a kernel: dQ, dK and dV for q
(B, Tq, NQ, H) and k/v (B, Tk, NKV, H) under every mask the forward takes
(causal, bidirectional, prefix-LM, window, q_offset), float32 or
bfloat16 (one dtype for all), float32 sums: bf16 on the tensor cores,
float32 on scalar kernels. The plain version is autograd through
``ref.flash_attention_gqa_ref`` (``ref.flash_attention_bwd_ref``).
``flash_attention.FlashAttention`` calls :func:`launch` from its
backward.
"""
from __future__ import annotations

import ctypes
import functools
import re

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import HEAD_DIMS

#: Launches of the CUDA entry (three kernels each) since the last reset.
launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: ctypes signature of the C entry (checked against its source by the tests).
ARGTYPES = [_P] * 10 + [_I] * 11 + [_F, _P]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Columns of the bf16 route's tile plan (``BWD_BF16_PLANS`` in the source):
#: keys a dK/dV block, query rows a dK/dV step, query rows a dQ block, keys
#: a dQ step.
PLAN_COLUMNS = ("kv_keys", "kv_rows", "q_rows", "q_keys")


def bf16_plans() -> dict:
    """The bf16 route's tile plan read from its source, head dim → the
    PLAN_COLUMNS and each kernel's shared memory in bytes (the layouts of
    ``RowsSmem`` and ``DkdvSmem``: rows of H + 8 bf16, P^T and dS^T rows of
    kv_rows + 8, 2-stage rings, the dK/dV steps' lse and D in float32)."""
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    table = re.search(r"#define BWD_BF16_PLANS\(X\)((?:[^\n]*\\\n)*[^\n]*)", src).group(1)
    plans = {}
    for row in re.findall(r"X\(([^)]*)\)", table):
        H, *cols = (int(c) for c in row.split(","))
        p = dict(zip(PLAN_COLUMNS, cols))
        ld = H + 8
        p["rows_smem"] = 2 * (2 * p["q_rows"] * ld + 2 * 2 * p["q_keys"] * ld)
        p["dkdv_smem"] = (2 * (2 * p["kv_keys"] * ld + 2 * 2 * p["kv_rows"] * ld
                               + 2 * p["kv_keys"] * (p["kv_rows"] + 8))
                          + 4 * 2 * 2 * p["kv_rows"])
        plans[H] = p
    return plans


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("flash_attention_bwd").flash_attention_bwd
    fn.argtypes = ARGTYPES
    fn.restype = _I
    return fn


def check_inputs(q, k, v) -> None:
    """Raise ValueError for q/k/v the backward does not take."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError("flash_attention_bwd expects q (B, T, NQ, H) and k/v "
                         "(B, S, NKV, H) of one shape")
    B, _, NQ, H = q.shape
    if k.shape[0] != B or k.shape[3] != H or NQ % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not match "
                         "(NQ must be a multiple of NKV)")
    if q.dtype not in _DTYPES or not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"flash_attention_bwd takes q, k, v of one dtype, float32 or "
                         f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if H not in HEAD_DIMS:
        raise ValueError(f"head dim {H} is not one of the kernel's {HEAD_DIMS}")


def launch(q, k, v, out, dout, *, causal: bool, window: int, q_offset: int,
           prefix_len: int = 0):
    """(dq, dk, dv) of ``flash_attention.launch(q, k, v, ...) = out`` for
    the output gradient ``dout``, each in the inputs' dtype, on q's CUDA
    device."""
    global launches
    check_inputs(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape or not (
            out.dtype == dout.dtype == q.dtype):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} and dout "
                         f"{tuple(dout.shape)} {dout.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v, out, dout)):
        raise ValueError("flash_attention_bwd kernel needs CUDA tensors on one device")
    q, k, v, out, dout = (t.contiguous() for t in (q, k, v, out, dout))
    B, Tq, NQ, H = q.shape
    _, Tk, NKV, _ = k.shape
    if not (B and Tq and Tk):
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lse = torch.empty((B, NQ, Tq), dtype=torch.float32, device=q.device)
    dsum = torch.empty_like(lse)
    rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
               dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
               dsum.data_ptr(), B, Tq, Tk, NQ, NKV, H, _DTYPES[q.dtype], int(causal),
               int(window), int(q_offset), int(prefix_len), H ** -0.5,
               torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention_bwd")
    launches += 1
    return dq, dk, dv
