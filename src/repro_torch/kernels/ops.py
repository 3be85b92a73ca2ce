"""The only kernel entry point the rest of the port uses.

Same signatures as ``repro.kernels.ops``. Dispatch is by device alone: a
tensor on the CPU runs the plain PyTorch version (:mod:`.ref`); a CUDA
tensor launches the hand-written kernel, or the call raises — there is
no fallback. Each kernel module counts its launches
(:func:`launch_counts`), so a run can show that its main path went
through the kernels. Six kernels are ported: the fused quantize →
packed matmul, paged decode attention, paged chunked prefill, the row
quantizer and the unfused integer matmul (the Table III mixed-group
path) and flash attention (whole-prompt prefill). The JAX registry
(block plans, autotune, plan files) is not part of the port yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import bitplane_matmul as _bpm
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import fused_matmul as _fused
from repro_torch.kernels import pack_quant as _pq
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import paged_prefill as _paged_pf
from repro_torch.kernels import ref as _ref

_MODULES = {
    "fused_quantize_matmul": _fused,
    "paged_attention": _paged,
    "paged_prefill": _paged_pf,
    "quantize_rows": _pq,
    "bitplane_matmul": _bpm,
    "flash_attention": _flash,
}


def launch_counts() -> Dict[str, int]:
    """CUDA launches per kernel since the last :func:`reset_launch_counts`."""
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0


def _on_cpu(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return False


def fused_quantize_matmul(x: torch.Tensor, w_packed: torch.Tensor, *,
                          w_bits: int = 8, a_bits: int = 8,
                          act_signed: bool = True, plane_bits: int = 2,
                          w_plane_lo: int = 0):
    """(M, K) float × (K·w_bits/8, N) packed int8 weight codes →
    ((M, N) int32 accumulator, (M, 1) float32 per-row scales).

    With ``w_bits=8`` the packed operand is the (K, N) codes themselves —
    the JAX signature. Activations are quantized per row in the kernel's
    K-loop prologue; ``w_plane_lo`` contracts only the top weight planes."""
    if plane_bits != 2:
        raise ValueError("the kernel decomposes 2-bit planes only")
    x = x.to(torch.float32)
    kw = dict(w_bits=w_bits, a_bits=a_bits, act_signed=act_signed,
              w_plane_lo=w_plane_lo)
    if _on_cpu(x, "fused_quantize_matmul"):
        return _ref.fused_quantize_matmul_ref(x, w_packed, **kw)
    return _fused.launch(x, w_packed, **kw)


def packed_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                  *, w_bits: int, a_bits: int = 8, act_signed: bool = True,
                  w_plane_lo: int = 0) -> torch.Tensor:
    """float x (M, K) × packed weights ((K·bits/8), N) → float (M, N):
    the fused kernel, then ``acc · xs · ws`` per element in that order
    (``ws`` regains 4**w_plane_lo for a plane-truncated view)."""
    acc, xs = fused_quantize_matmul(x, packed, w_bits=w_bits, a_bits=a_bits,
                                    act_signed=act_signed,
                                    w_plane_lo=w_plane_lo)
    ws = scale.reshape(1, -1)
    if w_plane_lo:
        ws = ws * (1 << (2 * w_plane_lo))
    return (acc.to(torch.float32) * xs * ws).to(x.dtype)


def quantize_rows(x: torch.Tensor, *, bits: int = 8, signed: bool = True):
    """Per-row (per-token) quantization: (M, K) float → ((M, K) int8
    codes, (M, 1) float32 scales). Unsigned 8-bit codes are stored
    wrapped (255 as -1)."""
    x = x.to(torch.float32)
    if _on_cpu(x, "quantize_rows"):
        return _ref.quantize_rows_ref(x, bits, signed)
    return _pq.launch(x, bits=bits, signed=signed)


def bitplane_matmul(x_codes: torch.Tensor, w_codes: torch.Tensor, *,
                    a_bits: int = 8, act_signed: bool = True,
                    plane_bits: int = 2, w_plane_lo: int = 0,
                    w_bits: int = 8) -> torch.Tensor:
    """Exact int product of (M, K) activation codes × weight codes →
    (M, N) int32. ``w_codes`` is the (K, N) codes for ``w_bits=8`` (the
    JAX signature) and the packed (K·w_bits/8, N) bytes otherwise;
    unsigned activation codes are read mod 2**a_bits; ``w_plane_lo``
    contracts only the top weight planes."""
    if plane_bits != 2:
        raise ValueError("the kernel decomposes 2-bit planes only")
    kw = dict(a_bits=a_bits, act_signed=act_signed, w_plane_lo=w_plane_lo)
    if _on_cpu(x_codes, "bitplane_matmul"):
        return _ref.bitplane_matmul_ref(x_codes, w_codes, w_bits=w_bits, **kw)
    return _bpm.launch(x_codes.to(torch.int8), w_codes.to(torch.int8),
                       w_bits=w_bits, **kw)


def mixed_group_matmul(x: torch.Tensor, w8_codes: torch.Tensor,
                       wl_packed: torch.Tensor, scale8: torch.Tensor,
                       scalel: torch.Tensor, *, w_bits: int,
                       a_bits: int = 8) -> torch.Tensor:
    """Intra-layer mixed 8-bit / low-bit filter groups (paper Table III):
    one signed per-row quantization of x shared by both groups, then one
    integer matmul per group — the 8-bit codes (K, N8) and the low group
    read packed ((K·w_bits/8, NL)) — each dequantized ``acc · xs · ws``
    with its own scales. Returns [y8, yl] (M, N8 + NL) in x's dtype."""
    xq, xs = quantize_rows(x, bits=a_bits, signed=True)
    acc8 = bitplane_matmul(xq, w8_codes, a_bits=a_bits)
    accl = bitplane_matmul(xq, wl_packed, a_bits=a_bits, w_bits=w_bits)
    y8 = acc8.to(torch.float32) * xs * scale8.reshape(1, -1)
    yl = accl.to(torch.float32) * xs * scalel.reshape(1, -1)
    return torch.cat([y8, yl], dim=1).to(x.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """GQA flash attention: q (B, T, NQ, H) over k/v (B, S, NKV, H), query
    head h reading KV head h // (NQ // NKV); causal and sliding-window
    masks at query positions q_offset + i; keys past S never seen.
    Returns (B, T, NQ, H) in q's dtype; a query that sees no key gets
    zeros. K/V may be float32 under a bfloat16 q (an int8 cache's
    prefill reads dequantized K/V)."""
    if _on_cpu(q, "flash_attention"):
        return _ref.flash_attention_gqa_ref(q, k, v, causal, window, q_offset)
    return _flash.launch(q, k, v, causal=causal, window=window,
                         q_offset=int(q_offset))


def paged_attention(q, pool_k, pool_v, block_table, q_pos, *,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    softcap: float = 0.0) -> torch.Tensor:
    """Flash-decode attention over one layer's paged KV pool: q (B, 1, NQ,
    H), pools (num_blocks, block_size, NKV, H), block_table (B, max_blocks)
    int32 (-1 = unallocated), q_pos (B,). Returns (B, 1, NQ, H) in q's
    dtype; rows that see no key output zeros."""
    if _on_cpu(q, "paged_attention"):
        return _ref.paged_attention_ref(q, pool_k, pool_v, block_table, q_pos,
                                        k_scale=k_scale, v_scale=v_scale,
                                        softcap=softcap)
    return _paged.launch(q, pool_k, pool_v, block_table, q_pos,
                         k_scale=k_scale, v_scale=v_scale, softcap=softcap)


def paged_prefill(q, k_new, v_new, pool_k, pool_v, blocks, start, length, *,
                  k_scale: Optional[torch.Tensor] = None,
                  v_scale: Optional[torch.Tensor] = None,
                  softcap: float = 0.0):
    """Chunked prefill over one layer's paged pool: the chunk (1, Lc, NQ,
    H) attends causally over [pool-resident prefix ++ chunk], and its K/V
    (1, Lc, NKV, H) is written into the row's destination blocks ``blocks``
    (mb,) at positions [start, start + length). The pool planes are
    updated IN PLACE (the JAX kernel aliases them); the returned planes
    are the same tensors. Returns (attn (1, Lc, NQ, H) in q's dtype,
    pool_k, pool_v, k_scale, v_scale)."""
    start, length = int(start), int(length)
    if _on_cpu(q, "paged_prefill"):
        return _ref.paged_prefill_ref(q, k_new, v_new, pool_k, pool_v, blocks,
                                      start, length, k_scale=k_scale,
                                      v_scale=v_scale, softcap=softcap)
    return _paged_pf.launch(q, k_new, v_new, pool_k, pool_v, blocks, start,
                            length, k_scale=k_scale, v_scale=v_scale,
                            softcap=softcap)
