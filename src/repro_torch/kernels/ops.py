"""The only kernel entry point the rest of the port uses.

Same signatures as ``repro.kernels.ops``, each with a per-call
``backend=``. Every op resolves its backend through the kernel registry
(:mod:`.registry`): by default a tensor on the CPU runs the plain
PyTorch version (:mod:`.ref`, the ``reference`` backend) and a CUDA
tensor launches the hand-written kernel (``cuda``); a backend chosen by
``backend=``, ``registry.use`` or ``set_active`` must match the device,
or the call raises — there is no fallback. The tiled matmuls take their
block plan from the registry (``registry.plan``; plan files and
``autotune`` pin others, none changing a bit). Each kernel module counts
its launches (:func:`launch_counts`), so a run can show that its main
path went through the kernels. Every Pallas kernel of the JAX package is
ported: the fused quantize → packed matmul, paged decode attention (also
run over the contiguous cache by ``decode_attention``), paged chunked
prefill, the row quantizer and the unfused integer matmul (the Table
III mixed-group path: one row pass, then one integer matmul per filter
group with the dequant in its store), flash attention (whole-prompt
prefill) and the RWKV-6 chunked recurrence ``wkv6``. The attention
kernels share one tile routine, so every attention path sums in one
order. Two kernels have no Pallas counterpart: ``dense_matmul``, the
batch-invariant bf16 product of rwkv6's, griffin's and unpacked models'
dense layers on the card (with a float32 store for griffin's gate
projections), ``rglru``, griffin's gates and recurrence in one
sequential pass, and ``expert_matmul``, the MoE layers' grouped expert
product (``dense_matmul``'s rows, one product an expert, reading only
the experts with rows). Training adds the gradients JAX gets from XLA's
autodiff: ``flash_attention_bwd`` (flash attention's), ``wkv6_bwd`` (the
RWKV-6 recurrence's), ``rglru_bwd`` (the RG-LRU's) and
``expert_matmul_bwd`` (the grouped expert product's dX and dW), each run
by an autograd Function on the card when grad is on and an input requires
it.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import bitplane_matmul as _bpm
from repro_torch.kernels import dense_matmul as _dense
from repro_torch.kernels import expert_matmul as _expert
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import flash_attention_bwd as _flash_bwd
from repro_torch.kernels import fused_matmul as _fused
from repro_torch.kernels import pack_quant as _pq
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import paged_prefill as _paged_pf
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rglru as _rglru
from repro_torch.kernels import wkv6 as _wkv6
from repro_torch.kernels.registry import KernelBackend, get_registry

_MODULES = {
    "fused_quantize_matmul": _fused,
    "paged_attention": _paged,
    "paged_prefill": _paged_pf,
    "quantize_rows": _pq,
    "bitplane_matmul": _bpm,
    "flash_attention": _flash,
    "wkv6": _wkv6,
    "dense_matmul": _dense,
    "rglru": _rglru,
    "flash_attention_bwd": _flash_bwd,
    "expert_matmul": _expert,
}


def launch_counts() -> Dict[str, int]:
    """CUDA launches per kernel since the last :func:`reset_launch_counts`
    (the two recurrences' backward entries under their own names)."""
    counts = {name: mod.launches for name, mod in _MODULES.items()}
    counts["wkv6_bwd"] = _wkv6.bwd_launches
    counts["rglru_bwd"] = _rglru.bwd_launches
    counts["expert_matmul_bwd"] = _expert.bwd_launches
    return counts


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
    _paged.contig_launches = 0
    _paged.ring_launches = 0
    _rglru.step_launches = 0
    _wkv6.bwd_launches = 0
    _rglru.bwd_launches = 0
    _expert.bwd_launches = 0


def _needs_grad(*ts) -> bool:
    """Whether a kernel call must record its gradient: autograd is on and
    an input requires one. Otherwise the kernel is called directly, as
    serving calls it."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _backend(t: torch.Tensor, name: str, backend) -> KernelBackend:
    """The backend op `name` runs on t's device (ValueError on a mismatch)."""
    return get_registry().resolve(backend, t.device, name)


def fused_quantize_matmul(x: torch.Tensor, w_packed: torch.Tensor, *,
                          w_bits: int = 8, a_bits: int = 8,
                          act_signed: bool = True, plane_bits: int = 2,
                          w_plane_lo: int = 0, backend=None):
    """(M, K) float × (K·w_bits/8, N) packed int8 weight codes →
    ((M, N) int32 accumulator, (M, 1) float32 per-row scales).

    With ``w_bits=8`` the packed operand is the (K, N) codes themselves —
    the JAX signature. Activations are quantized per row inside the
    kernel; ``w_plane_lo`` contracts only the top weight planes. float32
    and bfloat16 rows are read as they are (bf16 → f32 is exact)."""
    if plane_bits != 2:
        raise ValueError("the kernel decomposes 2-bit planes only")
    kw = dict(w_bits=w_bits, a_bits=a_bits, act_signed=act_signed,
              w_plane_lo=w_plane_lo)
    be = _backend(x, "fused_quantize_matmul", backend)
    if be.is_reference:
        return _ref.fused_quantize_matmul_ref(x.to(torch.float32), w_packed, **kw)
    return _fused.launch(_kernel_rows(x), w_packed, backend=be, **kw)


def _kernel_rows(x: torch.Tensor) -> torch.Tensor:
    """x as the fused kernel and the row quantizer read it: float32 or
    bfloat16 as it is, any other dtype as float32."""
    return x if x.dtype in (torch.float32, torch.bfloat16) else x.to(torch.float32)


def packed_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                  *, w_bits: int, a_bits: int = 8, act_signed: bool = True,
                  w_plane_lo: int = 0, packed8: Optional[torch.Tensor] = None,
                  scale8: Optional[torch.Tensor] = None, backend=None) -> torch.Tensor:
    """float x (M, K) × packed weights ((K·bits/8), N) → (M, N) in x's
    dtype: the fused kernel with ``(acc · xs) · ws`` per element in its
    store (``ws`` = scale · 4**w_plane_lo), one rounding to x's dtype.
    With ``packed8`` (8-bit codes (K, N8)) and ``scale8``, a leaf's second
    filter group: the result is [y8, y] (M, N8 + N), the 8-bit group
    first, both on the same row scales. On the card that is one matmul
    launch per group, each writing its columns of one output, after one
    row pass (none up to M = 8, where the matmul blocks reduce the rows'
    scales themselves)."""
    kw = dict(a_bits=a_bits, act_signed=act_signed, w_plane_lo=w_plane_lo)
    groups = [(packed, scale, w_bits)]
    if packed8 is not None:
        groups.insert(0, (packed8, scale8, 8))
    be = _backend(x, "packed_matmul", backend)
    if be.is_reference:
        ys = [_ref.packed_matmul_ref(x, p, s, w_bits=b, **kw) for p, s, b in groups]
        return torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    out_dtype = x.dtype if x.dtype in (torch.float32, torch.bfloat16) else torch.float32
    out = torch.empty((x.shape[0], sum(p.shape[1] for p, _, _ in groups)),
                      dtype=out_dtype, device=x.device)
    xk, xs, col = _kernel_rows(x), None, 0
    for p, s, b in groups:
        xs = _fused.launch_dequant(xk, p, s, out, col=col, w_bits=b, x_scales=xs,
                                   backend=be, **kw)
        col += p.shape[1]
    return out.to(x.dtype)


def quantize_rows(x: torch.Tensor, *, bits: int = 8, signed: bool = True, backend=None):
    """Per-row (per-token) quantization: (M, K) float → ((M, K) int8
    codes, (M, 1) float32 scales), the codes of x as float32. Unsigned
    8-bit codes are stored wrapped (255 as -1). float32 and bfloat16 rows
    are read as they are (bf16 → f32 is exact)."""
    if _backend(x, "quantize_rows", backend).is_reference:
        return _ref.quantize_rows_ref(x, bits, signed)
    return _pq.launch(_kernel_rows(x), bits=bits, signed=signed)


def bitplane_matmul(x_codes: torch.Tensor, w_codes: torch.Tensor, *,
                    a_bits: int = 8, act_signed: bool = True,
                    plane_bits: int = 2, w_plane_lo: int = 0,
                    w_bits: int = 8, backend=None) -> torch.Tensor:
    """Exact int product of (M, K) activation codes × weight codes →
    (M, N) int32. ``w_codes`` is the (K, N) codes for ``w_bits=8`` (the
    JAX signature) and the packed (K·w_bits/8, N) bytes otherwise;
    unsigned activation codes are read mod 2**a_bits; ``w_plane_lo``
    contracts only the top weight planes."""
    if plane_bits != 2:
        raise ValueError("the kernel decomposes 2-bit planes only")
    kw = dict(a_bits=a_bits, act_signed=act_signed, w_plane_lo=w_plane_lo)
    be = _backend(x_codes, "bitplane_matmul", backend)
    if be.is_reference:
        return _ref.bitplane_matmul_ref(x_codes, w_codes, w_bits=w_bits, **kw)
    return _bpm.launch(x_codes.to(torch.int8), w_codes.to(torch.int8),
                       w_bits=w_bits, backend=be, **kw)


def mixed_group_matmul(x: torch.Tensor, w8_codes: torch.Tensor,
                       wl_packed: torch.Tensor, scale8: torch.Tensor,
                       scalel: torch.Tensor, *, w_bits: int,
                       a_bits: int = 8, backend=None) -> torch.Tensor:
    """Intra-layer mixed 8-bit / low-bit filter groups (paper Table III):
    one signed per-row quantization of x shared by both groups, then one
    integer matmul per group — the 8-bit codes (K, N8) and the low group
    read packed ((K·w_bits/8, NL)) — each dequantized ``(acc · xs) · ws``
    in float32 with its own scales. Returns [y8, yl] (M, N8 + NL) in x's
    dtype, one rounding from float32.

    On the card that is one ``quantize_rows`` launch on x as it is
    (float32 or bfloat16), then one ``bitplane_matmul`` dequant launch per
    group, each storing its columns of one output (plus a fold launch
    where the plan splits K above M = 8): no concatenation, cast, product
    or fill around them."""
    be = _backend(x, "mixed_group_matmul", backend)
    if be.is_reference:
        xq, xs = quantize_rows(x, bits=a_bits, signed=True, backend=be)
        acc8 = bitplane_matmul(xq, w8_codes, a_bits=a_bits, backend=be)
        accl = bitplane_matmul(xq, wl_packed, a_bits=a_bits, w_bits=w_bits, backend=be)
        y8 = acc8.to(torch.float32) * xs * scale8.reshape(1, -1)
        yl = accl.to(torch.float32) * xs * scalel.reshape(1, -1)
        return torch.cat([y8, yl], dim=1).to(x.dtype)
    xk = _kernel_rows(x)
    xq, xs = _pq.launch(xk, bits=a_bits, signed=True)
    n8 = w8_codes.shape[1]
    out = torch.empty((x.shape[0], n8 + wl_packed.shape[1]), dtype=xk.dtype, device=x.device)
    _bpm.launch_dequant(xq, w8_codes, xs, scale8, out, col=0, w_bits=8, a_bits=a_bits,
                        backend=be)
    _bpm.launch_dequant(xq, wl_packed, xs, scalel, out, col=n8, w_bits=w_bits,
                        a_bits=a_bits, backend=be)
    return out.to(x.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0, prefix_len: int = 0,
                    backend=None) -> torch.Tensor:
    """GQA flash attention: q (B, T, NQ, H) over k/v (B, S, NKV, H), query
    head h reading KV head h // (NQ // NKV); causal, prefix-LM (under
    causal, keys < prefix_len are visible to every query) and
    sliding-window masks at query positions q_offset + i; keys past S
    never seen. Returns (B, T, NQ, H) in q's dtype; a query that sees no
    key gets zeros. K/V may be float32 under a bfloat16 q (an int8
    cache's prefill reads dequantized K/V). Under autograd (an input
    requires grad) the card's gradient is the ``flash_attention_bwd``
    kernel, which takes q, k, v of one dtype (ValueError otherwise); the
    CPU's is autograd through the plain version."""
    if _backend(q, "flash_attention", backend).is_reference:
        return _ref.flash_attention_gqa_ref(q, k, v, causal, window, q_offset,
                                            prefix_len)
    if _needs_grad(q, k, v):
        _flash_bwd.check_inputs(q, k, v)
        return _flash.FlashAttention.apply(q, k, v, bool(causal), int(window),
                                           int(q_offset), int(prefix_len))
    return _flash.launch(q, k, v, causal=causal, window=window,
                         q_offset=int(q_offset), prefix_len=int(prefix_len))


def paged_attention(q, pool_k, pool_v, block_table, q_pos, *,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    softcap: float = 0.0, backend=None) -> torch.Tensor:
    """Flash-decode attention over one layer's paged KV pool: q (B, 1, NQ,
    H), pools (num_blocks, block_size, NKV, H), block_table (B, max_blocks)
    int32 (-1 = unallocated), q_pos (B,). Returns (B, 1, NQ, H) in q's
    dtype; rows that see no key output zeros."""
    if _backend(q, "paged_attention", backend).is_reference:
        return _ref.paged_attention_ref(q, pool_k, pool_v, block_table, q_pos,
                                        k_scale=k_scale, v_scale=v_scale,
                                        softcap=softcap)
    return _paged.launch(q, pool_k, pool_v, block_table, q_pos,
                         k_scale=k_scale, v_scale=v_scale, softcap=softcap)


def paged_prefill(q, k_new, v_new, pool_k, pool_v, blocks, start, length, *,
                  k_scale: Optional[torch.Tensor] = None,
                  v_scale: Optional[torch.Tensor] = None,
                  softcap: float = 0.0, store: bool = True, backend=None):
    """Chunked prefill over one layer's paged pool: the chunk (1, Lc, NQ,
    H) attends causally over [pool-resident prefix ++ chunk], and its K/V
    (1, Lc, NKV, H) is written into the row's destination blocks ``blocks``
    (mb,) at positions [start, start + length). The pool planes are
    updated IN PLACE (the JAX kernel aliases them); the returned planes
    are the same tensors. ``store=False`` writes nothing: the chunk
    attends the K/V already resident at its own positions (a whole-prompt
    prefix-cache hit, whose blocks are shared). Returns (attn (1, Lc, NQ,
    H) in q's dtype, pool_k, pool_v, k_scale, v_scale)."""
    start, length = int(start), int(length)
    if _backend(q, "paged_prefill", backend).is_reference:
        return _ref.paged_prefill_ref(q, k_new, v_new, pool_k, pool_v, blocks,
                                      start, length, k_scale=k_scale,
                                      v_scale=v_scale, softcap=softcap,
                                      store=store)
    return _paged_pf.launch(q, k_new, v_new, pool_k, pool_v, blocks, start,
                            length, k_scale=k_scale, v_scale=v_scale,
                            softcap=softcap, store=store)


def decode_attention(q, k_cache, v_cache, kpos, q_pos, *, window: int = 0,
                     softcap: float = 0.0, k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None, backend=None) -> torch.Tensor:
    """One-token attention over one layer of the contiguous cache: q (B, 1,
    NQ, H), k/v_cache (B, S, NKV, H) (int8 codes with (B, S, NKV, 1)
    float32 scales for an int8 cache), kpos (B, S) slot positions (-1 =
    empty), q_pos (B,). The plain version is
    ``models.common.decode_attention``; on the card the paged decode
    kernel's code runs with each row's slots as its tiles. With ``window``
    > 0 the cache is a ring (position p in slot p % S iff kpos there is
    p) and the kernel's ring entry runs: each row sees the positions of
    its window, in the tiles and splits of a full row."""
    if _backend(q, "decode_attention", backend).is_reference:
        from repro_torch.models.common import decode_attention as plain

        return plain(q, k_cache, v_cache, kpos, q_pos, window=window,
                     softcap=softcap, k_scale=k_scale, v_scale=v_scale)
    return _paged.launch_contig(q, k_cache, v_cache, kpos, q_pos, k_scale=k_scale,
                                v_scale=v_scale, softcap=softcap, window=window)


def dense_matmul(x: torch.Tensor, w: torch.Tensor, *, out_dtype=None,
                 backend=None) -> torch.Tensor:
    """``x @ w`` over the last dim of x: (..., K) × (K, N) → (..., N) in
    x's dtype, each row's bits independent of how many rows share the
    product. The plain version is ``x @ w.to(x.dtype)``. On the card a
    bfloat16 x launches the batch-invariant kernel; a float32 x goes to
    ``torch.matmul`` in full float32, a dtype route, not a fallback: the
    port's float32 models serve the card-vs-CPU checks, which hold logits
    within a tolerance, not bitwise.

    ``out_dtype=torch.float32`` is JAX's ``x.astype(f32) @
    w.astype(f32)`` (griffin's gate projections): the plain version
    computes exactly that; on the card a bfloat16 x launches the same
    kernel with its float32 sums stored unrounded (the products of bf16
    operands are exact, only the order of the sums differs). Under
    autograd the kernel's gradient products run on ``torch.matmul``
    (``dense_matmul.DenseMatmul``)."""
    be = _backend(x, "dense_matmul", backend)
    f32_out = out_dtype == torch.float32
    if out_dtype not in (None, x.dtype) and not f32_out:
        raise ValueError(f"dense_matmul: out_dtype {out_dtype} (x's dtype or float32)")
    if be.is_reference:
        if f32_out:
            return x.to(torch.float32) @ w.to(torch.float32)
        return _ref.dense_matmul_ref(x, w)
    if x.dtype == torch.float32:
        return x @ w.to(torch.float32)
    lead = x.shape[:-1]
    x2, wx = x.reshape(-1, x.shape[-1]), w.to(x.dtype)
    od = torch.float32 if f32_out else x.dtype
    if _needs_grad(x2, wx):
        y = _dense.DenseMatmul.apply(x2, wx, od, be)
    else:
        y = _dense.launch(x2, wx, backend=be, out_dtype=od)
    return y.reshape(*lead, w.shape[1])


def expert_matmul(xe: torch.Tensor, w: torch.Tensor, counts: torch.Tensor, *,
                  backend=None) -> torch.Tensor:
    """The MoE capacity buffer's product: xe (E, cap, K) × w (E, K, N) →
    (E, cap, N) in xe's dtype, each expert's rows at or past ``counts``
    (E,) zero. The plain version is ``ref.expert_matmul_ref`` (JAX's
    ``einsum("ecd,edf->ecf")``, rows past the count zeroed). On the card
    a bfloat16 xe launches the grouped kernel: each kept row bitwise
    ``dense_matmul`` of the row alone against its expert, the counts read
    on the device, and an expert without rows reads no weight. A float32
    xe goes to ``torch.einsum`` in full float32, a dtype route, as
    :func:`dense_matmul`'s. Under autograd (an input requires grad) the
    card runs ``expert_matmul.ExpertMatmul``, whose backward is the
    ``expert_matmul_bwd`` kernel (dX and dW over the kept rows); the CPU's
    gradient is autograd through the plain version."""
    be = _backend(xe, "expert_matmul", backend)
    if be.is_reference or xe.dtype == torch.float32:
        return _ref.expert_matmul_ref(xe, w, counts)
    wx = w.to(xe.dtype)
    if _needs_grad(xe, wx):
        return _expert.ExpertMatmul.apply(xe, wx, counts)
    return _expert.launch(xe, wx, counts)


def wkv6_chunked(r, k, v, w, u, state, *, chunk: int = 64, backend=None):
    """RWKV-6 recurrence over (B, T) tokens with the state carried in and
    out: r/k (B, T, H, K) and v (B, T, H, V) in their own dtype, w (B, T,
    H, K) decays in (0, 1], u (H, K), state (B, H, K, V) float32. Chunk
    boundaries sit at absolute positions 0, chunk, 2·chunk, …, so a row's
    outputs and final state never depend on the length its batch was
    padded to (pad tokens: k = 0, w = 1). Returns (out (B, T, H, V)
    float32, state (B, H, K, V) float32). Under autograd (an input
    requires grad) the card runs ``wkv6.WKV6``, whose backward is the
    ``wkv6_bwd`` kernel; the CPU's gradient is autograd through the plain
    version."""
    if _backend(r, "wkv6", backend).is_reference:
        return _ref.wkv6_chunked_ref(r, k, v, w, u, state, chunk)
    if _needs_grad(r, k, v, w, u, state):
        return _wkv6.WKV6.apply(r, k, v, w, u, state, int(chunk))
    return _wkv6.launch(r, k, v, w, u, state, chunk=chunk)


def wkv6_step(r, k, v, w, u, state, *, backend=None):
    """One token of the recurrence: r/k/w (B, H, K), v (B, H, V), state
    (B, H, K, V) → (out (B, H, V), state) float32. The plain version is
    ``ref.wkv6_step``; on the card the wkv6 kernel runs at T = 1 with the
    carried state (one thread block per (row, head), whatever the batch)."""
    if _backend(r, "wkv6", backend).is_reference:
        return _ref.wkv6_step(r, k, v, w, u, state)
    out, state = _wkv6.launch(r[:, None], k[:, None], v[:, None], w[:, None], u,
                              state, chunk=1)
    return out[:, 0], state


def wkv6(r, k, v, w, u, *, chunk: int = 32, backend=None) -> torch.Tensor:
    """Chunked WKV6 with the JAX signature: r/k/w (T, H, K), v (T, H, V),
    u (H, K), zero initial state → (T, H, V) float32."""
    return wkv6_batched(r[None], k[None], v[None], w[None], u, chunk=chunk,
                        backend=backend)[0]


def wkv6_batched(r, k, v, w, u, *, chunk: int = 32, backend=None) -> torch.Tensor:
    """``wkv6`` over a batch: r/k/w (B, T, H, K), v (B, T, H, V) → (B, T,
    H, V) float32, each row from a zero state."""
    B, _, H, K = r.shape
    state = torch.zeros((B, H, K, v.shape[-1]), dtype=torch.float32,
                        device=r.device)
    return wkv6_chunked(r, k, v, w, u, state, chunk=chunk, backend=backend)[0]


def rglru_scan(ga, gi, y, a_bias, i_bias, lam, h0=None, lengths=None, *,
               backend=None):
    """Griffin's RG-LRU over (B, T, W) with the state carried in: ga, gi
    the float32 gate projections y A_r, y A_i; y the conv output (float32
    or bfloat16); a_bias, i_bias, lam (W,) float32; h0 (B, W) or None
    (zero); lengths (B,) real tokens of right-padded rows or None. Returns
    (h (B, T, W), h at each row's lengths - 1 (B, W)), float32. The plain
    version is ``ref.rglru_scan_ref``; on the card the ``rglru`` kernel,
    whose rows never depend on their padding or batch. Under autograd (an
    input requires grad) the card runs ``rglru.RGLRU``, whose backward is
    the ``rglru_bwd`` kernel, and h at lengths - 1 is a slice of h, so its
    gradient reaches h once; the CPU's gradient is autograd through the
    plain version."""
    if _backend(ga, "rglru", backend).is_reference:
        return _ref.rglru_scan_ref(ga, gi, y, a_bias, i_bias, lam, h0, lengths)
    if _needs_grad(ga, gi, y, a_bias, i_bias, lam, *([] if h0 is None else [h0])):
        h = _rglru.RGLRU.apply(ga, gi, y, a_bias, i_bias, lam, h0)
        if lengths is None:
            return h, h[:, -1]
        last = (torch.as_tensor(lengths).to(h.device).long() - 1).clamp(min=0)
        return h, h[torch.arange(h.shape[0], device=h.device), last]
    return _rglru.launch(ga, gi, y, a_bias, i_bias, lam, h0, lengths)


def rglru_step(ga, gi, y, a_bias, i_bias, lam, h0, *, backend=None):
    """One token of the RG-LRU: ga, gi, y (B, W), h0 (B, W) → h (B, W)
    float32; :func:`rglru_scan` at T = 1 with the carried state (on the
    card one launch of the step kernel, the same element's arithmetic)."""
    h, _ = rglru_scan(ga[:, None], gi[:, None], y[:, None], a_bias, i_bias, lam, h0,
                      backend=backend)
    return h[:, 0]
