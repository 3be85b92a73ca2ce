"""Plain PyTorch versions of the port's CUDA kernels.

Ported from ``repro.kernels.ref`` (``quantize_pack_ref``,
``bitplane_matmul_ref``, ``mixed_group_matmul_ref``,
``paged_attention_ref``, ``paged_prefill_ref``, ``flash_attention_ref``,
``wkv6_ref``), ``repro.models.rwkv6`` (``wkv6_chunked``,
``wkv6_step``), ``repro.models.moe`` (``_expert_ffn``'s product, as
``expert_matmul_ref``) and ``repro.models.griffin`` (``_rglru_coeffs`` with
``_rglru_scan``, as ``rglru_scan_ref``); ``wkv6_chunked_bwd_ref`` and
``rglru_scan_bwd_ref`` spell out the two backward kernels' algebra, which
JAX leaves to XLA's autodiff (held against it in
``tests/test_torch_train_recurrent.py``).
They are the semantic specification: on the CPU the kernel entry points
in :mod:`repro_torch.kernels.ops` run them, and on the card
``chip_smoke.py`` holds each CUDA kernel against them. Integer outputs
(codes, accumulators, activation scales, int8 pool bytes and scale
planes) are bitwise those of the JAX package; float outputs agree within
the tolerances stated in ``tests/test_torch_kernels.py``,
``tests/test_torch_mixed_matmul.py``, ``tests/test_torch_flash.py`` and
``tests/test_torch_rwkv6.py`` and ``tests/test_torch_griffin.py``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import bitplane
from repro_torch.core.quant import reciprocal_f32

_TILE = 64      # flash_attention_ref's padding granularity (see there)


def quantize_pack_ref(x: torch.Tensor, bits: int, signed: bool = True):
    """Per-row absmax symmetric quantization of (M, K) float32 x: int32
    codes and (M, 1) float32 scales, with the strength-reduced scale
    ``absmax * (1/qhi)`` that the jitted JAX reference computes."""
    qhi = (1 << (bits - 1)) - 1 if signed else (1 << bits) - 1
    qlo = -(1 << (bits - 1)) if signed else 0
    absmax = x.abs().amax(dim=1, keepdim=True)
    scale = absmax * reciprocal_f32(qhi)
    inv = torch.where(scale > 0, torch.ones_like(scale) / scale,
                      torch.zeros_like(scale))
    q = torch.clamp(torch.round(x * inv), qlo, qhi).to(torch.int32)
    return q, scale


def quantize_rows_ref(x: torch.Tensor, bits: int, signed: bool = True):
    """``quantize_pack_ref`` with the codes stored as int8: the int32 →
    int8 narrowing wraps, so an unsigned 8-bit code 255 is stored as -1
    (its bit pattern), as ``repro/kernels/pack_quant.py`` stores it."""
    q, s = quantize_pack_ref(x.to(torch.float32), bits, signed)
    return q.to(torch.int8), s


def bitplane_matmul_ref(x_codes: torch.Tensor, w: torch.Tensor, a_bits: int,
                        act_signed: bool = True, w_plane_lo: int = 0,
                        plane_bits: int = 2, w_bits: int = 8) -> torch.Tensor:
    """(M, K) int activation codes × weight codes → (M, N) int32, exact.
    ``w`` is (K, N) codes for ``w_bits=8`` and the packed (K·w_bits/8, N)
    bytes otherwise. Unsigned codes may arrive wrapped (255 as -1): they
    are read mod 2**a_bits. ``w_plane_lo`` shifts the weight codes before
    the product (keep planes [lo:]). The product runs in float64, exact
    here (|acc| < 2**53), since PyTorch has no integer matmul on CUDA."""
    x = x_codes.to(torch.int32)
    if not act_signed:
        x = x & ((1 << a_bits) - 1)
    w = bitplane.unpack_weights(w, w_bits, axis=0)
    if w_plane_lo:
        w = w >> (w_plane_lo * plane_bits)
    return (x.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)


def mixed_group_matmul_ref(x, w8_codes, wl_codes, scale8, scalel, a_bits: int):
    """Table III intra-layer mixing: x (M, K) float quantized once per row
    at ``a_bits`` (signed), an 8-bit group (K, N8) and a low-bit group
    (K, NL) of codes, each dequantized with its own per-channel scales;
    returns the float32 concatenation [y8, yl]."""
    q, s = quantize_pack_ref(x.to(torch.float32), a_bits)
    acc8 = bitplane_matmul_ref(q, w8_codes, a_bits)
    accl = bitplane_matmul_ref(q, wl_codes, a_bits)
    y8 = acc8.to(torch.float32) * s * scale8.reshape(1, -1)
    yl = accl.to(torch.float32) * s * scalel.reshape(1, -1)
    return torch.cat([y8, yl], dim=1)


def dense_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in x's dtype: the plain version of ``dense_matmul``."""
    return x @ w.to(x.dtype)


def expert_matmul_ref(xe: torch.Tensor, w: torch.Tensor, counts) -> torch.Tensor:
    """``einsum("ecd,edf->ecf")`` in xe's dtype (JAX's ``_expert_ffn``
    product) with each expert's rows at or past its count set to zero:
    the plain version of ``expert_matmul``."""
    y = torch.einsum("ecd,edf->ecf", xe, w.to(xe.dtype))
    rows = torch.arange(xe.shape[1], device=xe.device)
    live = rows[None, :] < torch.as_tensor(counts, device=xe.device).reshape(-1, 1)
    return torch.where(live[..., None], y, torch.zeros((), dtype=y.dtype, device=y.device))


def expert_matmul_bwd_ref(xe: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, counts):
    """The gradient of ``expert_matmul`` (the plain version of
    ``expert_matmul_bwd``): xe (E, cap, K), w (E, K, N), dy (E, cap, N) →
    (dx (E, cap, K) in xe's dtype, dw (E, K, N) in w's), sums in float32.
    dx[e, r] = dy[e, r] w[e]^T below the count, zero from it on; dw[e] sums
    xe[e, r]^T dy[e, r] over r below the count only, whatever the rows
    past it hold (an expert with count 0 gets zeros)."""
    rows = torch.arange(xe.shape[1], device=xe.device)
    live = (rows[None, :] < torch.as_tensor(counts, device=xe.device).reshape(-1, 1))[..., None]
    zero = torch.zeros((), dtype=torch.float32, device=xe.device)
    dyl = torch.where(live, dy.to(torch.float32), zero)
    xl = torch.where(live, xe.to(torch.float32), zero)
    dx = torch.where(live, torch.einsum("ecn,ekn->eck", dyl, w.to(torch.float32)), zero)
    dw = torch.einsum("eck,ecn->ekn", xl, dyl)
    return dx.to(xe.dtype), dw.to(w.dtype)


def flash_attention_ref(q, k, v, causal: bool = True, window: int = 0,
                        q_offset: int = 0, prefix_len: int = 0) -> torch.Tensor:
    """Naive float32 softmax attention over (BH, T, D): key j is visible
    to query p = q_offset + i iff j < Tk, j <= p or j < prefix_len
    (causal; prefix-LM over the first prefix_len positions, the rule of
    ``repro.models.common._mask_block``) and j > p - window (window > 0).
    A query that sees no key outputs zeros.

    Queries and keys are zero-padded to a multiple of ``_TILE`` (the tail
    masked) before the products: CPU kernels take another summation path
    for rows shorter than a vector, so padding to a fixed granularity
    keeps a row's result independent of the length its batch was padded
    to — bucketed prefill is bitwise exact-length prefill."""
    BH, Tq, D = q.shape
    Tk = k.shape[1]
    tq, tk = -(-Tq // _TILE) * _TILE, -(-Tk // _TILE) * _TILE
    qf = torch.nn.functional.pad(q.to(torch.float32), (0, 0, 0, tq - Tq))
    kf = torch.nn.functional.pad(k.to(torch.float32), (0, 0, 0, tk - Tk))
    vf = torch.nn.functional.pad(v.to(torch.float32), (0, 0, 0, tk - Tk))
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * (D ** -0.5)
    qpos = (q_offset + torch.arange(tq, device=q.device))[:, None]
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = (kpos < Tk).expand(tq, tk)
    if causal:
        mask = mask & ((kpos <= qpos) | (kpos < prefix_len))
    if window:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask[None], s, torch.tensor(float("-inf"), device=q.device))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask[None], p, torch.zeros_like(p))
    return torch.einsum("bqk,bkd->bqd", p, vf)[:, :Tq]


def flash_attention_gqa_ref(q, k, v, causal: bool = True, window: int = 0,
                            q_offset: int = 0, prefix_len: int = 0) -> torch.Tensor:
    """``flash_attention_ref`` in the model layout with the GQA dispatch of
    ``repro.kernels.ops.flash_attention``: q (B, T, NQ, H), k/v (B, S,
    NKV, H), KV heads repeated to the query heads. Returns (B, T, NQ, H)
    in q's dtype."""
    B, T, NQ, H = q.shape
    G = NQ // k.shape[2]
    qf = q.transpose(1, 2).reshape(B * NQ, T, H)
    kf = k.transpose(1, 2).repeat_interleave(G, dim=1).reshape(B * NQ, -1, H)
    vf = v.transpose(1, 2).repeat_interleave(G, dim=1).reshape(B * NQ, -1, H)
    out = flash_attention_ref(qf, kf, vf, causal, window, q_offset, prefix_len)
    return out.reshape(B, NQ, T, H).transpose(1, 2).to(q.dtype)


def flash_attention_bwd_ref(q, k, v, dout, causal: bool = True, window: int = 0,
                            q_offset: int = 0, prefix_len: int = 0):
    """(dq, dk, dv) of ``flash_attention_gqa_ref`` for the output gradient
    `dout`, by autograd: the plain version of ``flash_attention_bwd``.
    Each gradient has its input's dtype; a query that sees no key gets
    zero gradients."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_gqa_ref(*leaves, causal, window, q_offset, prefix_len)
        return torch.autograd.grad(out, leaves, dout)


def fused_quantize_matmul_ref(x: torch.Tensor, w_packed: torch.Tensor, *,
                              w_bits: int = 8, a_bits: int = 8,
                              act_signed: bool = True, w_plane_lo: int = 0,
                              plane_bits: int = 2):
    """(M, K) float32 × packed (K·w_bits/8, N) codes → ((M, N) int32,
    (M, 1) float32): ``quantize_pack_ref`` then the exact integer product
    of ``bitplane_matmul_ref``."""
    q, s = quantize_pack_ref(x, a_bits, act_signed)
    return bitplane_matmul_ref(q, w_packed, a_bits, act_signed, w_plane_lo,
                               plane_bits, w_bits), s


def packed_matmul_ref(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor, *,
                      w_bits: int = 8, a_bits: int = 8, act_signed: bool = True,
                      w_plane_lo: int = 0, plane_bits: int = 2) -> torch.Tensor:
    """``fused_quantize_matmul_ref`` dequantized as
    ``repro.core.quantized_linear._serve_matmul`` does it: ``(acc · xs) ·
    ws`` in float32, two products rounded in that order, ``ws = scale ·
    4**w_plane_lo``, then one rounding to x's dtype."""
    acc, xs = fused_quantize_matmul_ref(x.to(torch.float32), w_packed, w_bits=w_bits,
                                        a_bits=a_bits, act_signed=act_signed,
                                        w_plane_lo=w_plane_lo, plane_bits=plane_bits)
    ws = scale.reshape(1, -1).to(torch.float32)
    if w_plane_lo:
        ws = ws * (1 << (plane_bits * w_plane_lo))
    return (acc.to(torch.float32) * xs * ws).to(x.dtype)


def _row_view(pool, tbl, n):
    """Gather a row's blocks in table order: (n·bs, ...) values."""
    return pool[tbl].reshape(n * pool.shape[1], *pool.shape[2:])


def paged_attention_ref(q, pool_k, pool_v, block_table, q_pos,
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None,
                        softcap: float = 0.0) -> torch.Tensor:
    """Gather-then-attend: each row's blocks materialized in table order,
    then ``models.common.decode_attention``'s masked softmax (int8 pools
    rescaled per key and per value slot). Rows that see no key — freed
    slots, whose tables are all -1 — output zeros, as the kernel does."""
    from repro_torch.models.common import decode_attention
    from repro_torch.models.kv_cache import paged_gather

    k_rows, v_rows, kpos, ks_rows, vs_rows = paged_gather(
        pool_k, pool_v, block_table, k_scale, v_scale)
    out = decode_attention(q, k_rows, v_rows, kpos, q_pos, softcap=softcap,
                           k_scale=ks_rows, v_scale=vs_rows)
    pos = torch.as_tensor(q_pos, dtype=torch.int32, device=q.device)
    seen = ((kpos >= 0) & (kpos <= pos.reshape(-1, 1))).any(dim=1)
    return torch.where(seen.reshape(-1, 1, 1, 1), out, torch.zeros_like(out))


def paged_prefill_ref(q, k_new, v_new, pool_k, pool_v, blocks, start, length,
                      k_scale=None, v_scale=None, softcap: float = 0.0,
                      store: bool = True):
    """Scatter-then-gather-attend: write the chunk into the pool with
    ``kv_cache.paged_chunk_write`` (in place; int8 pools quantize on
    write; ``store=False`` skips the write and reads the pool as it is), gather the row's blocks in table order and run a full fp32
    masked softmax — chunk query i sees allocated positions <= start + i,
    padded queries (i >= length) see nothing and output zeros. Returns
    (attn (1, Lc, NQ, H) in q's dtype, pool_k, pool_v, k_scale, v_scale)."""
    from repro_torch.models.kv_cache import paged_chunk_write

    _, Lc, NQ, H = q.shape
    bs, NKV = pool_k.shape[1], pool_k.shape[2]
    G = NQ // NKV
    mb = blocks.shape[0]
    start, length = int(start), int(length)
    if store:
        paged_chunk_write(pool_k, pool_v, blocks, k_new, v_new, start, length, bs,
                          k_scale, v_scale)
    tbl = blocks.clamp(min=0).long()
    k_rows = _row_view(pool_k, tbl, mb).to(torch.float32)
    v_rows = _row_view(pool_v, tbl, mb).to(torch.float32)
    virt = torch.arange(mb * bs, dtype=torch.int32, device=q.device)
    alloc = (blocks >= 0).repeat_interleave(bs)
    kpos = torch.where(alloc, virt, torch.full_like(virt, -1))

    qr = q.reshape(Lc, NKV, G, H).to(torch.float32)
    s = torch.einsum("qngh,snh->nqgs", qr, k_rows)
    if k_scale is not None:
        ks = _row_view(k_scale, tbl, mb).reshape(mb * bs, NKV)
        s = s * ks.T[:, None, None, :]
    s = s * (H ** -0.5)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qi = torch.arange(Lc, dtype=torch.int32, device=q.device)
    qpos = torch.where(qi < length, start + qi, torch.full_like(qi, -1))
    valid = (kpos[None, :] >= 0) & (kpos[None, :] <= qpos[:, None])
    s = torch.where(valid[None, :, None, :], s,
                    torch.tensor(torch.finfo(torch.float32).min, device=q.device))
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid[None, :, None, :], p, torch.zeros_like(p))
    if v_scale is not None:
        vs = _row_view(v_scale, tbl, mb).reshape(mb * bs, NKV)
        p = p * vs.T[:, None, None, :]
    out = torch.einsum("nqgs,snh->qngh", p, v_rows)
    attn = out.reshape(1, Lc, NQ, H).to(q.dtype)
    return attn, pool_k, pool_v, k_scale, v_scale


def wkv6_ref(r, k, v, w, u) -> torch.Tensor:
    """RWKV-6 recurrence, sequential: r/k/w (T, H, K), v (T, H, V), u (H,
    K), zero initial state; out_t = r_t · (S + u ⊙ k_t v_tᵀ), S ← diag(w_t)
    S + k_t v_tᵀ. Returns (T, H, V) float32."""
    r, k, v, w, u = (a.to(torch.float32) for a in (r, k, v, w, u))
    T, H, K = r.shape
    S = torch.zeros((H, K, v.shape[-1]), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(T):
        kv = k[t][..., :, None] * v[t][..., None, :]
        outs.append(torch.einsum("hk,hkv->hv", r[t], S + u[..., :, None] * kv))
        S = w[t][..., :, None] * S + kv
    return torch.stack(outs)


def wkv6_chunked_ref(r, k, v, w, u, state, chunk: int, return_states: bool = False):
    """The chunked algebra of ``repro.models.rwkv6.wkv6_chunked`` with the
    state carried in and out: r/k/w (B, T, H, K), v (B, T, H, V), u (H,
    K), state (B, H, K, V) → (out (B, T, H, V), state) float32. Unlike
    JAX the chunk length never shrinks to T: T is padded up to a multiple
    of `chunk` with k = v = 0 and w = 1, so chunk boundaries sit at
    absolute positions and a prompt's outputs and final state do not
    depend on the length it was padded to. With ``return_states`` also
    the state entering each chunk, (B, H, ceil(T / chunk), K, V): what
    the backward (:func:`wkv6_chunked_bwd_ref`) walks."""
    B, T, H, K = r.shape
    C = int(chunk)
    pad = -T % C
    r, k, v, w = (a.to(torch.float32) for a in (r, k, v, w))
    if pad:
        def zp(a, value=0.0):
            return torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad), value=value)
        r, k, v, w = zp(r), zp(k), zp(v), zp(w, 1.0)
    u = u.to(torch.float32)
    S = state.to(torch.float32)
    dev = r.device
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=dev), -1)
    tri = tri[None, :, :, None, None]                    # s < t
    eye = torch.eye(C, dtype=torch.float32, device=dev)[None, :, None, :]
    outs, starts = [], []
    for c0 in range(0, T + pad, C):
        starts.append(S)
        rb, kb, vb, wb = (a[:, c0:c0 + C] for a in (r, k, v, w))
        lw = torch.log(torch.clamp(wb, min=1e-12))
        L = torch.cumsum(lw, dim=1)
        Lsh = L - lw
        term1 = torch.einsum("bchk,bhkv->bchv", rb * torch.exp(Lsh), S)
        diff = Lsh[:, :, None] - L[:, None, :]           # (B, Ct, Cs, H, K)
        gate = torch.where(tri, torch.exp(torch.clamp(diff, max=0.0)),
                           torch.zeros((), device=dev))
        P = torch.einsum("bthk,bshk,btshk->bths", rb, kb, gate)
        Pd = torch.einsum("bthk,hk,bthk->bth", rb, u, kb)
        P = P + eye * Pd[..., None]
        outs.append(term1 + torch.einsum("bths,bshv->bthv", P, vb))
        L_last = L[:, -1:]
        dk = kb * torch.exp(L_last - L)
        S = torch.exp(L_last[:, 0])[..., None] * S + torch.einsum(
            "bshk,bshv->bhkv", dk, vb)
    if return_states:
        return torch.cat(outs, dim=1)[:, :T], S, torch.stack(starts, dim=2)
    return torch.cat(outs, dim=1)[:, :T], S


def _prefix(x: torch.Tensor) -> torch.Tensor:
    """Sums of x along dim 1 before each index (0 at the first)."""
    s = x.cumsum(1)
    return torch.cat([torch.zeros_like(s[:, :1]), s[:, :-1]], dim=1)


def _suffix(x: torch.Tensor, dim: int, inclusive: bool) -> torch.Tensor:
    """Sums of x along `dim` from each index (inclusive) or after it to the end."""
    s = x.flip(dim).cumsum(dim).flip(dim)
    if inclusive:
        return s
    return torch.cat([s.narrow(dim, 1, x.shape[dim] - 1),
                      torch.zeros_like(x.narrow(dim, 0, 1))], dim=dim)


def wkv6_chunked_bwd_ref(r, k, v, w, u, states, dout, dstate, chunk: int):
    """The plain version of the ``wkv6_bwd`` kernel: the gradients of
    :func:`wkv6_chunked_ref` (out, state) for the output gradients dout
    (B, T, H, V) and dstate (B, H, K, V) or None, spelled out in float32
    as the kernel computes them (not autograd). The chunks are walked in
    reverse from dstate over the saved chunk-start states ``states`` (B,
    H, nc, K, V) and ``new_state`` (the state after the last chunk); per
    chunk, with lw = log(max(w, 1e-12)), A[t, s] = dout_t · v_s and the
    gate e^(Lsh_t - L_s) of s < t a sum of lw over s < j < t (never the
    difference of two long prefixes, so every exponent is <= 0):

        dr_t  = e^Lsh_t (S_c dout_t) + sum_s<t A[t,s] k_s gate + A[t,t] u k_t
        dk_s  = sum_t>s A[t,s] r_t gate + e^(L_last - L_s) (G v_s)
                + A[s,s] u r_s
        dv_s  = sum_t>s P[t,s] dout_t + Pd_s dout_s + (k_s e^(L_last - L_s)) G
        du   += sum_t A[t,t] r_t k_t
        dS_c  = e^L_last G + sum_t (r_t e^Lsh_t) dout_t^T,  G = dS_c+1

    and d(lw)_j = G . S_c+1 (rowwise) + dL_j + sum_t>j (dLsh_t + dL_t)
    with dLsh = r (its two gated terms in dr) and dL = -k (its two in dk).
    dw = d(lw) / w where w > 1e-12, else 0 (JAX clamps there); pads get
    nothing. Returns (dr, dk, dv in r's dtype, dw (B, T, H, K), du (H,
    K), dstate_in (B, H, K, V)), float32 otherwise."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    C = int(chunk)
    pad = -T % C
    f32 = torch.float32
    rf, kf, vf, wf, do = (a.to(f32) for a in (r, k, v, w, dout))
    if pad:
        def zp(a, value=0.0):
            return torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad), value=value)
        rf, kf, vf, do, wf = zp(rf), zp(kf), zp(vf), zp(do), zp(wf, 1.0)
    uf = u.to(f32)
    dev = rf.device
    lw = torch.log(torch.clamp(wf, min=1e-12))
    G = (torch.zeros((B, H, K, V), dtype=f32, device=dev) if dstate is None
         else dstate.to(f32))
    dr, dk, dlw = (torch.empty_like(rf) for _ in range(3))
    dv = torch.empty_like(vf)
    du = torch.zeros((H, K), dtype=f32, device=dev)
    nc = (T + pad) // C
    idx = torch.arange(C, device=dev)
    before = idx[None, :] < idx[:, None]                  # [t, j]: j < t
    strict = before[None, :, :, None, None]
    for c in reversed(range(nc)):
        sl = slice(c * C, (c + 1) * C)
        rb, kb, vb, lb, db = rf[:, sl], kf[:, sl], vf[:, sl], lw[:, sl], do[:, sl]
        S = states[:, :, c].to(f32)
        # seg[t, s] = sum of lw over s < j < t, from j = t - 1 down.
        run = _suffix(torch.where(strict, lb[:, None], torch.zeros((), device=dev)), 2, True)
        Lsh = run[:, :, 0]
        seg = torch.cat([run[:, :, 1:], torch.zeros_like(run[:, :, :1])], dim=2)
        gate = torch.where(strict, torch.exp(seg), torch.zeros((), device=dev))
        Lsuf = _suffix(lb, 1, False)                       # L_last - L_s
        Llast = lb.cumsum(1)[:, -1]
        A = torch.einsum("bthv,bshv->btsh", db, vb)
        Ad = torch.diagonal(A, dim1=1, dim2=2).permute(0, 2, 1)[..., None]   # (B, C, H, 1)
        dr_in = torch.einsum("btsh,bshk,btshk->bthk", A, kb, gate)
        dk_in = torch.einsum("btsh,bthk,btshk->bshk", A, rb, gate)
        P = torch.einsum("bthk,bshk,btshk->btsh", rb, kb, gate)
        Pd = torch.einsum("bthk,hk,bthk->bth", rb, uf, kb)
        dr1 = torch.exp(Lsh) * torch.einsum("bthv,bhkv->bthk", db, S)
        khat = kb * torch.exp(Lsuf)
        dks = torch.exp(Lsuf) * torch.einsum("bshv,bhkv->bshk", vb, G)
        dr[:, sl] = dr1 + dr_in + Ad * uf * kb
        dk[:, sl] = dk_in + dks + Ad * uf * rb
        dv[:, sl] = (torch.einsum("btsh,bthv->bshv", P, db) + Pd[..., None] * db
                     + torch.einsum("bshk,bhkv->bshv", khat, G))
        du = du + torch.einsum("bthk->hk", Ad * rb * kb)
        D = torch.exp(Llast)[..., None]                  # (B, H, K, 1)
        kin = kb * dk_in
        Y = rb * (dr1 + dr_in) - kin
        dlw[:, sl] = ((G * D * S).sum(-1)[:, None] + _prefix(kb * dks)
                      + _suffix(Y, 1, False) - kin)
        G = D * G + torch.einsum(
            "bthk,bthv->bhkv", rb * torch.exp(Lsh), db)
    dw = torch.where(wf > 1e-12, dlw / wf, torch.zeros((), device=dev))
    dr, dk, dv, dw = (a[:, :T] for a in (dr, dk, dv, dw))
    return dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dw, du, G


def wkv6_step(r, k, v, w, u, state):
    """One token: r/k/w (B, H, K), v (B, H, V), state (B, H, K, V) →
    (out (B, H, V), state) float32 (``repro.models.rwkv6.wkv6_step``)."""
    rf, kf, vf, wf = (a.to(torch.float32) for a in (r, k, v, w))
    kv = kf[..., :, None] * vf[..., None, :]
    out = torch.einsum("bhk,bhkv->bhv", rf,
                       state + u.to(torch.float32)[None, ..., None] * kv)
    return out, wf[..., None] * state + kv


RGLRU_C = 8.0   # the RG-LRU's c: a = exp(-c softplus(Lambda) r)


def rglru_coeffs_ref(ga, gi, y, a_bias, i_bias, lam):
    """``repro.models.griffin._rglru_coeffs`` from the gate projections ga
    = y A_r, gi = y A_i: (a, b) float32 with r = sigmoid(ga + b_r), i =
    sigmoid(gi + b_i), a = exp((-c softplus(Lambda)) r), b = sqrt(max(1 -
    a², 1e-12)) (i y). softplus as JAX's logaddexp(x, 0)."""
    lam = lam.to(torch.float32)
    softplus = torch.clamp(lam, min=0.0) + torch.log1p(torch.exp(-lam.abs()))
    r = torch.sigmoid(ga.to(torch.float32) + a_bias.to(torch.float32))
    i = torch.sigmoid(gi.to(torch.float32) + i_bias.to(torch.float32))
    a = torch.exp((-RGLRU_C * softplus) * r)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * y.to(torch.float32))
    return a, b


def rglru_scan_ref(ga, gi, y, a_bias, i_bias, lam, h0=None, lengths=None):
    """The RG-LRU over (B, T, W): h_t = a_t h_{t-1} + b_t from h0 (B, W)
    (zero if None), the coefficients of :func:`rglru_coeffs_ref`, a loop
    over t. Returns (h (B, T, W), h at each row's lengths - 1 (B, W)),
    float32 (T - 1 without lengths)."""
    a, b = rglru_coeffs_ref(ga, gi, y, a_bias, i_bias, lam)
    B, T, W = a.shape
    hv = (torch.zeros((B, W), dtype=torch.float32, device=a.device) if h0 is None
          else h0.to(torch.float32))
    hs = []
    for t in range(T):
        hv = a[:, t] * hv + b[:, t]
        hs.append(hv)
    h = torch.stack(hs, dim=1)
    if lengths is None:
        return h, h[:, -1]
    idx = (torch.as_tensor(lengths, device=a.device).long() - 1).clamp(min=0)
    return h, h[torch.arange(B, device=a.device), idx]


def rglru_scan_bwd_ref(ga, gi, y, a_bias, i_bias, lam, h0, h, dh):
    """The plain version of the ``rglru_bwd`` kernel: the gradients of
    :func:`rglru_scan_ref`'s h (B, T, W) for dh (B, T, W), spelled out in
    float32 as the kernel computes them (not autograd). Each (row,
    channel) folds t in reverse over the forward's saved h:

        g_t = dh_t + a_t+1 g_t+1,  da_t = g_t h_t-1,  db_t = g_t

    (h_-1 = h0, or zero), then back through :func:`rglru_coeffs_ref`: the
    square root's gradient is 0 where 1 - a² <= 1e-12 (JAX's maximum);
    softplus' is sigmoid(Lambda). Returns (dga, dgi float32 (B, T, W), dy
    in y's dtype, d a_bias, d i_bias, d lam (W,), dh0 (B, W) or None)."""
    f32 = torch.float32
    gaf, gif, yf, dhf = (t.to(f32) for t in (ga, gi, y, dh))
    lamf = lam.to(f32)
    softplus = torch.clamp(lamf, min=0.0) + torch.log1p(torch.exp(-lamf.abs()))
    neg = -RGLRU_C * softplus
    r = torch.sigmoid(gaf + a_bias.to(f32))
    i = torch.sigmoid(gif + i_bias.to(f32))
    a = torch.exp(neg * r)
    om = 1.0 - a * a
    sq = torch.sqrt(torch.clamp(om, min=1e-12))
    B, T, W = gaf.shape
    hf = h.to(f32)
    prev = torch.zeros((B, W), dtype=f32, device=gaf.device) if h0 is None else h0.to(f32)
    hprev = torch.cat([prev[:, None], hf[:, :-1]], dim=1)
    g = torch.zeros((B, W), dtype=f32, device=gaf.device)
    db = torch.empty_like(gaf)
    for t in reversed(range(T)):
        g = dhf[:, t] + (a[:, t + 1] * g if t + 1 < T else 0.0)
        db[:, t] = g
    da = db * hprev
    dsq = db * (i * yf)
    diy = db * sq
    dom = torch.where(om > 1e-12, dsq * 0.5 / sq, torch.zeros((), device=gaf.device))
    dx = (da - 2.0 * a * dom) * a
    dza = dx * neg * (r * (1.0 - r))
    dzi = diy * yf * (i * (1.0 - i))
    dlam = (dx * r).sum(dim=(0, 1)) * (-RGLRU_C) * torch.sigmoid(lamf)
    dh0 = None if h0 is None else a[:, 0] * g
    return (dza, dzi, (diy * i).to(y.dtype), dza.sum(dim=(0, 1)), dzi.sum(dim=(0, 1)),
            dlam, dh0)
