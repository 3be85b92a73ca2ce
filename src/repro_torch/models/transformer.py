"""Decoder / encoder / VLM transformer: init, the training loss,
whole-prompt, chunked and suffix-only prefill, and the decode step on the
contiguous cache or the paged pool.

Port of ``repro.models.transformer`` for the dense
decoders, the MoE decoders (mixtral-8x22b, llama4-maverick: the FFN is
``models.moe``'s capacity-bounded expert layer; mixtral's sliding window
keeps a window-sized ring cache), the VLM (paligemma-3b: a
patch-embedding stub before the text, prefix-LM attention) and the
encoder (hubert-xlarge: a frame-embedding stub, bidirectional
attention). Params
are a nested dict of stacked ``(L, …)`` tensors with the JAX key names
(``embed``, ``blocks/wq``, ``blocks/ffn/w_up``, ``final_norm``, …); a
Python loop over layers replaces ``lax.scan``. Attention runs the
kernels through :mod:`repro_torch.kernels.ops`: ``flash_attention`` for
a whole prompt (``prefill``) and for the uncached tail of a prefix-cache
hit (``prefill_suffix``), ``paged_prefill`` for every chunk of a prompt
and every speculative verify window (``prefill_chunk_logits[_multi]``),
``paged_attention`` for a paged decode step and ``decode_attention`` for
a contiguous one (the paged decode kernel over
each row's own slots, or its ring entry under a window; the JAX package
computes it outside any Pallas kernel, and ``common.decode_attention`` is
its plain version). The four kernels share one tile routine, so every
path sums in one order. A windowed model's whole-prompt prefill packs
its K/V into a ring of ``attn_window`` slots (``kv_cache.ring_align``);
it has no paged pool, as in JAX.

Training (``train_loss``) runs the forward under autograd: the flash
kernel, ``dense_matmul`` and the MoE layers' ``expert_matmul`` carry
their gradients (``ops.flash_attention``'s backward is the
``flash_attention_bwd`` kernel, ``ops.expert_matmul``'s the
``expert_matmul_bwd`` kernel), a QuantConfig on the config fake-quantizes
every block projection with the straight-through gradient (an MoE
layer's experts and float32 router stay unquantized, as in JAX), and
``cfg.remat`` checkpoints each block. The MoE layers' load-balance losses
are summed over the layers from a float32 zero, layer 0 first (JAX's scan
carry), and ``train_loss`` adds 0.01 of the sum to the loss.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantized_linear import PackedWeight
from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.models import moe
from repro_torch.models.kv_cache import (
    DecodeCache,
    KVCache,
    PagedKVCache,
    cache_write,
    dequantize_kv,
    full_slot_pos,
    paged_cache_write,
    quantize_kv,
    ring_align,
    row_write,
    write_slot,
)

# Free cache slots appended after a whole-prompt prefill for the tokens
# decoded next (the static engine grows the cache past them).
DECODE_HEADROOM = 8


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "vlm", "encoder"):
        raise ValueError(f"{cfg.name}: the transformer serves the dense, MoE, VLM and "
                         f"encoder families, not {cfg.family!r}")


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from a seeded torch.Generator on `device` (CUDA
    unless named): the JAX tree's layout and scales (N(0, 1/d_in)
    projections, N(0, 0.02²) embedding); the numbers differ from JAX's
    PRNG — tests carry JAX weights across with ``repro_torch.convert``."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = cm.generator(dev, seed)
    d, hd, L, dt = cfg.d_model, cfg.head_dim, cfg.num_layers, _dtype(cfg)
    blocks = {
        "ln1": cm.norm_init(cfg.norm, d, dt, dev, L),
        "ln2": cm.norm_init(cfg.norm, d, dt, dev, L),
        "wq": cm.dense_init(gen, d, cfg.n_heads * hd, dt, dev, L),
        "wk": cm.dense_init(gen, d, cfg.n_kv_heads * hd, dt, dev, L),
        "wv": cm.dense_init(gen, d, cfg.n_kv_heads * hd, dt, dev, L),
        "wo": cm.dense_init(gen, cfg.n_heads * hd, d, dt, dev, L),
    }
    if cfg.moe_experts:
        blocks["moe"] = moe.init_moe(gen, cfg, dt, dev, L)
    else:
        blocks["ffn"] = cm.ffn_init(gen, cfg, d, cfg.d_ff, dt, dev, L)
    if cfg.qk_norm:
        blocks["q_norm"] = torch.zeros((L, hd), dtype=dt, device=dev)
        blocks["k_norm"] = torch.zeros((L, hd), dtype=dt, device=dev)
    params = {
        "embed": cm.embed_init(gen, cfg.vocab, d, dt, dev),
        "blocks": blocks,
        "final_norm": cm.norm_init(cfg.norm, d, dt, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = cm.dense_init(gen, d, cfg.vocab, dt, dev)
    if cfg.frontend == "patch_stub":
        params["patch_proj"] = cm.dense_init(gen, cfg.frontend_dim, d, dt, dev)
    elif cfg.frontend == "frame_stub":
        params["frame_proj"] = cm.dense_init(gen, cfg.frontend_dim, d, dt, dev)
    return params


def layer_params(blocks: dict, i: int) -> dict:
    """Layer `i` of the stacked block params (views, no copy)."""
    out = {}
    for k, v in blocks.items():
        if isinstance(v, dict):
            out[k] = layer_params(v, i)
        elif isinstance(v, PackedWeight):
            out[k] = v.layer(i)
        else:
            out[k] = v[i]
    return out


def unstack_layers(blocks: dict, n: int) -> list:
    """The first `n` layers of the stacked block params as per-layer
    dicts: each stacked leaf unbound once (views, no copy). Under autograd
    each leaf's gradient is then one stack of its layers' gradients;
    indexing layer by layer (``layer_params``) would allocate a
    zero-filled gradient the size of the whole leaf for every layer."""
    out = [{} for _ in range(n)]
    for key, v in blocks.items():
        if isinstance(v, dict):
            per = unstack_layers(v, n)
        elif isinstance(v, PackedWeight):
            per = [v.layer(i) for i in range(n)]
        else:
            per = v.unbind(0)
        for i in range(n):
            out[i][key] = per[i]
    return out


def _attention_qkv(p, cfg: ModelConfig, x, positions):
    q_cfg, qm = cm.quant_mode(cfg)
    B, T, _ = x.shape
    hd = cfg.head_dim
    q = cm.linear(x, p["wq"], q_cfg, qm).reshape(B, T, cfg.n_heads, hd)
    k = cm.linear(x, p["wk"], q_cfg, qm).reshape(B, T, cfg.n_kv_heads, hd)
    v = cm.linear(x, p["wv"], q_cfg, qm).reshape(B, T, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = cm.rms_head_norm(q, p["q_norm"])
        k = cm.rms_head_norm(k, p["k_norm"])
    q = cm.rope(q, positions, cfg.rope_theta)
    k = cm.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _block_post_attn(p: dict, cfg: ModelConfig, x, attn):
    """Output projection + FFN (or MoE) residual, shared by prefill, decode
    and training. Returns (x, the MoE layer's aux loss, or None for a
    dense FFN, whose aux JAX adds as a zero); the serving paths discard
    the aux, as JAX's do."""
    attn = attn.reshape(*x.shape[:2], cfg.n_heads * cfg.head_dim)
    x = x + cm.linear(attn, p["wo"], *cm.quant_mode(cfg))
    h2 = cm.apply_norm(x, p["ln2"], cfg.norm)
    if cfg.moe_experts:
        y, aux = moe.moe_apply(p["moe"], h2, cfg)
        return x + y, aux
    return x + cm.ffn_apply(p["ffn"], h2, cfg), None


def _kv_attn_view(k, v, kv_quant_attn: bool):
    """The K/V values whole-prompt attention reads. With an int8 cache the
    prefill reads its own K/V through the quantizer
    (``dequantize_kv(quantize_kv(kv))``, float32), exactly what a later
    read of the cached codes sees; otherwise the identity."""
    if not kv_quant_attn:
        return k, v
    return dequantize_kv(*quantize_kv(k)), dequantize_kv(*quantize_kv(v))


def block_apply(p: dict, cfg: ModelConfig, x, positions, mask: cm.AttnMask,
                kv_quant_attn: bool = False):
    """Full-sequence block (prefill, training). Returns (x, k, v, the
    layer's aux loss or None); the returned k/v are unquantized (the cache
    quantizes them once, at the end of prefill, with the same
    ``quantize_kv``)."""
    h = cm.apply_norm(x, p["ln1"], cfg.norm)
    q, k, v = _attention_qkv(p, cfg, h, positions)
    k_att, v_att = _kv_attn_view(k, v, kv_quant_attn)
    attn = cm.chunked_attention(q, k_att, v_att, mask,
                                softcap=cfg.attn_logit_softcap)
    x, aux = _block_post_attn(p, cfg, x, attn)
    return x, k, v, aux


def block_decode(p: dict, cfg: ModelConfig, x, pos, k_cache, v_cache, slot_pos,
                 k_scale=None, v_scale=None):
    """Single-token block against one layer's slice of the contiguous
    cache: every row writes its new k/v (int8 codes and scales for a
    quantized cache) at its own position, in place, then attends through
    ``ops.decode_attention``."""
    h = cm.apply_norm(x, p["ln1"], cfg.norm)
    q, k, v = _attention_qkv(p, cfg, h, pos[:, None])
    if k_scale is not None:
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
        slot = write_slot(pos, k_cache.shape[1], cfg.attn_window)
        row_write(k_scale, ks, slot)
        row_write(v_scale, vs, slot)
    cache_write(k_cache, v_cache, slot_pos, k, v, pos, cfg.attn_window)
    attn = ops.decode_attention(q, k_cache, v_cache, slot_pos, pos,
                                window=cfg.attn_window,
                                softcap=cfg.attn_logit_softcap,
                                k_scale=k_scale, v_scale=v_scale)
    return _block_post_attn(p, cfg, x, attn)[0]


def block_decode_paged(p: dict, cfg: ModelConfig, x, pos, pool_k, pool_v,
                       block_table, block_size: int, k_scale=None, v_scale=None):
    """Single-token block against one layer's slice of the paged pool:
    write the new k/v at pos's (block, offset) — quantizing on the way in
    for an int8 pool — then attend through ``ops.paged_attention``."""
    h = cm.apply_norm(x, p["ln1"], cfg.norm)
    q, k, v = _attention_qkv(p, cfg, h, pos[:, None])
    paged_cache_write(pool_k, pool_v, block_table, k, v, pos, block_size,
                      k_scale=k_scale, v_scale=v_scale)
    attn = ops.paged_attention(q, pool_k, pool_v, block_table, pos,
                               k_scale=k_scale, v_scale=v_scale,
                               softcap=cfg.attn_logit_softcap)
    return _block_post_attn(p, cfg, x, attn)[0]


def compute_logits(params, cfg: ModelConfig, hidden):
    if cfg.tie_embeddings:
        return cm.logits_head(hidden, params["embed"],
                              softcap=cfg.logits_softcap, transpose=True)
    return cm.logits_head(hidden, params["head"], softcap=cfg.logits_softcap)


def _embed_scale(cfg: ModelConfig) -> bool:
    """Whether token embeddings are scaled by sqrt(d_model) at lookup (the
    VLM's gemma backbone): one rule for every path, as in JAX, so prefill
    and decode embed a token alike."""
    return cfg.family == "vlm"


def _frontend_rows(params, cfg: ModelConfig, batch, key: str, leaf: str):
    """The stub frontend's embeddings: ``batch[key]`` (B, n, frontend_dim)
    in the model dtype on the weights' device, through ``params[leaf]``."""
    w = params[leaf]
    rows = torch.as_tensor(batch[key]).to(device=w.device, dtype=_dtype(cfg))
    return cm.linear(rows, w)


def embed_inputs(params, cfg: ModelConfig, batch):
    """Model inputs → (x (B, T, d), positions (B, T)): token embeddings;
    for ``patch_stub`` the projected ``batch["patches"]`` (B, P,
    frontend_dim) before the scaled token embeddings; for ``frame_stub``
    the projected ``batch["frames"]`` (B, T, frontend_dim). Positions run
    over the whole sequence."""
    scale = _embed_scale(cfg)
    if cfg.frontend == "patch_stub":
        pe = _frontend_rows(params, cfg, batch, "patches", "patch_proj")
        te = cm.embed_lookup(params["embed"], batch["tokens"], scale=scale)
        x = torch.cat([pe, te], dim=1)
    elif cfg.frontend == "frame_stub":
        x = _frontend_rows(params, cfg, batch, "frames", "frame_proj")
    else:
        x = cm.embed_lookup(params["embed"], batch["tokens"], scale=scale)
    B, T = x.shape[:2]
    positions = torch.arange(T, dtype=torch.int32, device=x.device)[None].expand(B, T)
    return x, positions


def _mask_for(cfg: ModelConfig) -> cm.AttnMask:
    return cm.AttnMask(causal=cfg.causal, window=cfg.attn_window,
                       prefix_len=cfg.num_prefix_embeds if cfg.family == "vlm" else 0)


def _scan_blocks(params, cfg: ModelConfig, x, positions, mask,
                 collect_kv: bool, kv_quant_attn: bool = False):
    """Every layer's block_apply in order. Returns (x, aux, (k_all,
    v_all)): aux the MoE layers' aux losses summed layer 0 first (JAX's
    scan carry, whose float32 zero start changes no bit), None without
    an MoE layer; k/v stacked (L, B, T, NKV, H) when
    `collect_kv`, else None. Under autograd with ``cfg.remat`` each block
    is checkpointed (JAX's ``jax.checkpoint`` of the scan body, aux
    included): its activations are recomputed in the backward pass
    instead of kept."""
    ks, vs, aux = [], [], None
    remat = cfg.remat and torch.is_grad_enabled()
    for p in unstack_layers(params["blocks"], cfg.num_layers):
        if remat:
            x, k, v, a = torch.utils.checkpoint.checkpoint(
                block_apply, p, cfg, x, positions, mask, kv_quant_attn,
                use_reentrant=False)
        else:
            x, k, v, a = block_apply(p, cfg, x, positions, mask, kv_quant_attn)
        if a is not None:
            aux = a if aux is None else aux + a
        if collect_kv:
            ks.append(k)
            vs.append(v)
    return x, aux, ((torch.stack(ks), torch.stack(vs)) if collect_kv else None)


def _forward_hidden_aux(params, cfg: ModelConfig, batch):
    """(final-normed hidden states (B, T, d), the MoE layers' aux loss ()
    or None)."""
    x, positions = embed_inputs(params, cfg, batch)
    x, aux, _ = _scan_blocks(params, cfg, x, positions, _mask_for(cfg), False)
    return cm.apply_norm(x, params["final_norm"], cfg.norm), aux


def forward_hidden(params, cfg: ModelConfig, batch):
    """Full-sequence forward → final-normed hidden states (B, T, d)."""
    return _forward_hidden_aux(params, cfg, batch)[0]


def _on_device(batch: dict, device) -> dict:
    """A batch of numpy arrays (the data pipeline's) or tensors on
    `device`."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def train_loss(params, cfg: ModelConfig, batch):
    """Mean next-token cross-entropy (with z-loss) of a training batch plus
    0.01 of the MoE layers' load-balance loss → (total, {"loss",
    "aux_loss"}), JAX's three branches: the encoder's per-frame
    ``labels``; the VLM's text positions after the patches; the decoder's
    next token. A dense model's aux loss is zero, so its total is the
    loss."""
    batch = _on_device(batch, params["embed"].device)
    hidden, aux = _forward_hidden_aux(params, cfg, batch)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=hidden.device)
    logits = compute_logits(params, cfg, hidden)
    if cfg.family == "encoder":
        loss = cm.cross_entropy(logits, batch["labels"]).mean()
    elif cfg.family == "vlm":
        P = cfg.num_prefix_embeds
        loss = cm.cross_entropy(logits[:, P:-1], batch["tokens"][:, 1:]).mean()
    else:
        loss = cm.cross_entropy(logits[:, :-1], batch["tokens"][:, 1:]).mean()
    return loss + 0.01 * aux, {"loss": loss, "aux_loss": aux}


def prefill(params, cfg: ModelConfig, batch):
    """Whole-prompt forward; returns (DecodeCache on a contiguous KVCache,
    last-token logits (B, 1, V)). A VLM's batch carries ``patches`` beside
    ``tokens``, an encoder's ``frames`` in their place (see
    :func:`embed_inputs`).

    ``batch["lengths"]`` (B,) marks right-padded prompts: row b's real
    positions are 0..lengths[b]-1 of the whole sequence (a VLM's patches
    count), trailing pad slots are
    excluded from the cache (slot_pos = -1) and from the logits, so a
    prompt bucketed up to any length prefills bit-identically to an
    exact-length prefill (causal attention never looks at trailing pads,
    and neither the attention kernel nor the packed matmul lets a row
    depend on the padded length; an MoE layer's routing is
    capacity-bounded over every row of the batch, pads included, as in
    JAX, so there the padded length is part of the function). The cache
    carries DECODE_HEADROOM empty slots for the tokens decoded next; a
    windowed model's is a ring of ``attn_window`` slots holding each
    row's last positions (``ring_align``)."""
    x, positions = embed_inputs(params, cfg, batch)
    B, S = x.shape[:2]
    dev = x.device
    lengths = batch.get("lengths")
    if lengths is not None:
        lengths = torch.as_tensor(lengths, dtype=torch.int32).to(dev)
    x, _, (k_all, v_all) = _scan_blocks(params, cfg, x, positions, _mask_for(cfg),
                                        True, kv_quant_attn=cfg.kv_cache_quant)
    length = (torch.full((B,), S, dtype=torch.int32, device=dev)
              if lengths is None else lengths)
    if cfg.attn_window:
        k_all, v_all, slot_pos = ring_align(k_all, v_all, lengths, cfg.attn_window)
    else:
        zk = torch.zeros((*k_all.shape[:2], DECODE_HEADROOM, *k_all.shape[3:]),
                         dtype=k_all.dtype, device=dev)
        k_all = torch.cat([k_all, zk], dim=2)
        v_all = torch.cat([v_all, zk], dim=2)
        slot_pos = full_slot_pos(cfg.num_layers, B, S + DECODE_HEADROOM, length,
                                 device=dev)
    if cfg.kv_cache_quant:
        k_all, k_scale = quantize_kv(k_all)
        v_all, v_scale = quantize_kv(v_all)
    else:
        k_all, v_all = k_all.to(_dtype(cfg)), v_all.to(_dtype(cfg))
        k_scale = v_scale = None
    kvc = KVCache(k=k_all, v=v_all, slot_pos=slot_pos, length=length.clone(),
                  k_scale=k_scale, v_scale=v_scale, window=cfg.attn_window)
    hidden = cm.apply_norm(cm.last_token_slice(x, lengths),
                           params["final_norm"], cfg.norm)
    logits = compute_logits(params, cfg, hidden)
    return DecodeCache(pos=length.clone(), kv=kvc), logits


def _chunk_forward(params, cfg: ModelConfig, kv: PagedKVCache, tokens, start: int,
                   length: int, blocks, store: bool = True):
    """One row's chunk (1, Lc) through every layer against the paged
    pool: each layer runs ``ops.paged_prefill`` (the chunk attends
    causally over [prefix ++ chunk], its K/V written into the row's
    blocks in place unless ``store`` is False). Returns the last layer's
    output x (1, Lc, d)."""
    Lc = tokens.shape[1]
    dev = tokens.device
    positions = (start + torch.arange(Lc, dtype=torch.int32, device=dev))[None]
    x = cm.embed_lookup(params["embed"], tokens, scale=_embed_scale(cfg))
    for i in range(cfg.num_layers):
        p = layer_params(params["blocks"], i)
        pk, pv, ks, vs = kv.layer(i)
        h = cm.apply_norm(x, p["ln1"], cfg.norm)
        q, k, v = _attention_qkv(p, cfg, h, positions)
        attn = ops.paged_prefill(q, k, v, pk, pv, blocks, start, length,
                                 k_scale=ks, v_scale=vs,
                                 softcap=cfg.attn_logit_softcap, store=store)[0]
        x = _block_post_attn(p, cfg, x, attn)[0]
    return x


def prefill_chunk(params, cfg: ModelConfig, cache: DecodeCache, batch):
    """Prefill one chunk of a single row's prompt against the paged pool.

    ``batch``: tokens (1, Lc) right-padded chunk ids; lengths (1,) real
    chunk length; start — absolute position of the chunk's first token
    (positions [0, start) are already pool-resident); slot — the row's
    batch slot; blocks (nbp,) — the row's pool blocks in virtual-block
    order (-1 = unallocated); store (optional, default True). Each layer
    runs ``ops.paged_prefill``: the chunk attends causally over [prefix ++
    chunk] and its K/V lands in the row's blocks in place. With ``store``
    False nothing is written and the chunk attends the K/V already
    resident at its positions — a whole-prompt prefix-cache hit runs its
    last token so, computing the function its cold last chunk computed
    without writing the shared blocks. Updates ``cache.pos``/``kv.length`` at slot to
    start + length and returns ``(cache, logits (1, 1, V))`` for the
    chunk's last real token."""
    if cfg.attn_window:
        raise ValueError("chunked prefill requires a full-attention paged cache")
    tokens = batch["tokens"]
    length = int(batch["lengths"][0])
    start = int(batch["start"])
    slot = int(batch["slot"])
    blocks = torch.as_tensor(batch["blocks"], dtype=torch.int32).to(tokens.device)
    kv: PagedKVCache = cache.kv
    x = _chunk_forward(params, cfg, kv, tokens, start, length, blocks,
                       bool(batch.get("store", True)))
    hidden = cm.apply_norm(cm.last_token_slice(x, [length]),
                           params["final_norm"], cfg.norm)
    logits = compute_logits(params, cfg, hidden)
    cache.pos[slot] = start + length
    kv.length[slot] = start + length
    return cache, logits


def prefill_chunk_logits_multi(params, cfg: ModelConfig, cache: DecodeCache, batch):
    """Speculative-decode verify: R independent chunk rows through one
    call, logits for every chunk position of every row.

    ``batch`` keys (leading R where the single-row call is scalar):
      tokens (R, Lc)    right-padded chunk token ids per row
      lengths (R,)      real chunk length per row (0 for dead rows)
      starts (R,)       absolute position of each row's first chunk token
      slots (R,)        each row's batch slot; -1 marks a DEAD row
      blocks (R, nbp)   each row's pool blocks (-1 = unallocated)

    Rows run one after another, as JAX's ``lax.scan`` runs them: each
    live row is its own :func:`_chunk_forward` (one ``paged_prefill``
    launch per layer), attends only through its own block table and
    writes only its own blocks, so each live row's logits are bitwise
    what it returns alone (:func:`prefill_chunk_logits`). A dead row
    is not run: it writes nothing (JAX routes its writes to the trash
    block), its ``pos``/``length`` do not move and its logits rows are
    zeros the caller ignores. Returns ``(cache, logits (R, Lc, V))``."""
    if cfg.attn_window:
        raise ValueError("chunked prefill requires a full-attention paged cache")
    tokens = batch["tokens"]
    R, Lc = tokens.shape
    lengths = [int(n) for n in batch["lengths"]]
    starts = [int(s) for s in batch["starts"]]
    slots = [int(s) for s in batch["slots"]]
    blocks = torch.as_tensor(batch["blocks"], dtype=torch.int32).to(tokens.device)
    kv: PagedKVCache = cache.kv
    logits = torch.zeros((R, Lc, cfg.vocab), dtype=torch.float32, device=tokens.device)
    for r in range(R):
        if slots[r] < 0:
            continue
        x = _chunk_forward(params, cfg, kv, tokens[r:r + 1], starts[r], lengths[r],
                           blocks[r])
        hidden = cm.apply_norm(x, params["final_norm"], cfg.norm)
        logits[r] = compute_logits(params, cfg, hidden)[0]
        cache.pos[slots[r]] = starts[r] + lengths[r]
        kv.length[slots[r]] = starts[r] + lengths[r]
    return cache, logits


def prefill_chunk_logits(params, cfg: ModelConfig, cache: DecodeCache, batch):
    """JAX's single-row verify entry, kept for parity: one live row of
    :func:`prefill_chunk_logits_multi` with :func:`prefill_chunk`'s batch
    keys (tokens (1, Lc), lengths (1,), start, slot, blocks). Returns
    ``(cache, logits (1, Lc, V))``, every chunk position (those past the
    real length are padding)."""
    blocks = torch.as_tensor(batch["blocks"], dtype=torch.int32)
    return prefill_chunk_logits_multi(params, cfg, cache, {
        "tokens": batch["tokens"], "lengths": batch["lengths"],
        "starts": [batch["start"]], "slots": [batch["slot"]], "blocks": blocks[None]})


def prefill_suffix(params, cfg: ModelConfig, batch):
    """Prefill only the uncached tail of a prompt against prefix K/V
    resident in the paged pool — the compute half of the prefix cache.

    ``batch``: tokens (1, Ls) right-padded suffix ids; lengths (1,) real
    suffix length; start — absolute position of the first suffix token,
    the number of resident prefix positions; pool_k / pool_v (L,
    num_blocks, bs, NKV, H); prefix_blocks — the row's pool blocks
    covering [0, start) in virtual-block order; pool_k_scale /
    pool_v_scale for an int8 pool.

    Each layer gathers exactly positions [0, start) from the blocks (slot
    s holds position s; an int8 pool is dequantized), computes the
    suffix's q/k/v at its absolute positions and runs the flash kernel
    over [prefix ++ suffix] at ``q_offset=start``. The kernel's tiles sit
    at absolute positions and a row's result depends only on its query
    and the keys it sees, so each suffix row computes the bits the cold
    whole-prompt prefill gives it (the int8 path reads the prefix through
    the quantizer, as ``_kv_attn_view`` makes the cold prefill read its
    own K/V). JAX pads the prefix to a bucket and masks it with explicit
    key positions; the port knows ``start`` on the host and needs none.

    Returns ``(DecodeCache, logits (1, 1, V))``: the cache holds ONLY the
    suffix (slot t ↔ position start + t, see
    ``kv_cache.scatter_suffix_into_paged``); pos/length are start +
    lengths."""
    if cfg.attn_window:
        raise ValueError("prefix caching requires a full-attention cache")
    tokens = batch["tokens"]
    B, Ls = tokens.shape
    dev = tokens.device
    length = int(batch["lengths"][0])
    start = int(batch["start"])
    pool_k, pool_v = batch["pool_k"], batch["pool_v"]
    L, _, bs = pool_k.shape[:3]
    blocks = torch.as_tensor(batch["prefix_blocks"], dtype=torch.long)
    tbl = blocks.clamp(min=0).to(dev)
    P = tbl.shape[0] * bs
    quant = cfg.kv_cache_quant

    def gather(plane):
        return plane[:, tbl].reshape(L, P, *plane.shape[3:])[:, :start]

    pk, pv = gather(pool_k), gather(pool_v)
    if quant:
        pk = dequantize_kv(pk, gather(batch["pool_k_scale"]))
        pv = dequantize_kv(pv, gather(batch["pool_v_scale"]))
    positions = (start + torch.arange(Ls, dtype=torch.int32, device=dev))[None].expand(B, Ls)
    mask = _mask_for(cfg)
    x = cm.embed_lookup(params["embed"], tokens, scale=_embed_scale(cfg))
    ks, vs = [], []
    for i in range(L):
        p = layer_params(params["blocks"], i)
        h = cm.apply_norm(x, p["ln1"], cfg.norm)
        q, k, v = _attention_qkv(p, cfg, h, positions)
        k_att, v_att = _kv_attn_view(k, v, quant)
        k_cat = torch.cat([pk[i][None].to(k_att.dtype), k_att], dim=1)
        v_cat = torch.cat([pv[i][None].to(v_att.dtype), v_att], dim=1)
        attn = cm.chunked_attention(q, k_cat, v_cat, mask, q_offset=start,
                                    softcap=cfg.attn_logit_softcap)
        x = _block_post_attn(p, cfg, x, attn)[0]
        ks.append(k)
        vs.append(v)
    k_all, v_all = torch.stack(ks), torch.stack(vs)
    if quant:
        k_all, k_scale = quantize_kv(k_all)
        v_all, v_scale = quantize_kv(v_all)
    else:
        k_all, v_all = k_all.to(_dtype(cfg)), v_all.to(_dtype(cfg))
        k_scale = v_scale = None
    total = torch.full((B,), start + length, dtype=torch.int32, device=dev)
    spos = start + torch.arange(Ls, dtype=torch.int32, device=dev)
    spos = torch.where(torch.arange(Ls, device=dev) < length, spos, torch.full_like(spos, -1))
    kvc = KVCache(k=k_all, v=v_all,
                  slot_pos=spos[None, None].expand(L, B, Ls).contiguous(),
                  length=total.clone(), k_scale=k_scale, v_scale=v_scale)
    hidden = cm.apply_norm(cm.last_token_slice(x, [length]),
                           params["final_norm"], cfg.norm)
    logits = compute_logits(params, cfg, hidden)
    return DecodeCache(pos=total, kv=kvc), logits


def decode_step(params, cfg: ModelConfig, cache: DecodeCache,
                tokens: torch.Tensor):
    """tokens (B, 1) → (cache, logits (B, 1, V)). Every slot decodes at
    its own position cache.pos (continuous batching); the contiguous
    cache or the paged pool is written in place and every row's
    pos/length advances by one."""
    x = cm.embed_lookup(params["embed"], tokens, scale=_embed_scale(cfg))
    kv = cache.kv
    pos = cache.pos
    for i in range(cfg.num_layers):
        p = layer_params(params["blocks"], i)
        if isinstance(kv, PagedKVCache):
            pk, pv, ks, vs = kv.layer(i)
            x = block_decode_paged(p, cfg, x, pos, pk, pv, kv.block_table,
                                   kv.block_size, k_scale=ks, v_scale=vs)
        else:
            x = block_decode(p, cfg, x, pos, *kv.layer(i))
    hidden = cm.apply_norm(x, params["final_norm"], cfg.norm)
    logits = compute_logits(params, cfg, hidden)
    cache.pos = pos + 1
    kv.length = kv.length + 1
    return cache, logits


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device=None) -> DecodeCache:
    """Empty contiguous cache on `device` (CUDA unless named) for decoding
    after `seq_len` tokens of context (+ DECODE_HEADROOM slots), a ring of
    ``attn_window`` slots under a window; an int8 cache with scale planes
    when cfg.kv_cache_quant."""
    device = resolve_device(device)
    kvc = KVCache.init(cfg.num_layers, batch, seq_len + DECODE_HEADROOM,
                       cfg.n_kv_heads, cfg.head_dim, window=cfg.attn_window,
                       dtype=_dtype(cfg), quantized=cfg.kv_cache_quant,
                       device=device)
    return DecodeCache(pos=torch.full((batch,), seq_len, dtype=torch.int32,
                                      device=device), kv=kvc)


def init_paged_cache(cfg: ModelConfig, batch: int, num_blocks: int,
                     block_size: int, max_blocks: int,
                     device=None) -> DecodeCache:
    """Empty paged cache on `device` (CUDA unless named): `num_blocks`
    pool blocks (block 0 = trash) shared by `batch` slots of up to
    `max_blocks` blocks each; an int8 pool with scale planes when
    cfg.kv_cache_quant."""
    device = resolve_device(device)
    if cfg.attn_window:
        raise ValueError("paged KV cache requires full attention "
                         f"(attn_window={cfg.attn_window})")
    kvc = PagedKVCache.init(cfg.num_layers, batch, num_blocks, block_size,
                            max_blocks, cfg.n_kv_heads, cfg.head_dim,
                            dtype=_dtype(cfg), quantized=cfg.kv_cache_quant,
                            device=device)
    return DecodeCache(pos=torch.zeros((batch,), dtype=torch.int32,
                                       device=device), kv=kvc)
