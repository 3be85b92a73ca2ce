"""Dense decoder transformer on the paged KV pool: init, chunked prefill
and the paged decode step.

Port of the dense serving path of ``repro.models.transformer``. Params
are a nested dict of stacked ``(L, …)`` tensors with the JAX key names
(``embed``, ``blocks/wq``, ``blocks/ffn/w_up``, ``final_norm``, …); a
Python loop over layers replaces ``lax.scan``. Attention runs the paged
kernels through :mod:`repro_torch.kernels.ops`: ``paged_prefill`` for
every chunk of a prompt, ``paged_attention`` for every decode step.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantized_linear import PackedWeight
from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.models.kv_cache import DecodeCache, PagedKVCache, paged_cache_write


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_dense(cfg: ModelConfig) -> None:
    if (cfg.moe_experts or cfg.frontend != "none" or cfg.attn_window
            or cfg.qk_norm or cfg.family != "dense"):
        raise ValueError(f"{cfg.name}: the port serves full-attention dense "
                         "token transformers without qk-norm only (other "
                         "families come later)")


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from a seeded torch.Generator on `device` (CUDA
    unless named): the JAX tree's layout and scales (N(0, 1/d_in)
    projections, N(0, 0.02²) embedding); the numbers differ from JAX's
    PRNG — tests carry JAX weights across with ``repro_torch.convert``."""
    _check_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, hd, L, dt = cfg.d_model, cfg.head_dim, cfg.num_layers, _dtype(cfg)
    blocks = {
        "ln1": cm.norm_init(cfg.norm, d, dt, dev, L),
        "ln2": cm.norm_init(cfg.norm, d, dt, dev, L),
        "wq": cm.dense_init(gen, d, cfg.n_heads * hd, dt, dev, L),
        "wk": cm.dense_init(gen, d, cfg.n_kv_heads * hd, dt, dev, L),
        "wv": cm.dense_init(gen, d, cfg.n_kv_heads * hd, dt, dev, L),
        "wo": cm.dense_init(gen, cfg.n_heads * hd, d, dt, dev, L),
        "ffn": cm.ffn_init(gen, cfg, d, cfg.d_ff, dt, dev, L),
    }
    params = {
        "embed": cm.embed_init(gen, cfg.vocab, d, dt, dev),
        "blocks": blocks,
        "final_norm": cm.norm_init(cfg.norm, d, dt, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = cm.dense_init(gen, d, cfg.vocab, dt, dev)
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


def _attention_qkv(p, cfg: ModelConfig, x, positions):
    B, T, _ = x.shape
    hd = cfg.head_dim
    q = cm.linear(x, p["wq"]).reshape(B, T, cfg.n_heads, hd)
    k = cm.linear(x, p["wk"]).reshape(B, T, cfg.n_kv_heads, hd)
    v = cm.linear(x, p["wv"]).reshape(B, T, cfg.n_kv_heads, hd)
    q = cm.rope(q, positions, cfg.rope_theta)
    k = cm.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _block_post_attn(p: dict, cfg: ModelConfig, x, attn):
    """Output projection + FFN residual, shared by prefill and decode."""
    attn = attn.reshape(*x.shape[:2], cfg.n_heads * cfg.head_dim)
    x = x + cm.linear(attn, p["wo"])
    h2 = cm.apply_norm(x, p["ln2"], cfg.norm)
    return x + cm.ffn_apply(p["ffn"], h2, cfg)


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
    return _block_post_attn(p, cfg, x, attn)


def compute_logits(params, cfg: ModelConfig, hidden):
    if cfg.tie_embeddings:
        return cm.logits_head(hidden, params["embed"],
                              softcap=cfg.logits_softcap, transpose=True)
    return cm.logits_head(hidden, params["head"], softcap=cfg.logits_softcap)


def prefill_chunk(params, cfg: ModelConfig, cache: DecodeCache, batch):
    """Prefill one chunk of a single row's prompt against the paged pool.

    ``batch``: tokens (1, Lc) right-padded chunk ids; lengths (1,) real
    chunk length; start — absolute position of the chunk's first token
    (positions [0, start) are already pool-resident); slot — the row's
    batch slot; blocks (nbp,) — the row's pool blocks in virtual-block
    order (-1 = unallocated). Each layer runs ``ops.paged_prefill``: the
    chunk attends causally over [prefix ++ chunk] and its K/V lands in the
    row's blocks in place. Updates ``cache.pos``/``kv.length`` at slot to
    start + length and returns ``(cache, logits (1, 1, V))`` for the
    chunk's last real token."""
    if cfg.attn_window:
        raise ValueError("chunked prefill requires a full-attention paged cache")
    tokens = batch["tokens"]
    _, Lc = tokens.shape
    length = int(batch["lengths"][0])
    start = int(batch["start"])
    slot = int(batch["slot"])
    dev = tokens.device
    blocks = torch.as_tensor(batch["blocks"], dtype=torch.int32).to(dev)
    kv: PagedKVCache = cache.kv
    positions = (start + torch.arange(Lc, dtype=torch.int32, device=dev))[None]
    x = cm.embed_lookup(params["embed"], tokens)
    for i in range(cfg.num_layers):
        p = layer_params(params["blocks"], i)
        pk, pv, ks, vs = kv.layer(i)
        h = cm.apply_norm(x, p["ln1"], cfg.norm)
        q, k, v = _attention_qkv(p, cfg, h, positions)
        attn = ops.paged_prefill(q, k, v, pk, pv, blocks, start, length,
                                 k_scale=ks, v_scale=vs,
                                 softcap=cfg.attn_logit_softcap)[0]
        x = _block_post_attn(p, cfg, x, attn)
    hidden = cm.apply_norm(cm.last_token_slice(x, [length]),
                           params["final_norm"], cfg.norm)
    logits = compute_logits(params, cfg, hidden)
    cache.pos[slot] = start + length
    kv.length[slot] = start + length
    return cache, logits


def decode_step(params, cfg: ModelConfig, cache: DecodeCache,
                tokens: torch.Tensor):
    """tokens (B, 1) → (cache, logits (B, 1, V)). Every slot decodes at
    its own position cache.pos (continuous batching); the pool is written
    in place and every row's pos/length advances by one."""
    x = cm.embed_lookup(params["embed"], tokens)
    kv: PagedKVCache = cache.kv
    pos = cache.pos
    for i in range(cfg.num_layers):
        pk, pv, ks, vs = kv.layer(i)
        x = block_decode_paged(layer_params(params["blocks"], i), cfg, x, pos,
                               pk, pv, kv.block_table, kv.block_size,
                               k_scale=ks, v_scale=vs)
    hidden = cm.apply_norm(x, params["final_norm"], cfg.norm)
    logits = compute_logits(params, cfg, hidden)
    cache.pos = pos + 1
    kv.length = kv.length + 1
    return cache, logits


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
