"""Griffin hybrid (recurrentgemma): RG-LRU recurrent blocks and local
attention in a 2:1 pattern, GeGLU MLPs, MQA with RoPE.

Port of ``repro.models.griffin`` (serving and ``train_loss``), function
for function. Params keep the JAX tree: layers
grouped by the block pattern and stacked over groups (``groups/l{i}_{kind}``,
leading axis n_groups) plus a ``rem`` group of num_layers % 3 layers, so
``repro_torch.convert.params_from_numpy`` carries a JAX tree unchanged;
a Python loop over groups replaces ``lax.scan``.

Recurrence (RG-LRU, arXiv:2402.19427):
    r_t = sigmoid(y_t A_r + b_r), i_t = sigmoid(y_t A_i + b_i)
    a_t = exp(-c · softplus(Λ) · r_t)                        c = 8
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ y_t)
It runs through ``ops.rglru_scan`` / ``ops.rglru_step``: on the card the
``rglru`` kernel walks t in order (JAX's associative scan rounds in
another order), its plain version on the CPU. The two gate projections
are JAX's float32 products (``ops.dense_matmul(out_dtype=float32)``);
every other dense product goes through ``ops.dense_matmul`` (``cm.linear``)
and the untied head through ``cm.logits_head``, so on the card a row's
bits do not depend on its batch. The temporal conv (width 4) is
causal-depthwise as shifted adds, plain PyTorch as XLA ran it in JAX.
Local attention runs windowed ``ops.flash_attention`` over a prompt and,
at decode, ``ops.decode_attention`` over a window-sized ring cache
(position p in slot p % window). The JAX package serves griffin
unquantized, and so does the port (``model_zoo.check_policy``); its ring
stays in the model dtype whatever ``kv_cache_quant`` says, as in JAX.

Training (``train_loss``) runs ``_forward`` under autograd: on the card
the RG-LRU's gradient is the ``rglru_bwd`` kernel, local attention's the
``flash_attention_bwd`` kernel, the dense products' ``torch.matmul``; a
QuantConfig fake-quantizes ``rg_gate``, ``rg_in``, ``rg_out`` and the
FFN (JAX's QAT; attention and the gate projections stay unquantized, as
there), and ``cfg.remat`` checkpoints each (rglru, rglru, attn) group,
as JAX's ``jax.checkpoint`` of its scan body (the ``rem`` layers are not).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.models.kv_cache import (
    DecodeCache,
    KVCache,
    RecurrentState,
    cache_write,
    ring_align,
)
from repro_torch.models.transformer import unstack_layers


def _pattern(cfg: ModelConfig):
    return cfg.block_pattern or ("rglru", "rglru", "attn")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# -- init ----------------------------------------------------------------------


def _init_rec_mix(gen, cfg: ModelConfig, dev, n) -> dict:
    d, W, dt = cfg.d_model, cfg.rnn_width, _dtype(cfg)
    lead = () if n is None else (n,)
    return {
        "rg_in": cm.dense_init(gen, d, W, dt, dev, n),
        "rg_gate": cm.dense_init(gen, d, W, dt, dev, n),
        "rg_out": cm.dense_init(gen, W, d, dt, dev, n),
        "conv_w": cm.normal_init(gen, (*lead, cfg.conv_width, W), 1.0 / cfg.conv_width,
                                 dt, dev),
        "rg_a_proj": cm.dense_init(gen, W, W, dt, dev, n),
        "rg_i_proj": cm.dense_init(gen, W, W, dt, dev, n),
        "rg_a_bias": torch.zeros((*lead, W), dtype=torch.float32, device=dev),
        "rg_i_bias": torch.zeros((*lead, W), dtype=torch.float32, device=dev),
        "lambda_p": torch.full((*lead, W), 0.65, dtype=torch.float32, device=dev),
    }


def _init_attn_mix(gen, cfg: ModelConfig, dev, n) -> dict:
    d, hd, dt = cfg.d_model, cfg.head_dim, _dtype(cfg)
    return {
        "wq": cm.dense_init(gen, d, cfg.n_heads * hd, dt, dev, n),
        "wk": cm.dense_init(gen, d, cfg.n_kv_heads * hd, dt, dev, n),
        "wv": cm.dense_init(gen, d, cfg.n_kv_heads * hd, dt, dev, n),
        "wo": cm.dense_init(gen, cfg.n_heads * hd, d, dt, dev, n),
    }


def _init_layer(gen, cfg: ModelConfig, kind: str, dev, n=None) -> dict:
    dt = _dtype(cfg)
    mix = _init_rec_mix if kind == "rglru" else _init_attn_mix
    return {
        "ln1": cm.norm_init(cfg.norm, cfg.d_model, dt, dev, n),
        "ln2": cm.norm_init(cfg.norm, cfg.d_model, dt, dev, n),
        "mix": mix(gen, cfg, dev, n),
        "ffn": cm.ffn_init(gen, cfg, cfg.d_model, cfg.d_ff, dt, dev, n),
    }


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from a seeded torch.Generator on `device` (CUDA
    unless named), in the JAX tree's layout and scales; the numbers
    differ from JAX's PRNG (tests carry JAX weights across with
    ``repro_torch.convert``)."""
    dev = resolve_device(device)
    gen = cm.generator(dev, seed)
    pattern = _pattern(cfg)
    n_groups, rem = divmod(cfg.num_layers, len(pattern))
    dt = _dtype(cfg)
    params = {
        "embed": cm.embed_init(gen, cfg.vocab, cfg.d_model, dt, dev),
        "groups": {f"l{i}_{kind}": _init_layer(gen, cfg, kind, dev, n_groups)
                   for i, kind in enumerate(pattern)},
        "final_norm": cm.norm_init(cfg.norm, cfg.d_model, dt, dev),
        "head": cm.dense_init(gen, cfg.d_model, cfg.vocab, dt, dev),
    }
    if rem:
        params["rem"] = {f"l{i}_{pattern[i]}": _init_layer(gen, cfg, pattern[i], dev)
                         for i in range(rem)}
    return params


# -- RG-LRU + conv -------------------------------------------------------------


def _causal_conv(a: torch.Tensor, conv_w: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv as shifted adds. a (B, T, W); conv_w (cw, W);
    tail (B, cw-1, W) history for decode (zeros if None)."""
    cw = conv_w.shape[0]
    B, T, W = a.shape
    if tail is None:
        tail = torch.zeros((B, cw - 1, W), dtype=a.dtype, device=a.device)
    ext = torch.cat([tail.to(a.dtype), a], dim=1)          # (B, T + cw - 1, W)
    out = torch.zeros_like(a)
    for i in range(cw):
        out = out + ext[:, i:i + T] * conv_w[cw - 1 - i].to(a.dtype)
    return out


def _gate_projections(mix: dict, y: torch.Tensor):
    """JAX's ``y.astype(f32) @ A.astype(f32)`` for both gates, float32."""
    f32 = torch.float32
    return (ops.dense_matmul(y, mix["rg_a_proj"], out_dtype=f32),
            ops.dense_matmul(y, mix["rg_i_proj"], out_dtype=f32))


def _rglru_coeffs(mix: dict, y: torch.Tensor):
    """``repro.models.griffin._rglru_coeffs``: (a, b) float32 (the plain
    version of the coefficients the ``rglru`` kernel computes inside)."""
    from repro_torch.kernels import ref

    ga, gi = _gate_projections(mix, y)
    return ref.rglru_coeffs_ref(ga, gi, y, mix["rg_a_bias"], mix["rg_i_bias"],
                                mix["lambda_p"])


def _rglru_scan(mix: dict, y: torch.Tensor, h0=None, lengths=None):
    """Gates and recurrence over (B, T, W) → (h (B, T, W), h at lengths - 1)."""
    ga, gi = _gate_projections(mix, y)
    return ops.rglru_scan(ga, gi, y, mix["rg_a_bias"], mix["rg_i_bias"], mix["lambda_p"],
                          h0, lengths)


def rec_mix_apply(mix: dict, cfg: ModelConfig, x: torch.Tensor,
                  rec: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  lengths=None):
    """Whole-sequence recurrent temporal mix. x (B, T, d) normalized; rec
    an optional carried (h0 (B, W), conv_tail (B, cw-1, W)); lengths the
    real-token counts of right-padded rows: the state is taken at
    lengths - 1 and the conv tail from the cw - 1 inputs before lengths, so
    bucketed prefill is exact. Under a QuantConfig (QAT) the three block
    projections are fake-quantized, as JAX's are. Returns (out, (h_last,
    conv_tail_new))."""
    q, qm = cm.quant_mode(cfg)
    gate = F.gelu(cm.linear(x, mix["rg_gate"], q, qm), approximate="tanh")
    a_in = cm.linear(x, mix["rg_in"], q, qm)
    h0, conv_tail = rec if rec is not None else (None, None)
    y = _causal_conv(a_in, mix["conv_w"], conv_tail)
    h, h_last = _rglru_scan(mix, y, h0, lengths)
    out = cm.linear(h.to(x.dtype) * gate, mix["rg_out"], q, qm)
    cw = mix["conv_w"].shape[0]
    B, T, W = a_in.shape
    # Conv tail: the cw - 1 inputs before position `length` (zero history
    # where the sequence is shorter than the conv support).
    ext = torch.cat([torch.zeros((B, cw - 1, W), dtype=a_in.dtype, device=a_in.device),
                     a_in], dim=1)
    if lengths is None:
        new_tail = ext[:, T:T + cw - 1]
    else:
        start = torch.as_tensor(lengths, device=a_in.device).long()
        idx = start[:, None] + torch.arange(cw - 1, device=a_in.device)[None]
        new_tail = ext[torch.arange(B, device=a_in.device)[:, None], idx]
    return out, (h_last, new_tail)


def rec_mix_step(mix: dict, cfg: ModelConfig, x: torch.Tensor, h0, conv_tail):
    """One token. x (B, 1, d). Returns (out, h_new (B, W), conv_tail_new)."""
    gate = F.gelu(cm.linear(x, mix["rg_gate"]), approximate="tanh")
    a_in = cm.linear(x, mix["rg_in"])                       # (B, 1, W)
    y = _causal_conv(a_in, mix["conv_w"], conv_tail)
    ga, gi = _gate_projections(mix, y[:, 0])
    h = ops.rglru_step(ga, gi, y[:, 0], mix["rg_a_bias"], mix["rg_i_bias"],
                       mix["lambda_p"], h0)
    out = cm.linear(h[:, None].to(x.dtype) * gate, mix["rg_out"])
    new_tail = torch.cat([conv_tail[:, 1:].to(a_in.dtype), a_in], dim=1)
    return out, h, new_tail


# -- layers --------------------------------------------------------------------


def _qkv(mix: dict, cfg: ModelConfig, x, positions):
    B, T, _ = x.shape
    hd = cfg.head_dim
    q = cm.linear(x, mix["wq"]).reshape(B, T, cfg.n_heads, hd)
    k = cm.linear(x, mix["wk"]).reshape(B, T, cfg.n_kv_heads, hd)
    v = cm.linear(x, mix["wv"]).reshape(B, T, cfg.n_kv_heads, hd)
    return (cm.rope(q, positions, cfg.rope_theta), cm.rope(k, positions, cfg.rope_theta),
            v)


def _attn_apply(mix: dict, cfg: ModelConfig, x, positions):
    """Local attention over a whole prompt (windowed flash). Returns (out,
    k, v)."""
    B, T, _ = x.shape
    q, k, v = _qkv(mix, cfg, x, positions)
    attn = cm.chunked_attention(q, k, v, cm.AttnMask(causal=True, window=cfg.local_window))
    out = cm.linear(attn.reshape(B, T, cfg.n_heads * cfg.head_dim), mix["wo"])
    return out, k, v


def layer_apply(lp: dict, kind: str, cfg: ModelConfig, x, positions, rec_state=None,
                lengths=None):
    """Whole-sequence layer. Returns (x, state): (h, conv_tail) for rglru,
    (k, v) for attn."""
    h = cm.apply_norm(x, lp["ln1"], cfg.norm)
    if kind == "rglru":
        out, state = rec_mix_apply(lp["mix"], cfg, h, rec_state, lengths)
    else:
        out, k, v = _attn_apply(lp["mix"], cfg, h, positions)
        state = (k, v)
    x = x + out
    h2 = cm.apply_norm(x, lp["ln2"], cfg.norm)
    return x + cm.ffn_apply(lp["ffn"], h2, cfg), state


def _groups(params, cfg: ModelConfig):
    """The layers as (layer params, kind) lists in execution order, grouped
    as JAX scans them: one list per group of the block pattern (each
    stacked leaf unbound once), then the ``rem`` layers' list (empty when
    num_layers is a multiple of the pattern)."""
    pattern = _pattern(cfg)
    n_groups = cfg.num_layers // len(pattern)
    per = [unstack_layers(params["groups"][f"l{i}_{kind}"], n_groups)
           for i, kind in enumerate(pattern)]
    groups = [[(per[i][g], kind) for i, kind in enumerate(pattern)] for g in range(n_groups)]
    rem = [(lp, name.split("_", 1)[1]) for name, lp in params.get("rem", {}).items()]
    return groups, rem


def _layers(params, cfg: ModelConfig):
    """(layer params, kind) in execution order: group by group, then rem."""
    groups, rem = _groups(params, cfg)
    for g in groups:
        yield from g
    yield from rem


def _apply_layers(layers, cfg: ModelConfig, x, positions, lengths):
    """``layer_apply`` over (layer params, kind) pairs in order → (x,
    [(kind, state), ...])."""
    states = []
    for lp, kind in layers:
        x, st = layer_apply(lp, kind, cfg, x, positions, lengths=lengths)
        states.append((kind, st))
    return x, states


# -- model ---------------------------------------------------------------------


def _forward(params, cfg: ModelConfig, tokens, lengths=None, remat: bool = False):
    """Whole-prompt forward → (hidden (B, T, d), recurrent states, attention
    states), each list in execution order (JAX's ``_pack_cache`` order:
    [g0·l0, g0·l1, g1·l0, …, rem]). With ``remat`` (training) each group
    is checkpointed: its activations are recomputed in the backward pass
    instead of kept."""
    B, T = tokens.shape
    x = cm.embed_lookup(params["embed"], tokens, scale=True)
    positions = torch.arange(T, dtype=torch.int32, device=x.device)[None].expand(B, T)
    groups, rem = _groups(params, cfg)
    rec, att = [], []
    for layers in groups + [rem]:
        args = (layers, cfg, x, positions, lengths)
        if remat and layers is not rem:
            x, states = torch.utils.checkpoint.checkpoint(_apply_layers, *args,
                                                          use_reentrant=False)
        else:
            x, states = _apply_layers(*args)
        for kind, st in states:
            (rec if kind == "rglru" else att).append(st)
    return cm.apply_norm(x, params["final_norm"], cfg.norm), rec, att


def train_loss(params, cfg: ModelConfig, batch):
    """Mean next-token cross-entropy (with z-loss) of a training batch →
    (loss, {"loss", "aux_loss"}): JAX's ``train_loss``."""
    tokens = torch.as_tensor(batch["tokens"], device=params["embed"].device)
    hidden, _, _ = _forward(params, cfg, tokens, remat=cfg.remat and torch.is_grad_enabled())
    return cm.next_token_loss(cm.logits_head(hidden, params["head"]), tokens)


def _pack_cache(cfg: ModelConfig, rec, att, B: int, S: int, lengths=None) -> DecodeCache:
    """Stack the collected states into the decode carry: RecurrentState
    over the recurrent layers, the attention layers' K/V packed into
    window-sized rings (``ring_align``)."""
    w = cfg.local_window
    dev = rec[0][0].device if rec else att[0][0].device
    dt = _dtype(cfg)
    if rec:
        hs = torch.stack([h for h, _ in rec])
        tails = torch.stack([t for _, t in rec])
    else:        # degenerate attention-only pattern
        hs = torch.zeros((0, B, cfg.rnn_width), dtype=torch.float32, device=dev)
        tails = torch.zeros((0, B, cfg.conv_width - 1, cfg.rnn_width), dtype=dt, device=dev)
    if att:
        k_cat = torch.stack([k for k, _ in att])
        v_cat = torch.stack([v for _, v in att])
    else:        # degenerate recurrent-only pattern
        k_cat = torch.zeros((0, 1, 1, cfg.n_kv_heads, cfg.head_dim), dtype=dt, device=dev)
        v_cat = torch.zeros_like(k_cat)
    length = (torch.full((B,), S, dtype=torch.int32, device=dev) if lengths is None
              else torch.as_tensor(lengths, dtype=torch.int32).to(dev))
    k_all, v_all, slot_pos = ring_align(k_cat, v_cat, length, w)
    kv = KVCache(k=k_all, v=v_all, slot_pos=slot_pos, length=length.clone(), window=w)
    return DecodeCache(pos=length.clone(), kv=kv, rec=RecurrentState(h=hs, conv_tail=tails))


def prefill(params, cfg: ModelConfig, batch):
    """Whole-prompt forward → (DecodeCache, last-token logits (B, 1, V)).
    ``batch["lengths"]`` (B,) marks right-padded prompts: the recurrent
    states, conv tails, rings and logits are all taken at each row's last
    real token, so bucketed prefill is exact-length prefill."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    lengths = batch.get("lengths")
    if lengths is not None:
        lengths = torch.as_tensor(lengths, dtype=torch.int32).to(tokens.device)
    hidden, rec, att = _forward(params, cfg, tokens, lengths)
    logits = cm.logits_head(cm.last_token_slice(hidden, lengths), params["head"])
    return _pack_cache(cfg, rec, att, B, S, lengths), logits


def decode_step(params, cfg: ModelConfig, cache: DecodeCache, tokens):
    """tokens (B, 1) → (cache, logits (B, 1, V)). The recurrent states and
    the rings are updated in place (each row writes its new k/v at slot
    pos % window, then attends its window through the ring kernel), and
    every row's position advances by one."""
    pos = cache.pos
    x = cm.embed_lookup(params["embed"], tokens, scale=True)
    rec, kv = cache.rec, cache.kv
    B = x.shape[0]
    ri = ai = 0
    for lp, kind in _layers(params, cfg):
        h = cm.apply_norm(x, lp["ln1"], cfg.norm)
        if kind == "rglru":
            out, hn, tn = rec_mix_step(lp["mix"], cfg, h, rec.h[ri], rec.conv_tail[ri])
            rec.h[ri] = hn
            rec.conv_tail[ri] = tn
            ri += 1
        else:
            q, k, v = _qkv(lp["mix"], cfg, h, pos[:, None])
            kc, vc, spc = kv.k[ai], kv.v[ai], kv.slot_pos[ai]
            cache_write(kc, vc, spc, k, v, pos, cfg.local_window)
            attn = ops.decode_attention(q, kc, vc, spc, pos, window=cfg.local_window)
            out = cm.linear(attn.reshape(B, 1, cfg.n_heads * cfg.head_dim), lp["mix"]["wo"])
            ai += 1
        x = x + out
        h2 = cm.apply_norm(x, lp["ln2"], cfg.norm)
        x = x + cm.ffn_apply(lp["ffn"], h2, cfg)
    hidden = cm.apply_norm(x, params["final_norm"], cfg.norm)
    logits = cm.logits_head(hidden, params["head"])
    cache.pos = pos + 1
    kv.length = kv.length + 1
    return cache, logits


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None) -> DecodeCache:
    """Zero recurrent states and empty window-sized rings on `device` (CUDA
    unless named) for `batch` rows decoding after `seq_len` tokens: the
    footprint does not grow with the context."""
    device = resolve_device(device)
    pattern = _pattern(cfg)
    n_rec = sum(pattern[i % len(pattern)] == "rglru" for i in range(cfg.num_layers))
    dt = _dtype(cfg)
    w = cfg.local_window
    kv = KVCache.init(cfg.num_layers - n_rec, batch, min(seq_len, w), cfg.n_kv_heads,
                      cfg.head_dim, window=w, dtype=dt, device=device)
    rec = RecurrentState(
        h=torch.zeros((n_rec, batch, cfg.rnn_width), dtype=torch.float32, device=device),
        conv_tail=torch.zeros((n_rec, batch, cfg.conv_width - 1, cfg.rnn_width), dtype=dt,
                              device=device))
    return DecodeCache(pos=torch.full((batch,), seq_len, dtype=torch.int32, device=device),
                       kv=kv, rec=rec)
