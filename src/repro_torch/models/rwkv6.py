"""RWKV-6 "Finch": attention-free mixer with data-dependent decay.

Port of ``repro.models.rwkv6`` (serving and ``train_loss``): per-channel decay ``w_t = exp(-exp(base + tanh(x W_a) W_b))``
from the input, current-token bonus ``u``, head-wise state ``S ∈
R^{K×V}``, token shift on both mixers, squared-ReLU channel mix. Params
are a nested dict of stacked ``(L, …)`` tensors with the JAX key names;
a Python loop over layers replaces ``lax.scan``.

The recurrence runs through ``ops.wkv6_chunked`` (prefill: the chunked
algebra with the state carried in and out, chunk boundaries at absolute
positions) and ``ops.wkv6_step`` (decode: one token with the carried
state) — the CUDA ``wkv6`` kernel on the card, its plain versions on the
CPU. Every dense product (the mixers' projections, the decay LoRA, the
LM head) goes through ``ops.dense_matmul`` (:func:`_linear`): plain
``x @ w`` on the CPU, as the JAX package leaves them to XLA, and on the
card a bf16 kernel whose rows do not depend on M, so a prompt's logits
are the same bits in a static batch and alone. The JAX package serves
rwkv6 unquantized, and so does the port (``model_zoo.check_policy``).

Training (``train_loss``) runs ``_forward`` under autograd: on the card
``ops.wkv6_chunked``'s gradient is the ``wkv6_bwd`` kernel and the dense
products' run on ``torch.matmul``; ``cfg.remat`` checkpoints each layer
(JAX's ``jax.checkpoint`` of the scan body). JAX's mixers are raw
products with no fake-quant, so a QuantConfig (``--qat``) leaves rwkv6
unquantized in both packages.
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
from repro_torch.models.kv_cache import DecodeCache, RwkvState
from repro_torch.models.transformer import layer_params, unstack_layers


def _dims(cfg: ModelConfig) -> Tuple[int, int]:
    hd = cfg.rwkv_head_dim
    return cfg.d_model // hd, hd  # (H, K)


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from a seeded torch.Generator on `device` (CUDA
    unless named), in the JAX tree's layout and scales; the numbers
    differ from JAX's PRNG (tests carry JAX weights across with
    ``repro_torch.convert``)."""
    dev = resolve_device(device)
    gen = cm.generator(dev, seed)
    d, f, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    H, K = _dims(cfg)
    R = cfg.rwkv_decay_lora
    dt = getattr(torch, cfg.dtype)

    def full(shape, value, dtype=dt):
        return torch.full((L, *shape), value, dtype=dtype, device=dev)

    def dense(d_in, d_out):
        return cm.dense_init(gen, d_in, d_out, dt, dev, L)

    def normal(shape, std):
        return torch.randn((L, *shape), generator=gen, device=dev) * std

    blocks = {
        "ln1": cm.norm_init("layernorm", d, dt, dev, L),
        "ln2": cm.norm_init("layernorm", d, dt, dev, L),
        "tm": {
            "mu": full((5, d), 0.5),          # r, k, v, w, g token-shift mix
            "w_recept": dense(d, d), "w_key": dense(d, d), "w_value": dense(d, d),
            "w_gate": dense(d, d), "w_out": dense(d, d),
            "decay_base": full((d,), -4.0, torch.float32),
            "decay_a": dense(d, R),
            "decay_b": normal((R, d), 0.01).to(dt),
            "u": normal((H, K), 0.1),
            "gn_scale": full((d,), 1.0), "gn_bias": full((d,), 0.0),
        },
        "cmx": {
            "mu": full((2, d), 0.5),          # k, r
            "w_key": dense(d, f), "w_value": dense(f, d), "w_recept": dense(d, d),
        },
    }
    return {
        "embed": cm.embed_init(gen, cfg.vocab, d, dt, dev),
        "blocks": blocks,
        "final_norm": cm.norm_init("layernorm", d, dt, dev),
        "head": cm.dense_init(gen, d, cfg.vocab, dt, dev),
    }


def _shift(x: torch.Tensor, tail: torch.Tensor) -> torch.Tensor:
    """Token shift: y_t = x_{t-1}; position 0 receives `tail` (B, d)."""
    return torch.cat([tail[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Every dense product of the model: ``x @ w`` in x's dtype, each row
    independent of the number of rows on the card (``ops.dense_matmul``)."""
    return ops.dense_matmul(x, w)


def _decay(tm: dict, xw: torch.Tensor) -> torch.Tensor:
    lora = _linear(torch.tanh(_linear(xw, tm["decay_a"])), tm["decay_b"])
    dw = tm["decay_base"].to(torch.float32) + lora.to(torch.float32)
    return torch.exp(-torch.exp(dw))  # (…, d) in (0, 1)


def _group_norm(x: torch.Tensor, H: int, scale, bias, eps: float = 1e-5):
    """Per-head normalization of (..., H*K)."""
    shp = x.shape
    xh = x.reshape(*shp[:-1], H, shp[-1] // H).to(torch.float32)
    mean = xh.mean(dim=-1, keepdim=True)
    var = (xh - mean).square().mean(dim=-1, keepdim=True)
    xh = (xh - mean) * torch.rsqrt(var + eps)
    out = xh.reshape(shp) * scale.to(torch.float32) + bias.to(torch.float32)
    return out.to(x.dtype)


def _last_real(x: torch.Tensor, lengths) -> torch.Tensor:
    """(B, T, d) → (B, d) at each row's last real token."""
    return cm.last_token_slice(x, lengths)[:, 0]


def _mix(x, xx, mu, i):
    return x + (xx - x) * mu[i]


def time_mix(p: dict, cfg: ModelConfig, x, tail, wkv_state, lengths=None):
    """x (B, T, d) normalized input. Returns (out, new_tail, new_state).

    `lengths` marks right-padded prompts: pad positions get k = 0 (no
    state injection) and w = 1 (no decay), so the state after T steps is
    the state after `lengths` real steps, bitwise (the wkv6 chunks sit at
    absolute positions)."""
    B, T, d = x.shape
    H, K = _dims(cfg)
    xx = _shift(x, tail)
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xw, xg = (_mix(x, xx, mu, i) for i in range(5))
    r = _linear(xr, p["w_recept"]).reshape(B, T, H, K)
    k = _linear(xk, p["w_key"]).reshape(B, T, H, K)
    v = _linear(xv, p["w_value"]).reshape(B, T, H, K)
    g = F.silu(_linear(xg, p["w_gate"]))
    w = _decay(p, xw).reshape(B, T, H, K)
    if lengths is not None:
        real = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
        real = real[..., None, None]
        k = torch.where(real, k, torch.zeros((), dtype=k.dtype, device=k.device))
        w = torch.where(real, w, torch.ones((), dtype=w.dtype, device=w.device))
    out, state = ops.wkv6_chunked(r, k, v, w, p["u"], wkv_state, chunk=cfg.rwkv_chunk)
    out = out.reshape(B, T, d).to(x.dtype)
    out = _group_norm(out, H, p["gn_scale"], p["gn_bias"]) * g
    return _linear(out, p["w_out"]), _last_real(x, lengths), state


def time_mix_step(p: dict, cfg: ModelConfig, x, tail, wkv_state):
    """One token: x (B, 1, d). Returns (out, new_tail, new_state)."""
    B, _, d = x.shape
    H, K = _dims(cfg)
    xt = x[:, 0]
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xw, xg = (_mix(xt, tail.to(x.dtype), mu, i) for i in range(5))
    r = _linear(xr, p["w_recept"]).reshape(B, H, K)
    k = _linear(xk, p["w_key"]).reshape(B, H, K)
    v = _linear(xv, p["w_value"]).reshape(B, H, K)
    g = F.silu(_linear(xg, p["w_gate"]))
    w = _decay(p, xw).reshape(B, H, K)
    out, state = ops.wkv6_step(r, k, v, w, p["u"], wkv_state)
    out = out.reshape(B, d).to(x.dtype)
    out = _group_norm(out, H, p["gn_scale"], p["gn_bias"]) * g
    return _linear(out, p["w_out"])[:, None, :], xt, state


def _channel(p: dict, xk, xr):
    kk = torch.square(torch.relu(_linear(xk, p["w_key"])))
    return torch.sigmoid(_linear(xr, p["w_recept"])) * _linear(kk, p["w_value"])


def channel_mix(p: dict, x, tail, lengths=None):
    xx = _shift(x, tail)
    mu = p["mu"].to(x.dtype)
    return _channel(p, _mix(x, xx, mu, 0), _mix(x, xx, mu, 1)), _last_real(x, lengths)


def channel_mix_step(p: dict, x, tail):
    xt = x[:, 0]
    mu = p["mu"].to(x.dtype)
    tail = tail.to(x.dtype)
    return _channel(p, _mix(xt, tail, mu, 0), _mix(xt, tail, mu, 1))[:, None, :], xt


def _zero_state(cfg: ModelConfig, batch: int, device) -> RwkvState:
    H, K = _dims(cfg)
    L, d, dt = cfg.num_layers, cfg.d_model, getattr(torch, cfg.dtype)
    return RwkvState(
        wkv=torch.zeros((L, batch, H, K, K), dtype=torch.float32, device=device),
        tm_shift=torch.zeros((L, batch, d), dtype=dt, device=device),
        cm_shift=torch.zeros((L, batch, d), dtype=dt, device=device))


def _block(bp: dict, cfg: ModelConfig, x, tm_tail, wkv0, cm_tail, lengths):
    """One layer → (x, wkv state, time-mix tail, channel-mix tail)."""
    h = cm.apply_norm(x, bp["ln1"], "layernorm")
    out, tm2, wkv1 = time_mix(bp["tm"], cfg, h, tm_tail, wkv0, lengths=lengths)
    x = x + out
    h2 = cm.apply_norm(x, bp["ln2"], "layernorm")
    out2, cm2 = channel_mix(bp["cmx"], h2, cm_tail, lengths=lengths)
    return x + out2, wkv1, tm2, cm2


def _forward(params, cfg: ModelConfig, tokens, state: Optional[RwkvState],
             lengths=None, remat: bool = False):
    """Full-sequence forward → (hidden (B, T, d), final RwkvState). With
    ``remat`` (training) each layer is checkpointed: its activations are
    recomputed in the backward pass instead of kept."""
    x = cm.embed_lookup(params["embed"], tokens)
    if state is None:
        state = _zero_state(cfg, x.shape[0], x.device)
    wkv, tms, cms = [], [], []
    for i, bp in enumerate(unstack_layers(params["blocks"], cfg.num_layers)):
        args = (bp, cfg, x, state.tm_shift[i], state.wkv[i], state.cm_shift[i], lengths)
        if remat:
            x, wkv1, tm2, cm2 = torch.utils.checkpoint.checkpoint(_block, *args,
                                                                  use_reentrant=False)
        else:
            x, wkv1, tm2, cm2 = _block(*args)
        wkv.append(wkv1)
        tms.append(tm2)
        cms.append(cm2)
    hidden = cm.apply_norm(x, params["final_norm"], "layernorm")
    return hidden, RwkvState(wkv=torch.stack(wkv), tm_shift=torch.stack(tms),
                             cm_shift=torch.stack(cms))


def train_loss(params, cfg: ModelConfig, batch):
    """Mean next-token cross-entropy (with z-loss) of a training batch →
    (loss, {"loss", "aux_loss"}): JAX's ``train_loss``, the logits through
    the plain head product (``cm.logits_head``, as JAX leaves it to XLA)."""
    tokens = torch.as_tensor(batch["tokens"], device=params["embed"].device)
    hidden, _ = _forward(params, cfg, tokens, None,
                         remat=cfg.remat and torch.is_grad_enabled())
    return cm.next_token_loss(cm.logits_head(hidden, params["head"]), tokens)


def prefill(params, cfg: ModelConfig, batch):
    """Whole-prompt forward → (DecodeCache with the recurrent state,
    last-token logits (B, 1, V)). ``batch["lengths"]`` (B,) marks
    right-padded prompts: the wkv state passes through pad steps
    untouched, shift tails and logits come from each row's last real
    token, so bucketed prefill is exact-length prefill."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    lengths = batch.get("lengths")
    if lengths is not None:
        lengths = torch.as_tensor(lengths, dtype=torch.int32).to(tokens.device)
    hidden, state = _forward(params, cfg, tokens, None, lengths)
    logits = _linear(cm.last_token_slice(hidden, lengths), params["head"]).float()
    pos = (torch.full((B,), S, dtype=torch.int32, device=tokens.device)
           if lengths is None else lengths.clone())
    return DecodeCache(pos=pos, rwkv=state), logits


def decode_step(params, cfg: ModelConfig, cache: DecodeCache, tokens):
    """tokens (B, 1) → (cache, logits (B, 1, V)); the recurrent state is
    updated in place and every row's position advances by one."""
    x = cm.embed_lookup(params["embed"], tokens)
    st = cache.rwkv
    for i in range(cfg.num_layers):
        bp = layer_params(params["blocks"], i)
        h = cm.apply_norm(x, bp["ln1"], "layernorm")
        out, tm2, wkv1 = time_mix_step(bp["tm"], cfg, h, st.tm_shift[i], st.wkv[i])
        x = x + out
        h2 = cm.apply_norm(x, bp["ln2"], "layernorm")
        out2, cm2 = channel_mix_step(bp["cmx"], h2, st.cm_shift[i])
        x = x + out2
        st.wkv[i] = wkv1
        st.tm_shift[i] = tm2
        st.cm_shift[i] = cm2
    hidden = cm.apply_norm(x, params["final_norm"], "layernorm")
    logits = _linear(hidden, params["head"]).float()
    cache.pos = cache.pos + 1
    return cache, logits


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None) -> DecodeCache:
    """Zero recurrent state on `device` (CUDA unless named) for `batch`
    rows decoding after `seq_len` tokens (constant size: no context
    bound)."""
    device = resolve_device(device)
    return DecodeCache(pos=torch.full((batch,), seq_len, dtype=torch.int32,
                                      device=device),
                       rwkv=_zero_state(cfg, batch, device))
