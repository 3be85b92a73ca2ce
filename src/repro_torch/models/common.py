"""Shared model components: linear, norms (and the per-head qk-norm),
rotary embeddings, whole-sequence and decode attention, FFN, embeddings,
the logits head and the training loss (``cross_entropy``).

Port of the parts of ``repro.models.common`` the dense serving path uses.
Dtype rules follow the JAX code op by op (norms and softmax in float32,
results cast back to the activation dtype), so a float32 model agrees
with JAX to rounding and a bfloat16 model rounds at the same places.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quant import QuantConfig
from repro_torch.core.quantized_linear import PackedWeight, qmatmul


# The largest float32 draw an init makes: a leaf up to this size (every
# leaf of olmo-1b and rwkv6-3b) is drawn in one call, a larger one in
# slices along its first dim (other values, the same law), each cast as
# it is drawn, so a full-width init (one (32, 6144, 24576) leaf is 19.3
# GB in float32) never holds more float32 than this beside its weights.
# A first dim of 1 (a stack of one layer) is drawn as the leaf below it.
DRAW_BYTES = 4 << 30


def generator(device: torch.device, seed: int) -> torch.Generator:
    """The seeded generator an init draws from on `device`. On the
    ``meta`` device (a shape-and-dtype template, as a checkpoint restore
    builds one) nothing is drawn, and a CPU generator stands in."""
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    gen.manual_seed(seed)
    return gen


def normal_init(gen: torch.Generator, shape, std: float, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """N(0, std²) values of `shape` in `dtype`, drawn in float32."""
    numel = math.prod(shape)
    if numel * 4 <= DRAW_BYTES:
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return w.mul_(std).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    if shape[0] == 1:           # one slice is the whole leaf: draw its rows
        out[0] = normal_init(gen, shape[1:], std, dtype, device)
        return out
    rows = max(1, DRAW_BYTES // (4 * (numel // shape[0])))
    for i in range(0, shape[0], rows):
        out[i:i + rows] = normal_init(gen, (min(rows, shape[0] - i), *shape[1:]), std,
                                      dtype, device)
    return out


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, device=None, layers: Optional[int] = None):
    """N(0, 1/d_in) weights, (d_in, d_out) or stacked (layers, d_in, d_out)."""
    shape = (d_in, d_out) if layers is None else (layers, d_in, d_out)
    return normal_init(gen, shape, (1.0 / d_in) ** 0.5, dtype, device)


def linear(x: torch.Tensor, w, quant: Optional[QuantConfig] = None,
           quant_mode: str = "none") -> torch.Tensor:
    """Every model matmul. PackedWeight leaves carry their own per-layer
    precision and always run the packed kernel path. A dense weight runs
    ``ops.dense_matmul``: on the card a bfloat16 row's bits then do not
    depend on how many rows share the product (a library product's
    split-K does), so static ≡ continuous and chunked ≡ whole-prompt hold
    for an unpacked model too; float32 goes to ``torch.matmul`` and the
    CPU runs the plain ``x @ w``. With a ``quant`` config and
    ``quant_mode="fake"`` (quantization-aware training) the product runs
    on fake-quantized operands (``qmatmul(mode="fake")``)."""
    if isinstance(w, PackedWeight):
        return qmatmul(x, w, None)
    if quant is not None and quant_mode != "none":
        return qmatmul(x, w, quant, mode=quant_mode)
    from repro_torch.kernels import ops

    return ops.dense_matmul(x, w)


def norm_init(kind: str, d: int, dtype=torch.float32, device=None,
              layers: Optional[int] = None) -> dict:
    shape = (d,) if layers is None else (layers, d)
    if kind == "rmsnorm":
        return {"scale": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones(shape, dtype=dtype, device=device),
                "bias": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == "nonparam_ln":
        return {}
    raise ValueError(kind)


def chunked_row_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last dim (keepdim) as stages of 32-wide sums: each
    stage zero-pads the last dim to a multiple of 32 and sums its 32-wide
    chunks, until one value per row is left, then divides by the width."""
    d = x.shape[-1]
    while x.shape[-1] > 1:
        pad = -x.shape[-1] % 32
        if pad:
            x = F.pad(x, (0, pad))
        x = x.reshape(*x.shape[:-1], -1, 32).sum(dim=-1)
    return x / d


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last dim (keepdim), each row's bits independent of
    how many rows there are. On the card PyTorch's reduction sizes its
    thread blocks from the number of rows (a 4096-wide row is summed by
    512, 256 or 128 lanes at 1, 2 or 4 rows), so a decode row's norm moved
    with the batch; :func:`chunked_row_mean` reduces 32 values a warp at
    every stage, the same adds at every batch size. The CPU's mean is
    row-local already and stays as it is."""
    return chunked_row_mean(x) if x.is_cuda else x.mean(dim=-1, keepdim=True)


def apply_norm(x: torch.Tensor, params: dict, kind: str, eps: float = 1e-6):
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        var = row_mean(xf * xf)
        y = xf * torch.rsqrt(var + eps)
        return (y * (1.0 + params["scale"].to(torch.float32))).to(x.dtype)
    mean = row_mean(xf)
    var = row_mean((xf - mean).square())
    y = (xf - mean) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * params["scale"].to(torch.float32) + params["bias"].to(torch.float32)
    # nonparam_ln (olmo): no affine parameters at all
    return y.to(x.dtype)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head qk-norm (stablelm): x (..., H) scaled by the reciprocal RMS
    over H and by ``1 + scale``, in float32, cast back to x's dtype. Plain
    PyTorch, as JAX computes it outside any Pallas kernel; row-local, so a
    row's bits do not depend on its batch."""
    xf = x.to(torch.float32)
    var = row_mean(xf * xf)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., T, n, h) rotated by per-position angles; positions (..., T)."""
    h = x.shape[-1]
    half = h // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freqs = 1.0 / (theta ** (idx / half))
    angles = positions.to(torch.float32)[..., None] * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class AttnMask:
    causal: bool = True
    window: int = 0        # >0: key j visible iff q_pos - window < j <= q_pos
    prefix_len: int = 0    # >0: positions < prefix_len attend bidirectionally


def chunked_attention(q, k, v, mask: AttnMask, *, q_offset: int = 0,
                      softcap: float = 0.0, kpos=None) -> torch.Tensor:
    """Whole-sequence attention: q (B, T, NQ, H) over k/v (B, S, NKV, H),
    GQA, at query positions q_offset + i; key slot s holds absolute
    position s. The function of ``repro.models.common.chunked_attention``,
    computed by ``ops.flash_attention`` (the kernel on a CUDA tensor, its
    plain version on the CPU) for every mask JAX builds there: causal,
    bidirectional (``causal=False``), sliding-window and prefix-LM
    (``prefix_len``: under causal, keys < prefix_len are visible to every
    query, with a window if one is set). Explicit key positions (``kpos``)
    and a logit softcap are not ported and raise on every device alike:
    the port's suffix prefill gathers exactly the resident prefix
    positions and needs no ``kpos``; the softcap is gemma's."""
    from repro_torch.kernels import ops

    if kpos is not None:
        raise ValueError("chunked_attention: explicit key positions (kpos) are "
                         "not ported (prefill_suffix gathers exactly the resident "
                         "positions instead)")
    if softcap:
        raise ValueError("chunked_attention: a logit softcap is not ported yet")
    return ops.flash_attention(q, k, v, causal=mask.causal, window=mask.window,
                               q_offset=q_offset, prefix_len=mask.prefix_len)


def decode_attention(q, k_cache, v_cache, kpos, q_pos, window: int = 0,
                     softcap: float = 0.0, k_scale=None, v_scale=None):
    """One-token attention over a (B, S, NKV, H) cache with per-row slot
    positions kpos (B, S) (-1 = empty) and decode positions q_pos (B,).
    For an int8 cache, scores are computed on codes and rescaled per key
    slot, probabilities per value slot."""
    B, _, NQ, H = q.shape
    NKV = k_cache.shape[2]
    G = NQ // NKV
    q_pos = torch.as_tensor(q_pos, dtype=torch.int32, device=q.device)
    q_pos = q_pos.reshape(-1).expand(B)
    if kpos.ndim == 1:
        kpos = kpos[None].expand(B, kpos.shape[0])
    qr = q.reshape(B, NKV, G, H).to(torch.float32)
    s = torch.einsum("bngh,bsnh->bngs", qr, k_cache.to(torch.float32))
    if k_scale is not None:
        s = s * k_scale[..., 0].movedim(-1, 1)[:, :, None, :]
    s = s * (H ** -0.5)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    valid = (kpos >= 0) & (kpos <= q_pos[:, None])
    if window:
        valid = valid & (kpos > q_pos[:, None] - window)
    s = torch.where(valid[:, None, None, :], s,
                    torch.tensor(torch.finfo(torch.float32).min, device=q.device))
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale[..., 0].movedim(-1, 1)[:, :, None, :]
    out = torch.einsum("bngs,bsnh->bngh", p, v_cache.to(torch.float32))
    return out.reshape(B, 1, NQ, H).to(q.dtype)


def ffn_init(gen, cfg, d: int, f: int, dtype=torch.float32, device=None,
             layers: Optional[int] = None) -> dict:
    if cfg.ffn in ("swiglu", "geglu"):
        return {"w_gate": dense_init(gen, d, f, dtype, device, layers),
                "w_up": dense_init(gen, d, f, dtype, device, layers),
                "w_down": dense_init(gen, f, d, dtype, device, layers)}
    return {"w_up": dense_init(gen, d, f, dtype, device, layers),
            "w_down": dense_init(gen, f, d, dtype, device, layers)}


def quant_mode(cfg):
    """(QuantConfig, mode) of a model's block projections: fake
    quantization (quantization-aware training) when the config carries a
    QuantConfig, as in JAX; a packed leaf ignores both."""
    return cfg.quant, ("fake" if cfg.quant else "none")


def ffn_apply(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    q, qm = quant_mode(cfg)

    def lin(a, name):
        return linear(a, params[name], q, qm)

    if cfg.ffn in ("swiglu", "geglu"):
        h = glu(cfg.ffn, lin(x, "w_gate"), lin(x, "w_up"))
    elif cfg.ffn == "relu2":
        h = relu2(lin(x, "w_up"))
    elif cfg.ffn == "gelu":
        h = F.gelu(lin(x, "w_up"), approximate="tanh")
    else:
        raise ValueError(cfg.ffn)
    return lin(h, "w_down")


def glu(kind: str, gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """A gated FFN's hidden rows: silu(gate) * up (swiglu) or tanh-gelu
    (gate) * up (geglu), as JAX's dense and expert FFNs compute them."""
    act = F.silu(gate) if kind == "swiglu" else F.gelu(gate, approximate="tanh")
    return act * up


def relu2(up: torch.Tensor) -> torch.Tensor:
    """The squared-ReLU FFN's hidden rows."""
    return torch.square(torch.relu(up))


def embed_init(gen, vocab: int, d: int, dtype=torch.float32, device=None):
    return normal_init(gen, (vocab, d), 0.02, dtype, device)


def last_token_slice(x: torch.Tensor, lengths) -> torch.Tensor:
    """(B, T, d) → (B, 1, d) at the last real token of each row."""
    if lengths is None:
        return x[:, -1:]
    idx = (torch.as_tensor(lengths, device=x.device).long() - 1).clamp(min=0)
    return x[torch.arange(x.shape[0], device=x.device), idx][:, None]


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, scale: bool = False):
    out = table[ids.long()]
    if scale:
        out = out * (table.shape[1] ** 0.5)
    return out


def logits_head(x: torch.Tensor, table_or_w: torch.Tensor, softcap: float = 0.0,
                transpose: bool = False) -> torch.Tensor:
    """A plain large product, left to torch.matmul (as JAX leaves it to
    XLA), then float32 logits."""
    w = table_or_w.to(x.dtype)
    out = torch.matmul(x, w.T if transpose else w).to(torch.float32)
    if softcap:
        out = softcap * torch.tanh(out / softcap)
    return out


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor):
    """Mean next-token cross-entropy (with z-loss) of (B, T, V) float32
    logits over (B, T) tokens → (loss, {"loss", "aux_loss"}): the training
    loss of the recurrent families (JAX's rwkv6 and griffin
    ``train_loss``), which have no auxiliary loss."""
    loss = cross_entropy(logits[:, :-1], tokens[:, 1:]).mean()
    return loss, {"loss": loss, "aux_loss": torch.zeros((), dtype=torch.float32,
                                                        device=loss.device)}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Token-level cross-entropy with a z-loss; logits float32 (..., V),
    labels (...) integer. Returns the per-token loss."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return loss
