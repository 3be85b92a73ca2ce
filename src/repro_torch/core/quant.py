"""Uniform symmetric quantization (paper §V-A) with MAE-optimal clipping.

Port of ``repro.core.quant``: the same configs and the same elementwise
arithmetic in float32, so weight codes and scales are bitwise those of
the JAX package (held by ``tests/test_torch_core.py``). ``fake_quant``
carries JAX's straight-through gradient (its ``custom_vjp``) as a
``torch.autograd.Function``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

WEIGHT_BITS = (2, 4, 8)
ACT_BITS = tuple(range(2, 9))

# The 32 clipping fractions of the MAE search, bitwise those of
# ``jnp.linspace(0.35, 1.0, 32)`` (float32). NumPy's and PyTorch's
# linspace round differently in the last bit on 9 of them, and a
# fraction one ULP off picks a different scale on some channels.
_FRAC_BITS = np.array([
    0x3eb33333, 0x3ebdef7c, 0x3ec8abc4, 0x3ed3680d, 0x3ede2456, 0x3ee8e09f,
    0x3ef39ce7, 0x3efe592f, 0x3f048abc, 0x3f09e8e1, 0x3f0f4705, 0x3f14a529,
    0x3f1a034e, 0x3f1f6172, 0x3f24bf96, 0x3f2a1dba, 0x3f2f7bdf, 0x3f34da03,
    0x3f3a3828, 0x3f3f964c, 0x3f44f470, 0x3f4a5295, 0x3f4fb0b9, 0x3f550edd,
    0x3f5a6d01, 0x3f5fcb26, 0x3f65294a, 0x3f6a876e, 0x3f6fe593, 0x3f7543b7,
    0x3f7aa1db, 0x3f800000], np.uint32)
MAE_FRACS = _FRAC_BITS.view(np.float32)


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Quantization configuration for one linear layer (or a whole model);
    see ``repro.core.quant.QuantConfig``."""

    w_bits: int = 8
    a_bits: int = 8
    per_channel: bool = True
    mixed_ratio_8b: float = 0.0
    symmetric: bool = True
    act_signed: bool = True

    def __post_init__(self):
        if self.w_bits not in WEIGHT_BITS:
            raise ValueError(f"w_bits must be one of {WEIGHT_BITS}, got {self.w_bits}")
        if self.a_bits not in ACT_BITS:
            raise ValueError(f"a_bits must be in {ACT_BITS}, got {self.a_bits}")
        if not (0.0 <= self.mixed_ratio_8b <= 1.0):
            raise ValueError("mixed_ratio_8b must be in [0, 1]")


def qmax(bits: int, signed: bool = True) -> int:
    return (1 << (bits - 1)) - 1 if signed else (1 << bits) - 1


def qmin(bits: int, signed: bool = True) -> int:
    return -(1 << (bits - 1)) if signed else 0


def reciprocal_f32(n: int) -> float:
    """float32 ``1/n``. The jitted JAX code turns ``absmax / n`` into
    ``absmax * (1/n)`` (XLA strength reduction), which differs from the
    true quotient by one ULP on some inputs; every per-token scale in the
    port (activation rows, int8 KV) uses this form so its bytes match."""
    return float(np.float32(1.0) / np.float32(n))


def quantize(x: torch.Tensor, scale: torch.Tensor, bits: int,
             signed: bool = True) -> torch.Tensor:
    """round-half-even(x / scale) clipped to the code range, as int32."""
    inv = torch.where(scale > 0, 1.0 / scale, torch.zeros_like(scale))
    q = torch.round(x * inv)
    return torch.clamp(q, qmin(bits, signed), qmax(bits, signed)).to(torch.int32)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(scale.dtype) * scale


def _reduce_axes(x: torch.Tensor, axis: int):
    return tuple(i for i in range(x.ndim) if i != axis)


_XLA_WINDOW = 32
_MAE_ELEMS = 1 << 26     # candidate elements evaluated at once (256 MB in float32)


def _sum_in_order(t: torch.Tensor, k: int) -> torch.Tensor:
    """Sum over the last `k` dims of `t`, one element at a time in
    row-major order, starting from 0."""
    flat = t.reshape(*t.shape[:t.ndim - k], -1)
    acc = torch.zeros(flat.shape[:-1], dtype=t.dtype, device=t.device)
    for i in range(flat.shape[-1]):
        acc = acc + flat[..., i]
    return acc


def xla_mean(t: torch.Tensor, dims) -> torch.Tensor:
    """``jnp.mean(t, axis=dims)`` in XLA-CPU's summation order, bitwise.

    XLA's tree-reduction rewrite (read from its optimized HLO and LLVM IR
    for these reductions) turns a reduction over any dim longer than 32
    into a reduce-window of 32 along every reduced dim (a dim of at most
    32 is one window), zero-padded "same" style (the lower pad is half
    the total, rounded down), and repeats that on the result until every
    reduced dim is at most 32. Each window, and then the last reduce, is
    a sequential sum from 0 in row-major order of its elements. The mean
    is that sum times float32 1/n."""
    dims = sorted(d % t.ndim for d in dims)
    n = 1
    for d in dims:
        n *= t.shape[d]
    keep = [d for d in range(t.ndim) if d not in dims]
    t = t.permute(*keep, *dims)
    k, lead = len(dims), t.ndim - len(dims)
    while any(s > _XLA_WINDOW for s in t.shape[lead:]):
        pads, shape = [], list(t.shape[:lead])
        for s in t.shape[lead:]:
            w = min(s, _XLA_WINDOW)
            out = -(-s // w)
            total = out * w - s
            pads.append((total // 2, total - total // 2))
            shape += [out, w]
        flat_pad = [p for lo_hi in reversed(pads) for p in lo_hi]
        t = torch.nn.functional.pad(t, flat_pad).reshape(shape)
        outs = [lead + 2 * i for i in range(k)]
        t = _sum_in_order(t.permute(*range(lead), *outs,
                                    *[o + 1 for o in outs]), k)
    return _sum_in_order(t, k) * reciprocal_f32(n)


def mae_optimal_scale(x: torch.Tensor, bits: int, signed: bool = True,
                      axis: Optional[int] = None) -> torch.Tensor:
    """Clipping-threshold search minimizing the mean absolute error over
    the 32 fractions ``MAE_FRACS`` of |x|max (per tensor, or per channel
    along `axis`). Candidates go in groups of at most ``_MAE_ELEMS``
    elements: a full-size weight would otherwise hold 32 copies of
    itself. The mean sums in XLA-CPU's order (:func:`xla_mean`):
    near-tied candidates would otherwise flip."""
    if axis is None:
        absmax = x.abs().max()
        red = tuple(range(x.ndim))
    else:
        red = _reduce_axes(x, axis)
        absmax = x.abs().amax(dim=red, keepdim=True)
    q_hi = qmax(bits, signed)
    fracs = torch.from_numpy(MAE_FRACS).to(x.device)
    step = max(1, min(len(MAE_FRACS), _MAE_ELEMS // max(x.numel(), 1)))
    errs = []
    for i in range(0, len(MAE_FRACS), step):
        f = fracs[i:i + step].reshape(-1, *[1] * x.ndim)
        scale = absmax * f / q_hi                    # (c, ...) candidates
        err = (x - dequantize(quantize(x, scale, bits, signed), scale)).abs()
        errs.append(xla_mean(err, [d + 1 for d in red]))
    best = torch.argmin(torch.cat(errs), dim=0)      # the first minimum
    return absmax * fracs[best] / q_hi


def quantize_tensor(x: torch.Tensor, bits: int, signed: bool = True,
                    axis: Optional[int] = None,
                    optimal_clip: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shot (codes, scale) quantization of a tensor."""
    if optimal_clip:
        scale = mae_optimal_scale(x, bits, signed, axis=axis)
    else:
        if axis is None:
            absmax = x.abs().max()
        else:
            absmax = x.abs().amax(dim=_reduce_axes(x, axis), keepdim=True)
        scale = absmax / qmax(bits, signed)
    return quantize(x, scale, bits, signed), scale


class _FakeQuant(torch.autograd.Function):
    """JAX's ``_fake_quant_fwd`` / ``_fake_quant_bwd``: the forward saves
    the clip mask ``|x| <= scale·qmax`` (in x's dtype), the backward is
    ``g * mask``."""

    @staticmethod
    def forward(ctx, x, bits, signed, axis):
        q, scale = quantize_tensor(x, bits, signed, axis=axis, optimal_clip=False)
        thr = scale * qmax(bits, signed)
        ctx.save_for_backward((x.abs() <= thr).to(x.dtype))
        return dequantize(q, scale).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return g * mask, None, None, None


def fake_quant(x: torch.Tensor, bits: int, signed: bool = True,
               axis: Optional[int] = None) -> torch.Tensor:
    """Quantize-dequantize with a straight-through estimator.

    Forward: absmax symmetric quant-dequant (statistics computed on the
    fly). Backward: identity inside the clip range, zero outside. Without
    a gradient to carry, the forward runs alone."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _FakeQuant.apply(x, bits, signed, axis)
    q, scale = quantize_tensor(x, bits, signed, axis=axis, optimal_clip=False)
    return dequantize(q, scale).to(x.dtype)


def split_filter_groups(n_out: int, ratio_8b: float) -> Tuple[int, int]:
    """Table III intra-layer split: (n_8bit, n_lowbit) output channels."""
    n8 = int(round(n_out * ratio_8b))
    if 0 < ratio_8b:
        n8 = max(8, n8)
        n8 = min(n_out, ((n8 + 7) // 8) * 8)
    return n8, n_out - n8


def quantize_weights_mixed(w: torch.Tensor, cfg: QuantConfig
                           ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Intra-layer mixed quantization of a (..., n_out) weight matrix:
    (codes int32, scale, n8) with the first n8 output channels at 8 bits."""
    n_out = w.shape[-1]
    n8, _ = split_filter_groups(n_out, cfg.mixed_ratio_8b)
    axis = w.ndim - 1 if cfg.per_channel else None
    if n8 == 0:
        q, s = quantize_tensor(w, cfg.w_bits, True, axis=axis)
        return q, s, 0
    if n8 == n_out:
        q, s = quantize_tensor(w, 8, True, axis=axis)
        return q, s, n8
    q8, s8 = quantize_tensor(w[..., :n8], 8, True, axis=axis)
    ql, sl = quantize_tensor(w[..., n8:], cfg.w_bits, True, axis=axis)
    q = torch.cat([q8, ql], dim=-1)
    if axis is None:
        s8 = s8.reshape((1,) * (w.ndim - 1) + (1,)).expand(
            (1,) * (w.ndim - 1) + (n8,))
        sl = sl.reshape((1,) * (w.ndim - 1) + (1,)).expand(
            (1,) * (w.ndim - 1) + (n_out - n8,))
    return q, torch.cat([s8, sl], dim=-1), n8
