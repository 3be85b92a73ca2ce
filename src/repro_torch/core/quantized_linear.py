"""QuantizedLinear — the paper's technique as packed-weight PyTorch layers.

Port of ``repro.core.quantized_linear``. A :class:`PackedWeight` stores
2/4/8-bit weight codes packed along K in int8 words
(:mod:`repro_torch.core.bitplane`) plus per-output-channel scales, and
carries the activation precision its layer was packed for. Every packed
matmul runs hand-written integer kernels on the packed bytes themselves:
the fused quantize→integer-matmul kernel
(``kernels.ops.fused_quantize_matmul``) — the route ``repro`` takes with
``use_kernel=True`` — or, for a Table III mixed-group leaf, one shared
row quantization and one integer matmul per filter group, each storing
its dequantized columns of one output (``kernels.ops.mixed_group_matmul``).
The JAX model's dequant formula computes the same product in floats.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Union

import torch

from repro_torch.core import bitplane
from repro_torch.core.quant import (QuantConfig, fake_quant, quantize_tensor,
                                    quantize_weights_mixed)


@dataclasses.dataclass
class PackedWeight:
    """A packed sub-byte weight matrix + dequant scales.

    packed : int8, (K * bits // 8, N) — or (L, K * bits // 8, N) for a
             stacked scan-over-layers leaf; packed along K.
    scale  : (1, N) (or (L, 1, N)) per-output-channel float32 scales.
    bits   : 2/4/8.
    n8     : Table III mixing — the leading n8 output channels are 8-bit
             codes in `packed8` ((K, n8) or (L, K, n8)). 0 disables it.
    a_bits / act_signed : the activation precision the layer was packed for.
    plane_lo : contract only planes [plane_lo:] of the codes (a view-level
             precision drop; the weight scale regains 4**plane_lo).
    """

    packed: torch.Tensor
    scale: torch.Tensor
    bits: int
    k: int
    n8: int = 0
    packed8: Optional[torch.Tensor] = None
    a_bits: int = 8
    act_signed: bool = True
    plane_lo: int = 0

    @property
    def shape(self):
        return (self.k, self.scale.shape[-1])

    def layer(self, i: int) -> "PackedWeight":
        """Layer `i` of a stacked leaf (views, no copy)."""
        return dataclasses.replace(
            self, packed=self.packed[i], scale=self.scale[i],
            packed8=None if self.packed8 is None else self.packed8[i])

    def hbm_bytes(self) -> int:
        n_low = self.shape[1] - self.n8
        b = self.k * n_low * self.bits // 8 + self.k * self.n8
        return b + self.scale.numel() * 4


def pack_weight(w: torch.Tensor, cfg: QuantConfig) -> PackedWeight:
    """Quantize + pack a dense (K, N) weight matrix for serving."""
    if w.ndim != 2:
        raise ValueError(f"pack_weight expects (K, N), got {tuple(w.shape)}")
    k, n = w.shape
    w32 = w.to(torch.float32)
    ab, asg = cfg.a_bits, cfg.act_signed
    if cfg.mixed_ratio_8b > 0.0 and cfg.w_bits != 8:
        q, s, n8 = quantize_weights_mixed(w32, cfg)
        if n8 == n:
            return PackedWeight(q.to(torch.int8), s.reshape(1, n), 8, k, 0,
                                None, ab, asg)
        q8, ql = q[:, :n8], q[:, n8:]
        pk = bitplane.pack_weights(ql, cfg.w_bits, axis=0)
        return PackedWeight(pk, s.reshape(1, n), cfg.w_bits, k, n8,
                            q8.to(torch.int8).contiguous(), ab, asg)
    q, s = quantize_tensor(w32, cfg.w_bits, True,
                           axis=1 if cfg.per_channel else None)
    pk = bitplane.pack_weights(q, cfg.w_bits, axis=0).contiguous()
    s = s.to(torch.float32).reshape(1, -1).expand(1, n).contiguous()
    return PackedWeight(pk, s, cfg.w_bits, k, 0, None, ab, asg)


def _stack(pws) -> PackedWeight:
    first = pws[0]
    return dataclasses.replace(
        first,
        packed=torch.stack([p.packed for p in pws]),
        scale=torch.stack([p.scale for p in pws]),
        packed8=(None if first.packed8 is None
                 else torch.stack([p.packed8 for p in pws])))


def unpack_weight(pw: PackedWeight, *, apply_plane_lo: bool = True) -> torch.Tensor:
    """Dense int32 codes (K, N) of a 2-D leaf. A ``plane_lo`` view is
    applied by arithmetic shift unless ``apply_plane_lo=False``."""
    ql = bitplane.unpack_weights(pw.packed, pw.bits, axis=0)
    if pw.n8:
        ql = torch.cat([pw.packed8.to(torch.int32), ql], dim=1)
    if apply_plane_lo and pw.plane_lo:
        ql = ql >> (2 * pw.plane_lo)
    return ql


def dequantize_weight(pw: PackedWeight, dtype=torch.float32) -> torch.Tensor:
    # Truncated codes lose 2·plane_lo low bits, so one code unit is worth
    # 4**plane_lo original LSBs — the scale regains that factor.
    scale = pw.scale * (1 << (2 * pw.plane_lo)) if pw.plane_lo else pw.scale
    return (unpack_weight(pw).to(torch.float32) * scale).to(dtype)


def qmatmul(x: torch.Tensor, w: Union[torch.Tensor, PackedWeight],
            cfg: Optional[QuantConfig] = None, mode: str = "none") -> torch.Tensor:
    """x (..., K) times a (K, N) float weight or a PackedWeight.

    ``mode="fake"`` is quantization-aware training: x fake-quantized per
    tensor at ``cfg.a_bits``, w per output channel (or per tensor) at
    ``cfg.w_bits``, both with the straight-through gradient, then their
    product through ``ops.dense_matmul`` (``xq @ wq`` in JAX)."""
    if isinstance(w, PackedWeight):
        return _serve_matmul(x, w, cfg)
    if mode == "none" or cfg is None:
        return x @ w.to(x.dtype)
    if mode == "fake":
        from repro_torch.kernels import ops

        xq = fake_quant(x, cfg.a_bits, cfg.act_signed)
        wq = fake_quant(w, cfg.w_bits, True,
                        axis=w.ndim - 1 if cfg.per_channel else None)
        return ops.dense_matmul(xq, wq)
    raise ValueError(f"unknown qmatmul mode {mode!r}")


def _serve_matmul(x: torch.Tensor, pw: PackedWeight,
                  cfg: Optional[QuantConfig]) -> torch.Tensor:
    """Packed-weight matmul, ``(acc · xs) · ws`` per element in that order,
    then one rounding to x's dtype.

    A Table III leaf (``n8 > 0``) with signed activations and no plane
    truncation — the case ``repro.kernels.ops.mixed_group_matmul`` covers
    — runs ``ops.mixed_group_matmul``: the rows are quantized once and
    each filter group has its own integer matmul, the dequant in its
    store (on the card one row pass and two matmul launches at decode).
    Every other leaf runs
    ``ops.packed_matmul``, the fused quantize→integer-matmul kernel (per-
    row activation scales, exact int32 accumulation against the packed
    codes, the dequant in its store); an unsigned or plane-truncated Table
    III leaf runs it once per group on the same row scales, each group
    writing its columns of one output. Either way each element is the
    product ``unpack_weight`` feeds the JAX kernel."""
    from repro_torch.kernels import ops

    a_bits = cfg.a_bits if cfg is not None else pw.a_bits
    act_signed = cfg.act_signed if cfg is not None else pw.act_signed
    lead = x.shape[:-1]
    k = x.shape[-1]
    if k != pw.k:
        raise ValueError(f"K mismatch: x has {k}, weight has {pw.k}")
    x2 = x.reshape(-1, k)
    if pw.n8 and act_signed and not pw.plane_lo:
        y = ops.mixed_group_matmul(x2, pw.packed8, pw.packed, pw.scale[..., :pw.n8],
                                   pw.scale[..., pw.n8:], w_bits=pw.bits,
                                   a_bits=a_bits)
        return y.reshape(*lead, -1)
    y = ops.packed_matmul(x2, pw.packed, pw.scale[..., pw.n8:], w_bits=pw.bits,
                          a_bits=a_bits, act_signed=act_signed, w_plane_lo=pw.plane_lo,
                          packed8=pw.packed8 if pw.n8 else None,
                          scale8=pw.scale[..., :pw.n8] if pw.n8 else None)
    return y.reshape(*lead, -1)


_NO_PACK = ("embed", "head", "patch_proj", "frame_proj", "router", "u",
            "decay_base", "gn_scale", "gn_bias", "conv_w", "lambda_p")


def _walk(tree, fn, prefix=""):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def quantize_params_for_serving(params, cfg, min_size: int = 1 << 16):
    """Replace 2-D linear weights (and stacked (L, K, N) weights, packed
    per layer) with PackedWeight leaves. `cfg` is a QuantConfig or a
    PrecisionPolicy matched against '/'-joined parameter paths — the same
    paths ``repro`` matches, so one policy packs the same leaves in both
    packages. Embeddings/heads, frontends, routers, small vectors and
    anything below `min_size` elements stay full precision."""
    from repro_torch.core.precision import as_policy

    policy = as_policy(cfg)

    def maybe_pack(pstr, leaf):
        if any(re.search(rf"(^|/){re.escape(n)}$", pstr) for n in _NO_PACK):
            return leaf
        if (not isinstance(leaf, torch.Tensor)
                or not leaf.is_floating_point() or leaf.numel() < min_size):
            return leaf
        leaf_cfg = policy.for_path(pstr)
        if leaf.ndim == 2 and leaf.shape[0] % 16 == 0 and min(leaf.shape) >= 128:
            return pack_weight(leaf, leaf_cfg)
        if leaf.ndim == 3 and leaf.shape[1] % 16 == 0 and leaf.shape[2] >= 16:
            return _stack([pack_weight(w, leaf_cfg) for w in leaf])
        return leaf

    return _walk(params, maybe_pack)


def packed_leaves(params):
    """Every PackedWeight leaf of a nested parameter dict."""
    out = []
    _walk(params, lambda _, leaf: out.append(leaf)
          if isinstance(leaf, PackedWeight) else None)
    return out


def packed_weight_bytes(params) -> int:
    """Total packed GEMM weight bytes resident in `params`."""
    total = 0
    for leaf in packed_leaves(params):
        total += leaf.packed.numel()
        if leaf.packed8 is not None:
            total += leaf.packed8.numel()
    return total
