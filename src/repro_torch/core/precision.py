"""Per-layer precision policies: ordered rules mapping parameter paths
to :class:`~repro_torch.core.quant.QuantConfig`.

Port of the policy half of ``repro.core.precision`` (the spec grammar
and path matching) and of its precision-tier half: ``PLANE_BITS``,
``parse_tier_token``, ``parse_tier_specs``, ``degrade_order``,
``plane_offset`` and ``truncate_policy_view``, the zero-copy
plane-truncated view of packed serving params that speculative drafts
and per-request tiers are served through.
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Sequence, Tuple, Union

from repro_torch.core.quant import QuantConfig


@dataclasses.dataclass(frozen=True)
class LayerRule:
    """First-match-wins rule: `pattern` is re.search'd against the
    '/'-joined parameter path (e.g. "blocks/wq", "blocks/ffn/w_up")."""

    pattern: str
    cfg: QuantConfig

    def matches(self, path: str) -> bool:
        return re.search(self.pattern, path) is not None


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Ordered per-layer quantization rules + a default config."""

    default: QuantConfig
    rules: Tuple[LayerRule, ...] = ()

    @classmethod
    def uniform(cls, cfg: QuantConfig) -> "PrecisionPolicy":
        return cls(default=cfg)

    def for_path(self, path: str) -> QuantConfig:
        for rule in self.rules:
            if rule.matches(path):
                return rule.cfg
        return self.default

    def with_rule(self, pattern: str, cfg: QuantConfig) -> "PrecisionPolicy":
        return dataclasses.replace(self, rules=self.rules + (LayerRule(pattern, cfg),))

    def describe(self) -> str:
        parts = [f"default={quant_token(self.default)}"]
        parts += [f"{r.pattern}={quant_token(r.cfg)}" for r in self.rules]
        return "; ".join(parts)


def quant_token(cfg: QuantConfig) -> str:
    """Canonical "wXaY[rZZ]" token for a config."""
    s = f"w{cfg.w_bits}a{cfg.a_bits}"
    if cfg.mixed_ratio_8b:
        s += f"r{int(round(cfg.mixed_ratio_8b * 100))}"
    return s


def as_policy(
    quant: Union[None, QuantConfig, PrecisionPolicy]
) -> Optional[PrecisionPolicy]:
    """Normalize the user-facing `quant` argument (None passes through)."""
    if quant is None or isinstance(quant, PrecisionPolicy):
        return quant
    if isinstance(quant, QuantConfig):
        return PrecisionPolicy.uniform(quant)
    raise TypeError(f"expected QuantConfig or PrecisionPolicy, got {type(quant)!r}")


_SPEC_RE = re.compile(r"w(\d)a(\d)(?:r(\d+))?")


def parse_quant_token(token: str) -> QuantConfig:
    """Parse one "wXaY[rZZ]" token (rZZ = ZZ% 8-bit filter group)."""
    m = _SPEC_RE.fullmatch(token)
    if not m:
        raise ValueError(f"bad quant spec {token!r} (expected e.g. w4a8, w4a8r10)")
    return QuantConfig(
        w_bits=int(m.group(1)),
        a_bits=int(m.group(2)),
        mixed_ratio_8b=int(m.group(3)) / 100.0 if m.group(3) else 0.0,
    )


def parse_policy_spec(spec: str) -> PrecisionPolicy:
    """Parse "w4a8;wo=w8a8;ffn/w_up=w2a4r10" into a policy: the token
    without '=' is the default, each `pattern=wXaY[rZZ]` appends a rule."""
    default: Optional[QuantConfig] = None
    rules: List[LayerRule] = []
    for token in filter(None, (t.strip() for t in spec.split(";"))):
        if "=" in token:
            pattern, _, cfg_s = token.rpartition("=")
            rules.append(LayerRule(pattern.strip(), parse_quant_token(cfg_s.strip())))
        else:
            if default is not None:
                raise ValueError(f"duplicate default in policy spec {spec!r}")
            default = parse_quant_token(token)
    if default is None:
        raise ValueError(f"policy spec {spec!r} has no default wXaY token")
    return PrecisionPolicy(default=default, rules=tuple(rules))


# -- precision tiers: plane-truncated views of one packed weight set -------
#
# Weights are stored once as little-endian 2-bit planes
# (``repro_torch.core.bitplane``), and any precision at or below the
# storage width is a *view*: contract only the top planes
# (``PackedWeight.plane_lo``), never copy a byte. Speculative drafts and
# per-request serving tiers both route through :func:`truncate_policy_view`.

PLANE_BITS = 2


def parse_tier_token(spec: Union[str, QuantConfig]) -> QuantConfig:
    """Normalize one tier/draft token ("w4a8" or an already-built
    QuantConfig). Tiers are pure plane truncations of the stored planes,
    so the Table-III mixed 8-bit filter-group ratio ("rZZ") is rejected:
    a filter-group split changes *which channels* are 8-bit, which cannot
    be expressed as a plane subset of the resident codes."""
    cfg = spec if isinstance(spec, QuantConfig) else parse_quant_token(str(spec))
    if cfg.mixed_ratio_8b:
        raise ValueError(
            "a precision tier is a plane truncation of the resident "
            f"weights; a mixed 8-bit filter group ({quant_token(cfg)!r}) "
            "cannot be expressed as a plane subset"
        )
    return cfg


def parse_tier_specs(
    spec: Union[str, Sequence[Union[str, QuantConfig]]]
) -> Tuple[QuantConfig, ...]:
    """Parse a ``--tiers`` value ("w8a8,w4a8,w2a8", or a sequence of
    tokens/QuantConfigs) into an ordered tuple of tier configs. Each
    token goes through :func:`parse_tier_token` (no "rZZ"); duplicates
    are rejected because tier keys name counter buckets and views."""
    if isinstance(spec, str):
        tokens: Sequence = [t.strip() for t in spec.split(",") if t.strip()]
    else:
        tokens = list(spec)
    if not tokens:
        raise ValueError(f"empty tier spec {spec!r}")
    out: List[QuantConfig] = []
    seen = set()
    for tok in tokens:
        cfg = parse_tier_token(tok)
        key = quant_token(cfg)
        if key in seen:
            raise ValueError(f"duplicate precision tier {key!r} in {spec!r}")
        seen.add(key)
        out.append(cfg)
    return tuple(out)


def degrade_order(
    tiers: Union[Sequence[QuantConfig], Sequence[str]]
) -> Tuple[QuantConfig, ...]:
    """Tiers sorted quality-descending — the order graceful degradation
    walks under persistent pool pressure: widest weight planes first,
    activations as tiebreak. The last entry is the floor a degraded
    admission lands on, served through the same
    :func:`truncate_policy_view` as any requested tier."""
    cfgs = [parse_tier_token(t) for t in tiers]
    if not cfgs:
        raise ValueError("degrade_order needs at least one tier")
    return tuple(sorted(cfgs, key=lambda c: (-c.w_bits, -c.a_bits)))


def plane_offset(target_bits: int, view_bits: int) -> int:
    """Number of low 2-bit planes to drop so `target_bits` storage serves
    a `view_bits` contraction. 0 when the leaf is already at or below the
    view precision (nothing to truncate — the view runs it as-is)."""
    if view_bits >= target_bits:
        return 0
    drop = target_bits - view_bits
    if drop % PLANE_BITS:
        raise ValueError(
            f"cannot serve w{target_bits} storage at w{view_bits}: the "
            f"precision gap must be a whole number of {PLANE_BITS}-bit "
            "planes"
        )
    lo = drop // PLANE_BITS
    if PLANE_BITS * lo >= target_bits:
        raise ValueError(
            f"plane_lo={lo} leaves no planes of a w{target_bits} weight"
        )
    return lo


def truncate_policy_view(params, tier: Union[str, QuantConfig], *,
                         require_truncation: bool = False) -> Tuple[object, int]:
    """`tier`-precision view of packed serving params: every PackedWeight
    leaf stored above the tier's weight width gets ``plane_lo`` set (a
    ``dataclasses.replace``) so its matmuls contract only the top planes.
    Returns ``(view, truncated)``.

    The view is *zero-copy*: every tensor (packed bytes, 8-bit group,
    scales, and every unpacked leaf) is the served params' own object, so
    a view costs no device memory. A tier that truncates nothing returns
    ``params`` itself. A tier is a per-leaf *cap*: leaves already stored
    at or below the tier width serve as stored; a Table III leaf's 8-bit
    group is shifted with its low group (its ``plane_lo`` comes from the
    low group's width, as in ``repro``).

    Raises when the params carry no packed leaves (serve with a quant
    policy first), when the precision gap of some leaf is not a whole
    number of planes, or when the tier's activation precision disagrees
    with a truncating leaf's — plane truncation only lowers weight bits.
    With ``require_truncation`` (the speculative-draft contract) a view
    that truncates no leaf is also an error."""
    from repro_torch.core.quantized_linear import PackedWeight

    cfg = parse_tier_token(tier)
    counts = {"packed": 0, "truncated": 0}

    def view(leaf):
        if isinstance(leaf, dict):
            return {k: view(v) for k, v in leaf.items()}
        if not isinstance(leaf, PackedWeight):
            return leaf
        counts["packed"] += 1
        lo = plane_offset(leaf.bits, cfg.w_bits)
        if lo == 0:
            return leaf
        if leaf.a_bits != cfg.a_bits:
            raise ValueError(
                f"tier w{cfg.w_bits}a{cfg.a_bits} changes the "
                f"activation precision of a w{leaf.bits}a{leaf.a_bits} "
                "leaf; plane truncation only lowers weight bits — use "
                f"a{leaf.a_bits} in the tier spec"
            )
        counts["truncated"] += 1
        return dataclasses.replace(leaf, plane_lo=lo)

    view_params = view(params)
    if not counts["packed"]:
        raise ValueError(
            "precision-tier views need bit-plane-packed weights: "
            "serve with a quant policy (e.g. --quant w8a8) so the view "
            "can truncate the resident planes"
        )
    if not counts["truncated"]:
        if require_truncation:
            raise ValueError(
                f"draft policy w{cfg.w_bits} truncates no leaf: every "
                "packed weight is already at or below the draft precision"
            )
        return params, 0
    return view_params, counts["truncated"]
