"""Per-layer precision policies: ordered rules mapping parameter paths
to :class:`~repro_torch.core.quant.QuantConfig`.

Port of the policy half of ``repro.core.precision`` (the spec grammar
and path matching). The precision-tier half — plane-truncated policy
views — comes with the tier slice of the port.
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple, Union

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
