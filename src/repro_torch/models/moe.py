"""Mixture-of-Experts FFN with capacity-bounded, sort-based dispatch.

Port of ``repro.models.moe``: ``init_moe`` and ``moe_apply``, step by
step. The router runs in float32; each token picks its top-k experts
(ties to the lower index, as ``jax.lax.top_k``), the weights renormalized
when k > 1; the assignments are sorted by expert (a stable sort), each
expert takes the first ``cap`` of its assignments into a fixed (E, cap,
d) buffer and the rest are dropped (Switch-style); the experts' FFNs run
on the buffer; each token's output is its kept slots' outputs times
their gate weights. The Switch load-balance loss ``E·Σ me·ce`` comes out
beside it: training adds 0.01 of it to the loss (``transformer.
train_loss``), serving discards it. Under autograd the gradient flows as
JAX's does: into the router through the softmax, the top-k values, the
k > 1 renormalisation and ``me`` (not through ``ce``, a one-hot count);
into the tokens through the dispatch's gather and the combine; into the
experts through ``ops.expert_matmul`` (on the card its autograd Function,
whose backward is the ``expert_matmul_bwd`` kernel).

Every product of the expert FFN runs on ``ops.expert_matmul`` with each
expert's kept count (read on the device, no host sync): on the card the
grouped kernel reads only the experts with rows and gives each kept row
``dense_matmul``'s bits, whatever the capacity. Departures from JAX, none
changing a value: the combine gathers each token's k slots through the
inverse of the sort and adds them from zero in order k = 0, 1, … where
JAX scatter-adds in sorted order (from zero, a sum of k ≤ 2 terms is the
same in either order), so it needs no atomics; the per-expert counts come
from a comparison, not ``bincount`` (which reads its maximum on the host
on CUDA).

``moe_apply_shardmap`` (JAX's expert-parallel dispatch under a device
mesh, which falls back to ``moe_apply`` on one device) is not ported: it
belongs with the multi-card tooling, ROADMAP Queue 1 item 4.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common as cm


def expert_group(cfg: ModelConfig) -> str:
    """The key of the expert leaves: ``experts_ep`` (expert-parallel) or
    ``experts_tp`` (hidden dim split), after JAX's ``moe_shard``."""
    return "experts_ep" if cfg.moe_shard == "expert" else "experts_tp"


def _glu(cfg: ModelConfig) -> bool:
    return cfg.ffn in ("swiglu", "geglu")


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype, device, layers: int) -> dict:
    """Stacked MoE params of `layers` layers in JAX's layout: ``router``
    (L, d, E) float32 and the expert leaves (L, E, d, f) / (L, E, f, d) in
    `dtype` under :func:`expert_group` (``w_gate`` only for a GLU FFN),
    each N(0, 1/d_in)."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.moe_experts

    def stack(din, dout):
        return cm.normal_init(gen, (layers, E, din, dout), (1.0 / din) ** 0.5, dtype, device)

    experts = {"w_up": stack(d, f), "w_down": stack(f, d)}
    if _glu(cfg):
        experts["w_gate"] = stack(d, f)
    router = cm.dense_init(gen, d, E, torch.float32, device, layers)
    return {"router": router, expert_group(cfg): experts}


def capacity(n_tokens: int, top_k: int, experts: int, factor: float) -> int:
    """Rows of each expert's buffer: JAX's ``max(8, round_up(int(ceil(N·k
    / E) · factor), 8))``, ``int`` truncating as there."""
    cap = int(-(-n_tokens * top_k // experts) * factor)
    return max(8, -(-cap // 8) * 8)


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest of each row, a tie to the lower
    index (``jax.lax.top_k``'s rule): the first k of a stable descending
    sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


@dataclasses.dataclass
class Routing:
    """One call's routing. Flat assignments are token-major ((N·k,), token
    t's j-th choice at t·k + j); ``order`` sorts them by expert (stable),
    ``keep`` / ``dest`` are in sorted order (``dest`` = e·cap + position,
    E·cap where dropped); ``counts`` (E,) the kept rows of each expert."""

    gate_w: torch.Tensor      # (N, k) float32
    gate_idx: torch.Tensor    # (N, k) int64
    order: torch.Tensor       # (N·k,)
    keep: torch.Tensor        # (N·k,) bool
    dest: torch.Tensor        # (N·k,)
    counts: torch.Tensor      # (E,) int32, min(assignments, cap)
    cap: int
    aux: torch.Tensor         # () float32


def route(xt: torch.Tensor, router: torch.Tensor, cfg: ModelConfig) -> Routing:
    """Router, top-k, the aux loss and the sort-based dispatch plan of
    tokens xt (N, d), as JAX's ``moe_apply`` computes them."""
    N = xt.shape[0]
    E, K = cfg.moe_experts, cfg.moe_top_k
    dev = xt.device
    logits = xt.to(torch.float32) @ router.to(torch.float32)          # (N, E)
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = top_k(probs, K)
    if K > 1:
        gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True)
    experts = torch.arange(E, device=dev)
    me = probs.mean(dim=0)
    ce = (gate_idx[:, :1] == experts).to(torch.float32).mean(dim=0)
    aux = E * (me * ce).sum()
    cap = capacity(N, K, E, cfg.moe_capacity_factor)
    flat_expert = gate_idx.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    se = flat_expert[order]
    assigned = (flat_expert[:, None] == experts).sum(dim=0)             # (E,)
    starts = torch.cumsum(assigned, 0) - assigned
    pos = torch.arange(N * K, device=dev) - starts[se]
    keep = pos < cap
    dest = torch.where(keep, se * cap + pos, torch.full_like(se, E * cap))
    return Routing(gate_w=gate_w, gate_idx=gate_idx, order=order, keep=keep, dest=dest,
                   counts=assigned.clamp(max=cap).to(torch.int32), cap=cap,
                   aux=aux.to(torch.float32))


def _expert_ffn(experts: dict, xe: torch.Tensor, counts: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """xe (E, cap, d) → (E, cap, d): each expert's FFN on its rows, every
    product on ``ops.expert_matmul`` (rows past an expert's count stay
    zero)."""
    def mm(a, name):
        return ops.expert_matmul(a, experts[name], counts)

    if _glu(cfg):
        h = cm.glu(cfg.ffn, mm(xe, "w_gate"), mm(xe, "w_up"))
    else:
        h = cm.relu2(mm(xe, "w_up"))
    return mm(h, "w_down")


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor,
                                                                         torch.Tensor]:
    """x (B, T, d) → (out (B, T, d) in x's dtype, aux loss () float32).
    `params` is one layer's ``{"router", experts_ep | experts_tp}``."""
    B, T, d = x.shape
    E, K = cfg.moe_experts, cfg.moe_top_k
    N = B * T
    xt = x.reshape(N, d)
    r = route(xt, params["router"], cfg)
    st = r.order // K                                  # the sorted slots' tokens
    buf = x.new_zeros((E * r.cap + 1, d))              # the last row takes the drops
    buf[r.dest] = xt[st]
    xe = buf[:E * r.cap].view(E, r.cap, d)
    ye = _expert_ffn(params[expert_group(cfg)], xe, r.counts, cfg)
    ybuf = ye.reshape(E * r.cap, d)
    sg = r.gate_w.reshape(-1)[r.order]
    gathered = ybuf[torch.where(r.keep, r.dest, torch.zeros_like(r.dest))]
    gathered = gathered * r.keep[:, None].to(x.dtype) * sg[:, None].to(x.dtype)
    # Back to token-major order, then each token's k slots summed from zero.
    inv = torch.empty_like(r.order)
    inv[r.order] = torch.arange(N * K, device=x.device)
    per_token = gathered[inv].view(N, K, d)
    out = x.new_zeros((N, d))
    for j in range(K):
        out = out + per_token[:, j]
    return out.reshape(B, T, d), r.aux
