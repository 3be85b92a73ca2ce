"""AdamW and its cosine schedule: port of ``repro.optim.adamw``.

Mixed-precision discipline as in JAX: both moments are float32 whatever
the parameters' dtype; the update is computed in float32 and cast back;
weight decay only on matrices. One departure, for memory: ``apply_updates``
writes the new parameters and moments into the given tensors (JAX
returns new arrays and donates the old ones), a stacked leaf a slice of
layers at a time, so a full-width step holds no second copy of the
float32 moments. The arithmetic is JAX's, op by op.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import tree as tr
from repro_torch.configs.base import TrainConfig

# Elements of a leaf updated at once: float32 temporaries of a larger
# leaf stay this size (a stacked leaf goes a slice of its leading dims at
# a time; the update is elementwise, so the values are the same).
_UPDATE_ELEMS = 1 << 25


class AdamState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    mu: dict             # first moment  (float32, the params' tree)
    nu: dict             # second moment (float32)


def init_state(params) -> AdamState:
    zeros = tr.map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
    dev = next(iter(tr.leaves(params)), torch.zeros(())).device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev), mu=zeros,
                     nu=tr.map_tree(torch.clone, zeros))


def cosine_schedule(tc: TrainConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup to ``tc.lr``, then a cosine down to ``lr_min_ratio``
    of it; float32 of the step (an int or an int tensor)."""
    def lr(step):
        step = torch.as_tensor(step)
        warm = torch.clamp(step / max(tc.warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - tc.warmup_steps)
                           / max(tc.total_steps - tc.warmup_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        floor = tc.lr_min_ratio
        return tc.lr * warm * (floor + (1 - floor) * cos)

    return lr


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, over leaves in JAX's order, of each leaf's sum of
    squares in float32."""
    total = 0
    for leaf in tr.leaves(tree):
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most `max_norm`, the norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tr.map_tree(lambda g: g * scale.to(g.dtype), grads), norm


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 sqrt, correctly rounded. The card's (and XLA's) is already;
    PyTorch's vectorized float32 sqrt on the CPU is off by one ulp on some
    inputs, so there it is taken in float64 and rounded once (exact for a
    float32 argument): the same bits either way."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _is_matrix(p: torch.Tensor) -> bool:
    return p.ndim >= 2


def _slices(shape):
    """Indices over the leading dims of a leaf of `shape` covering at most
    _UPDATE_ELEMS elements each (the whole leaf, ``...``, for a small one
    or a scalar). Where one index of the first dim is larger (an MoE
    expert leaf of one or two layers, (L, E, d, f)), each index of it is
    cut along the next dims in turn."""
    n = math.prod(shape)
    if not shape or n <= _UPDATE_ELEMS:
        yield ...
        return
    inner = n // shape[0]
    if inner > _UPDATE_ELEMS:
        for i in range(shape[0]):
            for rest in _slices(shape[1:]):
                yield (i, rest) if rest is ... else (i, *rest)
        return
    rows = max(1, _UPDATE_ELEMS // inner)
    for i in range(0, shape[0], rows):
        yield (slice(i, i + rows),)


@torch.no_grad()
def apply_updates(params, grads, state: AdamState, tc: TrainConfig,
                  lr_fn: Optional[Callable] = None):
    """One AdamW step → (params, AdamState, lr). Weight decay only on
    matrices. The returned params and moments are the given tensors,
    updated in place."""
    lr_fn = lr_fn or cosine_schedule(tc)
    step = state.step + 1
    lr = lr_fn(step).to(torch.float32)
    b1, b2, eps = tc.beta1, tc.beta2, tc.eps
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=step.device), stepf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=step.device), stepf)

    def upd(p, g, m, v):
        for s in _slices(tuple(p.shape)):
            gf = g[s].to(torch.float32)
            m2 = b1 * m[s] + (1 - b1) * gf
            v2 = b2 * v[s] + (1 - b2) * torch.square(gf)
            mhat = m2 / c1
            vhat = v2 / c2
            delta = mhat / (_sqrt(vhat) + eps)
            if tc.weight_decay and _is_matrix(p):
                delta = delta + tc.weight_decay * p[s].to(torch.float32)
            p[s] = (p[s].to(torch.float32) - lr * delta).to(p.dtype)
            m[s] = m2
            v[s] = v2

    for p, g, m, v in zip(tr.leaves(params), tr.leaves(grads), tr.leaves(state.mu),
                          tr.leaves(state.nu)):
        upd(p, g, m, v)
    return params, AdamState(step=step, mu=state.mu, nu=state.nu), lr
