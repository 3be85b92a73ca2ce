"""Seeded fault injection for the serving stack.

Port of ``repro.serving.chaos`` (numpy only; the same streams, so a seed
fires the same schedule for the same visits in either package). A
:class:`FaultInjector` is handed to :class:`~repro_torch.serving.scheduler.
ContinuousScheduler` (``chaos=``, CLI ``--chaos-seed``) and consulted at
four seams, each of which the scheduler survives by degrading ONE request
or ONE call, never the engine loop:

  ``alloc``     admission's pool reservation "fails" (treated exactly like
                a pool-full step: the request waits, bypass and preemption
                kick in as under real pressure);
  ``kernel``    a decode dispatch raises before anything is dispatched;
                the scheduler dispatches the same call again through the
                same kernels (the pool is untouched, so survivors keep
                the greedy bit-identity contract) and keeps serving;
  ``nan``       one live row's step logits are overwritten with NaNs; the
                always-on non-finite detector fails that request alone
                (``error="nan-logits"``), its batch neighbours never see
                the corruption;
  ``callback``  a user ``on_token`` callback raises mid-emission; the
                scheduler catches it, marks that request errored, and the
                other slots keep decoding.

Determinism: each fault kind draws from its own ``(seed, kind)``-derived
PRNG stream, so a kind's fault schedule depends only on how many times its
own seam was visited; enabling one kind never shifts another kind's
schedule, and re-running the same workload with the same seed replays the
same faults. ``max_faults`` bounds the total number of fired faults so a
p=1.0 schedule still lets the workload finish.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

#: Seam names, in the order their PRNG streams are derived.
FAULT_KINDS = ("alloc", "kernel", "nan", "callback")


class InjectedFault(RuntimeError):
    """Raised by an armed fault seam. Never escapes the scheduler: every
    seam catches it and degrades the one request or call it covers."""


class FaultInjector:
    """Deterministic, seeded fault source (see the module docstring).

    ``p_<kind>`` is the per-visit firing probability of that seam;
    ``max_faults`` caps the total faults fired across all kinds (None =
    unbounded). ``fired``/``draws`` count per-kind activity for
    ``pool_stats()`` and the end-of-run chaos report.
    """

    def __init__(self, seed: int = 0, *, p_alloc: float = 0.0, p_kernel: float = 0.0,
                 p_nan: float = 0.0, p_callback: float = 0.0,
                 max_faults: Optional[int] = None):
        rates = {"alloc": float(p_alloc), "kernel": float(p_kernel),
                 "nan": float(p_nan), "callback": float(p_callback)}
        for kind, p in rates.items():
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"p_{kind} must be in [0, 1], got {p}")
        if max_faults is not None and max_faults < 0:
            raise ValueError("max_faults must be >= 0")
        self.seed = int(seed)
        self.rates = rates
        self.max_faults = max_faults
        self.fired: Dict[str, int] = {k: 0 for k in FAULT_KINDS}
        self.draws: Dict[str, int] = {k: 0 for k in FAULT_KINDS}
        # One independent stream per kind and one for victim picks, each
        # derived from (seed, stream index): a kind's schedule is a pure
        # function of (seed, visits to that seam).
        self._rngs = {k: np.random.default_rng((self.seed, i))
                      for i, k in enumerate(FAULT_KINDS)}
        self._pick_rng = np.random.default_rng((self.seed, len(FAULT_KINDS)))

    @property
    def total_fired(self) -> int:
        return sum(self.fired.values())

    def fire(self, kind: str) -> bool:
        """One visit to seam `kind`: True iff a fault fires here."""
        p = self.rates[kind]
        self.draws[kind] += 1
        if p <= 0.0:
            return False
        if self.max_faults is not None and self.total_fired >= self.max_faults:
            return False
        hit = bool(self._rngs[kind].random() < p)
        if hit:
            self.fired[kind] += 1
        return hit

    def pick(self, n: int) -> int:
        """Deterministic victim index in [0, n) (which live row's logits
        the ``nan`` fault corrupts)."""
        return int(self._pick_rng.integers(n))

    def counts(self) -> dict:
        """Counter snapshot for ``pool_stats()`` and reports."""
        return {
            "seed": self.seed,
            "rates": dict(self.rates),
            "max_faults": self.max_faults,
            "fired": dict(self.fired),
            "draws": dict(self.draws),
            "total_fired": self.total_fired,
        }
