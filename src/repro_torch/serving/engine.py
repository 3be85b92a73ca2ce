"""Serving engine over the packed-weight path.

Port of the continuous half of ``repro.serving.engine``: the engine packs
the weights once under a QuantConfig or a per-layer PrecisionPolicy and
serves requests through the continuous-batching scheduler on the paged
pool with chunked prefill. The static-batch baseline (``generate_static``)
comes with a later slice of the port.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import as_policy
from repro_torch.core.quantized_linear import quantize_params_for_serving
from repro_torch.serving.scheduler import ContinuousScheduler, Request


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, max_batch: int = 8,
                 quant=None, bucket: int = 64, seed: int = 0,
                 max_ctx: Optional[int] = None, on_token=None,
                 block_size: int = 16, pool_blocks: Optional[int] = None,
                 prefill_budget: int = 32, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.policy = as_policy(quant)
        if self.policy is not None:
            params = quantize_params_for_serving(params, self.policy,
                                                 min_size=1024)
        self.params = params
        self.max_batch = max_batch
        self.bucket = bucket
        self.seed = seed
        self.max_ctx = max_ctx
        self.on_token = on_token
        self.block_size = block_size
        self.pool_blocks = pool_blocks
        self.prefill_budget = prefill_budget
        self._sched: Optional[ContinuousScheduler] = None

    def _bucketed(self, n: int) -> int:
        return max(self.bucket, -(-n // self.bucket) * self.bucket)

    def scheduler(self, max_ctx: Optional[int] = None) -> ContinuousScheduler:
        """The engine's (lazily built) continuous scheduler, rebuilt only if
        a larger context bound is requested. An explicit engine `max_ctx`
        is a hard cap."""
        need = self.max_ctx if self.max_ctx is not None else (max_ctx or 128)
        if self._sched is None or need > self._sched.max_ctx:
            self._sched = ContinuousScheduler(
                self.cfg, self.params, max_batch=self.max_batch, max_ctx=need,
                quant=None, seed=self.seed,
                on_token=self.on_token, block_size=self.block_size,
                pool_blocks=self.pool_blocks,
                prefill_budget=self.prefill_budget, device=self.device)
        self._sched.on_token = self.on_token
        return self._sched

    def pool_stats(self) -> Optional[dict]:
        return self._sched.pool_stats() if self._sched is not None else None

    def _ctx_needed(self, requests: List[Request]) -> int:
        return max(self._bucketed(len(r.prompt)) + max(r.max_new_tokens, 1)
                   for r in requests)

    def generate(self, requests: List[Request]) -> List[Request]:
        """Continuous-batching generation; returns the input requests
        (out_tokens filled) in input order."""
        if not requests:
            return []
        self.scheduler(self._ctx_needed(requests)).run(requests)
        return list(requests)
