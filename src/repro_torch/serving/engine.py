"""Serving engine over the packed-weight path.

Port of ``repro.serving.engine``.
The engine packs the weights once under a QuantConfig or a per-layer
PrecisionPolicy and has two modes:

  * ``generate`` — continuous batching through ``ContinuousScheduler``:
    the paged pool with the prefix cache and chunked prefill by default,
    no prefix cache with ``prefix_cache=False``, solo whole-prompt
    admission with ``chunked_prefill=False``, the contiguous per-slot
    cache with ``paged=False``. The scheduler lives as long as the
    engine, so a prompt served again hits the blocks an earlier call
    left in the prefix cache. With ``speculate=k`` its greedy slots
    self-speculate: a plane-truncated view of the packed weights
    (``draft_policy``) drafts k tokens a step and one full-policy verify
    call emits the longest matching prefix, bitwise the greedy tokens
    without it. With ``tiers`` (e.g. "w8a8,w4a8,w2a8") a request may
    name a precision tier and is served through a plane-truncated view
    of the one packed weight set; ``cancel(rid)`` retires a queued or
    live request at the next step. On an overcommitted pool
    (``pool_blocks``) the scheduler preempts (``preempt``,
    ``victim_policy``), bypasses a blocked head (``max_head_bypass``) and,
    with ``degrade``, admits under sustained pressure at the lowest tier;
    ``chaos`` arms a seeded ``FaultInjector``. ``host_pool_bytes`` puts a
    host-RAM block tier under the pool (evicted and ``block-to-host``-
    preempted blocks spill there and swap back bitwise), and
    ``save_index``/``load_index`` persist the prefix index across
    processes (a load before the first ``generate`` is kept until the
    scheduler exists) and carry it across a ``max_ctx`` rebuild.
  * ``generate_static`` — the static batch (whole-prompt prefill of up
    to ``max_batch`` right-padded prompts, then a decode loop on the
    contiguous cache, grown past the prefill headroom when needed), the
    baseline continuous batching is measured against and the oracle of
    the "continuous ≡ static" contract. A recurrent model (rwkv6) keeps
    its constant-size state in place of the cache. Static batches do not
    speculate (``speculate`` applies to ``generate`` only, as in JAX).

Prompts are right-padded to the bucket with the real length passed to
prefill, so pad tokens never occupy cache slots or shift rope positions,
and both modes draw from the same per-request (seed, rid, step) sample
streams.
"""
from __future__ import annotations

import json
import warnings
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import as_policy
from repro_torch.core.quantized_linear import quantize_params_for_serving
from repro_torch.models import build_model
from repro_torch.models.model_zoo import check_policy
from repro_torch.models.kv_cache import KVCache, grow_cache
from repro_torch.serving import sampling
from repro_torch.serving.scheduler import ContinuousScheduler, Request


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, max_batch: int = 8,
                 quant=None, bucket: int = 64, seed: int = 0,
                 max_ctx: Optional[int] = None, on_token=None,
                 paged: Optional[bool] = None, block_size: int = 16,
                 pool_blocks: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 chunked_prefill: Optional[bool] = None,
                 prefill_budget: int = 32, speculate: int = 0,
                 draft_policy="w4a8", tiers=None, preempt: Optional[bool] = None,
                 victim_policy: str = "most-blocks", max_head_bypass: int = 4,
                 degrade: bool = False, degrade_after: int = 2, chaos=None,
                 host_pool_bytes: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg)
        self.policy = as_policy(quant)
        check_policy(cfg, self.policy)
        if self.policy is not None:
            params = quantize_params_for_serving(params, self.policy,
                                                 min_size=1024)
        self.params = params
        self.max_batch = max_batch
        self.bucket = bucket
        self.seed = seed
        self.max_ctx = max_ctx
        self.on_token = on_token
        self.paged = paged                  # None = paged if eligible
        self.block_size = block_size
        self.pool_blocks = pool_blocks
        self.prefix_cache = prefix_cache        # None = on if paged
        self.chunked_prefill = chunked_prefill  # None = on if paged
        self.prefill_budget = prefill_budget
        self.speculate = speculate          # draft tokens a step (0 = off)
        self.draft_policy = draft_policy    # plane-truncation draft spec
        self.tiers = tiers                  # per-request precision tiers
        self.preempt = preempt              # None = on when paged
        self.victim_policy = victim_policy
        self.max_head_bypass = max_head_bypass
        self.degrade = degrade              # admit at the floor tier under pressure
        self.degrade_after = degrade_after
        self.chaos = chaos                  # FaultInjector (tests, chaos runs)
        self.host_pool_bytes = host_pool_bytes  # host-RAM tier budget (0 = off)
        self._index_data = None             # a load_index payload held for the scheduler
        self._sched: Optional[ContinuousScheduler] = None

    def _bucketed(self, n: int) -> int:
        return max(self.bucket, -(-n // self.bucket) * self.bucket)

    def scheduler(self, max_ctx: Optional[int] = None) -> ContinuousScheduler:
        """The engine's (lazily built) continuous scheduler, rebuilt only if
        a larger context bound is requested. An explicit engine `max_ctx`
        is a hard cap. The prefix index survives the rebuild: a held
        `load_index` payload seeds the first scheduler, and a rebuild
        imports the old scheduler's index (fresher) into the new host
        tier; the block geometry does not depend on max_ctx."""
        need = self.max_ctx if self.max_ctx is not None else (max_ctx or 128)
        if self._sched is None or need > self._sched.max_ctx:
            carry, self._index_data = self._index_data, None
            if self._sched is not None and self._sched.host_tier:
                carry = self._sched.export_index()
            self._sched = ContinuousScheduler(
                self.cfg, self.params, max_batch=self.max_batch, max_ctx=need,
                quant=None, bucket=self.bucket, seed=self.seed,
                on_token=self.on_token, paged=self.paged,
                block_size=self.block_size, pool_blocks=self.pool_blocks,
                prefix_cache=self.prefix_cache,
                chunked_prefill=self.chunked_prefill,
                prefill_budget=self.prefill_budget, speculate=self.speculate,
                draft_policy=self.draft_policy, tiers=self.tiers,
                preempt=self.preempt, victim_policy=self.victim_policy,
                max_head_bypass=self.max_head_bypass, degrade=self.degrade,
                degrade_after=self.degrade_after, chaos=self.chaos,
                host_pool_bytes=self.host_pool_bytes, device=self.device)
            if carry:
                self._sched.import_index(carry)
        self._sched.on_token = self.on_token
        return self._sched

    def pool_stats(self) -> Optional[dict]:
        return self._sched.pool_stats() if self._sched is not None else None

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or live request of the continuous scheduler
        (it comes back with ``error="cancelled"`` at the next step). False
        before the first ``generate`` or for an unknown or retired rid."""
        return self._sched.cancel(rid) if self._sched is not None else False

    def save_index(self, path) -> int:
        """Write the scheduler's prefix index (device and host) to `path`
        as JSON; before the first ``generate``, the payload `load_index`
        holds. Returns the number of digests written (0 when there is
        neither)."""
        if self._sched is not None:
            return self._sched.save_index(path)
        if self._index_data:
            with open(path, "w") as f:
                json.dump(self._index_data, f)
                f.write("\n")
            return len(self._index_data.get("digests", {}))
        return 0

    def load_index(self, path) -> int:
        """Load a `save_index` file. With a scheduler it goes into its host
        tier at once (the digests loaded); before the first ``generate``
        the parsed payload is held and imported when the scheduler is
        built (the digests the file holds). A missing or corrupt file
        warns and loads 0; nothing raises."""
        if self._sched is not None:
            return self._sched.load_index(path)
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError) as e:
            warnings.warn(f"prefix-index load from {path!s} failed ({e}) — cold start")
            return 0
        if not isinstance(data, dict):
            warnings.warn("prefix-index load: unrecognized payload — cold start")
            return 0
        self._index_data = data
        digests = data.get("digests")
        return len(digests) if isinstance(digests, dict) else 0

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

    def generate_static(self, requests: List[Request]) -> List[Request]:
        """Static batch generation (prefill batch → decode loop) in slices
        of ``max_batch``; returns the requests (out_tokens filled)."""
        out: List[Request] = []
        for i in range(0, len(requests), self.max_batch):
            out.extend(self._generate_batch(requests[i:i + self.max_batch]))
        return out

    def _grown(self, cache, needed: int):
        """Refuse a batch whose decode writes exceed `max_ctx`, otherwise
        grow the contiguous cache (to a bucket multiple) to cover every
        decode write."""
        kv = cache.kv
        if not isinstance(kv, KVCache) or kv.window:
            return cache
        if self.max_ctx is not None and needed > self.max_ctx:
            raise ValueError(
                f"static batch writes {needed} cache slots but max_ctx is "
                f"{self.max_ctx}; raise max_ctx or lower max_new_tokens")
        if needed > kv.k.shape[2]:
            cache = grow_cache(cache, -(-needed // self.bucket) * self.bucket)
        return cache

    def _generate_batch(self, reqs: List[Request]) -> List[Request]:
        B = len(reqs)
        lens = [len(r.prompt) for r in reqs]
        L = self._bucketed(max(lens))
        tokens = np.zeros((B, L), np.int64)
        for i, r in enumerate(reqs):
            tokens[i, :lens[i]] = r.prompt      # right-pad; real len in lengths
        batch = {"tokens": torch.from_numpy(tokens).to(self.device),
                 "lengths": torch.tensor(lens, dtype=torch.int32)}
        cache, logits = self.model.prefill(self.params, batch)
        # The highest decode write is at position len + max_new - 2 (the
        # first token comes from the prefill logits and writes nothing).
        needed = max(n + max(r.max_new_tokens, 1) - 1 for n, r in zip(lens, reqs))
        cache = self._grown(cache, needed)

        temps = np.asarray([r.temperature for r in reqs], np.float32)
        top_ks = np.asarray([r.top_k for r in reqs], np.int32)
        keys = np.stack([sampling.request_key(self.seed, r.rid) for r in reqs])
        steps = np.zeros((B,), np.int32)

        def sample(lg):
            return sampling.sample_tokens(lg[:, -1, :], temps, top_ks, keys,
                                          steps).cpu().numpy()

        cur = sample(logits)
        steps += 1
        outs = [[int(cur[i])] for i in range(B)]
        done = [len(o) >= r.max_new_tokens
                or (r.eos_id is not None and o[-1] == r.eos_id)
                for o, r in zip(outs, reqs)]
        for _ in range(max(r.max_new_tokens for r in reqs) - 1):
            if all(done):
                break               # every sequence hit max_new/EOS
            tok = torch.from_numpy(cur[:, None].astype(np.int64)).to(self.device)
            cache, logits = self.model.decode_step(self.params, cache, tok)
            cur = sample(logits)
            steps += 1
            for i, r in enumerate(reqs):
                if not done[i]:
                    outs[i].append(int(cur[i]))
                    done[i] = (len(outs[i]) >= r.max_new_tokens
                               or (r.eos_id is not None and outs[i][-1] == r.eos_id))
        for r, o in zip(reqs, outs):
            r.out_tokens = o
        return reqs
