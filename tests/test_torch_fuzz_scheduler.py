"""Differential fuzz of the port's continuous scheduler with the host-RAM
tier on, held against a solo oracle on the port's own engine.

Each case drives one scheduler through a seeded stream of steps:
admissions onto a shared system prefix (so prefix hits, copy-on-write
and, on a pool sized well below the working set, LRU eviction to the
host tier happen all the time), cancellations, step-budget deadlines,
pool-pressure preemption under ``block-to-host`` or ``most-blocks``, and
in one configuration precision tiers with self-speculation. It checks
what the serving stack promises:

  * ``assert_pool_invariants`` after every step (refcounts, partition,
    reservations, device/host digest exclusivity, host bytes);
  * every retired stream is its solo oracle's: a clean retirement
    exactly, a cancelled or expired one a prefix. Sampling is indexed by
    (seed, rid, step), so sampled streams compare exactly too.

The seeds are a fixed list of parametrized cases (no hypothesis, no
shrinking), so every run of the suite draws the same streams.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.configs import get_reduced_config
from repro_torch.core.quant import QuantConfig
from repro_torch.models import build_model
from repro_torch.serving import (ContinuousScheduler, Request, ServingEngine,
                                 assert_pool_invariants)

Q8 = QuantConfig(w_bits=8, a_bits=8)
SYS = np.arange(16) % 64                     # shared system prefix
HOSTKB = 1 << 20
POOL_BLOCKS = 9        # a request needs up to 8: two rows rarely fit
TIERS = "w8a8,w4a8"

# name → (int8 pool, scheduler settings, tiers, steps)
CONFIGS = {
    "bf16-block-to-host-chunked": (False, dict(
        victim_policy="block-to-host", chunked_prefill=True, prefill_budget=8), None, 160),
    "int8-block-to-host": (True, dict(victim_policy="block-to-host"), None, 140),
    "bf16-most-blocks": (False, dict(victim_policy="most-blocks"), None, 140),
    "int8-most-blocks-chunked": (True, dict(
        victim_policy="most-blocks", chunked_prefill=True, prefill_budget=8), None, 140),
    "q8-tiers-speculate-block-to-host": (False, dict(
        victim_policy="block-to-host", quant=Q8, tiers=TIERS, speculate=2,
        draft_policy="w4a8"), TIERS, 120),
}
CASES = [("bf16-block-to-host-chunked", s) for s in (0, 1, 2)] + [
    ("int8-block-to-host", s) for s in (3, 4, 5)] + [
    ("bf16-most-blocks", s) for s in (6, 7)] + [
    ("int8-most-blocks-chunked", s) for s in (8, 9)] + [
    ("q8-tiers-speculate-block-to-host", s) for s in (10, 11)]


@pytest.fixture(scope="module")
def models():
    built = {}

    def get(int8):
        if int8 not in built:
            cfg = dataclasses.replace(get_reduced_config("olmo-1b"), kv_cache_quant=int8)
            built[int8] = (cfg, build_model(cfg).init(seed=0, device="cpu"))
        return built[int8]
    return get


class _Oracle:
    """Solo reference on the port's engine: each distinct request served
    alone (prefix cache off, no preemption, a pool far larger than any
    request), memoized, so its stream is the uninterrupted, unshared
    one."""

    def __init__(self, cfg, params, quant=None, tiers=None, chunked=False):
        self.engine = ServingEngine(
            cfg, params, max_batch=2, quant=quant, bucket=16, max_ctx=64, paged=True,
            block_size=4, pool_blocks=96, prefix_cache=False, chunked_prefill=chunked,
            prefill_budget=8, preempt=False, tiers=tiers, device="cpu")
        self.memo = {}

    def stream(self, req: Request):
        key = (tuple(int(t) for t in req.prompt), req.max_new_tokens, req.tier,
               float(req.temperature), req.rid)
        if key not in self.memo:
            clone = Request(rid=req.rid, prompt=np.array(req.prompt),
                            max_new_tokens=req.max_new_tokens,
                            temperature=req.temperature, tier=req.tier)
            self.engine.generate([clone])
            assert clone.error is None, f"oracle failed: {clone.error}"
            self.memo[key] = clone.out_tokens
        return self.memo[key]


_ORACLES: dict = {}


def _fuzz_run(cfg, params, oracle, seed, steps, sched_kw, tiers=None):
    rng = np.random.default_rng(seed)
    sched = ContinuousScheduler(
        cfg, params, max_batch=2, max_ctx=64, bucket=16, paged=True, block_size=4,
        pool_blocks=POOL_BLOCKS, host_pool_bytes=HOSTKB, device="cpu",
        **sched_kw)
    tails = [rng.integers(0, 64, int(rng.integers(1, 8))) for _ in range(5)]
    tier_names = tiers.split(",") if tiers else [None]
    retired, next_rid = [], 0
    for _ in range(steps):
        u = rng.random()
        backlog = sched.num_active + len(sched.waiting)
        if u < 0.35 and backlog < 6:
            tail = tails[int(rng.integers(len(tails)))]
            extra = rng.integers(0, 64, int(rng.integers(0, 4)))
            prompt = np.concatenate([SYS[:int(rng.integers(4, 17))], tail,
                                     extra]).astype(np.int64)
            sched.submit(Request(
                rid=next_rid, prompt=prompt, max_new_tokens=int(rng.integers(2, 7)),
                temperature=float(rng.choice([0.0, 0.0, 0.0, 0.8])),
                tier=tier_names[int(rng.integers(len(tier_names)))],
                deadline_steps=(int(rng.integers(2, 8)) if rng.random() < 0.08
                                else None)))
            next_rid += 1
        elif u < 0.42:
            rids = ([r.rid for r in sched._slots if r is not None]
                    + [r.rid for r in sched.waiting])
            if rids:
                sched.cancel(int(rng.choice(rids)))
        retired.extend(sched.step())
        assert_pool_invariants(sched)
    while sched.num_active or sched.waiting:
        retired.extend(sched.step())
        assert_pool_invariants(sched)

    assert retired, "the run retired nothing"
    clean = 0
    for req in retired:
        got = req.out_tokens or []
        ref = oracle.stream(req)
        if req.error is None:
            assert got == ref, (f"rid {req.rid} diverged from its solo oracle:\n"
                                f"  got {got}\n  ref {ref}")
            clean += 1
        else:
            assert req.error in ("cancelled", "deadline"), req.error
            assert got == ref[:len(got)], (f"rid {req.rid} ({req.error}) emitted a "
                                           f"non-prefix stream:\n  got {got}\n  ref {ref}")
    assert clean, "every retirement was abnormal: nothing verified"
    drained = (sched._live_blocks == 0 and sched._avail == sched.pool_blocks
               and (sched._block_tab == -1).all())
    assert drained, "blocks or reservations left after the drain"
    return sched


@pytest.mark.parametrize("config, seed", CASES,
                         ids=[f"{c}-{s}" for c, s in CASES])
def test_fuzz_differential(models, config, seed):
    int8, sched_kw, tiers, steps = CONFIGS[config]
    cfg, params = models(int8)
    chunked = sched_kw.get("chunked_prefill", False)
    key = (int8, tiers, chunked)
    if key not in _ORACLES:
        _ORACLES[key] = _Oracle(cfg, params, quant=sched_kw.get("quant"), tiers=tiers,
                                chunked=chunked)
    sched = _fuzz_run(cfg, params, _ORACLES[key], seed, steps, sched_kw, tiers)
    st = sched.pool_stats()
    assert st["swap_outs"] > 0, "the pool never spilled to the host tier"
    assert st["preemptions"] > 0, "the pool never preempted"
    assert st["swap_ins"] > 0 and st["prefix_hit_tokens"] > 0
