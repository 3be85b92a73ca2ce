"""The port's pool-pressure preemption with warm resume, its victim
policies, the bounded head-of-line bypass and graceful degradation, held
against itself and against ``repro`` on the CPU at the reduced olmo-1b
config.

Against itself: the counterpart of each case of ``tests/test_preemption.py``
in both admission modes (whole-prompt and chunked prefill) — a preempted
request, its slot released, its written blocks registered and itself
requeued as prompt ++ generated, emits exactly the stream of an
uninterrupted run on the bf16 and int8 pools, sampled, with tiers and
with speculation; no request is preempted twice; each victim policy picks
its victim; the bypass is bounded; a degraded request emits its
solo-at-floor-tier stream; and the refusals (a bad or host-tier policy,
``preempt`` off the pool, ``degrade`` without tiers).

Against JAX: one scripted sequence that preempts, bypasses and degrades,
through both schedulers in float32 with JAX's weights carried across:
greedy tokens, errors, per-request ``preemptions``/``degraded_to`` and
every ``_lifecycle_stats`` key but ``chaos``, after each scenario. The
JAX runs are built once, in a module fixture, each step waited out on the
device (``torch_parity.synced``).
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_reduced_config as jax_reduced
from repro.core.precision import parse_policy_spec as jax_policy
from repro.models import build_model as jax_build
from repro.serving import ContinuousScheduler as JaxScheduler
from repro.serving import Request as JaxRequest
from repro_torch import convert
from repro_torch.configs import get_reduced_config
from repro_torch.core.precision import parse_policy_spec
from repro_torch.core.quant import QuantConfig
from repro_torch.models import build_model
from repro_torch.serving import (VICTIM_POLICIES, ContinuousScheduler, Request,
                                 assert_pool_invariants)
from torch_parity import synced, to_numpy_tree

Q8 = QuantConfig(w_bits=8, a_bits=8)
P4 = (np.arange(4) * 3 + 2) % 64
P8 = (np.arange(8) * 3 + 1) % 64
P11 = (np.arange(11) * 5 + 2) % 64
P16 = (np.arange(16) * 7 + 3) % 64
MODES = pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])


@pytest.fixture(scope="module")
def olmo():
    cfg = get_reduced_config("olmo-1b")
    return cfg, build_model(cfg).init(seed=0, device="cpu")


def _sched(cfg, params, **kw):
    args = dict(max_batch=2, max_ctx=64, bucket=16, paged=True, block_size=4,
                chunked_prefill=False, prefill_budget=8, device="cpu")
    args.update(kw)
    return ContinuousScheduler(cfg, params, **args)


def _drain(sched, cap=300):
    """Step to empty, the pool invariants held at every step boundary."""
    out, steps = [], 0
    while sched.num_active or sched.num_waiting:
        out.extend(sched.step())
        assert_pool_invariants(sched)
        steps += 1
        assert steps < cap, "scheduler failed to drain (deadlock?)"
    return out


def _solo(cfg, params, req, **kw):
    """The uninterrupted stream: the same settings, a pool that never runs
    short."""
    kw.setdefault("pool_blocks", 64)
    sched = _sched(cfg, params, **kw)
    sched.submit(req)
    _drain(sched)
    assert sched.preemptions == 0
    return req.out_tokens


def _preempt_scenario(cfg, params, *, r1_kw=None, r2_kw=None, **sched_kw):
    """r1 decodes alone until r2's admission cannot fit the pool: r1 is
    preempted, r2 serves, r1 resumes warm. Returns (sched, r1, r2)."""
    sched_kw.setdefault("pool_blocks", 10)
    sched = _sched(cfg, params, **sched_kw)
    r1 = Request(1, P8, max_new_tokens=12, **(r1_kw or {}))
    r2 = Request(2, P16, max_new_tokens=8, **(r2_kw or {}))
    sched.submit(r1)
    for _ in range(3):
        sched.step()
    sched.submit(r2)
    _drain(sched)
    assert sched.preemptions >= 1
    assert r1.preemptions >= 1 and r2.preemptions == 0
    assert r1.error is None and r2.error is None
    return sched, r1, r2


# -- the bit-identity contract -------------------------------------------------

@MODES
@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16", "int8"])
def test_preempt_resume_bit_identical(olmo, kv_int8, chunked):
    cfg, params = olmo
    cfg = dataclasses.replace(cfg, kv_cache_quant=kv_int8)
    sched, r1, r2 = _preempt_scenario(cfg, params, chunked_prefill=chunked)
    assert r1.out_tokens == _solo(cfg, params, Request(1, P8, max_new_tokens=12),
                                  chunked_prefill=chunked)
    assert r2.out_tokens == _solo(cfg, params, Request(2, P16, max_new_tokens=8),
                                  chunked_prefill=chunked)
    # The resume was warm: re-admission hit the blocks preemption
    # registered (the whole prompt at least).
    assert sched.pool_stats()["prefix_hit_tokens"] >= len(P8)


@MODES
def test_preempt_resume_bit_identical_sampled(olmo, chunked):
    """The sample stream is a function of (seed, rid, step), and a resume
    draws at step = tokens already emitted."""
    cfg, params = olmo
    _, r1, _ = _preempt_scenario(cfg, params, chunked_prefill=chunked,
                                 r1_kw=dict(temperature=0.8, top_k=8))
    assert r1.out_tokens == _solo(
        cfg, params, Request(1, P8, max_new_tokens=12, temperature=0.8, top_k=8),
        chunked_prefill=chunked)


@MODES
def test_preempt_resume_bit_identical_tiers(olmo, chunked):
    cfg, params = olmo
    kw = dict(quant=Q8, tiers="w8a8,w4a8", chunked_prefill=chunked)
    sched, r1, r2 = _preempt_scenario(cfg, params, r1_kw=dict(tier="w8a8"),
                                      r2_kw=dict(tier="w4a8"), **kw)
    assert r1.degraded_to is None           # preemption never degrades
    assert sched._slot_tier == [None, None]  # every victim's tier cleared
    assert r1.out_tokens == _solo(cfg, params,
                                  Request(1, P8, max_new_tokens=12, tier="w8a8"), **kw)
    assert r2.out_tokens == _solo(cfg, params,
                                  Request(2, P16, max_new_tokens=8, tier="w4a8"), **kw)


@MODES
def test_preempt_resume_bit_identical_speculative(olmo, chunked):
    cfg, params = olmo
    sched, r1, r2 = _preempt_scenario(cfg, params, quant=Q8, speculate=2,
                                      draft_policy="w4a8", chunked_prefill=chunked)
    assert sched.spec_rounds > 0
    # Transitive: speculating ≡ not speculating ≡ uninterrupted.
    assert r1.out_tokens == _solo(cfg, params, Request(1, P8, max_new_tokens=12),
                                  quant=Q8, chunked_prefill=chunked)
    assert r2.out_tokens == _solo(cfg, params, Request(2, P16, max_new_tokens=8),
                                  quant=Q8, chunked_prefill=chunked)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16", "int8"])
def test_whole_prompt_resume_recomputes_each_position_as_first_computed(olmo, kv_int8):
    """Under whole-prompt admission a resume recomputes the prompt
    positions the pool no longer holds through whole-prompt prefill and
    the generated ones through the chunk kernel (the decode step's
    function; on the card the flash kernel's int8 route is not), from the
    first generated position to the last served token."""
    cfg, params = olmo
    cfg = dataclasses.replace(cfg, kv_cache_quant=kv_int8)
    sched = _sched(cfg, params, pool_blocks=10)
    chunks, flash = [], []
    inner_chunk, inner_suffix = sched.model.prefill_chunk, sched.model.prefill_suffix

    def prefill_chunk(params, cache, batch):
        chunks.append((int(batch["start"]), int(batch["lengths"][0])))
        return inner_chunk(params, cache, batch)

    def prefill_suffix(params, batch):
        flash.append((int(batch["start"]), int(batch["lengths"][0])))
        return inner_suffix(params, batch)

    sched.model.prefill_chunk, sched.model.prefill_suffix = prefill_chunk, prefill_suffix
    p13 = (np.arange(13) * 5 + 2) % 64
    r1 = Request(1, p13, max_new_tokens=12)
    sched.submit(r1)
    sched.step()
    sched.submit(Request(2, P16, max_new_tokens=8))
    _drain(sched)
    assert r1.preemptions == 1
    assert r1.out_tokens == _solo(cfg, params, Request(1, p13, max_new_tokens=12))
    # Preempted with 2 tokens out, position 14 written up to 13: the resume
    # hits the 3 whole blocks [0, 12), prefills the prompt's last position
    # 12 with the flash route and the generated positions [13, 15) with
    # one chunk (budget 8); r2 was admitted cold.
    assert flash == [(12, 1)] and chunks == [(13, 2)]


@MODES
def test_preempted_twice_never(olmo, chunked):
    """A request already preempted is never chosen to make room again,
    and a head that was preempted never preempts: it waits instead."""
    cfg, params = olmo
    sched, r1, _ = _preempt_scenario(cfg, params, chunked_prefill=chunked)
    assert r1.preemptions == 1
    assert sched.preemptions == 1


# -- victim policies -----------------------------------------------------------

def _two_live_plus_head(cfg, params, head_kw=None, r1_kw=None, r2_kw=None, **sched_kw):
    """Rows 1 (5+ blocks) and 2 (3 blocks) decoding; request 3 needs more
    than the pool has left, forcing a choice between them. (Under chunked
    prefill the two admit on consecutive steps.)"""
    sched_kw.setdefault("max_batch", 3)
    sched_kw.setdefault("pool_blocks", 12)
    sched = _sched(cfg, params, **sched_kw)
    r1 = Request(1, P11, max_new_tokens=12, **(r1_kw or {}))
    r2 = Request(2, P8, max_new_tokens=4, **(r2_kw or {}))
    sched.submit(r1)
    sched.submit(r2)
    sched.step()
    while sched.num_waiting or sched._chunk_plans:
        sched.step()
    r3 = Request(3, P16, max_new_tokens=8, **(head_kw or {}))
    sched.submit(r3)
    _drain(sched)
    assert all(r.error is None for r in (r1, r2, r3))
    return sched, r1, r2, r3


@MODES
def test_victim_policy_most_blocks(olmo, chunked):
    cfg, params = olmo
    _, r1, r2, _ = _two_live_plus_head(cfg, params, victim_policy="most-blocks",
                                       chunked_prefill=chunked)
    assert r1.preemptions == 1 and r2.preemptions == 0


@MODES
def test_victim_policy_lowest_tier(olmo, chunked):
    """lowest-tier evicts the cheapest-precision slot even though the other
    frees more blocks."""
    cfg, params = olmo
    _, r1, r2, _ = _two_live_plus_head(
        cfg, params, victim_policy="lowest-tier", quant=Q8, tiers="w8a8,w2a8",
        r1_kw=dict(tier="w8a8"), r2_kw=dict(tier="w2a8"), head_kw=dict(tier="w8a8"),
        chunked_prefill=chunked)
    assert r2.preemptions == 1 and r1.preemptions == 0


@MODES
def test_victim_policy_latest_deadline(olmo, chunked):
    """latest-deadline evicts the slot with the most slack: no deadline
    outranks a step budget."""
    cfg, params = olmo
    _, r1, r2, _ = _two_live_plus_head(cfg, params, victim_policy="latest-deadline",
                                       r1_kw=dict(deadline_steps=60),
                                       chunked_prefill=chunked)
    assert r2.preemptions == 1 and r1.preemptions == 0


def test_victim_policies_are_jaxs():
    from repro.serving import VICTIM_POLICIES as JAX_POLICIES

    assert VICTIM_POLICIES == JAX_POLICIES


@pytest.mark.parametrize("kwargs, match", [
    (dict(victim_policy="coin-flip"), "victim_policy"),
    (dict(victim_policy="block-to-host"), "host-RAM block tier"),
    (dict(paged=False, preempt=True), "preempt"),
    (dict(degrade=True), "degrade"),
    (dict(max_head_bypass=-1), "max_head_bypass"),
    (dict(degrade_after=0), "degrade_after"),
], ids=["bad-policy", "block-to-host", "preempt-off-pool", "degrade-no-tiers",
        "bypass", "degrade-after"])
def test_refusals(olmo, kwargs, match):
    """A bad policy, the host-tier policy (not ported yet), preemption off
    the pool, degradation without tiers, and out-of-range bounds raise."""
    cfg, params = olmo
    with pytest.raises(ValueError, match=match):
        _sched(cfg, params, **kwargs)


def test_preempt_defaults_follow_the_pool(olmo):
    cfg, params = olmo
    assert _sched(cfg, params).preempt
    assert not _sched(cfg, params, paged=False).preempt
    stats = _sched(cfg, params, paged=False).pool_stats()
    assert stats["preempt"] is False and stats["preemptions"] == 0


# -- the head-of-line bypass and starvation freedom ----------------------------

@MODES
def test_bounded_bypass_is_starvation_free(olmo, chunked):
    """With preemption off, a pool-blocked big head lets smaller requests
    past, but only max_head_bypass times in a row: the head admits (and
    finishes) once capacity frees instead of starving behind the stream."""
    cfg, params = olmo
    admitted = []                       # first emission = admission

    def first_seen(req, tok):
        if req.rid not in admitted:
            admitted.append(req.rid)

    sched = _sched(cfg, params, pool_blocks=8, preempt=False, max_head_bypass=2,
                   on_token=first_seen, chunked_prefill=chunked)
    sched.submit(Request(0, P8, max_new_tokens=20))
    sched.step()
    sched.submit(Request(1, P16, max_new_tokens=4))
    for i in range(4):
        sched.submit(Request(10 + i, P4 + i, max_new_tokens=1))
    done = _drain(sched)
    assert all(r.error is None for r in done)
    stats = sched.pool_stats()
    assert stats["preemptions"] == 0 and stats["preempt"] is False
    assert stats["pool_pressure_events"] > 0 and stats["queue_wait_steps"] > 0
    assert stats["head_bypasses"] == 2          # the bound, not the stream
    assert admitted.index(10) < admitted.index(1)
    assert admitted.index(11) < admitted.index(1)
    assert admitted.index(1) < admitted.index(12)
    assert admitted.index(1) < admitted.index(13)


# -- graceful degradation ------------------------------------------------------

@MODES
def test_degrade_under_sustained_pressure(olmo, chunked):
    """After degrade_after consecutive pressure steps new admissions are
    pinned, for life, to the lowest tier, and the degraded stream is
    bitwise that tier's solo stream."""
    cfg, params = olmo
    kw = dict(quant=Q8, tiers="w8a8,w2a8", chunked_prefill=chunked)
    sched = _sched(cfg, params, pool_blocks=8, preempt=False, degrade=True,
                   degrade_after=1, **kw)
    hog = Request(0, P11, max_new_tokens=10, tier="w8a8")
    sched.submit(hog)
    sched.step()
    late = Request(1, P16, max_new_tokens=6, tier="w8a8")
    sched.submit(late)
    _drain(sched)
    assert late.error is None and hog.error is None
    assert late.degraded_to == "w2a8" and hog.degraded_to is None
    assert sched.degraded_requests == 1
    low = _solo(cfg, params, Request(1, P16, max_new_tokens=6, tier="w2a8"), **kw)
    asked = _solo(cfg, params, Request(1, P16, max_new_tokens=6, tier="w8a8"), **kw)
    assert late.out_tokens == low
    assert late.out_tokens != asked            # the degradation is real
    tiers = sched.pool_stats()["tiers"]
    assert tiers["w2a8"]["requests"] == 1 and tiers["w8a8"]["requests"] == 1


# -- against the JAX scheduler -------------------------------------------------

POLICY = "w8a8"
TIERS = "w8a8,w4a8,w2a8"
PARITY_KW = dict(max_batch=2, max_ctx=64, bucket=16, paged=True, block_size=4,
                 prefill_budget=8, pool_blocks=10, tiers=TIERS, degrade=True,
                 degrade_after=2)


def _preempt_resume(sched, make):
    """r1 (at the floor tier, which degradation cannot lower) decodes;
    r2's admission preempts it; r1 resumes warm."""
    sched.submit(make(1, P8, 12, tier="w2a8"))
    done = [r for _ in range(3) for r in sched.step()]
    sched.submit(make(2, P16, 8))
    return done + _drain(sched)


def _preempt_then_bypass(sched, make):
    """r11 preempts r10; the preempted head cannot preempt back, so two
    small requests queued behind it admit past it while it waits."""
    sched.submit(make(10, P8 + 1, 12, tier="w2a8"))
    done = [r for _ in range(3) for r in sched.step()]
    sched.submit(make(11, P16 + 1, 8, tier="w2a8"))
    done += sched.step()
    for rid, prompt, n in [(12, P4, 1), (13, P4 + 1, 2)]:
        sched.submit(make(rid, prompt, n, tier="w2a8"))
    return done + _drain(sched)


def _degrade_sustained(sched, make):
    """A tiered hog holds the pool while a stream of tiered requests
    queues: the pressure lasts past degrade_after steps, and later
    admissions land on the lowest tier."""
    sched.submit(make(20, P11, 14, tier="w8a8"))
    done = sched.step()
    for rid, prompt, n, tier in [(21, P16 + 2, 6, "w8a8"), (22, P16 + 3, 6, "w4a8"),
                                 (23, P4 + 2, 3, "w8a8"), (24, P8 + 2, 4, "w4a8")]:
        sched.submit(make(rid, prompt, n, tier=tier))
    return done + _drain(sched)


PARITY_SCENARIOS = (_preempt_resume, _preempt_then_bypass, _degrade_sustained)


def _parity_run(sched, make):
    """Each scenario's requests (tokens, error, preemptions, degraded_to) by
    rid, and every lifecycle key but chaos, with the prefix-hit tokens,
    after it."""
    out = []
    for fn in PARITY_SCENARIOS:
        done = fn(sched, make)
        life = {k: v for k, v in sched.pool_stats().items()
                if (k in sched._lifecycle_stats() and k != "chaos")
                or k == "prefix_hit_tokens"}
        out.append(({r.rid: (r.out_tokens, r.error, r.preemptions, r.degraded_to)
                     for r in done}, life))
    return out


def _f32_cfgs():
    jcfg = dataclasses.replace(jax_reduced("olmo-1b"), dtype="float32")
    tcfg = dataclasses.replace(get_reduced_config("olmo-1b"), dtype="float32")
    return jcfg, tcfg


@pytest.fixture(scope="module")
def parity_runs():
    jcfg, tcfg = _f32_cfgs()
    params = jax_build(jcfg).init(jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(to_numpy_tree(params), "cpu")
    out = {}
    for chunked in (False, True):
        jsched = synced(JaxScheduler(jcfg, params, quant=jax_policy(POLICY),
                                     chunked_prefill=chunked, **PARITY_KW))
        want = _parity_run(jsched, lambda rid, p, n, **k: JaxRequest(
            rid, p, max_new_tokens=n, **k))
        tsched = ContinuousScheduler(tcfg, tparams, quant=parse_policy_spec(POLICY),
                                     chunked_prefill=chunked, device="cpu", **PARITY_KW)
        got = _parity_run(tsched, lambda rid, p, n, **k: Request(
            rid, p, max_new_tokens=n, **k))
        out[chunked] = (want, got, tsched)
    return out


@pytest.mark.parametrize("index", range(len(PARITY_SCENARIOS)),
                         ids=[fn.__name__[1:] for fn in PARITY_SCENARIOS])
@MODES
def test_scheduler_matches_jax_under_pressure(parity_runs, chunked, index):
    """Greedy tokens, errors, per-request preemptions and degraded_to, every
    lifecycle counter and the prefix-hit tokens equal the JAX scheduler's
    after each scenario."""
    want, got, _ = parity_runs[chunked]
    assert got[index] == want[index]


@MODES
def test_parity_sequence_preempts_bypasses_and_degrades(parity_runs, chunked):
    """What the sequence must show beyond agreeing with JAX: a preemption
    and a warm resume, a bypass, a degradation, no failed request, and a
    clean pool at the end."""
    _, got, tsched = parity_runs[chunked]
    (first, life1), (second, life2), (third, life3) = got
    assert first[1][2] == 1 and first[1][3] is None         # preempted, not degraded
    assert life1["prefix_hit_tokens"] >= len(P8)             # its resume was warm
    assert second[10][2] == 1 and life2["head_bypasses"] >= 1
    assert life3["degraded_requests"] >= 1
    assert any(deg == "w2a8" for _, _, _, deg in third.values())
    assert all(err is None for res, _ in got for _, err, _, _ in res.values())
    assert_pool_invariants(tsched)
    assert tsched._avail == tsched.pool_blocks
