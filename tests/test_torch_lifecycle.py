"""The port's request lifecycle — cancellation, deadlines and contained
user callbacks — held against ``repro`` and against itself on the CPU at
the reduced olmo-1b config.

Against JAX: one scripted sequence of scenarios through both schedulers
in float32 (a cancelled queued request, a cancelled live request and the
slot it frees, a cancelled chunk plan, a cancel from inside
``on_token``, a ``deadline_steps`` expiring live and one expiring in the
queue, a raising request callback, a raising scheduler callback, and a
pool too small for two long requests at once): tokens, errors and the
lifecycle counters after each scenario equal to JAX's. The JAX run is
built once, in a module fixture, each of its steps waited out on the
device (``torch_parity.synced``). Against itself: the counterparts of the
non-preemption cases of ``tests/test_lifecycle.py`` (every terminal path
frees what a normal retirement frees, the pool invariants hold at each
step boundary), ``deadline_s`` under ``run()`` and without a clock, the
engine's ``cancel``, and the serve CLI's ``--deadline-ms``.
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
from repro_torch.models import build_model
from repro_torch.serving import (ContinuousScheduler, Request, ServingEngine,
                                 assert_pool_invariants)
from torch_parity import synced, to_numpy_tree

POLICY = "w4a8;wo=w8a8"
PROMPT_A = (np.arange(8) * 3 + 1) % 64
PROMPT_B = (np.arange(11) * 5 + 2) % 64
PROMPT_C = (np.arange(7) * 3 + 4) % 64
LONG = (np.arange(40) * 7 + 3) % 64
LIFE_COUNTERS = ("cancellations", "deadline_misses", "pool_pressure_events",
                 "queue_wait_steps", "callback_errors")
KW = dict(max_batch=2, max_ctx=96, bucket=16, paged=True, block_size=4,
          chunked_prefill=True, prefill_budget=8, pool_blocks=20)


def _drain(sched, cap=400):
    out, steps = [], 0
    while sched.num_active or sched.num_waiting:
        out.extend(sched.step())
        steps += 1
        assert steps < cap, "scheduler failed to drain"
    return out


# -- scenarios, run in order on one scheduler of each package ------------------

def _cancel_queued(sched, make):
    sched.submit(make(0, PROMPT_A, 8))
    sched.submit(make(1, PROMPT_B, 8))
    done = sched.step()
    sched.submit(make(2, PROMPT_C, 8))
    flags = [sched.cancel(2)]
    done += _drain(sched)
    flags += [sched.cancel(2), sched.cancel(99)]     # terminal, never seen
    return done, flags


def _cancel_live(sched, make):
    sched.submit(make(10, PROMPT_A, 40))
    done = [r for _ in range(4) for r in sched.step()]
    flags = [sched.cancel(10)]
    sched.submit(make(11, PROMPT_B, 5))
    return done + _drain(sched), flags


def _cancel_mid_chunk(sched, make):
    sched.submit(make(20, LONG, 4))
    done = sched.step()                 # the plan's first chunk has landed
    flags = [20 in {r.rid for r in sched._slots if r is not None}, sched.cancel(20)]
    done += _drain(sched)
    flags.append(sched._avail == sched.pool_blocks)
    sched.submit(make(21, PROMPT_A, 4))
    return done + _drain(sched), flags


def _cancel_from_callback(sched, make):
    def stop_after_three(req, tok):
        if len(req.out_tokens or ()) >= 3:
            sched.cancel(req.rid)

    sched.submit(make(30, PROMPT_A, 30, on_token=stop_after_three))
    sched.submit(make(31, PROMPT_C, 6))
    return _drain(sched), []


def _deadline_live(sched, make):
    sched.submit(make(40, PROMPT_A, 50, deadline_steps=5))
    sched.submit(make(41, PROMPT_B, 4))
    return _drain(sched), []


def _deadline_queued(sched, make):
    sched.submit(make(50, PROMPT_A, 12))
    sched.submit(make(51, PROMPT_B, 12))
    done = sched.step()
    sched.submit(make(52, PROMPT_C, 4, deadline_steps=2))
    return done + _drain(sched), []


def _raising_request_callback(sched, make):
    def boom(req, tok):
        raise RuntimeError("user callback exploded")

    sched.submit(make(60, PROMPT_A, 8, on_token=boom))
    sched.submit(make(61, PROMPT_B, 8))
    return _drain(sched), []


def _raising_scheduler_callback(sched, make):
    calls = []

    def flaky(req, tok):
        calls.append(tok)
        if len(calls) == 2:
            raise ValueError("stream sink hiccup")

    sched.on_token = flaky
    sched.submit(make(70, PROMPT_A, 6))
    sched.submit(make(71, PROMPT_B, 6))
    try:
        return _drain(sched), [len(calls) >= 2]
    finally:
        sched.on_token = None


def _pool_pressure(sched, make):
    """Two requests of 12 and 13 blocks in a pool of 20: the second waits,
    counting pressure events and queue-wait steps, then serves."""
    sched.submit(make(80, PROMPT_A + 5, 40))
    sched.submit(make(81, PROMPT_B + 5, 40))
    return _drain(sched), []


SCENARIOS = (_cancel_queued, _cancel_live, _cancel_mid_chunk, _cancel_from_callback,
             _deadline_live, _deadline_queued, _raising_request_callback,
             _raising_scheduler_callback, _pool_pressure)


def _run(sched, make):
    """Each scenario's (tokens and errors by rid, the scenario's own flags,
    lifecycle counters after it); the pool invariants after each."""
    out = []
    for fn in SCENARIOS:
        done, flags = fn(sched, make)
        st = sched.pool_stats()
        out.append(({r.rid: (r.out_tokens, r.error) for r in done}, flags,
                    {k: st[k] for k in LIFE_COUNTERS}))
        if isinstance(sched, ContinuousScheduler):
            assert_pool_invariants(sched)
    return out


def _cfgs():
    jcfg = dataclasses.replace(jax_reduced("olmo-1b"), dtype="float32")
    tcfg = dataclasses.replace(get_reduced_config("olmo-1b"), dtype="float32")
    return jcfg, tcfg


@pytest.fixture(scope="module")
def runs():
    jcfg, tcfg = _cfgs()
    params = jax_build(jcfg).init(jax.random.PRNGKey(0))
    jsched = synced(JaxScheduler(jcfg, params, quant=jax_policy(POLICY), preempt=False,
                                 max_head_bypass=0, **KW))
    want = _run(jsched, lambda rid, p, n, **k: JaxRequest(rid, p, max_new_tokens=n, **k))
    tsched = ContinuousScheduler(tcfg, convert.params_from_numpy(to_numpy_tree(params), "cpu"),
                                 quant=parse_policy_spec(POLICY), preempt=False,
                                 max_head_bypass=0, device="cpu", **KW)
    got = _run(tsched, lambda rid, p, n, **k: Request(rid, p, max_new_tokens=n, **k))
    return want, got


@pytest.mark.parametrize("index", range(len(SCENARIOS)),
                         ids=[fn.__name__[1:] for fn in SCENARIOS])
def test_lifecycle_matches_jax(runs, index):
    """Tokens, errors, the scenario's flags (what ``cancel`` returned, the
    freed pool) and the lifecycle counters equal the JAX scheduler's."""
    want, got = runs
    assert got[index] == want[index]


def test_lifecycle_outcomes(runs):
    """What the sequence must show, beyond agreeing with JAX: each failed
    request carries its reason and a prefix of its stream, its neighbours
    complete, and the counters count each event once."""
    _, got = runs
    (res, flags, life) = got[0]
    assert res[2] == ([], "cancelled") and flags == [True, False, False]
    assert res[0] == (res[0][0], None) and len(res[0][0]) == 8
    assert life["cancellations"] == 1 and life["queue_wait_steps"] > 0
    res, flags, life = got[1]
    assert flags == [True] and res[10][1] == "cancelled" and 0 < len(res[10][0]) < 40
    assert res[11][1] is None and len(res[11][0]) == 5 and life["cancellations"] == 2
    res, flags, _ = got[2]
    assert flags == [True, True, True] and res[20] == ([], "cancelled")
    assert res[21][1] is None and len(res[21][0]) == 4
    res, _, life = got[3]
    assert res[30][1] == "cancelled" and 3 <= len(res[30][0]) <= 5
    assert res[31][1] is None and life["cancellations"] == 4
    res, _, life = got[4]
    assert res[40][1] == "deadline" and 0 < len(res[40][0]) < 50
    assert res[41][1] is None and len(res[41][0]) == 4 and life["deadline_misses"] == 1
    res, _, life = got[5]
    assert res[52] == ([], "deadline") and life["deadline_misses"] == 2
    assert res[50][1] is None and res[51][1] is None
    res, _, life = got[6]
    assert "on_token callback raised" in res[60][1] and "user callback exploded" in res[60][1]
    assert len(res[60][0]) == 1 and res[61][1] is None and len(res[61][0]) == 8
    assert life["callback_errors"] == 1
    res, flags, life = got[7]
    assert flags == [True] and life["callback_errors"] == 2
    assert sorted(r[1] is None for r in res.values()) == [False, True]
    res, _, life = got[8]
    assert all(r[1] is None and len(r[0]) == 40 for r in res.values())
    assert life["pool_pressure_events"] > 0


# -- the port against itself ---------------------------------------------------

@pytest.fixture(scope="module")
def olmo():
    cfg = get_reduced_config("olmo-1b")
    return cfg, build_model(cfg).init(seed=0, device="cpu")


def _sched(cfg, params, **kw):
    return ContinuousScheduler(cfg, params, device="cpu", **dict(KW, **kw))


@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16", "int8"])
def test_failed_requests_emit_a_prefix_and_spare_neighbours(olmo, kv_int8):
    """On bf16 and int8 pools: a request cancelled from its callback, one
    past its deadline_steps and one whose callback raises each return a
    prefix of the stream they emit unperturbed, and their neighbours emit
    exactly the unperturbed tokens; the pool invariants hold after every
    step and nothing leaks once drained."""
    cfg, params = olmo
    cfg = dataclasses.replace(cfg, kv_cache_quant=kv_int8)
    prompts = [PROMPT_A, PROMPT_B, PROMPT_C, LONG[:20], PROMPT_B + 3]

    def serve(perturb):
        sched = _sched(cfg, params, max_batch=3, pool_blocks=None)

        def cancel_at_5(req, tok):
            if len(req.out_tokens) >= 5:
                sched.cancel(req.rid)

        def boom(req, tok):
            if len(req.out_tokens) >= 2:
                raise KeyError("sink")

        extra = {0: dict(on_token=cancel_at_5), 2: dict(deadline_steps=9),
                 3: dict(on_token=boom)} if perturb else {}
        for i, p in enumerate(prompts):
            sched.submit(Request(i, p, max_new_tokens=12, **extra.get(i, {})))
        done = []
        while sched.num_active or sched.num_waiting:
            done.extend(sched.step())
            assert_pool_invariants(sched)
        assert sched._live_blocks == 0 and sched._avail == sched.pool_blocks
        return {r.rid: r for r in done}, sched.pool_stats()

    ref, _ = serve(False)
    got, st = serve(True)
    assert [got[i].error for i in (0, 2)] == ["cancelled", "deadline"]
    assert got[3].error == "on_token callback raised: KeyError('sink')"
    for i in (0, 2, 3):
        assert 0 < len(got[i].out_tokens) < 12
        assert got[i].out_tokens == ref[i].out_tokens[:len(got[i].out_tokens)]
    assert len(got[0].out_tokens) == 5 and len(got[3].out_tokens) == 2
    for i in (1, 4):
        assert got[i].error is None and got[i].out_tokens == ref[i].out_tokens
    assert (st["cancellations"], st["deadline_misses"], st["callback_errors"]) == (1, 1, 1)


def test_deadline_wall_clock_via_run(olmo):
    """deadline_s counts from arrival on run()'s clock: a deadline already
    past fails at once, a generous one does not fire."""
    cfg, params = olmo
    sched = _sched(cfg, params)
    dead = Request(0, PROMPT_A, max_new_tokens=8, deadline_s=0.0)
    fine = Request(1, PROMPT_B, max_new_tokens=8, deadline_s=60.0)
    done = {r.rid: r for r in sched.run([dead, fine])}
    assert done[0].error == "deadline" and done[0].out_tokens == []
    assert done[1].error is None and len(done[1].out_tokens) == 8
    assert sched.deadline_misses == 1
    assert_pool_invariants(sched)


def test_deadline_ignored_without_clock(olmo):
    """Manual step() loops have no wall clock: deadline_s never fires
    there (deadline_steps is the deterministic budget)."""
    cfg, params = olmo
    sched = _sched(cfg, params)
    r = Request(0, PROMPT_A, max_new_tokens=6, deadline_s=0.0)
    sched.submit(r)
    _drain(sched)
    assert r.error is None and len(r.out_tokens) == 6


def test_lifecycle_counters_in_pool_stats(olmo):
    """The counters sit in pool_stats on the paged pool and on the
    contiguous cache, zero on an undisturbed run."""
    cfg, params = olmo
    for kw in ({}, dict(paged=False, chunked_prefill=False, pool_blocks=None)):
        sched = _sched(cfg, params, **kw)
        sched.submit(Request(0, PROMPT_A, max_new_tokens=4))
        _drain(sched)
        st = sched.pool_stats()
        assert {k: st[k] for k in LIFE_COUNTERS} == {k: 0 for k in LIFE_COUNTERS}


def test_engine_cancel(olmo):
    """ServingEngine.cancel: False before the first generate; a request
    cancelling itself through the engine from its callback comes back
    cancelled while the other completes."""
    cfg, params = olmo
    engine = ServingEngine(cfg, params, max_batch=2, bucket=16, block_size=4,
                           prefill_budget=8, device="cpu")
    assert engine.cancel(0) is False
    engine.scheduler(64)

    def stop(req, tok):
        if len(req.out_tokens) >= 2:
            engine.cancel(req.rid)

    a = Request(0, PROMPT_A, max_new_tokens=10, on_token=stop)
    b = Request(1, PROMPT_B, max_new_tokens=10)
    engine.generate([a, b])
    assert a.error == "cancelled" and 2 <= len(a.out_tokens) < 10
    assert b.error is None and len(b.out_tokens) == 10
    assert engine.pool_stats()["cancellations"] == 1


def test_serve_cli_deadline_ms(capsys):
    """--deadline-ms gives every synthetic request a wall-clock deadline;
    at 0.001 ms every request misses it, each retired with its blocks
    freed, and the lifecycle line reports the misses."""
    from repro_torch.launch import serve

    argv = ["--arch", "olmo-1b", "--reduced", "--continuous", "--policy", "w8a8",
            "--tiers", "w8a8,w4a8", "--deadline-ms", "0.001", "--device", "cpu",
            "--requests", "3", "--max-new", "4", "--block-size", "4"]
    engine, done, report = serve.run(serve.build_parser().parse_args(argv))
    assert all(r.error == "deadline" and r.deadline_s == 1e-6 for r in done)
    assert report["stats"]["deadline_misses"] == 6       # warmup and timed pass
    assert_pool_invariants(engine._sched)
    out = capsys.readouterr().out
    assert "lifecycle: 6 deadline misses, 0 cancellations" in out
    assert "precision tiers:" in out
