"""The port's seeded fault injection over its serving stack, held against
``repro`` and against itself on the CPU at the reduced olmo-1b config.

Every fault kind degrades ONE request or ONE call, never the engine:
alloc faults become ordinary pool pressure (queueing, preemption,
bypass), kernel faults dispatch the same decode call again, NaN-poisoned
logits fail exactly the poisoned request, and raising callbacks are
contained. Against JAX: the injector fires JAX's schedule bitwise for
each kind and seed, and one run with all four seams armed gives JAX's
``counts()``, failed requests and greedy tokens (the JAX run waited out
step by step, ``torch_parity.synced``). Against itself: the injector cases
of ``tests/test_chaos.py``, each seam alone, the seeded sweep over seeds
0-2, a real decode error escaping ``step()``, and the serve CLI's chaos
flags.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_reduced_config as jax_reduced
from repro.core.precision import parse_policy_spec as jax_policy
from repro.models import build_model as jax_build
from repro.serving import ContinuousScheduler as JaxScheduler
from repro.serving import FaultInjector as JaxFaultInjector
from repro.serving import Request as JaxRequest
from repro_torch import convert
from repro_torch.configs import get_reduced_config
from repro_torch.core.precision import parse_policy_spec
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.serving import (ContinuousScheduler, FaultInjector, InjectedFault,
                                 Request, assert_pool_invariants)
from repro_torch.serving.chaos import FAULT_KINDS
from torch_parity import synced, to_numpy_tree

P8 = (np.arange(8) * 3 + 1) % 64
P11 = (np.arange(11) * 5 + 2) % 64


@pytest.fixture(scope="module")
def olmo():
    cfg = get_reduced_config("olmo-1b")
    return cfg, build_model(cfg).init(seed=0, device="cpu")


def _sched(cfg, params, **kw):
    args = dict(max_batch=2, max_ctx=64, bucket=16, paged=True, block_size=4,
                device="cpu")
    args.update(kw)
    return ContinuousScheduler(cfg, params, **args)


def _drain(sched, cap=400):
    """Step to empty, the pool invariants held at every step boundary."""
    out, steps = [], 0
    while sched.num_active or sched.num_waiting:
        out.extend(sched.step())
        assert_pool_invariants(sched)
        steps += 1
        assert steps < cap, "scheduler failed to drain under faults"
    return out


def _workload(make=Request, n=4, **kw):
    return [make(i, (P8 if i % 2 else P11) + i, max_new_tokens=6, **kw)
            for i in range(n)]


def _serve(cfg, params, chaos=None, **kw):
    sched = _sched(cfg, params, chaos=chaos, **kw)
    for r in _workload():
        sched.submit(r)
    return sched, {r.rid: r for r in _drain(sched)}


# -- the injector itself -------------------------------------------------------

def test_injector_is_deterministic():
    a = FaultInjector(7, p_kernel=0.3, p_nan=0.1)
    b = FaultInjector(7, p_kernel=0.3, p_nan=0.1)
    sched_a = [a.fire("kernel") for _ in range(50)]
    assert sched_a == [b.fire("kernel") for _ in range(50)]
    assert any(sched_a)
    assert a.counts() == b.counts()


def test_injector_streams_are_independent():
    """Enabling one kind never shifts another kind's schedule."""
    solo = FaultInjector(3, p_nan=0.2)
    both = FaultInjector(3, p_nan=0.2, p_kernel=0.9)
    solo_sched, both_sched = [], []
    for _ in range(40):
        both.fire("kernel")
        solo_sched.append(solo.fire("nan"))
        both_sched.append(both.fire("nan"))
    assert solo_sched == both_sched


def test_injector_zero_rate_never_draws_entropy():
    inj = FaultInjector(0, p_alloc=0.0)
    assert not any(inj.fire("alloc") for _ in range(20))
    assert inj.draws["alloc"] == 20 and inj.fired["alloc"] == 0


def test_injector_max_faults_cap():
    inj = FaultInjector(1, p_kernel=1.0, max_faults=3)
    fires = [inj.fire("kernel") for _ in range(10)]
    assert sum(fires) == 3 and fires[:3] == [True] * 3
    assert inj.total_fired == 3


def test_injector_validation():
    with pytest.raises(ValueError, match="p_nan"):
        FaultInjector(0, p_nan=1.5)
    with pytest.raises(ValueError, match="max_faults"):
        FaultInjector(0, max_faults=-1)
    inj = FaultInjector(5)
    assert {inj.pick(3) for _ in range(50)} <= {0, 1, 2}
    assert issubclass(InjectedFault, RuntimeError)


@pytest.mark.parametrize("seed", [0, 1, 7, 2**40 + 3])
@pytest.mark.parametrize("kind", FAULT_KINDS)
def test_injector_fires_jaxs_schedule(kind, seed):
    """Side by side with JAX's injector, for each kind and seed: the same
    visits fire the same faults, the victim picks agree, and so do the
    counts — with the other kinds armed and the cap reached."""
    rates = dict(p_alloc=0.3, p_kernel=0.6, p_nan=0.1, p_callback=0.05)
    for cap in (None, 7):
        port = FaultInjector(seed, max_faults=cap, **rates)
        ref = JaxFaultInjector(seed, max_faults=cap, **rates)
        got, want = [], []
        for i in range(200):
            other = FAULT_KINDS[i % len(FAULT_KINDS)]
            got.append((port.fire(kind), port.fire(other), port.pick(1 + i % 5)))
            want.append((ref.fire(kind), ref.fire(other), ref.pick(1 + i % 5)))
        assert got == want
        assert port.counts() == ref.counts()


# -- one seam at a time ----------------------------------------------------------

def test_kernel_fault_redispatches_bit_identically(olmo):
    """Every decode dispatch 'fails' (capped): the call dispatched again
    keeps each stream bitwise the fault-free run."""
    cfg, params = olmo
    _, clean = _serve(cfg, params)
    sched, done = _serve(cfg, params, FaultInjector(11, p_kernel=1.0, max_faults=8))
    assert sched.kernel_fallbacks == 8 == sched.chaos.fired["kernel"]
    for rid, r in done.items():
        assert r.error is None
        assert r.out_tokens == clean[rid].out_tokens


def test_nan_fault_fails_only_poisoned_request(olmo):
    cfg, params = olmo
    _, clean = _serve(cfg, params)
    sched, done = _serve(cfg, params, FaultInjector(2, p_nan=1.0, max_faults=1))
    assert sched.nan_logit_events == 1
    poisoned = [r for r in done.values() if r.error == "nan-logits"]
    assert len(poisoned) == 1
    p = poisoned[0]
    assert p.out_tokens == clean[p.rid].out_tokens[:len(p.out_tokens)]
    for r in done.values():
        if r.error is None:
            assert r.out_tokens == clean[r.rid].out_tokens


def test_alloc_fault_degrades_to_pool_pressure(olmo):
    """A failed reservation behaves exactly like a full pool: the request
    waits (or preempts or bypasses) and every request still completes,
    bitwise the clean run."""
    cfg, params = olmo
    _, clean = _serve(cfg, params)
    sched, done = _serve(cfg, params, FaultInjector(4, p_alloc=0.5, max_faults=6))
    assert sched.pool_pressure_events >= sched.chaos.fired["alloc"] >= 1
    for rid, r in done.items():
        assert r.error is None
        assert r.out_tokens == clean[rid].out_tokens


def test_callback_fault_is_contained(olmo):
    cfg, params = olmo
    seen = []
    sched = _sched(cfg, params, on_token=lambda r, t: seen.append(t),
                   chaos=FaultInjector(9, p_callback=1.0, max_faults=1))
    for r in _workload():
        sched.submit(r)
    done = {r.rid: r for r in _drain(sched)}
    assert sched.callback_errors == 1
    errored = [r for r in done.values() if r.error]
    assert len(errored) == 1 and "callback" in errored[0].error
    assert len(seen) > 0                 # the stream kept flowing


def test_callback_seam_draws_only_with_a_callback(olmo):
    cfg, params = olmo
    sched, _ = _serve(cfg, params, FaultInjector(9, p_callback=1.0))
    assert sched.chaos.draws["callback"] == 0 and sched.callback_errors == 0


# -- seeded end-to-end sweep -----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_chaos_sweep(olmo, seed):
    """All four seams armed at once over an overcommitted pool: bounded
    steps, every request terminal, the pool invariants at every step,
    survivors bitwise the fault-free run, failed requests a prefix of it,
    and the same seed replays the same faults."""
    cfg, params = olmo
    kw = dict(pool_blocks=10)
    _, clean = _serve(cfg, params, **kw)

    def chaos():
        return FaultInjector(seed, p_alloc=0.15, p_kernel=0.15, p_nan=0.05,
                             p_callback=0.05, max_faults=12)

    sched, done = _serve(cfg, params, chaos(), **kw)
    assert len(done) == 4
    for r in done.values():
        assert r.out_tokens is not None             # terminal, always
        if r.error is None:
            assert r.out_tokens == clean[r.rid].out_tokens
        else:
            assert r.out_tokens == clean[r.rid].out_tokens[:len(r.out_tokens)]
    assert sched.kernel_fallbacks == sched.chaos.fired["kernel"]
    assert sched.nan_logit_events == sched.chaos.fired["nan"]
    counts = sched.chaos.counts()

    sched2, done2 = _serve(cfg, params, chaos(), **kw)
    assert sched2.chaos.counts() == counts
    assert {rid: (r.error, r.out_tokens) for rid, r in done2.items()} == {
        rid: (r.error, r.out_tokens) for rid, r in done.items()}


def test_chaos_counts_surface_in_pool_stats(olmo):
    cfg, params = olmo
    sched, _ = _serve(cfg, params, FaultInjector(6, p_kernel=0.5, max_faults=2))
    stats = sched.pool_stats()
    ch = stats["chaos"]
    assert ch["seed"] == 6 and ch["total_fired"] == 2
    assert ch["fired"]["kernel"] == 2 and ch["draws"]["kernel"] >= 2
    assert stats["kernel_fallbacks"] == 2
    assert _sched(cfg, params).pool_stats()["chaos"] is None


@pytest.mark.parametrize("armed", [False, True], ids=["no-chaos", "kernel-chaos"])
def test_real_decode_error_escapes_step(olmo, armed):
    """The decode seam catches only InjectedFault: a RuntimeError from the
    model propagates out of step() and is not counted as a re-dispatch
    (armed, the injected fault before it is counted, and the re-dispatch
    raises the real error)."""
    cfg, params = olmo
    sched = _sched(cfg, params, chaos=FaultInjector(0, p_kernel=1.0) if armed else None)
    for r in _workload():
        sched.submit(r)
    sched.step()
    before = sched.kernel_fallbacks
    assert before == (1 if armed else 0)

    def broken(*args, **kwargs):
        raise RuntimeError("device fault")

    sched.model.decode_step = broken
    with pytest.raises(RuntimeError, match="device fault"):
        sched.step()
    assert sched.kernel_fallbacks == before + armed


# -- against the JAX scheduler, every seam armed ---------------------------------

POLICY = "w4a8;wo=w8a8"
PARITY_KW = dict(max_batch=2, max_ctx=64, bucket=16, paged=True, block_size=4,
                 prefill_budget=8, pool_blocks=10)


def _chaos_run(sched, make):
    """Six greedy requests, each with an on_token, through an armed
    scheduler: (tokens and errors by rid, chaos counts, the counters each
    seam moves)."""
    for r in _workload(make, n=6, on_token=lambda req, tok: None):
        sched.submit(r)
    done = []
    while sched.num_active or sched.num_waiting:
        done.extend(sched.step())
    st = sched.pool_stats()
    return ({r.rid: (r.out_tokens, r.error) for r in done}, st["chaos"],
            {k: st[k] for k in ("kernel_fallbacks", "nan_logit_events",
                                "callback_errors", "pool_pressure_events",
                                "preemptions", "head_bypasses")})


@pytest.fixture(scope="module")
def parity_runs():
    jcfg = dataclasses.replace(jax_reduced("olmo-1b"), dtype="float32")
    tcfg = dataclasses.replace(get_reduced_config("olmo-1b"), dtype="float32")
    params = jax_build(jcfg).init(jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(to_numpy_tree(params), "cpu")
    rates = dict(p_alloc=0.2, p_kernel=0.2, p_nan=0.06, p_callback=0.06, max_faults=12)
    out = {}
    for chunked in (True, False):
        jsched = synced(JaxScheduler(jcfg, params, quant=jax_policy(POLICY),
                                     chunked_prefill=chunked,
                                     chaos=JaxFaultInjector(5, **rates), **PARITY_KW))
        want = _chaos_run(jsched, JaxRequest)
        tsched = ContinuousScheduler(tcfg, tparams, quant=parse_policy_spec(POLICY),
                                     chunked_prefill=chunked, device="cpu",
                                     chaos=FaultInjector(5, **rates), **PARITY_KW)
        got = _chaos_run(tsched, Request)
        out[chunked] = (want, got, tsched)
    return out


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
def test_chaos_run_matches_jax(parity_runs, chunked):
    """Every seam armed: the same counts(), failed requests, greedy tokens
    and seam counters as the JAX scheduler; every seam fired."""
    want, got, tsched = parity_runs[chunked]
    assert got == want
    _, counts, counters = got
    assert all(counts["fired"][k] >= 1 for k in FAULT_KINDS), counts
    assert counters["kernel_fallbacks"] == counts["fired"]["kernel"]
    assert counters["nan_logit_events"] == counts["fired"]["nan"]
    assert_pool_invariants(tsched)


# -- the serve CLI ---------------------------------------------------------------

def test_serve_cli_chaos_flags_on_cpu(capsys):
    """--pool-blocks, --chaos-seed and --chaos-rate: the lifecycle and chaos
    lines are printed and the run ends normally."""
    serve.main(["--arch", "olmo-1b", "--reduced", "--continuous", "--policy",
                "w4a8;wo=w8a8", "--requests", "6", "--max-new", "6", "--max-batch", "2",
                "--block-size", "4", "--pool-blocks", "9", "--chaos-seed", "3",
                "--chaos-rate", "0.2", "--chaos-max-faults", "6", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "  lifecycle: " in out and "preemptions (policy=most-blocks)" in out
    chaos = next(line for line in out.splitlines() if line.startswith("  chaos: seed=3 "))
    assert "re-dispatched decode calls" in chaos and "NaN-logit retirements" in chaos


@pytest.mark.parametrize("argv, match", [
    (["--degrade"], "--degrade lowers admissions"),
    (["--victim-policy", "block-to-host"], "host tier"),
])
def test_serve_cli_pressure_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        serve.main(["--arch", "olmo-1b", "--reduced", "--continuous", "--device", "cpu",
                    *argv])
