"""The port's per-request precision tiers, held against ``repro`` and
against itself on the CPU at the reduced olmo-1b config.

Against JAX: ``parse_tier_specs`` and ``degrade_order`` (each refusal's
message), the tier-seeded chain digests byte for byte, the scheduler's
tier refusals, and scripted request sequences through both schedulers in
float32 (a mixed batch on the float32 and the int8 pool, mid-decode
admission, a tier-scoped prefix, an unknown and a malformed tier, a
cancellation inside a mixed batch, speculation with tiers): greedy
tokens, errors, per-tier counters, speculation and lifecycle counters
equal to JAX's. The JAX runs are built once, in a module fixture, each
step waited out on the device (``torch_parity.synced``).
Against itself (bf16 and int8 pools): a mixed batch bitwise each
request's solo-at-tier stream, with and without speculation; every tier
view sharing every tensor with the served params; the serve CLI's
``--tiers`` refusals and a CPU run with its per-tier report.
"""
import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.configs import get_reduced_config as jax_reduced
from repro.core import precision as jprec
from repro.core.quant import QuantConfig as JaxQuantConfig
from repro.models import build_model as jax_build
from repro.serving import ContinuousScheduler as JaxScheduler
from repro.serving import Request as JaxRequest
from repro_torch import convert
from repro_torch.configs import get_reduced_config
from repro_torch.core import precision as tprec
from repro_torch.core.quant import QuantConfig
from repro_torch.core.quantized_linear import PackedWeight
from repro_torch.models import build_model
from repro_torch.serving import ContinuousScheduler, Request, assert_pool_invariants
from torch_parity import leaves, synced, to_numpy_tree

TIERS = "w8a8,w4a8,w2a8"
PROMPT_A = np.zeros(8, np.int64)
PROMPT_B = (np.arange(11) * 5 + 2) % 64      # not a multiple of block or bucket
PROMPT_C = (np.arange(7) * 3 + 1) % 64
PROMPT_P = np.concatenate([PROMPT_C + 9, PROMPT_B]) % 64   # no other prompt's prefix
SPEC_COUNTERS = ("spec_rounds", "spec_draft_tokens", "spec_accepted_tokens",
                 "spec_verify_calls", "spec_verify_rows")
LIFE_COUNTERS = ("cancellations", "deadline_misses", "pool_pressure_events",
                 "queue_wait_steps", "callback_errors")
KW = dict(max_batch=3, max_ctx=64, bucket=16, paged=True, block_size=4,
          chunked_prefill=True, prefill_budget=8)


def _outcome(fn, *args, **kw):
    """fn's result, or the message of the ValueError it raises."""
    try:
        return fn(*args, **kw)
    except ValueError as e:
        return f"ValueError: {e}"


def _fields(out):
    if isinstance(out, str):
        return out
    return [(c.w_bits, c.a_bits, c.mixed_ratio_8b) for c in out]


# -- tier specs, the degrade order, digests -----------------------------------

@pytest.mark.parametrize("spec", ["w8a8,w4a8,w2a8", " w8a8, w4a8 ,w2a8", "w2a8,w8a8",
                                  "w8a8,w4a8r10", "w4a8,w4a8", "", " , ", "w9", "w4a8,x"])
def test_parse_tier_specs_matches_jax(spec):
    """Tier specs parse to JAX's configs in order, and every refusal (a
    mixed 8-bit group, a duplicate, an empty spec, a malformed token)
    carries JAX's message."""
    assert _fields(_outcome(tprec.parse_tier_specs, spec)) == _fields(
        _outcome(jprec.parse_tier_specs, spec))


def test_parse_tier_specs_sequences_match_jax():
    """Sequences of tokens and configs parse as strings do; a duplicate
    across the two forms is refused with JAX's message."""
    assert tprec.parse_tier_specs(["w8a8", QuantConfig(w_bits=4, a_bits=8)]) == (
        QuantConfig(w_bits=8, a_bits=8), QuantConfig(w_bits=4, a_bits=8))
    got = _outcome(tprec.parse_tier_specs, ["w4a8", QuantConfig(w_bits=4, a_bits=8)])
    want = _outcome(jprec.parse_tier_specs, ["w4a8", JaxQuantConfig(w_bits=4, a_bits=8)])
    assert got == want and "duplicate" in got


@pytest.mark.parametrize("tiers", [["w2a8", "w8a8", "w4a8"], ["w4a4", "w4a8", "w8a4"],
                                   ["w4a8"], [], ["w4a8r25"]])
def test_degrade_order_matches_jax(tiers):
    """Quality-descending order (weight bits, then activation bits) as in
    JAX; an empty list and a mixed-group token are refused in its words."""
    assert _fields(_outcome(tprec.degrade_order, tiers)) == _fields(
        _outcome(jprec.degrade_order, tiers))


@pytest.mark.parametrize("tier", [None, "w4a8", "w2a8"])
@pytest.mark.parametrize("n", [32, 37])
def test_hash_chunks_tier_seeded_byte_equal_jax(tier, n):
    """Tier-seeded chain digests are JAX's bytes; tier None keeps the
    untiered seed, and two tiers never share a digest."""
    toks = np.random.default_rng(n).integers(0, 50_000, n)
    ns = SimpleNamespace(block_size=4)
    got = ContinuousScheduler._hash_chunks(ns, toks, tier)
    assert got == JaxScheduler._hash_chunks(ns, toks, tier)
    if tier is None:
        assert got == ContinuousScheduler._hash_chunks(ns, toks)
    else:
        other = ContinuousScheduler._hash_chunks(ns, toks, None)
        assert not set(got[0]) & set(other[0])
        assert (got[1] is None) == (n % 4 == 0) and (got[1] is None or got[1] != other[1])


# -- scripted sequences through both schedulers --------------------------------

def _mixed(sched, make, n=10):
    for rid, prompt, tier in [(1, PROMPT_A, "w8a8"), (2, PROMPT_B, "w4a8"),
                              (3, PROMPT_C, "w2a8")]:
        sched.submit(make(rid, prompt, n, tier=tier))
    return _drain(sched)


def _mid_decode(sched, make):
    sched.submit(make(11, PROMPT_A + 1, 14, tier="w8a8"))
    done = []
    for _ in range(5):
        done.extend(sched.step())
    sched.submit(make(12, PROMPT_B, 8, tier="w2a8"))
    sched.submit(make(13, PROMPT_C + 2, 6, temperature=0.7, tier="w4a8"))
    return done + _drain(sched)


def _prefix_scoped(sched, make):
    """Same tier hits the resident prompt, another tier does not: the
    prefix-hit deltas travel with the tokens as rid -1's 'tokens'."""
    done, hits = [], []
    for rid, tier in [(21, "w4a8"), (22, "w4a8"), (23, "w2a8")]:
        before = sched.pool_stats()["prefix_hit_tokens"]
        sched.submit(make(rid, PROMPT_P, 4, tier=tier))
        done += _drain(sched)
        hits.append(sched.pool_stats()["prefix_hit_tokens"] - before)
    return done + [SimpleNamespace(rid=-1, out_tokens=hits, error=None, temperature=0)]


def _bad_tiers(sched, make):
    """A valid but unconfigured tier and two malformed ones fail only their
    own requests; the storage tier (None) and a configured one serve."""
    for rid, tier in [(31, "w8a4"), (32, "w4a8r25"), (33, "w8a8"), (34, None),
                      (35, "w6a8")]:
        sched.submit(make(rid, PROMPT_A, 4, tier=tier))
    return _drain(sched)


def _cancel_in_mix(sched, make):
    """A live w2a8 row is cancelled while a w8a8 and a w4a8 row decode;
    a queued w4a8 request is cancelled before admission."""
    for rid, prompt, tier in [(41, PROMPT_A + 3, "w8a8"), (42, PROMPT_B, "w2a8"),
                              (43, PROMPT_C, "w4a8"), (44, PROMPT_B + 1, "w4a8")]:
        sched.submit(make(rid, prompt, 12, tier=tier))
    done = []
    for _ in range(6):
        done.extend(sched.step())
    assert sched.cancel(42) and sched.cancel(44)
    return done + _drain(sched)


def _drain(sched):
    out = []
    while sched.num_active or sched.num_waiting:
        out.extend(sched.step())
    return out


# name -> (kv_int8, scheduler kwargs, scenario functions run in order on ONE
# scheduler, so later scenarios meet the prefix cache the earlier ones left)
CONFIGS = {
    "f32": (False, {}, (_mixed, _mid_decode, _prefix_scoped, _bad_tiers,
                        _cancel_in_mix)),
    "int8": (True, {}, (_mixed, _mid_decode)),
    "spec": (False, dict(speculate=3, draft_policy="w2a8"), (_mixed,)),
}
SCENARIOS = [(c, i) for c, (_, _, fns) in CONFIGS.items() for i in range(len(fns))]


def _run_config(name, sched, make):
    """Each scenario's outcome: (tokens and errors by rid, per-tier
    counters, speculation and lifecycle counters after it)."""
    out = []
    for fn in CONFIGS[name][2]:
        done = fn(sched, make)
        st = sched.pool_stats()
        res = {r.rid: (r.out_tokens if r.temperature == 0 else len(r.out_tokens), r.error)
               for r in done}
        out.append((res, st["tiers"], {k: st[k] for k in SPEC_COUNTERS + LIFE_COUNTERS}))
    return out


def _cfgs(kv_int8):
    jcfg = dataclasses.replace(jax_reduced("olmo-1b"), dtype="float32",
                               kv_cache_quant=kv_int8)
    tcfg = dataclasses.replace(get_reduced_config("olmo-1b"), dtype="float32",
                               kv_cache_quant=kv_int8)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def f32_params():
    jcfg, _ = _cfgs(False)
    return jax_build(jcfg).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def jax_runs(f32_params):
    out = {}
    for name, (kv_int8, kw, _) in CONFIGS.items():
        jcfg, _ = _cfgs(kv_int8)
        sched = synced(JaxScheduler(jcfg, f32_params, quant=jprec.parse_policy_spec("w8a8"),
                                    tiers=TIERS, preempt=False, max_head_bypass=0,
                                    **dict(KW, **kw)))
        out[name] = _run_config(name, sched, lambda rid, p, n, **k: JaxRequest(
            rid, p, max_new_tokens=n, **k))
    return out


@pytest.fixture(scope="module")
def torch_runs(f32_params):
    out = {}
    params = convert.params_from_numpy(to_numpy_tree(f32_params), "cpu")
    for name, (kv_int8, kw, _) in CONFIGS.items():
        _, tcfg = _cfgs(kv_int8)
        sched = ContinuousScheduler(tcfg, params, quant=tprec.parse_policy_spec("w8a8"),
                                    tiers=TIERS, preempt=False, max_head_bypass=0,
                                    device="cpu", **dict(KW, **kw))
        out[name] = _run_config(name, sched, lambda rid, p, n, **k: Request(
            rid, p, max_new_tokens=n, **k))
        assert_pool_invariants(sched)
    return out


@pytest.mark.parametrize("config,index", SCENARIOS,
                         ids=[f"{c}-{CONFIGS[c][2][i].__name__[1:]}" for c, i in SCENARIOS])
def test_scheduler_matches_jax(jax_runs, torch_runs, config, index):
    """Greedy tokens (a sampled request's count), errors, per-tier
    counters, speculation and lifecycle counters equal to the JAX
    scheduler's after each scenario of the sequence."""
    want, got = jax_runs[config][index], torch_runs[config][index]
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]


def test_scenario_outcomes(torch_runs):
    """What the sequences above must show, beyond agreeing with JAX:
    every tier served and counted, mid-decode admission, same-tier hits
    and no cross-tier hit, bad tiers failing alone, a cancellation in a
    mixed batch, and speculation only for slots above the w2 draft."""
    res, tiers, _ = torch_runs["f32"][0]
    assert all(res[r][1] is None and len(res[r][0]) == 10 for r in (1, 2, 3))
    assert all(tiers[t]["requests"] == 1 and tiers[t]["tokens"] == 10
               and tiers[t]["decode_calls"] > 0 for t in ("w8a8", "w4a8", "w2a8"))
    hits = torch_runs["f32"][2][0][-1][0]
    assert hits[0] == 0 and hits[1] > 0 and hits[2] == 0
    res = torch_runs["f32"][3][0]
    assert "unknown precision tier 'w8a4'" in res[31][1] and res[31][0] == []
    assert "bad precision tier" in res[32][1] and res[32][0] == []
    assert "bad precision tier" in res[35][1] and res[35][0] == []
    assert res[33][1] is None and len(res[33][0]) == 4
    assert res[34][1] is None and torch_runs["f32"][3][1]["base"]["requests"] == 1
    res, _, life = torch_runs["f32"][4]
    assert res[42][1] == res[44][1] == "cancelled" and res[44][0] == []
    assert 0 < len(res[42][0]) < 12 and life["cancellations"] == 2
    assert all(res[r][1] is None and len(res[r][0]) == 12 for r in (41, 43))
    _, tiers, spec = torch_runs["spec"][0]
    assert tiers["w8a8"]["spec_draft_tokens"] > 0 and tiers["w4a8"]["spec_draft_tokens"] > 0
    assert tiers["w2a8"]["spec_draft_tokens"] == 0
    assert spec["spec_verify_rows"] >= spec["spec_verify_calls"] > 0


@pytest.mark.parametrize("kwargs,match", [
    (dict(paged=False, chunked_prefill=False), "paged KV cache"),
    (dict(quant=None), "quant policy"),
    (dict(tiers="w4a4"), "activation precision"),
    (dict(tiers="w8a8,w8a8"), "duplicate"),
    (dict(tiers="w8a8,w4a8r10"), "plane subset"),
    (dict(tiers="w5a8"), "w_bits must be one of"),
])
def test_scheduler_tier_refusals_match_jax(f32_params, kwargs, match):
    """A non-paged pool, unpacked params, a change of activation bits, a
    duplicate tier, a mixed-group tier and a width no config has are
    refused with JAX's messages."""
    jcfg, tcfg = _cfgs(False)
    args = dict(KW, tiers=TIERS)
    args.update(kwargs)
    jq = args.pop("quant", "w8a8")
    tparams = convert.params_from_numpy(to_numpy_tree(f32_params), "cpu")
    want = _outcome(JaxScheduler, jcfg, f32_params, preempt=False,
                    quant=None if jq is None else jprec.parse_policy_spec(jq), **args)
    got = _outcome(ContinuousScheduler, tcfg, tparams, preempt=False, device="cpu",
                   quant=None if jq is None else tprec.parse_policy_spec(jq), **args)
    assert isinstance(got, str) and match in got
    assert got == want


# -- the port against itself ---------------------------------------------------

@pytest.fixture(scope="module")
def olmo():
    cfg = get_reduced_config("olmo-1b")
    return cfg, build_model(cfg).init(seed=0, device="cpu")


def _sched(cfg, params, tiers=TIERS, **kw):
    return ContinuousScheduler(cfg, params, quant=QuantConfig(w_bits=8, a_bits=8),
                               tiers=tiers, device="cpu", **dict(KW, **kw))


def _streams(done):
    return {r.rid: r.out_tokens for r in done}


JOBS = [(1, PROMPT_A, "w8a8", 0.0), (2, PROMPT_B, "w4a8", 0.7), (3, PROMPT_C, "w2a8", 0.0),
        (4, PROMPT_P, "w4a8", 0.0), (5, PROMPT_B + 1, "w2a8", 0.7)]


@pytest.mark.parametrize("kv_int8,speculate", [(False, 0), (True, 0), (False, 3)],
                         ids=["bf16", "int8", "bf16-spec"])
def test_mixed_batch_bitwise_solo_at_tier(olmo, kv_int8, speculate):
    """Five requests at three tiers (greedy and sampled, two admitted
    mid-decode) in one batch: every stream, sampled ones included, equals
    the stream of an engine configured with that request's tier alone,
    with the same flags; the pool holds its invariants."""
    cfg, params = olmo
    cfg = dataclasses.replace(cfg, kv_cache_quant=kv_int8)
    spec = dict(speculate=speculate, draft_policy="w2a8") if speculate else {}

    def make(job):
        rid, prompt, tier, temp = job
        return Request(rid, prompt, max_new_tokens=10, temperature=temp, tier=tier)

    sched = _sched(cfg, params, **spec)
    for job in JOBS[:3]:
        sched.submit(make(job))
    done = [r for _ in range(4) for r in sched.step()]
    for job in JOBS[3:]:
        sched.submit(make(job))
    done += _drain(sched)
    assert_pool_invariants(sched)
    mixed = _streams(done)
    st = sched.pool_stats()
    assert sum(tc["decode_calls"] for tc in st["tiers"].values()) > sched.steps_run
    for tier in ("w8a8", "w4a8", "w2a8"):
        solo = _sched(cfg, params, tiers=tier, **spec)
        for job in JOBS:
            if job[2] == tier:
                solo.submit(make(job))
        got = _streams(_drain(solo))
        assert_pool_invariants(solo)
        assert got == {rid: mixed[rid] for rid in got}, tier
        assert solo.pool_stats()["tiers"][tier]["tokens"] == st["tiers"][tier]["tokens"]
    if speculate:
        assert st["tiers"]["w2a8"]["spec_draft_tokens"] == 0
        assert st["tiers"]["w8a8"]["spec_draft_tokens"] > 0


def test_tier_views_share_every_tensor(olmo):
    """Each tier view is the storage params with plane_lo set: every packed
    byte, scale and unpacked leaf is the served params' own object, the
    storage tier is the params object itself."""
    cfg, params = olmo
    sched = _sched(cfg, params)
    assert sched._tier_views[None] is sched.params
    assert sched._tier_views["w8a8"] is sched.params
    assert sched.tiers == ("w8a8", "w4a8", "w2a8")
    src = dict(leaves(sched.params))
    for key, lo in (("w4a8", 2), ("w2a8", 3)):
        n = 0
        for path, leaf in leaves(sched._tier_views[key]):
            if isinstance(leaf, PackedWeight):
                n += 1
                assert leaf.plane_lo == lo, path
                assert leaf.packed is src[path].packed and leaf.scale is src[path].scale
            else:
                assert leaf is src[path], path
        assert n > 0


@pytest.mark.parametrize("argv,match", [
    (["--policy", "w8a8", "--tiers", TIERS], "add --continuous"),
    (["--static", "--policy", "w8a8", "--tiers", TIERS], "add --continuous"),
    (["--continuous", "--tiers", TIERS], "add a quant policy"),
])
def test_serve_cli_tier_refusals(argv, match):
    """--tiers without --continuous or without a policy exits with JAX's
    words."""
    from repro_torch.launch import serve

    base = ["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--requests", "2",
            "--max-new", "3"]
    with pytest.raises(SystemExit, match=match):
        serve.run(serve.build_parser().parse_args(base + argv))


def test_serve_cli_tiers_on_cpu(capsys):
    """--tiers assigns tiers round-robin and prints the per-tier report;
    each greedy request emits what a run with only its tier emits."""
    from repro_torch.launch import serve

    argv = ["--arch", "olmo-1b", "--reduced", "--continuous", "--policy", "w8a8",
            "--device", "cpu", "--requests", "6", "--max-new", "5", "--block-size", "4",
            "--prefill-budget", "8"]
    _, done, report = serve.run(serve.build_parser().parse_args(argv + ["--tiers", TIERS]))
    assert [r.tier for r in sorted(done, key=lambda r: r.rid)] == TIERS.split(",") * 2
    st = report["stats"]
    assert st["tier_serving"]
    assert all(st["tiers"][t]["requests"] == 4 for t in TIERS.split(","))
    assert "precision tiers:" in capsys.readouterr().out
    mixed = {r.rid: r.out_tokens for r in done if r.temperature == 0}
    _, solo, _ = serve.run(serve.build_parser().parse_args(argv + ["--tiers", "w4a8"]))
    for r in solo:
        if r.temperature == 0 and mixed.get(r.rid) is not None and r.rid % 3 == 1:
            assert r.out_tokens == mixed[r.rid]
