"""The port's host-RAM block tier, ``block-to-host`` preemption and the
durable prefix index, held against itself and against ``repro`` on the
CPU at the reduced olmo-1b config (block size 4, as the JAX fixtures).

Against itself: the counterpart of each case of ``tests/test_host_tier.py``
— a prefix chunk the pool evicted to the host store and swapped back
serves exactly the tokens of a cold prefill on bf16 and int8 pools (in
both admission modes), with precision tiers and when admitted
mid-decode; a ``block-to-host`` victim resumes with its uninterrupted
stream; the two refusals; the byte budget drops the oldest entries; the
index survives a restart (bf16 and int8), a ``max_ctx`` rebuild and a
save before the first ``generate``; another geometry and a disabled
tier load nothing; an injected reservation failure leaves the host
store untouched. Every scenario ends with the pool invariants, the
host half included.

Against JAX: ``write_pool_block`` bitwise on bf16 and int8 pools; the
``_serve_twice`` stream through both schedulers with the same host
budget on weights carried by ``repro_torch.convert`` (float32 and int8
pools, both admission modes, a budget of two blocks, ``block-to-host``
preemption): equal greedy tokens and equal host and prefix counters;
and an index written by either package loads in the other with the same
digest count and bitwise-equal block bytes (bf16 bits, int8 codes,
scale planes), then serves the stream warm from host. The JAX schedulers
are wrapped by ``torch_parity.synced``. Seeds are fixed and nothing is
drawn by hypothesis.
"""
import base64
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.core.precision import parse_policy_spec as jax_policy
from repro.models import build_model as jax_build
from repro.models import kv_cache as jkv
from repro.serving import ContinuousScheduler as JaxScheduler
from repro.serving import Request as JaxRequest
from repro_torch import convert
from repro_torch.configs import get_reduced_config
from repro_torch.core.precision import parse_policy_spec
from repro_torch.core.quant import QuantConfig
from repro_torch.models import build_model
from repro_torch.models import kv_cache as tkv
from repro_torch.serving import (ContinuousScheduler, FaultInjector, Request,
                                 ServingEngine, assert_pool_invariants)
from repro_torch.serving.scheduler import INDEX_SCHEMA, INDEX_VERSION
from torch_parity import np_of, synced, to_numpy_tree

Q8 = QuantConfig(w_bits=8, a_bits=8)
SYS = np.arange(24) % 64                      # shared prefix: 6 blocks @4
HOSTKB = 1 << 20                              # roomy host budget
POLICY = "w4a8;wo=w8a8"
MODES = pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
HOST_COUNTERS = ("swap_ins", "swap_outs", "host_hit_blocks", "host_hit_tokens",
                 "host_evictions", "host_blocks", "host_bytes")
# test_torch_prefix_cache.COUNTERS
PREFIX_COUNTERS = ("prefix_hit_blocks", "prefix_hit_tokens", "cow_copies",
                   "prefix_evictions", "cached_prefix_blocks", "retained_prefix_blocks",
                   "peak_allocated_blocks")


@pytest.fixture(scope="module")
def olmo():
    cfg = get_reduced_config("olmo-1b")
    return cfg, build_model(cfg).init(seed=0, device="cpu")


@pytest.fixture(scope="module")
def olmo_int8():
    cfg = dataclasses.replace(get_reduced_config("olmo-1b"), kv_cache_quant=True)
    return cfg, build_model(cfg).init(seed=0, device="cpu")


def _sched(cfg, params, **kw):
    args = dict(max_batch=2, max_ctx=48, bucket=16, paged=True, block_size=4,
                chunked_prefill=False, prefill_budget=8, device="cpu")
    args.update(kw)
    return ContinuousScheduler(cfg, params, **args)


def _drain(sched, cap=400):
    """Step to empty, the pool invariants held at every step boundary."""
    out, steps = [], 0
    while sched.num_active or sched.num_waiting:
        out.extend(sched.step())
        assert_pool_invariants(sched)
        steps += 1
        assert steps < cap, "scheduler failed to drain (deadlock?)"
    return out


def _requests(n=4, tail=3, max_new=4, cls=Request, **kw):
    rng = np.random.default_rng(7)
    return [cls(rid=i, prompt=np.concatenate(
                [SYS, rng.integers(0, 64, tail + i)]).astype(np.int64),
                max_new_tokens=max_new, temperature=0.0, **kw)
            for i in range(n)]


def _serve_twice(cfg, params, host_bytes, **kw):
    """Serve the same stream twice through one scheduler on a pool small
    enough that round 1's cached blocks are evicted before round 2.
    Returns (scheduler, round 1 tokens, round 2 tokens)."""
    kw.setdefault("pool_blocks", 14)
    sched = _sched(cfg, params, host_pool_bytes=host_bytes, **kw)
    a = _requests()
    sched.run(a)
    assert_pool_invariants(sched)
    b = _requests()
    sched.run(b)
    assert_pool_invariants(sched)
    return sched, [r.out_tokens for r in a], [r.out_tokens for r in b]


# -- the bit-identity contract --------------------------------------------------

@MODES
@pytest.mark.parametrize("fixture", ["olmo", "olmo_int8"])
def test_warm_from_host_bit_identical(fixture, chunked, request):
    """Round 2 serves round 1's prompts after the pool churned their
    blocks out to host: every stream equals the run without the tier,
    and the swap counters show the tier carried hits."""
    cfg, params = request.getfixturevalue(fixture)
    _, c1, c2 = _serve_twice(cfg, params, 0, chunked_prefill=chunked)
    sched, h1, h2 = _serve_twice(cfg, params, HOSTKB, chunked_prefill=chunked)
    assert h1 == c1 and h2 == c2
    st = sched.pool_stats()
    assert st["host_tier"] and st["swap_outs"] > 0
    assert st["swap_ins"] > 0 and st["host_hit_blocks"] > 0
    assert st["host_hit_rate"] > 0
    assert st["host_bytes"] <= st["host_pool_bytes"]


@MODES
def test_warm_from_host_bit_identical_tiers(olmo, chunked):
    """Digests are tier-seeded, so a w4a8 request never hits a w8a8
    chunk, through the host tier too."""
    cfg, params = olmo
    kw = dict(quant=Q8, tiers="w8a8,w4a8", pool_blocks=14, chunked_prefill=chunked)

    def reqs():
        rs = _requests()
        for r in rs:
            r.tier = ("w8a8", "w4a8")[r.rid % 2]
        return rs

    def toks(done):
        return [r.out_tokens for r in sorted(done, key=lambda r: r.rid)]

    cold = _sched(cfg, params, **kw)
    cold.run(reqs())
    c1 = toks(cold.run(reqs()))
    warm = _sched(cfg, params, host_pool_bytes=HOSTKB, **kw)
    warm.run(reqs())
    w1 = toks(warm.run(reqs()))
    assert w1 == c1
    assert_pool_invariants(warm)
    assert warm.pool_stats()["swap_ins"] > 0

    # A w8a8 prompt of its own, churned out to host by the stream: its
    # host entries serve it at w8a8 and never at w4a8.
    own = (np.arange(12) * 11 + 5) % 64
    warm.run([Request(50, own, max_new_tokens=2, tier="w8a8")])
    warm.run(reqs())
    assert any(h in warm._host_index for h in warm._hash_chunks(own, "w8a8")[0])
    for tier, hit in (("w8a8", True), ("w4a8", False)):
        probe = Request(51, own, max_new_tokens=2, tier=tier)
        assert warm._reject_reason(probe) is None
        m = warm._match_prefix(probe)
        assert bool(m[0] or m[5]) == hit, tier
    assert_pool_invariants(warm)


@MODES
def test_warm_from_host_mid_decode(olmo, chunked):
    """A host-resident prefix admitted while another row is mid-decode
    swaps back in without disturbing either stream."""
    cfg, params = olmo

    def run(host_bytes):
        sched = _sched(cfg, params, pool_blocks=14, host_pool_bytes=host_bytes,
                       chunked_prefill=chunked)
        sched.run(_requests())               # populate, then churn out
        long = Request(90, (np.arange(9) * 5 + 1) % 64, max_new_tokens=10)
        sched.submit(long)
        for _ in range(3):
            sched.step()
        rejoin = _requests(n=1, max_new=6)[0]
        sched.submit(rejoin)
        _drain(sched)
        return sched, long.out_tokens, rejoin.out_tokens

    _, cold_long, cold_rejoin = run(0)
    sched, warm_long, warm_rejoin = run(HOSTKB)
    assert warm_long == cold_long
    assert warm_rejoin == cold_rejoin
    assert sched.pool_stats()["swap_ins"] > 0


def test_alloc_fault_leaves_host_store(olmo):
    """An injected reservation failure (the chaos ``alloc`` seam) before an
    admission that would swap blocks in leaves the host store as it was;
    the next step admits, swaps them in, and the stream is the cold
    one's."""
    cfg, params = olmo
    _, _, cold = _serve_twice(cfg, params, 0)
    sched = _sched(cfg, params, pool_blocks=14, host_pool_bytes=HOSTKB)
    sched.run(_requests())
    req = _requests(n=1)[0]
    assert sched._reject_reason(req) is None and sched._match_prefix(req)[5]

    def snapshot():
        return ({hid: (frozenset(e.digests), e.nbytes)
                 for hid, e in sched._host_store.items()},
                dict(sched._host_index), sched.host_bytes, sched.swap_ins)

    before = snapshot()
    sched.chaos = FaultInjector(0, p_alloc=1.0, max_faults=1)
    sched.submit(req)
    sched.step()
    assert sched.chaos.counts()["fired"]["alloc"] == 1
    assert snapshot() == before and sched.num_waiting == 1
    assert_pool_invariants(sched)
    _drain(sched)
    assert sched.swap_ins > before[3]
    assert req.out_tokens == cold[0]


# -- block-to-host preemption ------------------------------------------------------

P8 = (np.arange(8) * 3 + 1) % 64
P16 = (np.arange(16) * 7 + 3) % 64


def _preempt_scenario(sched, cls=Request):
    """r1 decodes alone for 3 steps, then r2 arrives on a pool too small
    for both: r1 is preempted and resumes."""
    r1 = cls(1, P8, max_new_tokens=12)
    r2 = cls(2, P16, max_new_tokens=8)
    sched.submit(r1)
    for _ in range(3):
        sched.step()
    sched.submit(r2)
    while sched.num_active or sched.num_waiting:
        sched.step()
    return r1, r2


@MODES
def test_block_to_host_preempt_resume_bit_identical(olmo, chunked):
    """Under victim_policy=block-to-host the victim's blocks spill to
    host at once; its resume still emits exactly the uninterrupted
    stream, and it hits its whole prompt."""
    cfg, params = olmo
    solo = _sched(cfg, params, pool_blocks=64, max_ctx=64, chunked_prefill=chunked)
    ref1 = Request(1, P8, max_new_tokens=12)
    ref2 = Request(2, P16, max_new_tokens=8)
    solo.run([ref1])
    solo.run([ref2])

    sched = _sched(cfg, params, pool_blocks=10, max_ctx=64, chunked_prefill=chunked,
                   host_pool_bytes=HOSTKB, victim_policy="block-to-host")
    r1, r2 = _preempt_scenario(sched)
    assert_pool_invariants(sched)
    assert r1.error is None and r2.error is None
    assert sched.preemptions >= 1 and r1.preemptions >= 1
    assert r1.out_tokens == ref1.out_tokens
    assert r2.out_tokens == ref2.out_tokens
    st = sched.pool_stats()
    assert st["victim_policy"] == "block-to-host"
    assert st["swap_outs"] > 0 and st["swap_ins"] > 0
    assert st["prefix_hit_tokens"] >= len(P8)


def test_block_to_host_requires_host_tier(olmo):
    cfg, params = olmo
    with pytest.raises(ValueError, match="block-to-host"):
        _sched(cfg, params, victim_policy="block-to-host")
    with pytest.raises(ValueError, match="host_pool_bytes"):
        _sched(cfg, params, paged=False, host_pool_bytes=HOSTKB)


# -- the byte budget ----------------------------------------------------------------

def test_host_budget_evicts_oldest(olmo):
    """A budget smaller than the working set drops the oldest entries
    first and never overshoots; the invariants (host-byte conservation
    included) hold throughout."""
    cfg, params = olmo
    probe = _sched(cfg, params, host_pool_bytes=HOSTKB)
    one = probe._host_block_nbytes()
    assert one == 2 * cfg.num_layers * 4 * cfg.n_kv_heads * cfg.head_dim * 2
    budget = 2 * one                        # room for exactly two blocks
    sched, _, _ = _serve_twice(cfg, params, budget)
    st = sched.pool_stats()
    assert st["host_bytes"] <= budget
    assert st["host_blocks"] <= 2
    assert st["host_evictions"] > 0
    assert list(sched._host_store) == sorted(sched._host_store)
    assert_pool_invariants(sched)

    # Oldest first, directly: three spills into a two-block budget drop
    # the first one's digests and keep the newer two.
    s = _sched(cfg, params, host_pool_bytes=budget, pool_blocks=8)
    digests = []
    for blk in (1, 2, 3):
        h = bytes([blk]) * 16
        digests.append(h)
        s._prefix_index[h] = blk
        s._block_hash[blk] = {h}
        s._free.remove(blk)
        s._spill_block(blk)
        s._free.append(blk)
    assert s.host_evictions == 1 and s.swap_outs == 3
    assert digests[0] not in s._host_index
    assert [s._host_store[s._host_index[h]].digests for h in digests[1:]] == [
        {digests[1]}, {digests[2]}]
    assert_pool_invariants(s)


# -- the durable prefix index ------------------------------------------------------

def _engine(cfg, params, **kw):
    args = dict(max_batch=2, bucket=16, paged=True, block_size=4, pool_blocks=40,
                chunked_prefill=False, preempt=False, host_pool_bytes=HOSTKB,
                device="cpu")
    args.update(kw)
    return ServingEngine(cfg, params, **args)


@pytest.mark.parametrize("fixture", ["olmo", "olmo_int8"])
def test_index_survives_restart(fixture, request, tmp_path):
    """save_index, a fresh engine, load_index (held until the first
    scheduler exists): the repeated stream is served warm from host,
    tokens bitwise the first process's."""
    cfg, params = request.getfixturevalue(fixture)
    path = tmp_path / "idx.json"
    e1 = _engine(cfg, params)
    out1 = [r.out_tokens for r in e1.generate(_requests())]
    assert e1.save_index(path) > 0

    e2 = _engine(cfg, params)
    assert e2.load_index(path) > 0          # held: no scheduler yet
    out2 = [r.out_tokens for r in e2.generate(_requests())]
    assert out2 == out1
    st = e2.pool_stats()
    assert st["host_hit_rate"] > 0 and st["swap_ins"] > 0
    assert st["prefill_tokens_computed"] < e1.pool_stats()["prefill_tokens_computed"]
    assert_pool_invariants(e2._sched)


def test_index_survives_scheduler_rebuild(olmo):
    """A max_ctx-growth rebuild imports the old scheduler's index into the
    new host tier: the stream after the rebuild hits warm."""
    cfg, params = olmo
    eng = _engine(cfg, params)
    out1 = [r.out_tokens for r in eng.generate(_requests())]
    old = eng._sched
    big = Request(99, np.concatenate([SYS, np.arange(40) % 64]).astype(np.int64),
                  max_new_tokens=4)
    eng.generate([big])
    assert eng._sched is not old, "growth should have rebuilt"
    out2 = [r.out_tokens for r in eng.generate(_requests())]
    assert out2 == out1
    assert eng.pool_stats()["host_hit_rate"] > 0
    assert_pool_invariants(eng._sched)


def test_index_roundtrip_before_first_generate(olmo, tmp_path):
    """An engine that loaded an index and never served saves it back
    verbatim (the --index flag's save at exit)."""
    cfg, params = olmo
    path, path2 = tmp_path / "a.json", tmp_path / "b.json"
    e1 = _engine(cfg, params)
    e1.generate(_requests())
    n = e1.save_index(path)
    e2 = _engine(cfg, params)
    assert e2.load_index(path) == n
    assert e2.save_index(path2) == n
    assert json.loads(path2.read_text()) == json.loads(path.read_text())


def test_index_geometry_mismatch_cold_starts(olmo, tmp_path):
    """An index saved from another pool geometry (block size) warns and
    loads nothing."""
    cfg, params = olmo
    path = tmp_path / "idx.json"
    e1 = _engine(cfg, params, block_size=4)
    e1.generate(_requests())
    e1.save_index(path)
    other = _engine(cfg, params, block_size=8)
    other.generate(_requests(n=1))
    with pytest.warns(UserWarning, match="geometry"):
        assert other._sched.load_index(path) == 0
    assert_pool_invariants(other._sched)


def test_import_skipped_when_tier_off(olmo, tmp_path):
    cfg, params = olmo
    path = tmp_path / "idx.json"
    e1 = _engine(cfg, params)
    e1.generate(_requests(n=2))
    e1.save_index(path)
    off = _engine(cfg, params, host_pool_bytes=0)
    off.generate(_requests(n=1))
    with pytest.warns(UserWarning, match="host"):
        assert off._sched.load_index(path) == 0
    assert_pool_invariants(off._sched)


def test_index_format(olmo):
    """The port writes the JAX package's header and geometry names: the
    dtype as JAX spells it, kv_shape [L, bs, NKV, H], every plane's
    base64 bytes of the block's size."""
    cfg, params = olmo
    sched, _, _ = _serve_twice(cfg, params, HOSTKB)
    data = sched.export_index()
    assert (data["schema"], data["version"]) == (INDEX_SCHEMA, INDEX_VERSION)
    assert data["kv_dtype"] == "bfloat16" and data["quantized"] is False
    assert data["kv_shape"] == [cfg.num_layers, 4, cfg.n_kv_heads, cfg.head_dim]
    assert len(data["digests"]) == (sum(len(h) for h in sched._block_hash.values())
                                    + len(sched._host_index))
    for blk in data["blocks"]:
        assert blk["k_scale"] is None and blk["v_scale"] is None
        assert len(base64.b64decode(blk["k"])) == sched._host_block_nbytes() // 2


# -- against JAX: the pool move ---------------------------------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_write_pool_block_bitwise_jax(quant):
    """write_pool_block leaves the port's pool and scale planes bitwise
    JAX's, the other blocks untouched."""
    rng = np.random.default_rng(3)
    L_, NB, BS, NKV, H = 2, 6, 4, 2, 8
    shape, bshape = (L_, NB, BS, NKV, H), (L_, BS, NKV, H)
    if quant:
        planes = [rng.integers(-128, 128, s).astype(np.int8) for s in (shape, shape)]
        planes += [rng.random((*shape[:4], 1)).astype(np.float32) for _ in range(2)]
        block = [rng.integers(-128, 128, bshape).astype(np.int8) for _ in range(2)]
        block += [rng.random((*bshape[:3], 1)).astype(np.float32) for _ in range(2)]
        to_t, jdt = torch.from_numpy, jnp.int8
    else:
        planes = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
        block = [rng.standard_normal(bshape).astype(np.float32) for _ in range(2)]

        def to_t(a):
            return torch.from_numpy(a).to(torch.bfloat16)
        jdt = jnp.bfloat16
    B, MB = 2, 3
    tc = tkv.DecodeCache(pos=torch.zeros((B,), dtype=torch.int32), kv=tkv.PagedKVCache(
        k=to_t(planes[0].copy()), v=to_t(planes[1].copy()),
        block_table=torch.full((B, MB), -1, dtype=torch.int32),
        length=torch.zeros((B,), dtype=torch.int32),
        k_scale=torch.from_numpy(planes[2].copy()) if quant else None,
        v_scale=torch.from_numpy(planes[3].copy()) if quant else None, block_size=BS))
    jc = jkv.DecodeCache(pos=jnp.zeros((B,), jnp.int32), kv=jkv.PagedKVCache(
        k=jnp.asarray(planes[0], jdt), v=jnp.asarray(planes[1], jdt),
        block_table=jnp.full((B, MB), -1, jnp.int32), length=jnp.zeros((B,), jnp.int32),
        k_scale=jnp.asarray(planes[2]) if quant else None,
        v_scale=jnp.asarray(planes[3]) if quant else None, block_size=BS))
    tblock = [to_t(block[0]), to_t(block[1])] + (
        [torch.from_numpy(b) for b in block[2:]] if quant else [])
    jblock = [jnp.asarray(block[0], jdt), jnp.asarray(block[1], jdt)] + (
        [jnp.asarray(b) for b in block[2:]] if quant else [])
    before = tc.kv.k.clone()
    tkv.write_pool_block(tc, 4, *tblock)
    jc = jkv.write_pool_block(jc, 4, *jblock)
    names = ("k", "v", "k_scale", "v_scale") if quant else ("k", "v")
    for name in names:
        assert np.array_equal(np_of(getattr(tc.kv, name)),
                              np.asarray(getattr(jc.kv, name), np.float32)), name
    keep = [i for i in range(NB) if i != 4]
    assert torch.equal(tc.kv.k[:, keep], before[:, keep])
    assert torch.equal(tc.kv.k[:, 4], tblock[0])


# -- against JAX: one stream through both schedulers ------------------------------

KINDS = {"f32": ("float32", False), "int8": ("float32", True), "bf16": ("bfloat16", False)}


@pytest.fixture(scope="module")
def models():
    """(JAX config, port config, JAX params, port params) by pool kind,
    built once: the port's weights are JAX's, carried by convert."""
    built = {}

    def get(kind):
        if kind not in built:
            dtype, kv8 = KINDS[kind]
            jcfg = dataclasses.replace(jax_reduced("olmo-1b"), dtype=dtype,
                                       kv_cache_quant=kv8)
            tcfg = dataclasses.replace(get_reduced_config("olmo-1b"), dtype=dtype,
                                       kv_cache_quant=kv8)
            params = jax_build(jcfg).init(jax.random.PRNGKey(0))
            built[kind] = (jcfg, tcfg, params,
                           convert.params_from_numpy(to_numpy_tree(params), "cpu"))
        return built[kind]
    return get


def _pair(models, kind, **kw):
    """A JAX scheduler (each step waited out) and a port scheduler with
    the same settings, policy and weights."""
    jcfg, tcfg, params, tparams = models(kind)
    args = dict(max_batch=2, max_ctx=48, bucket=16, paged=True, block_size=4,
                chunked_prefill=False, prefill_budget=8)
    args.update(kw)
    js = synced(JaxScheduler(jcfg, params, quant=jax_policy(POLICY), **args))
    ts = ContinuousScheduler(tcfg, tparams, quant=parse_policy_spec(POLICY),
                             device="cpu", **args)
    return js, ts


def _stats_equal(js, ts, keys=HOST_COUNTERS + PREFIX_COUNTERS + ("preemptions",)):
    a, b = js.pool_stats(), ts.pool_stats()
    assert {k: b[k] for k in keys} == {k: a[k] for k in keys}
    return b


@pytest.mark.parametrize("budget_blocks", [None, 2], ids=["roomy", "two-blocks"])
@MODES
@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_serve_twice_matches_jax(models, kind, chunked, budget_blocks):
    """The `_serve_twice` stream through both schedulers with the same
    host budget: the same greedy tokens in both rounds and the same host
    and prefix counters; a budget of two blocks evicts in both alike."""
    js, ts = _pair(models, kind, pool_blocks=14, chunked_prefill=chunked,
                   host_pool_bytes=HOSTKB)
    if budget_blocks:
        budget = budget_blocks * ts._host_block_nbytes()
        js.host_pool_bytes = ts.host_pool_bytes = budget
    for _ in range(2):
        want = {r.rid: r.out_tokens for r in js.run(_requests(cls=JaxRequest))}
        got = {r.rid: r.out_tokens for r in ts.run(_requests())}
        assert got == want
        st = _stats_equal(js, ts)
    assert st["swap_ins"] > 0 and st["host_hit_tokens"] > 0
    assert (st["host_evictions"] > 0) == bool(budget_blocks)
    assert_pool_invariants(ts)


@MODES
def test_block_to_host_preempt_matches_jax(models, chunked):
    """The block-to-host preemption scenario through both schedulers:
    the same tokens, preemptions and host counters."""
    js, ts = _pair(models, "f32", pool_blocks=10, max_ctx=64, chunked_prefill=chunked,
                   host_pool_bytes=HOSTKB, victim_policy="block-to-host")
    j1, j2 = _preempt_scenario(js, JaxRequest)
    t1, t2 = _preempt_scenario(ts)
    assert (t1.out_tokens, t2.out_tokens) == (j1.out_tokens, j2.out_tokens)
    assert (t1.preemptions, t2.preemptions) == (j1.preemptions, j2.preemptions)
    st = _stats_equal(js, ts)
    assert st["preemptions"] >= 1 and st["swap_outs"] > 0 and st["swap_ins"] > 0
    assert_pool_invariants(ts)


# -- against JAX: index interchange -----------------------------------------------

def _by_digest(data):
    return {hx: data["blocks"][i] for hx, i in data["digests"].items()}


@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
def test_index_interchange(models, kind, tmp_path):
    """An index the JAX scheduler wrote loads into a fresh port scheduler
    with every digest, each block's bytes (bf16 bits, int8 codes, scale
    planes) bitwise the file's; the port's index loads into a fresh JAX
    scheduler alike. A port that loaded JAX's index then serves the
    stream warm from host, with JAX's tokens on the float32 and int8
    pools of the float32 model."""
    js, ts = _pair(models, kind, pool_blocks=14, host_pool_bytes=HOSTKB)
    want = {r.rid: r.out_tokens for r in js.run(_requests(cls=JaxRequest))}
    ts.run(_requests())
    jpath, tpath = tmp_path / "jax.json", tmp_path / "port.json"
    n_jax, n_port = js.save_index(jpath), ts.save_index(tpath)
    assert n_jax == n_port > 0
    jdata, tdata = json.loads(jpath.read_text()), json.loads(tpath.read_text())
    header = ("schema", "version", "block_size", "quantized", "kv_shape", "kv_dtype")
    assert {k: tdata[k] for k in header} == {k: jdata[k] for k in header}
    if kind != "bf16":
        # Equal tokens, so equal chains over prompt ++ generated; in bf16
        # the two packages' generated tokens may part.
        assert set(tdata["digests"]) == set(jdata["digests"])

    fresh_t, fresh_j = _pair(models, kind, pool_blocks=14, host_pool_bytes=HOSTKB)
    assert fresh_t.load_index(jpath) == n_jax
    assert _by_digest(fresh_t.export_index()) == _by_digest(jdata)
    assert_pool_invariants(fresh_t)
    assert fresh_j.load_index(tpath) == n_port
    assert _by_digest(fresh_j.export_index()) == _by_digest(tdata)

    got = {r.rid: r.out_tokens for r in fresh_t.run(_requests())}
    st = fresh_t.pool_stats()
    assert st["swap_ins"] > 0 and st["host_hit_tokens"] > 0
    if kind != "bf16":
        assert got == want
    assert_pool_invariants(fresh_t)
