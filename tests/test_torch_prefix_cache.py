"""The port's cross-request prefix cache, held against ``repro`` and
against itself on the CPU at the reduced olmo-1b config.

Against JAX: the chain digests byte for byte, the three pool moves of an
admission hit (suffix scatter, row metadata, copy-on-write) bitwise on
bf16 and int8 pools, ``prefill_suffix`` logits within atol 1e-3 in
float32 (the packed linears take another route there, see
``test_torch_model.py``), and one request sequence through both
schedulers with equal greedy tokens and equal prefix counters (on the
float32 and, run once per admission mode, the int8 pool; there
``prefill_tokens_computed`` is pinned at JAX's less bucket - 1 per
whole-prompt hit under chunked prefill, the port's recorded departure,
and equal under whole-prompt admission). Against
itself: ``prefill_suffix`` bitwise the cold prefill, and the
counterparts of ``tests/test_prefix_cache.py`` (warm ≡ cold on bf16 and
int8 pools, exclusive ownership with the cache off, copy-on-write,
eviction under a reservation, counters, multi-turn resubmission), each
ending with the ported pool invariants. Seeds are fixed and nothing is
drawn by hypothesis.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.core.precision import parse_policy_spec as jax_policy
from repro.core.quantized_linear import quantize_params_for_serving as jax_pack
from repro.models import build_model as jax_build
from repro.models import kv_cache as jkv
from repro.models import transformer as jtf
from repro.serving import ContinuousScheduler as JaxScheduler
from repro.serving import Request as JaxRequest
from repro_torch import convert
from repro_torch.configs import get_reduced_config
from repro_torch.core.precision import parse_policy_spec
from repro_torch.core.quantized_linear import quantize_params_for_serving
from repro_torch.models import build_model
from repro_torch.models import kv_cache as tkv
from repro_torch.models import transformer as ttf
from repro_torch.serving import (ContinuousScheduler, Request, ServingEngine,
                                 assert_pool_invariants)
from torch_parity import np_of, synced, to_numpy_tree

POLICY = "w4a8;wo=w8a8"
ATOL = 1e-3
SYS = np.arange(10) % 64                       # shared prefix, 10 tokens
PROMPT_A = np.concatenate([SYS, [7, 9]])       # 12 tokens = 3 full blocks @4
PROMPT_B = np.concatenate([SYS, [11, 3]])
PROMPT_C = SYS                                 # partial last block @4


# -- digests ------------------------------------------------------------------

@pytest.mark.parametrize("bs", [4, 16])
@pytest.mark.parametrize("n", [32, 37])
def test_hash_chunks_byte_equal_jax(bs, n):
    """Chain digests of full blocks and of a partial tail are JAX's bytes."""
    toks = np.random.default_rng(n).integers(0, 50_000, n)
    want = JaxScheduler._hash_chunks(SimpleNamespace(block_size=bs), toks)
    got = ContinuousScheduler._hash_chunks(SimpleNamespace(block_size=bs), toks)
    assert got == want
    assert (got[1] is None) == (n % bs == 0)


# -- pool moves ---------------------------------------------------------------

L_, NB, BS, NKV, H, B, MB = 2, 9, 4, 2, 8, 3, 4


def _pools(quant, seed):
    """The same random pool (numpy) as a port cache and a JAX cache."""
    rng = np.random.default_rng(seed)
    shape = (L_, NB, BS, NKV, H)
    if quant:
        k, v = (rng.integers(-128, 128, shape).astype(np.int8) for _ in range(2))
        ks, vs = (rng.random((*shape[:4], 1)).astype(np.float32) for _ in range(2))
    else:
        k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        ks = vs = None
    table = np.full((B, MB), -1, np.int32)
    length = np.zeros((B,), np.int32)

    def torch_cache():
        t = (lambda a: torch.from_numpy(a.copy())) if quant else (
            lambda a: torch.from_numpy(a).to(torch.bfloat16))
        return tkv.DecodeCache(pos=torch.zeros((B,), dtype=torch.int32),
                               kv=tkv.PagedKVCache(
            k=t(k), v=t(v), block_table=torch.from_numpy(table.copy()),
            length=torch.from_numpy(length.copy()),
            k_scale=None if ks is None else torch.from_numpy(ks.copy()),
            v_scale=None if vs is None else torch.from_numpy(vs.copy()), block_size=BS))

    dt = jnp.int8 if quant else jnp.bfloat16
    jcache = jkv.DecodeCache(pos=jnp.zeros((B,), jnp.int32), kv=jkv.PagedKVCache(
        k=jnp.asarray(k, dt), v=jnp.asarray(v, dt), block_table=jnp.asarray(table),
        length=jnp.asarray(length), k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), block_size=BS))
    return torch_cache(), jcache


def _solo(quant, s, total, seed):
    """A suffix-only solo cache of `s` slots for a row of `total` tokens."""
    rng = np.random.default_rng(seed)
    shape = (L_, 1, s, NKV, H)
    if quant:
        k, v = (rng.integers(-128, 128, shape).astype(np.int8) for _ in range(2))
        ks, vs = (rng.random((*shape[:4], 1)).astype(np.float32) for _ in range(2))
    else:
        k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        ks = vs = None
    sp = np.full((L_, 1, s), -1, np.int32)
    tt = (lambda a: torch.from_numpy(a)) if quant else (
        lambda a: torch.from_numpy(a).to(torch.bfloat16))
    tsolo = tkv.DecodeCache(pos=torch.tensor([total], dtype=torch.int32), kv=tkv.KVCache(
        k=tt(k), v=tt(v), slot_pos=torch.from_numpy(sp),
        length=torch.tensor([total], dtype=torch.int32),
        k_scale=None if ks is None else torch.from_numpy(ks),
        v_scale=None if vs is None else torch.from_numpy(vs)))
    dt = jnp.int8 if quant else jnp.bfloat16
    jsolo = jkv.DecodeCache(pos=jnp.asarray([total], jnp.int32), kv=jkv.KVCache(
        k=jnp.asarray(k, dt), v=jnp.asarray(v, dt), slot_pos=jnp.asarray(sp),
        length=jnp.asarray([total], jnp.int32),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs)))
    return tsolo, jsolo


def _assert_caches_equal(tc, jc):
    for name in ("k", "v", "k_scale", "v_scale", "block_table", "length"):
        t, j = getattr(tc.kv, name), getattr(jc.kv, name)
        if t is None:
            assert j is None, name
            continue
        assert np.array_equal(np_of(t), np.asarray(j, np.float32 if t.is_floating_point()
                                                    else None)), name
    assert np.array_equal(tc.pos.numpy(), np.asarray(jc.pos))


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("move", ["scatter_suffix", "set_row", "copy_block"])
def test_pool_moves_bitwise_jax(quant, move):
    """scatter_suffix_into_paged (a suffix of 10 slots from block 1, its
    third block landing in the trash block through the row's -1),
    set_paged_row
    and copy_pool_block leave the port's pool, scale planes, table,
    lengths and positions bitwise JAX's."""
    tc, jc = _pools(quant, seed=1)
    row = np.asarray([3, 5, 7, -1], np.int32)
    if move == "copy_block":
        tc = tkv.copy_pool_block(tc, 5, 2)
        jc = jkv.copy_pool_block(jc, 5, 2)
    else:
        tsolo, jsolo = _solo(quant, 10, 14, seed=2)
        if move == "scatter_suffix":
            tc = tkv.scatter_suffix_into_paged(tc, tsolo, 1, row, 1)
            jc = jkv.scatter_suffix_into_paged(jc, jsolo, 1, jnp.asarray(row), 1)
        else:
            tc = tkv.set_paged_row(tc, tsolo, 1, row)
            jc = jkv.set_paged_row(jc, jsolo, 1, jnp.asarray(row))
    _assert_caches_equal(tc, jc)


# -- suffix prefill -----------------------------------------------------------

def _f32_models(kv_int8):
    jcfg = dataclasses.replace(jax_reduced("olmo-1b"), dtype="float32",
                               kv_cache_quant=kv_int8)
    tcfg = dataclasses.replace(get_reduced_config("olmo-1b"), dtype="float32",
                               kv_cache_quant=kv_int8)
    params = jax_build(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, tcfg, params


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8"])
def test_prefill_suffix_matches_jax_and_cold(kv_int8):
    """A 13-token prompt prefilled cold into a pool of 4-token blocks; then
    its suffix from position 8 (a partial hit) and its last token alone
    (a full hit) through ``prefill_suffix``: logits within atol of JAX's
    ``prefill_suffix`` on the same pool, and bitwise the port's cold
    whole-prompt prefill; the suffix's K/V bitwise the cold K/V."""
    jcfg, tcfg, params = _f32_models(kv_int8)
    jparams = jax_pack(params, jax_policy(POLICY), min_size=1024)
    tparams = convert.params_from_numpy(to_numpy_tree(jparams), "cpu")
    prompt = (np.arange(13) * 7 + 2) % 512
    n, bucket = len(prompt), 16
    toks = np.zeros((1, bucket), np.int64)
    toks[0, :n] = prompt
    cold, cold_logits = ttf.prefill(tparams, tcfg, {
        "tokens": torch.from_numpy(toks), "lengths": torch.tensor([n])})
    cache = ttf.init_paged_cache(tcfg, 1, 6, 4, 4, device="cpu")
    row = np.asarray([2, 5, 1, 4], np.int32)
    tkv.scatter_into_paged(cache, cold, 0, row)
    kv = cache.kv
    jsuffix = jax.jit(jtf.prefill_suffix, static_argnums=(1,))
    for start in (8, n - 1):
        ls = n - start
        stoks = np.zeros((1, bucket), np.int64)
        stoks[0, :ls] = prompt[start:]
        covering = -(-start // 4)
        batch = {"tokens": torch.from_numpy(stoks), "lengths": [ls], "start": start,
                 "pool_k": kv.k, "pool_v": kv.v,
                 "prefix_blocks": torch.from_numpy(row[:covering])}
        jbatch = {"tokens": jnp.asarray(stoks, jnp.int32),
                  "lengths": jnp.asarray([ls], jnp.int32), "start": jnp.int32(start),
                  "pool_k": jnp.asarray(kv.k.numpy()), "pool_v": jnp.asarray(kv.v.numpy()),
                  "prefix_blocks": jnp.asarray(row)}
        if kv_int8:
            batch.update(pool_k_scale=kv.k_scale, pool_v_scale=kv.v_scale)
            jbatch.update(pool_k_scale=jnp.asarray(kv.k_scale.numpy()),
                          pool_v_scale=jnp.asarray(kv.v_scale.numpy()))
        solo, logits = ttf.prefill_suffix(tparams, tcfg, batch)
        _, jlogits = jsuffix(jparams, jcfg, jbatch)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0)
        assert torch.equal(logits, cold_logits), f"start={start}"
        assert solo.pos.tolist() == solo.kv.length.tolist() == [n]
        assert torch.equal(solo.kv.k[:, 0, :ls], cold.kv.k[:, 0, start:n])
        if kv_int8:
            assert torch.equal(solo.kv.k_scale[:, 0, :ls], cold.kv.k_scale[:, 0, start:n])


# -- one request sequence through both schedulers ------------------------------

COUNTERS = ("prefix_hit_blocks", "prefix_hit_tokens", "cow_copies", "prefix_evictions",
            "cached_prefix_blocks", "retained_prefix_blocks", "peak_allocated_blocks")


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "whole"])
def test_scheduler_counters_match_jax(chunked):
    """Live sharing, a partial hit, full hits that copy a shared partial
    block on write and LRU eviction in a pool of 12 blocks: the port's
    scheduler emits JAX's greedy tokens and JAX's prefix counters."""
    jcfg, tcfg, params = _f32_models(False)
    kw = dict(max_batch=2, max_ctx=32, block_size=4, prefill_budget=8, bucket=16,
              pool_blocks=12, chunked_prefill=chunked)
    prompts = [PROMPT_A, PROMPT_B, PROMPT_C, PROMPT_A, PROMPT_C,
               np.concatenate([[5, 1, 2, 8], SYS[:5]])]
    news = [6, 4, 2, 5, 4, 6]
    jsched = JaxScheduler(jcfg, params, quant=jax_policy(POLICY), paged=True,
                          prefix_cache=True, preempt=False, max_head_bypass=0, **kw)
    want = {r.rid: r.out_tokens for r in jsched.run(
        [JaxRequest(i, p, max_new_tokens=m) for i, (p, m) in enumerate(zip(prompts, news))])}
    tsched = ContinuousScheduler(
        tcfg, convert.params_from_numpy(to_numpy_tree(params), "cpu"),
        quant=parse_policy_spec(POLICY), preempt=False, max_head_bypass=0,
        device="cpu", **kw)
    got = {r.rid: r.out_tokens for r in tsched.run(
        [Request(i, p, max_new_tokens=m) for i, (p, m) in enumerate(zip(prompts, news))])}
    assert got == want
    js, ts = jsched.pool_stats(), tsched.pool_stats()
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert ts["prefix_hit_blocks"] > 0 and ts["cow_copies"] > 0
    assert ts["prefix_evictions"] > 0
    assert_pool_invariants(tsched)


# The same sequence on the int8 pool, both schedulers run once per mode. The
# port's scheduler counts the `_prefill_suffix` calls: under chunked
# prefill only a whole-prompt hit takes that route.
@pytest.fixture(scope="module")
def int8_prefix_runs():
    jcfg, tcfg, params = _f32_models(True)
    prompts = [PROMPT_A, PROMPT_B, PROMPT_C, PROMPT_A, PROMPT_C,
               np.concatenate([[5, 1, 2, 8], SYS[:5]])]
    news = [6, 4, 2, 5, 4, 6]
    out = {}
    for chunked in (True, False):
        kw = dict(max_batch=2, max_ctx=32, block_size=4, prefill_budget=8, bucket=16,
                  pool_blocks=12, chunked_prefill=chunked)
        jsched = synced(JaxScheduler(jcfg, params, quant=jax_policy(POLICY), paged=True,
                                     prefix_cache=True, preempt=False, max_head_bypass=0,
                                     **kw))
        want = {r.rid: r.out_tokens for r in jsched.run(
            [JaxRequest(i, p, max_new_tokens=m)
             for i, (p, m) in enumerate(zip(prompts, news))])}
        tsched = ContinuousScheduler(
            tcfg, convert.params_from_numpy(to_numpy_tree(params), "cpu"),
            quant=parse_policy_spec(POLICY), preempt=False, max_head_bypass=0,
            device="cpu", **kw)
        suffix_calls = []
        inner = tsched._prefill_suffix
        tsched._prefill_suffix = lambda *a: suffix_calls.append(a[2]) or inner(*a)
        got = {r.rid: r.out_tokens for r in tsched.run(
            [Request(i, p, max_new_tokens=m)
             for i, (p, m) in enumerate(zip(prompts, news))])}
        out[chunked] = (want, got, jsched.pool_stats(), tsched.pool_stats(),
                        suffix_calls, tsched)
    return out


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "whole"])
def test_scheduler_counters_match_jax_int8(int8_prefix_runs, chunked):
    """``test_scheduler_counters_match_jax``'s sequence on the int8 pool: the
    port's scheduler emits JAX's greedy tokens and JAX's prefix counters,
    in both admission modes (where the two reach a whole-prompt hit by
    different functions under chunked prefill)."""
    want, got, js, ts, _, tsched = int8_prefix_runs[chunked]
    assert got == want
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert ts["prefix_hit_blocks"] > 0 and ts["cow_copies"] > 0
    assert ts["prefix_evictions"] > 0
    assert_pool_invariants(tsched)


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "whole"])
def test_prefill_tokens_computed_departure(int8_prefix_runs, chunked):
    """The port counts the tokens its prefill kernels run: a whole-prompt
    hit under chunked prefill runs one token (``paged_prefill`` with
    ``store=False``) where JAX runs and counts a bucket of 16, so the
    port's count is JAX's less bucket - 1 for each such hit; under
    whole-prompt admission both run the same suffix bucket and count the
    same."""
    _, _, js, ts, suffix_calls, _ = int8_prefix_runs[chunked]
    if chunked:
        full_hits = len(suffix_calls)
        assert full_hits > 0
        assert ts["prefill_tokens_computed"] == js["prefill_tokens_computed"] - full_hits * 15
    else:
        assert suffix_calls
        assert ts["prefill_tokens_computed"] == js["prefill_tokens_computed"]


# -- the port against itself: tests/test_prefix_cache.py's contracts ----------

@pytest.fixture(scope="module")
def olmo():
    cfg = get_reduced_config("olmo-1b")
    params = build_model(cfg).init(seed=0, device="cpu")
    return cfg, quantize_params_for_serving(params, parse_policy_spec(POLICY),
                                            min_size=1024)


@pytest.fixture(scope="module")
def olmo_int8(olmo):
    return dataclasses.replace(olmo[0], kv_cache_quant=True), olmo[1]


def _drain(sched):
    out = []
    while sched.num_active or sched.num_waiting:
        out.extend(sched.step())
    assert_pool_invariants(sched)
    return out


def _cold(cfg, params, reqs):
    done = ServingEngine(cfg, params, max_batch=2, bucket=16,
                         device="cpu").generate_static(reqs)
    return {r.rid: r.out_tokens for r in done}


def _sched(cfg, params, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_ctx", 48)
    kw.setdefault("bucket", 16)
    kw.setdefault("paged", True)
    kw.setdefault("block_size", 4)
    return ContinuousScheduler(cfg, params, device="cpu", **kw)


def _assert_drained_invariants(sched):
    """The shared checker, plus what holds once every request retired."""
    assert_pool_invariants(sched)
    assert sched._live_blocks == 0
    assert sched._refcnt[1:].sum() == 0
    assert len(sched._free) + len(sched._lru) == sched.pool_blocks
    assert sched._avail == sched.pool_blocks
    assert (sched._block_tab == -1).all()


@pytest.mark.parametrize("fixture", ["olmo", "olmo_int8"])
@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "whole"])
def test_prefix_hit_bit_identical(fixture, chunked, request):
    """Live sharing between concurrent rows, a fully cached resubmitted
    prompt and a mid-decode join onto resident blocks all emit the cold
    (static-engine) greedy tokens, on bf16 and int8 pools, with chunked
    and whole-prompt admission."""
    cfg, params = request.getfixturevalue(fixture)
    ref = _cold(cfg, params, [Request(0, PROMPT_A, max_new_tokens=8),
                              Request(1, PROMPT_B, max_new_tokens=8)])
    sched = _sched(cfg, params, chunked_prefill=chunked)
    assert sched.prefix_cache
    r0 = Request(0, PROMPT_A, max_new_tokens=8)
    r1 = Request(1, PROMPT_B, max_new_tokens=8)
    sched.run([r0, r1])
    assert r0.out_tokens == ref[0] and r1.out_tokens == ref[1]
    stats = sched.pool_stats()
    assert stats["prefix_hit_blocks"] >= 2      # SYS = 2 full blocks
    assert stats["prefix_hit_tokens"] >= 8

    r2 = Request(2, PROMPT_A, max_new_tokens=8)   # every position resident
    sched.run([r2])
    assert r2.out_tokens == ref[0]
    assert sched.pool_stats()["prefix_hit_tokens"] >= 8 + len(PROMPT_A)

    mid = _sched(cfg, params, chunked_prefill=chunked)
    first = Request(0, PROMPT_A, max_new_tokens=12)
    mid.submit(first)
    for _ in range(3):
        mid.step()
    joined = Request(1, PROMPT_B, max_new_tokens=8)
    mid.submit(joined)
    _drain(mid)
    assert mid.pool_stats()["prefix_hit_blocks"] > 0
    assert joined.out_tokens == ref[1]
    assert first.out_tokens == _cold(
        cfg, params, [Request(0, PROMPT_A, max_new_tokens=12)])[0]
    _assert_drained_invariants(mid)


def test_prefix_cache_off_keeps_exclusive_ownership(olmo):
    """prefix_cache=False: no sharing, no retention — every block returns
    to the free list on retirement."""
    cfg, params = olmo
    ref = _cold(cfg, params, [Request(0, PROMPT_A, max_new_tokens=6)])
    sched = _sched(cfg, params, prefix_cache=False)
    r0 = Request(0, PROMPT_A, max_new_tokens=6)
    r1 = Request(1, PROMPT_A, max_new_tokens=6)
    sched.run([r0, r1])
    assert r0.out_tokens == ref[0] and r1.out_tokens == ref[0]
    stats = sched.pool_stats()
    assert not stats["prefix_cache"]
    assert stats["prefix_hit_blocks"] == 0
    assert len(sched._free) == sched.pool_blocks
    assert len(sched._lru) == 0
    _assert_drained_invariants(sched)


def test_prefix_cache_requires_paged_support(olmo):
    """As in JAX: on by default on the paged pool, and prefix_cache=True
    raises on the contiguous cache and on a recurrent model."""
    cfg, params = olmo
    assert _sched(cfg, params).prefix_cache
    with pytest.raises(ValueError, match="prefix caching"):
        ContinuousScheduler(cfg, params, max_batch=1, max_ctx=32, bucket=16,
                            paged=False, prefix_cache=True, device="cpu")
    rcfg = get_reduced_config("rwkv6-3b")
    rparams = build_model(rcfg).init(seed=0, device="cpu")
    assert not ContinuousScheduler(rcfg, rparams, max_batch=1, max_ctx=32,
                                   device="cpu").prefix_cache
    with pytest.raises(ValueError, match="prefix caching"):
        ContinuousScheduler(rcfg, rparams, max_batch=1, max_ctx=32,
                            prefix_cache=True, device="cpu")


def test_shared_retirement_never_double_frees(olmo):
    """Two rows sharing prefix blocks retire one after the other: the
    shared blocks are decref'd once per row, never freed twice, and the
    pool comes back to full capacity."""
    cfg, params = olmo
    sched = _sched(cfg, params)
    r0 = Request(0, PROMPT_A, max_new_tokens=10)   # retires second
    r1 = Request(1, PROMPT_B, max_new_tokens=3)    # retires first
    sched.submit(r0)
    for _ in range(2):
        sched.step()
    sched.submit(r1)
    _drain(sched)
    assert sched.pool_stats()["prefix_hit_blocks"] >= 2
    _assert_drained_invariants(sched)


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "whole"])
def test_cow_on_shared_partial_block(olmo, chunked):
    """A retained partial prompt block revived by two rows: each row's
    first decode append copies it on write (the pristine block stays
    cached), and every output is the cold one."""
    cfg, params = olmo
    ref = _cold(cfg, params, [Request(0, PROMPT_C, max_new_tokens=6)])
    sched = _sched(cfg, params, chunked_prefill=chunked)
    a = Request(0, PROMPT_C, max_new_tokens=6)
    sched.run([a])                     # registers the partial block
    b = Request(1, PROMPT_C, max_new_tokens=6)
    c = Request(2, PROMPT_C, max_new_tokens=6)
    sched.submit(b)
    sched.submit(c)
    _drain(sched)
    stats = sched.pool_stats()
    assert stats["cow_copies"] >= 2
    assert a.out_tokens == b.out_tokens == c.out_tokens == ref[0]
    _assert_drained_invariants(sched)
    hits = stats["prefix_hit_tokens"]
    d = Request(3, PROMPT_C, max_new_tokens=6)
    sched.run([d])
    assert d.out_tokens == ref[0]
    assert sched.pool_stats()["prefix_hit_tokens"] >= hits + len(PROMPT_C)


def test_eviction_races_reservation(olmo):
    """A pool mostly held by retained prefix blocks evicts them — never a
    live row's blocks — when a later admission's allocations need the
    space; evicted digests leave the index and accounting stays exact."""
    cfg, params = olmo
    ref_a = _cold(cfg, params, [Request(0, PROMPT_A, max_new_tokens=6)])
    ref_b = _cold(cfg, params, [Request(1, PROMPT_B, max_new_tokens=13)])
    sched = _sched(cfg, params, pool_blocks=6, max_ctx=32)
    a = Request(0, PROMPT_A, max_new_tokens=6)
    sched.run([a])
    assert sched.pool_stats()["retained_prefix_blocks"] >= 3
    b = Request(1, PROMPT_B, max_new_tokens=13)
    sched.run([b])
    stats = sched.pool_stats()
    assert stats["prefix_evictions"] >= 1
    assert stats["prefix_hit_blocks"] >= 2
    assert not b.failed and b.out_tokens == ref_b[1]
    assert a.out_tokens == ref_a[0]
    _assert_drained_invariants(sched)


def test_int8_scale_plane_sharing(olmo_int8):
    """int8 pool: shared blocks share their float32 scale planes — the
    partial block's too — and warm outputs match the cold int8 engine."""
    cfg, params = olmo_int8
    ref = _cold(cfg, params, [Request(0, PROMPT_C, max_new_tokens=6)])
    sched = _sched(cfg, params)
    assert sched.cache.kv.quantized
    a = Request(0, PROMPT_C, max_new_tokens=6)
    b = Request(1, PROMPT_C, max_new_tokens=6)
    sched.run([a])
    sched.run([b])
    stats = sched.pool_stats()
    assert stats["prefix_hit_blocks"] >= 3      # 2 full + partial
    assert stats["cow_copies"] >= 1
    assert a.out_tokens == b.out_tokens == ref[0]
    _assert_drained_invariants(sched)


def test_pool_stats_counters(olmo):
    """pool_stats() reports the prefix-cache counters the serve CLI and
    chip_smoke.py read."""
    cfg, params = olmo
    sched = _sched(cfg, params)
    sched.run([Request(0, PROMPT_A, max_new_tokens=4)])
    sched.run([Request(1, PROMPT_A, max_new_tokens=4)])
    stats = sched.pool_stats()
    for key in ("prefix_cache", "prefix_hit_blocks", "prefix_hit_tokens",
                "prefix_hit_rate", "cow_copies", "prefix_evictions",
                "retained_prefix_blocks", "cached_prefix_blocks", "prompt_tokens",
                "prefill_tokens_computed"):
        assert key in stats, key
    assert stats["prefix_cache"] is True
    assert stats["prefix_hit_tokens"] == len(PROMPT_A)
    assert stats["prefix_hit_rate"] == 0.5
    assert stats["prompt_tokens"] == 2 * len(PROMPT_A)
    assert_pool_invariants(sched)


def test_multi_turn_resubmission_is_warm(olmo):
    """Retirement registers the blocks of GENERATED tokens too: a second
    turn whose prompt is the first turn's prompt ++ answer ++ new tokens
    hits past the original prompt and emits the cold run's tokens."""
    cfg, params = olmo
    first = Request(0, PROMPT_A, max_new_tokens=9)
    sched = _sched(cfg, params, pool_blocks=24, max_ctx=64)
    sched.run([first])
    hits0 = sched.pool_stats()["prefix_hit_tokens"]
    turn2 = np.concatenate([PROMPT_A, first.out_tokens, [5, 13]])
    ref = _cold(cfg, params, [Request(1, turn2, max_new_tokens=6)])
    r = Request(1, turn2, max_new_tokens=6)
    sched.run([r])
    assert r.out_tokens == ref[1]
    pos = len(PROMPT_A) + len(first.out_tokens) - 1
    bs = sched.block_size
    assert sched.pool_stats()["prefix_hit_tokens"] - hits0 >= (pos // bs) * bs > len(PROMPT_A)
    _assert_drained_invariants(sched)
