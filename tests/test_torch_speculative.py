"""The port's self-speculative decoding, held against ``repro`` and
against itself on the CPU at the reduced olmo-1b config.

Against JAX: ``plane_offset``, ``parse_tier_token``, ``greedy_accept``
and ``truncate_policy_view`` (plane offsets leaf by leaf, and each
refusal's message); ``set_decode_positions`` bitwise;
``prefill_chunk_logits_multi`` on the same pool and batch (two live rows
and a dead one, float32 and int8 pools): logits within atol 1e-3,
positions and lengths exactly, pool values to float32 rounding and int8
codes within one step (the packed linears take another route in the
port, see ``test_torch_model.py``); and the scheduler with ``speculate``
1/2/3/4 and drafts w4a8/w2a8 (solo, mid-decode admission, the int8 pool,
a Table III policy): greedy tokens and speculation counters equal to the
JAX scheduler's. Against itself: the multi-row verify bitwise each row's
own ``prefill_chunk_logits`` call (logits, pool bytes, scale planes,
positions), greedy tokens with speculation equal to those without, the
draft view sharing every tensor with the served params, the prefix cache
after a speculative retirement, and the CLI's refusals. The JAX
scheduler runs are built once, in a module fixture.
"""
import dataclasses

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
from repro.serving import speculative as jspec
from repro_torch import convert
from repro_torch.configs import get_reduced_config
from repro_torch.core.precision import parse_policy_spec
from repro_torch.core.quant import QuantConfig
from repro_torch.core.quantized_linear import PackedWeight
from repro_torch.models import build_model
from repro_torch.models import kv_cache as tkv
from repro_torch.models import transformer as ttf
from repro_torch.serving import ContinuousScheduler, Request, assert_pool_invariants
from repro_torch.serving import speculative as tspec
from torch_parity import leaves, np_of, to_numpy_tree

ATOL = 1e-3
Q8 = "w8a8"
TABLE3 = "w4a8r25;wo=w8a8"
PROMPT_A = np.zeros(8, np.int64)            # degenerate: drafts stay on script
PROMPT_B = (np.arange(11) * 5 + 2) % 64     # not a multiple of block or bucket
SPEC_COUNTERS = ("spec_rounds", "spec_draft_tokens", "spec_accepted_tokens",
                 "spec_verify_calls", "spec_verify_rows")


def _outcome(fn, *args, **kw):
    """fn's result, or the message of the ValueError it raises."""
    try:
        return fn(*args, **kw)
    except ValueError as e:
        return f"ValueError: {e}"


# -- plane math and the acceptance rule ---------------------------------------

@pytest.mark.parametrize("target,view", [(8, 4), (8, 2), (4, 2), (4, 8), (8, 8), (2, 2),
                                         (8, 3), (4, 3), (8, 0), (4, 0)])
def test_plane_offset_matches_jax(target, view):
    """The planes a view drops, and the refusals of a gap that is not whole
    planes or leaves none, are JAX's."""
    assert _outcome(tspec.plane_offset, target, view) == _outcome(
        jspec.plane_offset, target, view)


@pytest.mark.parametrize("token", ["w4a8", "w2a8", "w8a4", "w4a8r25", "w9", "x"])
def test_parse_tier_token_matches_jax(token):
    def fields(fn):
        out = _outcome(fn, token)
        return out if isinstance(out, str) else (out.w_bits, out.a_bits, out.mixed_ratio_8b)

    assert fields(tspec.parse_draft_spec) == fields(jspec.parse_draft_spec)
    cfg = QuantConfig(w_bits=2, a_bits=8)
    assert tspec.parse_tier_token(cfg) is cfg


@pytest.mark.parametrize("seed", range(4))
def test_greedy_accept_matches_jax(seed):
    assert tspec.greedy_accept([5, 6, 7], [9, 9]) == [5]
    assert tspec.greedy_accept([5, 6, 7], [5, 6]) == [5, 6, 7]
    assert tspec.greedy_accept([5, 6, 7], [5, 9]) == [5, 6]
    assert tspec.greedy_accept([5], []) == [5]
    rng = np.random.default_rng(seed)
    for _ in range(50):
        k = int(rng.integers(0, 6))
        verify = rng.integers(0, 3, k + 1)
        drafts = rng.integers(0, 3, k)
        assert tspec.greedy_accept(verify, drafts) == jspec.greedy_accept(verify, drafts)


# -- the draft view -----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    """JAX's float32 reduced olmo-1b params (unpacked)."""
    jcfg = dataclasses.replace(jax_reduced("olmo-1b"), dtype="float32")
    return jcfg, jax_build(jcfg).init(jax.random.PRNGKey(0))


def _packed_pair(params, policy):
    jp = jax_pack(params, jax_policy(policy), min_size=1024)
    return jp, convert.params_from_numpy(to_numpy_tree(jp), "cpu")


@pytest.mark.parametrize("policy,draft", [(Q8, "w4a8"), (Q8, "w2a8"),
                                          ("w4a8;wo=w8a8", "w4a8"), (TABLE3, "w2a8")])
def test_draft_view_shares_tensors_and_matches_jax(jax_params, policy, draft):
    """Every leaf of the port's draft view has JAX's plane_lo, and every
    tensor of it — packed bytes, 8-bit group, scales, unpacked leaves — is
    the served params' own object: the view allocates nothing."""
    _, params = jax_params
    jp, tp = _packed_pair(params, policy)
    jview, jn = jspec.derive_draft_params(jp, draft)
    tview, tn = tspec.derive_draft_params(tp, draft)
    assert tn == jn > 0
    jleaves = dict(leaves(to_numpy_tree(jview)))
    n_packed = 0
    for path, leaf in leaves(tview):
        src = tp
        for key in path.split("/"):
            src = src[key]
        if isinstance(leaf, PackedWeight):
            n_packed += 1
            assert leaf.plane_lo == jleaves[f"{path}/plane_lo"], path
            assert leaf.packed is src.packed and leaf.scale is src.scale, path
            assert leaf.packed8 is src.packed8, path
            assert leaf.plane_lo >= src.plane_lo == 0
        else:
            assert leaf is src, path
    assert n_packed and (policy != TABLE3 or any(
        isinstance(l, PackedWeight) and l.n8 and l.plane_lo == 1 for _, l in leaves(tview)))


def test_draft_view_refusals_match_jax(jax_params):
    """The refusals raise with JAX's messages: no packed leaves, a draft
    that truncates nothing, a change of activation bits, a mixed-group
    token and a gap of no whole plane; a tier view that truncates nothing
    is the params object itself."""
    _, params = jax_params
    jp, tp = _packed_pair(params, Q8)
    tp_raw = convert.params_from_numpy(to_numpy_tree(params), "cpu")
    for (jargs, targs) in [((params, "w4a8"), (tp_raw, "w4a8")),
                           ((jp, "w8a8"), (tp, "w8a8")),
                           ((jp, "w4a4"), (tp, "w4a4")),
                           ((jp, "w4a8r25"), (tp, "w4a8r25")),
                           ((jp, "w5a8"), (tp, "w5a8"))]:
        want = _outcome(jspec.derive_draft_params, *jargs)
        assert isinstance(want, str)
        assert _outcome(tspec.derive_draft_params, *targs) == want
    view, n = tspec.truncate_policy_view(tp, "w8a8")
    assert view is tp and n == 0


# -- the model's verify entry -------------------------------------------------

L_BS, L_NB, L_MB = 4, 12, 5
ROWS = {0: np.arange(10) * 7 % 512, 2: (np.arange(6) * 13 + 3) % 512}
TABLES = [[1, 2, 3, 4, -1], [-1] * 5, [5, 6, 7, -1, -1]]


def _models(kv_int8):
    jcfg = dataclasses.replace(jax_reduced("olmo-1b"), dtype="float32",
                               kv_cache_quant=kv_int8)
    tcfg = dataclasses.replace(get_reduced_config("olmo-1b"), dtype="float32",
                               kv_cache_quant=kv_int8)
    return jcfg, tcfg


def _prefilled(jcfg, tcfg, jparams, tparams):
    """A 3-slot pool of 4-token blocks with ROWS prefilled chunk by chunk
    into slots 0 and 2 (slot 1 free), in both packages."""
    jcache = jtf.init_paged_cache(jcfg, batch=3, num_blocks=L_NB, block_size=L_BS,
                                  max_blocks=L_MB)
    jcache = dataclasses.replace(jcache, kv=dataclasses.replace(
        jcache.kv, block_table=jnp.asarray(TABLES, jnp.int32)))
    tcache = ttf.init_paged_cache(tcfg, 3, L_NB, L_BS, L_MB, device="cpu")
    tcache.kv.block_table.copy_(torch.tensor(TABLES))
    jchunk = jax.jit(jtf.prefill_chunk, static_argnums=(1,))
    for slot, prompt in ROWS.items():
        blocks = np.asarray(TABLES[slot], np.int32)
        for start in range(0, len(prompt), 8):
            t = min(8, len(prompt) - start)
            toks = np.zeros((1, 8), np.int32)
            toks[0, :t] = prompt[start:start + t]
            jcache, _ = jchunk(jparams, jcfg, jcache, {
                "tokens": jnp.asarray(toks), "lengths": jnp.asarray([t], jnp.int32),
                "start": jnp.int32(start), "slot": jnp.int32(slot),
                "blocks": jnp.asarray(blocks)})
            tcache, _ = ttf.prefill_chunk(tparams, tcfg, tcache, {
                "tokens": torch.from_numpy(toks.astype(np.int64)), "lengths": [t],
                "start": start, "slot": slot, "blocks": torch.from_numpy(blocks)})
    return jcache, tcache


def _clone(cache):
    kv = cache.kv
    return tkv.DecodeCache(pos=cache.pos.clone(), kv=tkv.PagedKVCache(
        k=kv.k.clone(), v=kv.v.clone(), block_table=kv.block_table.clone(),
        length=kv.length.clone(),
        k_scale=None if kv.k_scale is None else kv.k_scale.clone(),
        v_scale=None if kv.v_scale is None else kv.v_scale.clone(),
        block_size=kv.block_size))


def _planes(cache):
    kv = cache.kv
    return [kv.k, kv.v] + ([kv.k_scale, kv.v_scale] if kv.quantized else [])


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8"])
def test_prefill_chunk_logits_multi_matches_jax_and_solo(jax_params, kv_int8):
    """Windows of 4 (slot 0, from position 10) and 3 (slot 2, from 6) real
    tokens in a chunk of 4, slot 1 dead: logits within atol of JAX's on
    the same pool and batch, positions and lengths exactly JAX's, pool
    values to float32 rounding (int8 codes within one step, scales to
    rounding); against the port itself, each live row's logits and every
    pool byte, scale, position and length bitwise what the rows' own
    ``prefill_chunk_logits`` calls leave; the dead row's position and
    length unchanged and no block outside the live rows' (and the trash
    block) touched."""
    jcfg, tcfg = _models(kv_int8)
    _, params = jax_params
    jparams, tparams = _packed_pair(params, "w4a8;wo=w8a8")
    jcache, tcache = _prefilled(jcfg, tcfg, jparams, tparams)
    Lc = 4
    tokens = np.asarray([[3, 9, 27, 81], [0, 0, 0, 0], [5, 25, 125, 0]], np.int32)
    lengths, starts, slots = [4, 0, 3], [10, 0, 6], [0, -1, 2]
    btab = np.asarray(TABLES, np.int32)
    solo = _clone(tcache)
    before = [a.clone() for a in _planes(tcache)]
    pos0, len0 = tcache.pos.clone(), tcache.kv.length.clone()

    jmulti = jax.jit(jtf.prefill_chunk_logits_multi, static_argnums=(1,))
    jcache, jlog = jmulti(jparams, jcfg, jcache, {
        "tokens": jnp.asarray(tokens), "lengths": jnp.asarray(lengths, jnp.int32),
        "starts": jnp.asarray(starts, jnp.int32), "slots": jnp.asarray(slots, jnp.int32),
        "blocks": jnp.asarray(btab)})
    tcache, tlog = ttf.prefill_chunk_logits_multi(tparams, tcfg, tcache, {
        "tokens": torch.from_numpy(tokens.astype(np.int64)), "lengths": lengths,
        "starts": starts, "slots": slots, "blocks": torch.from_numpy(btab)})
    assert tlog.shape == (3, Lc, tcfg.vocab) and tlog.dtype == torch.float32
    for r in (0, 2):
        n = lengths[r]
        np.testing.assert_allclose(tlog[r, :n].numpy(), np.asarray(jlog)[r, :n],
                                   atol=ATOL, rtol=0)
    assert tcache.pos.tolist() == np.asarray(jcache.pos).tolist() == [14, int(pos0[1]), 9]
    assert tcache.kv.length.tolist() == np.asarray(jcache.kv.length).tolist()
    assert int(tcache.kv.length[1]) == int(len0[1])
    live = [b for r in (0, 2) for b in TABLES[r] if b >= 0]
    tk, jk = np_of(tcache.kv.k)[:, live], np.asarray(jcache.kv.k, np.float32)[:, live]
    assert np.abs(tk - jk).max() <= (1 if kv_int8 else ATOL)
    if kv_int8:
        np.testing.assert_allclose(np_of(tcache.kv.k_scale)[:, live],
                                   np.asarray(jcache.kv.k_scale)[:, live], rtol=1e-4)

    # The port against itself: the rows' own calls, one after another.
    for r in (0, 2):
        solo, lg = ttf.prefill_chunk_logits(tparams, tcfg, solo, {
            "tokens": torch.from_numpy(tokens[r:r + 1].astype(np.int64)),
            "lengths": [lengths[r]], "start": starts[r], "slot": slots[r],
            "blocks": torch.from_numpy(btab[r])})
        assert torch.equal(tlog[r], lg[0]), f"row {r}"
        assert not tlog[1].any()
    assert torch.equal(tcache.pos, solo.pos) and torch.equal(tcache.kv.length, solo.kv.length)
    for a, b, c in zip(_planes(tcache), _planes(solo), before):
        assert torch.equal(a[:, 1:], b[:, 1:])
        untouched = [blk for blk in range(1, L_NB) if blk not in live]
        assert torch.equal(a[:, untouched], c[:, untouched])


def test_prefill_chunk_default_is_the_last_token(jax_params):
    """``prefill_chunk`` keeps its (1, 1, V) last-token logits;
    ``prefill_chunk_logits`` returns every position, its last real row the
    same logits to float32 rounding (the CPU's plain head product is one
    matmul of 1 row or of 8, whose BLAS may sum a row in another order; on
    the card ``chip_smoke.verify_vs_decode`` gates the head's rows bitwise
    at every verify width it checks)."""
    jcfg, tcfg = _models(False)
    _, params = jax_params
    _, tparams = _packed_pair(params, "w4a8;wo=w8a8")
    out = []
    for entry in (ttf.prefill_chunk, ttf.prefill_chunk_logits):
        cache = ttf.init_paged_cache(tcfg, 1, 6, 4, 4, device="cpu")
        toks = torch.zeros((1, 8), dtype=torch.int64)
        toks[0, :6] = torch.arange(6) * 11
        cache, lg = entry(tparams, tcfg, cache, {
            "tokens": toks, "lengths": [6], "start": 0, "slot": 0,
            "blocks": torch.tensor([1, 2, 3, -1])})
        assert cache.pos.tolist() == cache.kv.length.tolist() == [6]
        out.append(lg)
    assert out[0].shape == (1, 1, tcfg.vocab) and out[1].shape == (1, 8, tcfg.vocab)
    torch.testing.assert_close(out[0][0, 0], out[1][0, 5], atol=1e-5, rtol=0)


def test_set_decode_positions_matches_jax():
    """One write sets every row's position and length, bitwise JAX's, in
    place (the cache's own tensors)."""
    tcfg = get_reduced_config("olmo-1b")
    jcfg = jax_reduced("olmo-1b")
    tcache = ttf.init_paged_cache(tcfg, 3, 6, 4, 4, device="cpu")
    jcache = jtf.init_paged_cache(jcfg, batch=3, num_blocks=6, block_size=4, max_blocks=4)
    pos_t, len_t = tcache.pos, tcache.kv.length
    pos, length = np.asarray([7, 0, 13], np.int64), np.asarray([7, 2, 13], np.int64)
    out = tkv.set_decode_positions(tcache, pos, length)
    jout = jkv.set_decode_positions(jcache, pos, length)
    assert out is tcache and tcache.pos is pos_t and tcache.kv.length is len_t
    assert tcache.pos.dtype == tcache.kv.length.dtype == torch.int32
    assert tcache.pos.tolist() == np.asarray(jout.pos).tolist() == [7, 0, 13]
    assert tcache.kv.length.tolist() == np.asarray(jout.kv.length).tolist() == [7, 2, 13]


# -- the scheduler against JAX's ----------------------------------------------

KW = dict(max_batch=2, max_ctx=64, bucket=16, paged=True, block_size=4,
          chunked_prefill=True, prefill_budget=8)
# name -> (policy, speculate, draft, kv_int8, max_batch)
SCENARIOS = {
    "solo-k1-w4a8": (Q8, 1, "w4a8", False, 2),
    "solo-k2-w2a8": (Q8, 2, "w2a8", False, 2),
    "solo-k4-w4a8": (Q8, 4, "w4a8", False, 2),
    "int8-k4-w4a8": (Q8, 4, "w4a8", True, 2),
    "mid-k4-w4a8": (Q8, 4, "w4a8", False, 3),
    "table3-k3-w2a8": (TABLE3, 3, "w2a8", False, 2),
}


def _requests(name, make):
    """The scenario's requests as `make(rid, prompt, max_new, temperature)`
    in submission waves: solo runs one greedy request; the mid-decode run
    admits a greedy and a sampled request while a greedy one decodes."""
    if name.startswith("mid"):
        return [[make(0, PROMPT_A, 14, 0.0)],
                [make(1, PROMPT_B, 8, 0.0), make(2, PROMPT_B[::-1].copy(), 8, 0.7)]]
    return [[make(1, PROMPT_B if "int8" not in name else PROMPT_A, 12, 0.0)]]


def _serve(sched, waves):
    done = []
    for i, wave in enumerate(waves):
        for r in wave:
            sched.submit(r)
        for _ in range(3 if i + 1 < len(waves) else 10 ** 6):
            done.extend(sched.step())
            if not (sched.num_active or sched.num_waiting):
                break
    greedy = {r.rid: r.out_tokens for r in done if r.temperature == 0}
    return greedy, {k: sched.pool_stats()[k] for k in SPEC_COUNTERS}, done


@pytest.fixture(scope="module")
def jax_runs(jax_params):
    """Each scenario through the JAX scheduler, once per module: greedy
    tokens and speculation counters."""
    _, params = jax_params
    out = {}
    for name, (policy, k, draft, kv_int8, mb) in SCENARIOS.items():
        jcfg, _ = _models(kv_int8)
        sched = JaxScheduler(jcfg, params, quant=jax_policy(policy), preempt=False,
                             max_head_bypass=0, speculate=k, draft_policy=draft,
                             **dict(KW, max_batch=mb))
        out[name] = _serve(sched, _requests(name, lambda *a: JaxRequest(
            a[0], a[1], max_new_tokens=a[2], temperature=a[3])))[:2]
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scheduler_matches_jax_and_no_speculation(jax_params, jax_runs, name):
    """The port's scheduler with speculation emits JAX's greedy tokens and
    JAX's speculation counters, and the greedy tokens it emits without
    speculation; the pool holds its invariants."""
    _, params = jax_params
    policy, k, draft, kv_int8, mb = SCENARIOS[name]
    _, tcfg = _models(kv_int8)
    tparams = convert.params_from_numpy(to_numpy_tree(params), "cpu")
    got = {}
    for spec in (k, 0):
        sched = ContinuousScheduler(tcfg, tparams, quant=parse_policy_spec(policy),
                                    preempt=False, max_head_bypass=0,
                                    speculate=spec, draft_policy=draft, device="cpu",
                                    **dict(KW, max_batch=mb))
        got[spec] = _serve(sched, _requests(name, lambda *a: Request(
            a[0], a[1], max_new_tokens=a[2], temperature=a[3])))
        assert_pool_invariants(sched)
    want_toks, want_counts = jax_runs[name]
    assert got[k][0] == want_toks == got[0][0]
    assert got[k][1] == want_counts
    assert want_counts["spec_rounds"] > 0 and want_counts["spec_draft_tokens"] > 0
    drafted = sum(r.spec_drafted for r in got[k][2])
    accepted = sum(r.spec_accepted for r in got[k][2])
    assert (drafted, accepted) == (want_counts["spec_draft_tokens"],
                                   want_counts["spec_accepted_tokens"])
    assert all(r.spec_drafted == 0 for r in got[k][2] if r.temperature > 0)


# -- the port against itself --------------------------------------------------

@pytest.fixture(scope="module")
def olmo():
    cfg = get_reduced_config("olmo-1b")
    return cfg, build_model(cfg).init(seed=0, device="cpu")


def _sched(cfg, params, speculate, draft="w4a8", policy=Q8, **kw):
    args = dict(KW, quant=parse_policy_spec(policy), speculate=speculate,
                draft_policy=draft, device="cpu")
    args.update(kw)
    return ContinuousScheduler(cfg, params, **args)


def _drain(sched):
    out = []
    while sched.num_active or sched.num_waiting:
        out.extend(sched.step())
    assert_pool_invariants(sched)
    return out


def test_acceptance_counters(olmo):
    """Per-request counters mirror the scheduler's totals (one request),
    the acceptance rate is their ratio, and verify rows >= calls."""
    cfg, params = olmo
    sched = _sched(cfg, params, 4)
    req = Request(1, PROMPT_A, max_new_tokens=16)
    sched.submit(req)
    _drain(sched)
    st = sched.pool_stats()
    assert st["speculate"] == 4
    assert st["spec_draft_tokens"] >= st["spec_accepted_tokens"] > 0
    assert st["spec_acceptance_rate"] == pytest.approx(
        st["spec_accepted_tokens"] / st["spec_draft_tokens"])
    assert (req.spec_drafted, req.spec_accepted) == (st["spec_draft_tokens"],
                                                     st["spec_accepted_tokens"])
    assert req.spec_acceptance_rate == pytest.approx(st["spec_acceptance_rate"])
    assert st["spec_verify_rows"] >= st["spec_verify_calls"] > 0


def test_prefix_cache_after_speculative_retirement(olmo):
    """A speculating request's retirement registers its prompt blocks as
    usual; a same-prompt follower hits them and still emits the stream
    without speculation (speculative writes land only past the prompt)."""
    cfg, params = olmo
    ref = _sched(cfg, params, 0)
    ref.submit(Request(1, PROMPT_B, max_new_tokens=10))
    ref_toks = _drain(ref)[0].out_tokens
    sched = _sched(cfg, params, 4)
    sched.submit(Request(1, PROMPT_B, max_new_tokens=10))
    first = _drain(sched)[0].out_tokens
    sched.submit(Request(2, PROMPT_B, max_new_tokens=10))
    second = _drain(sched)[0].out_tokens
    assert first == ref_toks == second
    assert sched.pool_stats()["prefix_hit_tokens"] > 0
    assert sched.pool_stats()["spec_rounds"] > 0


def test_speculation_refusals(olmo):
    """Speculation needs packed weights, the paged pool and a transformer:
    the scheduler raises otherwise (nothing falls back to plain decode)."""
    cfg, params = olmo
    with pytest.raises(ValueError, match="quant policy"):
        ContinuousScheduler(cfg, params, speculate=4, device="cpu", **KW)
    with pytest.raises(ValueError, match="paged KV cache"):
        _sched(cfg, params, 4, paged=False, chunked_prefill=False)
    with pytest.raises(ValueError, match="speculate must be >= 1"):
        _sched(cfg, params, -1)
    rcfg = get_reduced_config("rwkv6-3b")
    rparams = build_model(rcfg).init(seed=0, device="cpu")
    with pytest.raises(ValueError, match="paged KV cache"):
        ContinuousScheduler(rcfg, rparams, speculate=2, device="cpu", max_batch=2)


@pytest.mark.parametrize("argv,exc,match", [
    (["--policy", Q8, "--speculate", "2"], SystemExit, "add --continuous"),
    (["--static", "--policy", Q8, "--speculate", "2"], SystemExit, "add --continuous"),
    (["--continuous", "--speculate", "2"], SystemExit, "add a quant policy"),
    (["--continuous", "--policy", Q8, "--speculate", "2", "--no-paged"], ValueError,
     "paged KV cache"),
    (["--continuous", "--policy", Q8, "--speculate", "2", "--draft-policy", "w8a8"],
     ValueError, "truncates no leaf"),
    (["--arch", "rwkv6-3b", "--continuous", "--speculate", "2"], SystemExit,
     "add a quant policy"),
    (["--arch", "rwkv6-3b", "--continuous", "--policy", Q8, "--speculate", "2"],
     SystemExit, "unquantized"),
])
def test_serve_cli_refusals(argv, exc, match):
    from repro_torch.launch import serve

    base = ["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--requests", "2",
            "--max-new", "3"]
    with pytest.raises(exc, match=match):
        serve.run(serve.build_parser().parse_args(base + argv))


def test_serve_cli_speculation_on_cpu(capsys):
    """--speculate 3 --draft-policy w2a8 on a Table III policy: the CLI
    reports the speculation counters, and every greedy request emits the
    tokens it emits without --speculate."""
    from repro_torch.launch import serve

    argv = ["--arch", "olmo-1b", "--reduced", "--continuous", "--policy", TABLE3,
            "--device", "cpu", "--requests", "4", "--max-new", "6", "--block-size", "4",
            "--prefill-budget", "8"]
    toks = {}
    for extra in ([], ["--speculate", "3", "--draft-policy", "w2a8"]):
        _, done, report = serve.run(serve.build_parser().parse_args(argv + extra))
        toks[bool(extra)] = {r.rid: r.out_tokens for r in done if r.temperature == 0}
        assert report["stats"]["speculate"] == (3 if extra else 0)
    assert toks[True] == toks[False]
    assert "speculative decode: k=3" in capsys.readouterr().out
