"""The Griffin hybrid (recurrentgemma-9b) in the port, held against the
JAX package on float32 copies of its reduced config, and the port's own
serving contracts for it.

Weights are JAX's (``init`` from PRNGKey 0), carried across with
``repro_torch.convert``; inputs are seeded with numpy. Tolerances: the
conv and the recurrent mixers within 1e-6 (the same float32 operations;
the RG-LRU's sequential scan against JAX's associative scan rounds in
another order, within 1e-5 on the plain version); whole-model prefill
and decode logits within 1e-4 and the recurrent states and ring K/V
within 1e-5 (other summation orders in the products and the attention;
measured below 5e-6); ring slot positions bitwise. Inside the port the
serving contracts compare greedy tokens (CPU float32 rows are not
batch-invariant, ROADMAP Queue 3): bucketed ≡ exact length, mid-flight
join ≡ solo, static ≡ continuous, also past the window.
"""
import ctypes
import dataclasses
import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced_config as jax_reduced
from repro.core.precision import parse_policy_spec as jax_policy
from repro.models import build_model as jax_build
from repro.models import griffin as jg
from repro.models import kv_cache as jkv
from repro_torch import convert
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core.precision import parse_policy_spec
from repro_torch.kernels import build, ops, ref
from repro_torch.models import build_model
from repro_torch.models import common as tcm
from repro_torch.models import griffin as tg
from repro_torch.models import kv_cache as tkv
from repro_torch.models.model_zoo import check_policy
from repro_torch.serving import ContinuousScheduler, Request, ServingEngine
from torch_parity import to_numpy_tree

ARCH = "recurrentgemma-9b"
RNG = np.random.default_rng(25)
PROMPTS = [np.arange(10) * 7 % 512, (np.arange(7) * 13 + 3) % 512,
           (np.arange(23) * 5 + 1) % 512]
LOGIT_TOL = 1e-4
STATE_TOL = 1e-5


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a).copy())
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module", params=[3, 5], ids=["reduced", "rem"])
def pair(request):
    """(JAX cfg, JAX params, port cfg, the same params in the port), float32;
    num_layers 5 adds the two-layer ``rem`` group the reduced config lacks."""
    n = request.param
    jcfg = dataclasses.replace(jax_reduced(ARCH), dtype="float32", num_layers=n)
    tcfg = dataclasses.replace(get_reduced_config(ARCH), dtype="float32", num_layers=n)
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, convert.params_from_numpy(to_numpy_tree(jparams), "cpu")


# -- config, rings ----------------------------------------------------------------

@pytest.mark.parametrize("full", [True, False])
def test_config_is_jax_s(full):
    cfg = get_config(ARCH) if full else get_reduced_config(ARCH)
    jcfg = jax_config(ARCH) if full else jax_reduced(ARCH)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    if full:
        assert (cfg.num_layers, cfg.d_model, cfg.rnn_width, cfg.n_heads, cfg.n_kv_heads,
                cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.local_window) == (
                    38, 4096, 4096, 16, 1, 256, 12288, 256000, 2048)


@pytest.mark.parametrize("lengths", [None, [5, 16, 16], [16, 23, 1], [0, 9, 23]])
def test_ring_align_is_jax_s(lengths):
    """Below, at and above the window (and a zero-length row): k, v and
    slot_pos bitwise JAX's ``ring_align``."""
    L, B, S, NKV, H, W = 2, 3, 23, 1, 4, 16
    k = RNG.standard_normal((L, B, S, NKV, H)).astype(np.float32)
    v = RNG.standard_normal((L, B, S, NKV, H)).astype(np.float32)
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    want = jkv.ring_align(jnp.asarray(k), jnp.asarray(v), jl, W)
    got = tkv.ring_align(_t(k), _t(v), None if lengths is None else torch.tensor(lengths), W)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_ring_cache_init_is_window_sized():
    """A windowed cache is a window-sized ring whatever size is asked for,
    as in JAX; a full cache keeps its size."""
    ring = tkv.KVCache.init(2, 3, 11, 1, 16, window=64, device="cpu")
    want = jkv.KVCache.init(2, 3, 11, 1, 16, window=64)
    assert ring.k.shape == want.k.shape == (2, 3, 64, 1, 16) and ring.window == 64
    assert ring.slot_pos.shape == (2, 3, 64) and bool((ring.slot_pos == -1).all())
    assert tkv.KVCache.init(2, 3, 11, 1, 16, device="cpu").k.shape[2] == 11


@pytest.mark.parametrize("int8", [False, True])
def test_ring_decode_entry_is_its_plain_version(int8):
    """``ops.decode_attention`` with a window over a wrapped ring on CPU
    tensors: bitwise ``common.decode_attention`` (rows before, at and past
    the wrap, one empty)."""
    B, S, NKV, G, H = 4, 16, 1, 4, 16
    q = _t(RNG.standard_normal((B, 1, NKV * G, H)), torch.bfloat16)
    k = _t(RNG.standard_normal((B, S, NKV, H)).astype(np.float32))
    v = _t(RNG.standard_normal((B, S, NKV, H)).astype(np.float32))
    q_pos = torch.tensor([5, 15, 40, 0], dtype=torch.int32)
    n = (q_pos + 1).clamp(max=S)
    _, _, kpos = tkv.ring_align(k[None], v[None], q_pos + 1, S)
    kpos = kpos[0]
    kpos[3] = -1
    if int8:
        (k, ks), (v, vs) = tkv.quantize_kv(k), tkv.quantize_kv(v)
    else:
        k, v, ks, vs = k.to(torch.bfloat16), v.to(torch.bfloat16), None, None
    got = ops.decode_attention(q, k, v, kpos, q_pos, window=S, k_scale=ks, v_scale=vs)
    want = tcm.decode_attention(q, k, v, kpos, q_pos, window=S, k_scale=ks, v_scale=vs)
    assert bool((n > 0).all()) and torch.equal(got, want)


# -- the RG-LRU and the mixers ----------------------------------------------------

def _mix(pair):
    jcfg, jparams, tcfg, tparams = pair
    jmix = jax.tree_util.tree_map(lambda a: a[0], jparams["groups"]["l0_rglru"]["mix"])
    tmix = {k: v[0] for k, v in tparams["groups"]["l0_rglru"]["mix"].items()}
    return jmix, tmix


def test_causal_conv_with_tail_is_jax_s(pair):
    jmix, tmix = _mix(pair)
    a = RNG.standard_normal((2, 9, 64)).astype(np.float32)
    tail = RNG.standard_normal((2, 3, 64)).astype(np.float32)
    for t in (None, tail):
        want = jg._causal_conv(jnp.asarray(a), jmix["conv_w"],
                               None if t is None else jnp.asarray(t))
        got = tg._causal_conv(_t(a), tmix["conv_w"], None if t is None else _t(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("carry", [False, True])
def test_rglru_plain_version_is_jax_s(pair, carry):
    """The RG-LRU's plain version (``ops.rglru_scan`` on the CPU) against
    JAX's ``_rglru_coeffs`` + ``_rglru_scan``, with a carried h0 and
    right-padded rows: h within 1e-5, and h at lengths - 1 that row of
    JAX's h; the gate coefficients within 1e-6."""
    jmix, tmix = _mix(pair)
    B, T, W = 3, 20, 64
    y = RNG.standard_normal((B, T, W)).astype(np.float32)
    h0 = RNG.standard_normal((B, W)).astype(np.float32) if carry else None
    lengths = np.array([20, 13, 1], np.int32)
    ja, jb = jg._rglru_coeffs(jmix, jnp.asarray(y))
    jh = np.asarray(jg._rglru_scan(ja, jb, None if h0 is None else jnp.asarray(h0)))
    ta, tb = tg._rglru_coeffs(tmix, _t(y))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6, rtol=0)
    h, h_last = tg._rglru_scan(tmix, _t(y), None if h0 is None else _t(h0), _t(lengths))
    np.testing.assert_allclose(h.numpy(), jh, atol=1e-5, rtol=0)
    np.testing.assert_allclose(h_last.numpy(), jh[np.arange(B), lengths - 1], atol=1e-5,
                               rtol=0)


def test_rglru_split_and_step_are_one_call():
    """Inside the port the recurrence walks t in order: a prompt run as
    two calls with the carry is bitwise one call, and the step is bitwise
    a T = 1 call."""
    B, T, W = 2, 12, 32
    ga, gi, y = (_t(RNG.standard_normal((B, T, W)).astype(np.float32)) for _ in range(3))
    ab, ib = (_t(RNG.standard_normal(W).astype(np.float32)) for _ in range(2))
    lam = _t(RNG.uniform(0.1, 1.0, W).astype(np.float32))
    h, last = ops.rglru_scan(ga, gi, y, ab, ib, lam)
    h1, last1 = ops.rglru_scan(ga[:, :5], gi[:, :5], y[:, :5], ab, ib, lam)
    h2, last2 = ops.rglru_scan(ga[:, 5:], gi[:, 5:], y[:, 5:], ab, ib, lam, last1)
    assert torch.equal(torch.cat([h1, h2], 1), h) and torch.equal(last2, last)
    step = ops.rglru_step(ga[:, 5], gi[:, 5], y[:, 5], ab, ib, lam, last1)
    assert torch.equal(step, h[:, 5])


def test_rec_mix_apply_and_step_are_jax_s(pair):
    """``rec_mix_apply`` over right-padded rows with a carried state, then
    ``rec_mix_step`` on its state: outputs, h and conv tails within 1e-6."""
    jcfg, _, tcfg, _ = pair
    jmix, tmix = _mix(pair)
    B, T, d, W = 3, 11, 64, 64
    x = RNG.standard_normal((B, T, d)).astype(np.float32)
    h0 = RNG.standard_normal((B, W)).astype(np.float32)
    tail = RNG.standard_normal((B, 3, W)).astype(np.float32)
    lengths = np.array([11, 6, 2], np.int32)
    jo, (jh, jt) = jg.rec_mix_apply(jmix, jcfg, jnp.asarray(x), (jnp.asarray(h0),
                                    jnp.asarray(tail)), jnp.asarray(lengths))
    to, (th, tt) = tg.rec_mix_apply(tmix, tcfg, _t(x), (_t(h0), _t(tail)), _t(lengths))
    for g, w in ((to, jo), (th, jh), (tt, jt)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    x1 = RNG.standard_normal((B, 1, d)).astype(np.float32)
    jo, jh, jt = jg.rec_mix_step(jmix, jcfg, jnp.asarray(x1), jh, jt)
    to, th, tt = tg.rec_mix_step(tmix, tcfg, _t(x1), th, tt)
    for g, w in ((to, jo), (th, jh), (tt, jt)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


# -- the whole model against JAX --------------------------------------------------

def _batch(prompts, L):
    toks = np.zeros((len(prompts), L), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    return toks, np.asarray([len(p) for p in prompts], np.int32)


def _check_cache(tc, jc):
    for name, got, want in (("h", tc.rec.h, jc.rec.h),
                            ("conv_tail", tc.rec.conv_tail, jc.rec.conv_tail),
                            ("k", tc.kv.k, jc.kv.k), ("v", tc.kv.v, jc.kv.v)):
        assert tuple(got.shape) == np.asarray(want).shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=STATE_TOL, rtol=0,
                                   err_msg=name)
    assert np.array_equal(tc.kv.slot_pos.numpy(), np.asarray(jc.kv.slot_pos))
    assert tc.kv.window == jc.kv.window
    assert tc.pos.tolist() == np.asarray(jc.pos).tolist()
    assert tc.kv.length.tolist() == np.asarray(jc.kv.length).tolist()


def test_prefill_and_decode_across_the_window_match_jax(pair):
    """Right-padded prefill of three prompts (one longer than the reduced
    window of 16), then 10 decode steps on JAX's greedy tokens, which
    carry every row past the window (the ring wraps): logits within 1e-4,
    h, conv tails and ring K/V within 1e-5, slot positions bitwise, after
    the prefill and after every step."""
    jcfg, jparams, tcfg, tparams = pair
    toks, lens = _batch(PROMPTS, 32)
    jc, lj = jax.jit(jg.prefill, static_argnums=(1,))(
        jparams, jcfg, {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lens)})
    tc, lt = tg.prefill(tparams, tcfg, {"tokens": _t(toks, torch.int64),
                                        "lengths": _t(lens)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_TOL, rtol=0)
    _check_cache(tc, jc)
    jdecode = jax.jit(jg.decode_step, static_argnums=(1,))
    cur = np.asarray(lj)[:, -1].argmax(-1)[:, None].astype(np.int32)
    for _ in range(10):
        jc, lj = jdecode(jparams, jcfg, jc, jnp.asarray(cur))
        tc, lt = tg.decode_step(tparams, tcfg, tc, _t(cur, torch.int64))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_TOL, rtol=0)
        _check_cache(tc, jc)
        cur = np.asarray(lj)[:, -1].argmax(-1)[:, None].astype(np.int32)
    assert (lens + 10).min() > jcfg.local_window


def test_greedy_tokens_are_jax_s(pair):
    """Each of the short prompts decoded greedily, alone, on each side:
    the same 6 tokens."""
    jcfg, jparams, tcfg, tparams = pair
    jprefill = jax.jit(jg.prefill, static_argnums=(1,))
    jdecode = jax.jit(jg.decode_step, static_argnums=(1,))
    for p in PROMPTS[:2]:
        toks = p[None].astype(np.int32)
        jc, lj = jprefill(jparams, jcfg, {"tokens": jnp.asarray(toks)})
        tc, lt = tg.prefill(tparams, tcfg, {"tokens": _t(toks, torch.int64)})
        jt, tt = [int(np.asarray(lj)[0, -1].argmax())], [int(lt[0, -1].argmax())]
        for _ in range(5):
            jc, lj = jdecode(jparams, jcfg, jc, jnp.asarray([[jt[-1]]], jnp.int32))
            tc, lt = tg.decode_step(tparams, tcfg, tc, torch.tensor([[tt[-1]]]))
            jt.append(int(np.asarray(lj)[0, -1].argmax()))
            tt.append(int(lt[0, -1].argmax()))
        assert tt == jt


def test_init_tree_is_jax_s(pair):
    """``init_params`` builds JAX's tree: the same paths, shapes and dtypes
    (groups stacked over n_groups, ``rem`` where num_layers % 3)."""
    jcfg, jparams, tcfg, tparams = pair
    from torch_parity import leaves

    mine = dict(leaves(build_model(tcfg).init(seed=0, device="cpu")))
    theirs = dict(leaves(to_numpy_tree(jparams)))
    assert sorted(mine) == sorted(theirs)
    for path, a in mine.items():
        assert tuple(a.shape) == theirs[path].shape, path
        assert str(a.dtype).split(".")[-1] == theirs[path].dtype.name, path


# -- the port's own contracts -------------------------------------------------------

@pytest.fixture(scope="module")
def griffin():
    cfg = get_reduced_config(ARCH)
    return cfg, build_model(cfg).init(seed=0, device="cpu")


LONG = (np.arange(29) * 11 + 2) % 512      # longer than the window of 16


@pytest.mark.parametrize("prompt,bucket", [(PROMPTS[2], 32), (PROMPTS[2], 64),
                                           (LONG, 32), (LONG, 64)])
def test_bucketed_prefill_is_exact_length_prefill(griffin, prompt, bucket):
    """A prompt right-padded to a bucket (one longer than the window)
    prefills as at its own length: the same greedy continuation, the same
    slot positions, position and length."""
    cfg, params = griffin
    model = build_model(cfg)
    p = prompt.astype(np.int64)
    toks = np.zeros((1, bucket), np.int64)
    toks[0, :len(p)] = p
    runs = []
    for batch in ({"tokens": _t(p[None])},
                  {"tokens": _t(toks), "lengths": torch.tensor([len(p)], dtype=torch.int32)}):
        cache, lg = model.prefill(params, batch)
        sp = cache.kv.slot_pos.clone()
        out = [int(lg[0, -1].argmax())]
        for _ in range(4):
            cache, lg = model.decode_step(params, cache, torch.tensor([[out[-1]]]))
            out.append(int(lg[0, -1].argmax()))
        runs.append((out, sp, cache.pos.tolist(), cache.kv.length.tolist()))
    assert runs[0][0] == runs[1][0] and torch.equal(runs[0][1], runs[1][1])
    assert runs[0][2:] == runs[1][2:] == ([len(p) + 4], [len(p) + 4])


def test_midflight_join_matches_solo(griffin):
    """A request admitted while another row decodes (its ring row, h and
    conv tail overwritten by the solo prefill's scatter) emits the tokens
    it emits alone, greedy and sampled."""
    cfg, params = griffin
    kw = dict(max_batch=2, max_ctx=32, bucket=16, device="cpu")
    for temp in (0.0, 0.8):
        alone = ContinuousScheduler(cfg, params, **kw).run(
            [Request(1, PROMPTS[1], max_new_tokens=6, temperature=temp)])[0].out_tokens
        sched = ContinuousScheduler(cfg, params, **kw)
        assert not sched.paged and not sched.chunked_prefill
        sched.submit(Request(0, LONG, max_new_tokens=9))
        for _ in range(3):
            sched.step()
        joined = Request(1, PROMPTS[1], max_new_tokens=6, temperature=temp)
        sched.submit(joined)
        while sched.num_active or sched.num_waiting:
            sched.step()
        assert joined.out_tokens == alone


def test_static_matches_continuous_across_the_window(griffin):
    """Static batches and continuous batching with whole-prompt admission
    emit the same tokens, greedy and sampled, for a prompt longer than the
    window and one that crosses it while decoding; a long request is never
    refused for context (rings and states are constant-size)."""
    cfg, params = griffin
    reqs = lambda: [Request(0, PROMPTS[0], max_new_tokens=9),
                    Request(1, LONG, max_new_tokens=6, temperature=0.8, top_k=40),
                    Request(2, PROMPTS[2], max_new_tokens=12),
                    Request(3, PROMPTS[1], max_new_tokens=14)]
    eng = ServingEngine(cfg, params, max_batch=2, bucket=16, device="cpu")
    static = {r.rid: r.out_tokens for r in eng.generate_static(reqs())}
    cont = {r.rid: r.out_tokens for r in eng.generate(reqs())}
    assert cont == static
    stats = eng.pool_stats()
    assert stats["paged"] is False and stats["chunked_prefill"] is False
    ring = eng.scheduler().cache.kv
    assert ring.window == cfg.local_window and ring.k.shape[2] == cfg.local_window
    assert stats["resident_kv_bytes"] > ring.k.numel() * 2 * ring.k.element_size()
    long = eng.scheduler().run([Request(9, np.arange(200) % 512, max_new_tokens=3)])[0]
    assert not long.failed and len(long.out_tokens) == 3


@pytest.mark.parametrize("kw,match", [
    (dict(paged=True), "paged KV cache requires"),
    (dict(chunked_prefill=True), "chunked prefill requires"),
    (dict(prefix_cache=True), "prefix caching requires"),
    (dict(tiers="w8a8"), "tiers need the paged"),
    (dict(preempt=True), "preemption needs the paged"),
    (dict(quant=parse_policy_spec("w4a8")), "griffin unquantized"),
])
def test_scheduler_refuses_what_jax_refuses(griffin, kw, match):
    """Paging, chunked prefill, the prefix cache, tiers, preemption and a
    policy stay off for griffin, as JAX's eligibility gates leave them."""
    cfg, params = griffin
    with pytest.raises(ValueError, match=match):
        ContinuousScheduler(cfg, params, device="cpu", **kw)


def test_check_policy_refuses_the_hybrid_like_jax():
    """A policy for griffin is refused with the JAX limit named; the JAX
    package itself fails on a packed ``rg_a_proj`` where the message says."""
    cfg = get_reduced_config(ARCH)
    for policy in (parse_policy_spec("w4a8"), parse_policy_spec("w4a8;wo=w8a8")):
        with pytest.raises(ValueError, match=r"repro/models/griffin\.py:128"):
            check_policy(cfg, policy)
    check_policy(cfg, None)
    with pytest.raises(ValueError, match="griffin unquantized"):
        ServingEngine(cfg, {}, quant=parse_policy_spec("w4a8"), device="cpu")
    from repro.core.quantized_linear import quantize_params_for_serving as jax_pack

    # A stacked (n_groups, W, W) gate leaf at rnn_width 256, packed by JAX.
    w = jax.random.normal(jax.random.PRNGKey(0), (1, 256, 256)) * 0.0625
    packed = jax_pack({"groups": {"l0_rglru": {"mix": {"rg_a_proj": w}}}},
                      jax_policy("w4a8"), min_size=1024)["groups"]["l0_rglru"]["mix"]
    assert hasattr(packed["rg_a_proj"], "packed")
    with pytest.raises(AttributeError, match="astype"):
        jg._rglru_coeffs(packed, jnp.zeros((1, 2, 256)))


def test_kv_int8_leaves_the_ring_bf16(griffin):
    """``kv_cache_quant`` does not quantize griffin's ring (JAX keeps it in
    the model dtype too): bf16 K/V, no scale planes."""
    cfg, params = griffin
    cfg8 = dataclasses.replace(cfg, kv_cache_quant=True)
    cache, _ = build_model(cfg8).prefill(params, {"tokens": _t(PROMPTS[0][None])})
    assert cache.kv.k.dtype == torch.bfloat16 and not cache.kv.quantized
    sched = ContinuousScheduler(cfg8, params, max_batch=2, max_ctx=32, device="cpu")
    assert sched.cache.kv.k.dtype == torch.bfloat16 and not sched.cache.kv.quantized


@pytest.mark.parametrize("flags,report", [
    (["--static"], "[static]"),
    (["--continuous", "--kv-int8"], "ring KV cache + recurrent state:"),
])
def test_serve_cli(capsys, flags, report):
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "3",
                "--max-new", "4", "--max-batch", "2", *flags])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and report in out and "req 2: [" in out


def test_serve_cli_refuses_a_policy():
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match="griffin unquantized"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--policy", "w4a8"])


# -- kernel bindings ----------------------------------------------------------------

@pytest.mark.parametrize("module,source,entry", [
    ("rglru", "rglru", "rglru"),
    ("rglru", "rglru", "rglru_step"),
    ("paged_attention", "paged_attention", "ring_attention"),
    ("dense_matmul", "dense_matmul", "dense_matmul_f32"),
])
def test_new_ctypes_signatures_match_their_c_entries(module, source, entry):
    """The ctypes argtypes of this slice's C entries follow their
    parameters one for one, as the other kernels' bindings do."""
    src = (build.CSRC / f"{source}.cu").read_text()
    params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src).group(1).split(",")
    want = [ctypes.c_void_p if "*" in p else
            ctypes.c_float if p.split()[0] == "float" else ctypes.c_int
            for p in params]
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    assert getattr(mod, f"{entry.upper()}_ARGTYPES", mod.ARGTYPES) == want
    assert source in build.KERNELS


H100_SMS = 132      # the plan's streaming multiprocessors in these tests


@pytest.mark.parametrize("B", [1, 2, 3, 4, 8, 64])
@pytest.mark.parametrize("W", [8, 64, 72, 4096, 4104])
@pytest.mark.parametrize("y_bytes", [2, 4])
def test_rglru_plan_tiles_cover_w_in_16_byte_rows(B, W, y_bytes):
    """The prefill kernel's plan: its blocks cover the W channels exactly
    (the last tile ragged only by whole 16-byte rows), the tile is one the
    kernel instantiates, split into whole fold warps and 16-byte rows of
    ga, gi, y and h, and its gate warps cover a chunk's rows evenly."""
    from repro_torch.kernels import rglru

    tile, warps = rglru.plan(B, W, H100_SMS)
    assert (tile, warps) in rglru.PLANS and tile % 32 == 0
    blocks = -(-W // tile)
    assert (blocks - 1) * tile < W <= blocks * tile
    last = W - (blocks - 1) * tile
    assert last % 8 == 0 and (last * y_bytes) % 16 == 0 and (last * 4) % 16 == 0
    assert (tile * y_bytes) % 16 == 0 and (tile * 4) % 16 == 0
    assert (32 * tile) % (32 * warps) == 0 and (32 * warps) % tile == 0


def test_rglru_plan_fills_the_card_at_griffin_s_batches():
    """recurrentgemma-9b (W = 4096): B = 1 (a continuous run's solo
    admission) takes 32-channel tiles and 16 gate warps, 128 blocks of one
    an SM; B = 2 (the ring-wrap pair) 64 and 16; B = 4 (a static batch) 64
    and 8, 256 blocks two an SM; a W the tensor copies cannot take raises."""
    from repro_torch.kernels import rglru

    assert rglru.plan(1, 4096, H100_SMS) == (32, 16)
    assert rglru.plan(2, 4096, H100_SMS) == (64, 16)
    assert rglru.plan(4, 4096, H100_SMS) == (64, 8)
    for B in (1, 2, 4):
        assert B * 4096 // rglru.plan(B, 4096, H100_SMS)[0] >= 128
    with pytest.raises(ValueError, match="multiple of 8"):
        rglru.plan(1, 4100, H100_SMS)


def test_rglru_plans_are_the_kernel_s_instantiations_and_griffin_reaches_each():
    """``rglru.PLANS`` lists exactly the (tile, gate warps) pairs that
    ``csrc/rglru.cu`` instantiates, and griffin's batches of 1-4 rows at
    W = 4096 reach every one of them on the H100, so no instantiation is
    built that the card's gates never run."""
    from repro_torch.kernels import rglru

    src = (build.CSRC / "rglru.cu").read_text()
    built = {(int(c), int(m)) for c, m in re.findall(r"^\s*RGLRU_PLAN\((\d+), (\d+)\)\s*$",
                                                       src, re.M)}
    assert built == set(rglru.PLANS) and len(rglru.PLANS) == len(built)
    assert {rglru.plan(B, 4096, H100_SMS) for B in (1, 2, 3, 4)} == built


def test_ring_splits_cover_any_window():
    """Ring decode scratch holds every split a window may span, wherever
    it starts (33 for the 2048-key window)."""
    from repro_torch.kernels.paged_attention import SPLIT, ring_splits

    assert ring_splits(2048) == 33 and ring_splits(16) == 2
    for w in (1, 16, 63, 64, 65, 2048):
        for first in range(0, 3 * SPLIT):
            spans = (first + w - 1) // SPLIT - first // SPLIT + 1
            assert spans <= ring_splits(w)


def test_new_kernels_never_fall_back():
    """A non-CPU tensor goes to the RG-LRU kernel (or the dense kernel's
    float32 store) or raises; it never runs the plain version."""
    z = torch.zeros((1, 2, 8), device="meta")
    w8 = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.rglru_scan(z, z, z, w8, w8, w8)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.rglru_step(z[:, 0], z[:, 0], z[:, 0], w8, w8, w8, z[:, 0])
    x = torch.zeros((2, 8), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.dense_matmul(x, torch.zeros((8, 8), dtype=torch.bfloat16),
                         out_dtype=torch.float32)


def test_dense_matmul_float32_store_cpu_is_jax_s_product():
    """On the CPU the float32-store product is ``x.float() @ w.float()``,
    JAX's ``yf @ A.astype(f32)``, for bf16 and float32 rows."""
    x = _t(RNG.standard_normal((5, 64)).astype(np.float32))
    w = _t(RNG.standard_normal((64, 40)).astype(np.float32)).to(torch.bfloat16)
    for xx in (x, x.to(torch.bfloat16)):
        got = ops.dense_matmul(xx, w, out_dtype=torch.float32)
        assert got.dtype == torch.float32
        assert torch.equal(got, xx.to(torch.float32) @ w.to(torch.float32))
    assert ref.rglru_scan_ref is not None


@pytest.mark.parametrize("d", [16, 64, 160, 2048, 2560, 4096, 6144])
def test_chunked_row_mean_is_the_mean_row_by_row(d):
    """The card's norm mean (``common.chunked_row_mean``, 32-wide sums in
    stages) is the mean within float32 rounding (1e-6 relative), and each
    row's bits are the same whatever the number of rows (1-9)."""
    x = _t((RNG.standard_normal((9, d)) * 3).astype(np.float32))
    got = tcm.chunked_row_mean(x)
    np.testing.assert_allclose(got.numpy(), x.mean(-1, keepdim=True).numpy(), rtol=1e-6,
                               atol=1e-6)
    for m in range(1, 10):
        assert torch.equal(tcm.chunked_row_mean(x[:m]), got[:m])
    assert torch.equal(tcm.row_mean(x), x.mean(-1, keepdim=True))
