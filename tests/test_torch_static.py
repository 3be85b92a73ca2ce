"""Whole-prompt prefill and the static engine of the PyTorch port: the
model's ``prefill`` and contiguous ``decode_step`` and the engine's
``generate_static`` held against the JAX package, and the port's own
contracts across its serving paths (bucketed ≡ exact-length prefill,
static solo ≡ static batch ≡ continuous with chunked prefill, with solo
whole-prompt admission and on the contiguous cache), and the serve CLI.

Against JAX, weights are JAX's, packed by JAX under the serving policy and
carried across with ``repro_torch.convert.params_from_numpy``, on a
float32 copy of the reduced olmo-1b config. The port contracts the
integer codes, the JAX model the dequantized floats, so logits and cached
float K/V agree at float32 rounding: atol 1e-3; int8 cache codes within
one step (a value within rounding of a half-code boundary). Inside the
port the contracts are bitwise (identical tokens).
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
from repro.models import transformer as jtf
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch import convert
from repro_torch.configs import get_reduced_config
from repro_torch.core.precision import parse_policy_spec
from repro_torch.core.quantized_linear import quantize_params_for_serving
from repro_torch.models import build_model
from repro_torch.models import transformer as ttf
from repro_torch.serving import ContinuousScheduler, Request, ServingEngine
from torch_parity import to_numpy_tree

ATOL = 1e-3
POLICY = "w4a8;wo=w8a8"
MIXED = "w4a6r25;wo=w8a8"            # Table III intra-layer mixing
PROMPTS = [np.arange(10) * 7 % 512, (np.arange(7) * 13 + 3) % 512,
           (np.arange(23) * 5 + 1) % 512]


def _pair(policy, kv_int8=False):
    """(JAX cfg, packed JAX params, port cfg, the same params in the port)."""
    jcfg = dataclasses.replace(jax_reduced("olmo-1b"), dtype="float32",
                               kv_cache_quant=kv_int8)
    tcfg = dataclasses.replace(get_reduced_config("olmo-1b"), dtype="float32",
                               kv_cache_quant=kv_int8)
    jparams = jax_pack(jax_build(jcfg).init(jax.random.PRNGKey(0)),
                       jax_policy(policy), min_size=1024)
    return jcfg, jparams, tcfg, convert.params_from_numpy(to_numpy_tree(jparams), "cpu")


def _batch(prompts, L):
    toks = np.zeros((len(prompts), L), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    return toks, np.asarray([len(p) for p in prompts], np.int32)


@pytest.mark.parametrize("policy,kv_int8", [(POLICY, False), (POLICY, True),
                                            (MIXED, False)])
def test_prefill_and_contiguous_decode_match_jax(policy, kv_int8):
    """Right-padded whole-prompt prefill of three prompts: last-token
    logits and the contiguous cache (K/V, slot positions, lengths, int8
    scales) against JAX's ``prefill``; then three contiguous decode steps
    against JAX's ``decode_step``."""
    jcfg, jparams, tcfg, tparams = _pair(policy, kv_int8)
    toks, lens = _batch(PROMPTS, 32)
    jcache, lj = jax.jit(jtf.prefill, static_argnums=(1,))(
        jparams, jcfg, {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lens)})
    tcache, lt = ttf.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks.astype(np.int64)),
                                             "lengths": torch.from_numpy(lens)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)
    jkv, tkv = jcache.kv, tcache.kv
    assert tkv.k.shape == jkv.k.shape == (2, 3, 32 + ttf.DECODE_HEADROOM, 4, 16)
    assert np.array_equal(tkv.slot_pos.numpy(), np.asarray(jkv.slot_pos))
    assert tkv.length.tolist() == np.asarray(jkv.length).tolist() == lens.tolist()
    assert tcache.pos.tolist() == lens.tolist()
    live = tkv.slot_pos.numpy() >= 0
    for t, j in ((tkv.k, jkv.k), (tkv.v, jkv.v)):
        diff = np.abs(t.numpy().astype(np.float32) - np.asarray(j).astype(np.float32))
        assert diff[live].max() <= (1 if kv_int8 else ATOL)
    if kv_int8:
        np.testing.assert_allclose(tkv.k_scale.numpy()[live], np.asarray(jkv.k_scale)[live],
                                   rtol=1e-4)

    jdecode = jax.jit(jtf.decode_step, static_argnums=(1,))
    cur = np.asarray(lj)[:, -1].argmax(-1)[:, None].astype(np.int32)
    for _ in range(3):
        jcache, lj = jdecode(jparams, jcfg, jcache, jnp.asarray(cur))
        tcache, lt = ttf.decode_step(tparams, tcfg, tcache, torch.from_numpy(cur))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)
        cur = np.asarray(lj)[:, -1].argmax(-1)[:, None].astype(np.int32)
    assert tcache.pos.tolist() == np.asarray(jcache.pos).tolist() == (lens + 3).tolist()
    assert np.array_equal(tcache.kv.slot_pos.numpy(), np.asarray(jcache.kv.slot_pos))


@pytest.fixture(scope="module")
def olmo():
    """The reduced config in its serving dtype (bfloat16), packed under
    the Table III policy."""
    cfg = get_reduced_config("olmo-1b")
    params = build_model(cfg).init(seed=0, device="cpu")
    return cfg, params


@pytest.mark.parametrize("kv_int8", [False, True])
def test_bucketed_prefill_is_exact_length_prefill(olmo, kv_int8):
    """A prompt right-padded to any bucket prefills bitwise as at its own
    length: logits and every live cache slot."""
    cfg, params = olmo
    cfg = dataclasses.replace(cfg, kv_cache_quant=kv_int8)
    params = quantize_params_for_serving(params, parse_policy_spec(MIXED), min_size=1024)
    p = PROMPTS[2]
    n = len(p)
    outs = []
    for L in (n, 32, 64):
        toks, lens = _batch([p], L)
        outs.append(ttf.prefill(params, cfg, {"tokens": torch.from_numpy(toks.astype(np.int64)),
                                              "lengths": torch.from_numpy(lens)}))
    (c0, l0) = outs[0]
    for c, lg in outs[1:]:
        assert torch.equal(lg, l0)
        for a, b in ((c.kv.k, c0.kv.k), (c.kv.v, c0.kv.v)):
            assert torch.equal(a[:, :, :n], b[:, :, :n])
        if kv_int8:
            assert torch.equal(c.kv.k_scale[:, :, :n], c0.kv.k_scale[:, :, :n])
        assert bool((c.kv.slot_pos[:, :, n:] == -1).all())


@pytest.mark.parametrize("policy", [POLICY, MIXED])
def test_generate_static_matches_jax(policy):
    """Greedy static batches (two slots, three requests: a second batch of
    one) emit JAX's tokens."""
    jcfg, jparams, tcfg, tparams = _pair(policy)
    reqs = lambda R: [R(i, p, max_new_tokens=6) for i, p in enumerate(PROMPTS)]
    want = {r.rid: r.out_tokens for r in JaxEngine(
        jcfg, jparams, max_batch=2, bucket=16).generate_static(reqs(JaxRequest))}
    got = {r.rid: r.out_tokens for r in ServingEngine(
        tcfg, tparams, max_batch=2, bucket=16, device="cpu").generate_static(reqs(Request))}
    assert got == want
    assert all(len(t) == 6 for t in got.values())


def _requests():
    return [Request(0, PROMPTS[0], max_new_tokens=9),
            Request(1, PROMPTS[1], max_new_tokens=6, temperature=0.8, top_k=40),
            Request(2, PROMPTS[2], max_new_tokens=7)]


@pytest.mark.parametrize("policy,kv_int8", [(MIXED, False), (POLICY, True)])
def test_every_path_matches_static(olmo, policy, kv_int8):
    """The static engine is the oracle: a request alone, in a static
    batch, and through the continuous scheduler — chunked prefill on the
    paged pool, solo whole-prompt admission on the paged pool, and the
    contiguous per-slot cache — emits the same tokens, greedy and
    sampled."""
    cfg, params = olmo
    cfg = dataclasses.replace(cfg, kv_cache_quant=kv_int8)
    kw = dict(max_batch=2, quant=parse_policy_spec(policy), bucket=16, device="cpu")
    static = {r.rid: r.out_tokens
              for r in ServingEngine(cfg, params, **kw).generate_static(_requests())}
    solo = ServingEngine(cfg, params, **kw).generate_static(
        [Request(2, PROMPTS[2], max_new_tokens=7)])
    assert solo[0].out_tokens == static[2]
    for paths in (dict(), dict(chunked_prefill=False), dict(paged=False)):
        eng = ServingEngine(cfg, params, block_size=4, prefill_budget=8, **paths, **kw)
        got = {r.rid: r.out_tokens for r in eng.generate(_requests())}
        assert got == static, paths
        stats = eng.pool_stats()
        assert stats["paged"] == paths.get("paged", True)
        assert stats["chunked_prefill"] == (not paths)


def test_contiguous_scheduler_admits_mid_decode(olmo):
    """On the contiguous cache, a request admitted while another row is
    decoding (its row overwritten by the solo prefill's scatter) emits the
    tokens it emits alone."""
    cfg, params = olmo
    kw = dict(max_batch=2, max_ctx=48, quant=parse_policy_spec(POLICY), bucket=16,
              paged=False, device="cpu")
    alone = ContinuousScheduler(cfg, params, **kw).run(
        [Request(5, PROMPTS[2], max_new_tokens=6)])[0].out_tokens
    sched = ContinuousScheduler(cfg, params, **kw)
    sched.submit(Request(0, PROMPTS[0], max_new_tokens=4))
    sched.submit(Request(1, PROMPTS[1], max_new_tokens=12))
    for _ in range(5):                 # request 0 retires; its row frees
        sched.step()
    late = Request(5, PROMPTS[2], max_new_tokens=6)
    sched.submit(late)
    while sched.num_active or sched.num_waiting:
        sched.step()
    assert late.out_tokens == alone
    too_long = sched.run([Request(9, np.arange(60) % 512, max_new_tokens=4)])[0]
    assert too_long.failed


@pytest.mark.parametrize("flags,report", [
    (["--static", "--policy", MIXED], "[static]"),
    (["--policy", POLICY, "--kv-int8"], "[static]"),
    (["--continuous", "--no-chunked-prefill", "--policy", MIXED], "paged KV pool:"),
    (["--continuous", "--no-paged", "--policy", POLICY], "contiguous KV cache:"),
])
def test_serve_cli_static_and_whole_prompt_paths(capsys, flags, report):
    from repro_torch.launch import serve

    serve.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--requests", "3",
                "--max-new", "4", "--max-batch", "2", "--block-size", "4", *flags])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and report in out
    assert "req 2: [" in out
    assert ("chunked prefill:" in out) is False


def test_serve_cli_refuses_static_with_continuous():
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match="mutually exclusive"):
        serve.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--static",
                    "--continuous"])
