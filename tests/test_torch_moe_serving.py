"""mixtral-8x22b (MoE top-2, a 16-token window reduced), llama4-maverick
(MoE top-1, qk-norm) and nemotron-4-340b (dense, relu2) served by the
port, held against the JAX package on float32 copies of their reduced
configs, with JAX's weights (``init`` from PRNGKey 0) carried across.

Held: whole-prompt prefill and contiguous decode logits within
``test_torch_model.py``'s atol 1e-3 of JAX's, mixtral's over a 40-token
prompt beside a 23-token one and 8 decode steps across the ring's wrap
(on the float and the int8 ring, and packed); prefill ≡ decode in the
port at capacity factor 16, where no token drops (JAX's
``test_prefill_decode_consistency`` setting), within 1e-4; the greedy
tokens of short prompts through the static engine and the continuous
scheduler equal to JAX's (mixtral: solo admission into the contiguous
ring; llama4: solo admission into the paged pool; nemotron-4-340b:
chunked prefill); the packed leaf set and bytes equal to JAX's
``quantize_params_for_serving`` (the router and the (L, E, d, f) experts
stay float); and the refusals of JAX's scheduler and serve CLI: no paged
pool under a window, no chunked prefill, prefix cache or speculation for
MoE or windowed archs, the model surface's entries gated as JAX gates
them.
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
from repro.serving import ContinuousScheduler as JaxScheduler
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch import convert
from repro_torch.configs import get_reduced_config
from repro_torch.core.precision import parse_policy_spec
from repro_torch.core.quantized_linear import quantize_params_for_serving
from repro_torch.models import build_model
from repro_torch.models import transformer as ttf
from repro_torch.serving import ContinuousScheduler, Request, ServingEngine
from torch_parity import assert_packed_equal, leaves, to_numpy_tree

ATOL = 1e-3
POLICY = "w4a8;wo=w8a8"
MIXED = "w4a6r25;wo=w8a8"
MIXTRAL, LLAMA4, NEMOTRON = "mixtral-8x22b", "llama4-maverick-400b-a17b", "nemotron-4-340b"
ARCHS = [MIXTRAL, LLAMA4, NEMOTRON]
PROMPTS = [np.arange(10) * 7 % 512, (np.arange(5) * 13 + 3) % 512,
           (np.arange(7) * 5 + 1) % 512]


@pytest.fixture(scope="module")
def models():
    """Per arch: (JAX cfg, JAX raw params, port cfg), float32, built once."""
    out = {}
    for arch in ARCHS:
        jcfg = dataclasses.replace(jax_reduced(arch), dtype="float32")
        tcfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
        out[arch] = (jcfg, jax.jit(jax_build(jcfg).init)(jax.random.PRNGKey(0)), tcfg)
    return out


def _pair(models, arch, packed=False, kv_int8=False, **over):
    """(JAX cfg, JAX params, port cfg, the same params in the port)."""
    jcfg, raw, tcfg = models[arch]
    jcfg = dataclasses.replace(jcfg, kv_cache_quant=kv_int8, **over)
    tcfg = dataclasses.replace(tcfg, kv_cache_quant=kv_int8, **over)
    jparams = jax_pack(raw, jax_policy(POLICY), min_size=1024) if packed else raw
    return jcfg, jparams, tcfg, convert.params_from_numpy(to_numpy_tree(jparams), "cpu")


def _batch(prompts, L):
    toks = np.zeros((len(prompts), L), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    return toks, np.asarray([len(p) for p in prompts], np.int32)


@pytest.mark.parametrize("arch,packed,kv_int8", [
    (MIXTRAL, False, False), (MIXTRAL, False, True), (MIXTRAL, True, False),
    (LLAMA4, False, False), (LLAMA4, True, True), (NEMOTRON, False, False)],
    ids=["mixtral", "mixtral-int8", "mixtral-w4a8", "llama4", "llama4-w4a8-int8",
         "nemotron-340b"])
def test_prefill_and_decode_match_jax(models, arch, packed, kv_int8):
    """Right-padded prompts through whole-prompt prefill, then 8 decode
    steps on the contiguous cache: logits, positions and the live cache
    slots against JAX's. mixtral's 40-token prompt overfills its 16-slot
    ring at prefill and its 23-token one wraps it during the decode."""
    jcfg, jparams, tcfg, tparams = _pair(models, arch, packed, kv_int8)
    rng = np.random.default_rng(11)
    prompts = ([rng.integers(0, 512, 40), rng.integers(0, 512, 23)] if arch == MIXTRAL
               else PROMPTS)
    toks, lens = _batch(prompts, 48 if arch == MIXTRAL else 16)
    jcache, lj = jax.jit(jtf.prefill, static_argnums=(1,))(
        jparams, jcfg, {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lens)})
    tcache, lt = ttf.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks.astype(np.int64)),
                                             "lengths": torch.from_numpy(lens)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)
    assert tcache.kv.window == jcache.kv.window == jcfg.attn_window
    assert tuple(tcache.kv.k.shape) == tuple(jcache.kv.k.shape)
    assert np.array_equal(tcache.kv.slot_pos.numpy(), np.asarray(jcache.kv.slot_pos))
    jdecode = jax.jit(jtf.decode_step, static_argnums=(1,))
    cur = np.asarray(lj)[:, -1].argmax(-1)[:, None].astype(np.int32)
    for _ in range(8):
        jcache, lj = jdecode(jparams, jcfg, jcache, jnp.asarray(cur))
        tcache, lt = ttf.decode_step(tparams, tcfg, tcache, torch.from_numpy(cur))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)
        cur = np.asarray(lj)[:, -1].argmax(-1)[:, None].astype(np.int32)
    assert tcache.pos.tolist() == np.asarray(jcache.pos).tolist() == (lens + 8).tolist()
    assert np.array_equal(tcache.kv.slot_pos.numpy(), np.asarray(jcache.kv.slot_pos))
    live = tcache.kv.slot_pos.numpy() >= 0
    diff = np.abs(tcache.kv.k.numpy().astype(np.float32)
                  - np.asarray(jcache.kv.k).astype(np.float32))[live]
    assert diff.max() <= (1 if kv_int8 else ATOL)


@pytest.mark.parametrize("arch", [MIXTRAL, LLAMA4])
def test_prefill_equals_decode_without_drops(models, arch):
    """At capacity factor 16 no token drops, so a token's MoE output does
    not depend on its batch: decode(prefill(tokens[:T]), tokens[T]) gives
    the last-position logits of prefill(tokens[:T+1]) within 1e-4
    (float32; mixtral's prompt of 24 wraps its 16-slot ring)."""
    _, _, tcfg, tparams = _pair(models, arch, moe_capacity_factor=16.0)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 512, (2, 25)))
    cache, _ = ttf.prefill(tparams, tcfg, {"tokens": toks[:, :-1]})
    _, dec = ttf.decode_step(tparams, tcfg, cache, toks[:, -1:])
    _, full = ttf.prefill(tparams, tcfg, {"tokens": toks})
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("engine", ["static", "continuous"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax(models, arch, engine):
    """Three greedy requests of 5-10 tokens through two slots under
    ``w4a8;wo=w8a8``: the static engine (a second batch of one) and the
    continuous scheduler (the third admitted mid-decode: solo into the
    ring or the paged pool for the MoE archs, chunked for nemotron) emit
    JAX's tokens."""
    jcfg, raw, tcfg = models[arch]
    traw = convert.params_from_numpy(to_numpy_tree(raw), "cpu")
    reqs = lambda R: [R(i, p, max_new_tokens=6) for i, p in enumerate(PROMPTS)]  # noqa: E731
    if engine == "static":
        want = JaxEngine(jcfg, raw, max_batch=2, quant=jax_policy(POLICY),
                         bucket=16).generate_static(reqs(JaxRequest))
        got = ServingEngine(tcfg, traw, max_batch=2, quant=parse_policy_spec(POLICY),
                            bucket=16, device="cpu").generate_static(reqs(Request))
    else:
        kw = dict(max_batch=2, max_ctx=48, block_size=4, prefill_budget=8, bucket=16)
        if arch != MIXTRAL:
            kw.update(preempt=False)
        want = JaxScheduler(jcfg, raw, quant=jax_policy(POLICY), prefix_cache=False,
                            **kw).run(reqs(JaxRequest))
        sched = ContinuousScheduler(tcfg, traw, quant=parse_policy_spec(POLICY),
                                    prefix_cache=False, device="cpu", **kw)
        assert (sched.paged, sched.chunked_prefill) == {
            MIXTRAL: (False, False), LLAMA4: (True, False), NEMOTRON: (True, True)}[arch]
        got = sched.run(reqs(Request))
    want = {r.rid: r.out_tokens for r in want}
    assert {r.rid: r.out_tokens for r in got} == want
    assert all(len(t) == 6 for t in want.values())


@pytest.mark.parametrize("arch,policy", [(MIXTRAL, POLICY), (MIXTRAL, MIXED),
                                         (LLAMA4, POLICY), (NEMOTRON, POLICY)])
def test_packed_leaf_set_is_jaxs(models, arch, policy):
    """The port packs JAX's raw weights into JAX's leaves, bytes and
    scales; the router and the stacked (L, E, d, f) experts stay float, as
    JAX packs 2-D and (L, K, N) leaves only."""
    _, raw, _ = models[arch]
    jp = jax_pack(raw, jax_policy(policy), min_size=1024)
    tp = quantize_params_for_serving(convert.params_from_numpy(to_numpy_tree(raw), "cpu"),
                                     parse_policy_spec(policy), min_size=1024)
    jl, tl = dict(leaves(jp)), dict(leaves(tp))
    assert sorted(jl) == sorted(tl)
    packed = set()
    for p, leaf in tl.items():
        if isinstance(leaf, torch.Tensor):
            assert np.array_equal(leaf.numpy(), np.asarray(jl[p])), p
        else:
            assert_packed_equal(jl[p], leaf, p)
            packed.add(p.split("/")[-1])
    want = {"wq", "wk", "wv", "wo"} | ({"w_up", "w_down"} if arch == NEMOTRON else set())
    assert packed == want


def test_model_surface_is_gated_as_jaxs(models):
    """The chunk, suffix and verify entries exist exactly where JAX's
    build_model offers them (nemotron-4-340b, not the MoE or windowed
    archs), and a windowed arch's paged cache raises JAX's words."""
    entries = ("prefill_chunk", "prefill_suffix", "prefill_chunk_logits",
               "prefill_chunk_logits_multi", "init_paged_cache")
    for arch in ARCHS:
        jcfg, _, tcfg = models[arch]
        jm, tm = jax_build(jcfg), build_model(tcfg)
        for e in entries:
            assert hasattr(tm, e) == hasattr(jm, e), (arch, e)
        assert hasattr(tm, "prefill_chunk") == (arch == NEMOTRON)
    jcfg, _, tcfg = models[MIXTRAL]
    with pytest.raises(ValueError, match="paged KV cache requires full attention") as te:
        build_model(tcfg).init_paged_cache(2, 9, 4, 4, device="cpu")
    with pytest.raises(ValueError) as je:
        jax_build(jcfg).init_paged_cache(2, 9, 4, 4)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("arch,kw", [
    (MIXTRAL, dict(paged=True)), (LLAMA4, dict(chunked_prefill=True)),
    (LLAMA4, dict(prefix_cache=True)), (MIXTRAL, dict(speculate=2)),
    (LLAMA4, dict(speculate=2))],
    ids=["mixtral-paged", "llama4-chunked", "llama4-prefix", "mixtral-speculate",
         "llama4-speculate"])
def test_scheduler_refuses_what_jax_refuses(models, arch, kw):
    """The same ValueError text as JAX's scheduler for a paged pool under a
    window, chunked prefill, the prefix cache and speculation on an MoE
    arch."""
    jcfg, raw, tcfg = models[arch]
    with pytest.raises(ValueError) as je:
        JaxScheduler(jcfg, raw, quant=jax_policy(POLICY), max_batch=2, max_ctx=48, **kw)
    with pytest.raises(ValueError) as te:
        ContinuousScheduler(tcfg, convert.params_from_numpy(to_numpy_tree(raw), "cpu"),
                            quant=parse_policy_spec(POLICY), max_batch=2, max_ctx=48,
                            device="cpu", **kw)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("arch", [MIXTRAL, LLAMA4])
def test_serve_cli_serves_and_refuses_speculation(arch, capsys):
    """The serve CLI serves each MoE arch cut to one layer (--layers 1)
    continuously, and raises the scheduler's speculation error for it."""
    from repro_torch.launch import serve

    base = ["--arch", arch, "--reduced", "--layers", "1", "--device", "cpu",
            "--policy", POLICY, "--requests", "3", "--max-new", "4", "--max-batch", "2"]
    serve.main(base + ["--continuous"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "req 2: [" in out
    with pytest.raises(ValueError, match="speculative decoding requires the paged"):
        serve.main(base + ["--continuous", "--speculate", "2"])
