"""nemotron-4-15b (relu2, layernorm, untied head, GQA 2:1 reduced) and
stablelm-12b (swiglu, layernorm, per-head qk-norm) in the port, held
against the JAX package on float32 copies of their reduced configs.

Weights are JAX's (``init`` from PRNGKey 0), carried across with
``repro_torch.convert`` — raw, or packed by JAX under ``w4a8;wo=w8a8``.
Held: the port packs the same bytes from the same raw weights; the init
tree has JAX's layout (``q_norm``/``k_norm`` where qk-norm is on);
``rms_head_norm`` within 1e-6 of JAX's; whole-prompt prefill with
contiguous decode, a prefill chunk with paged decode on the float and
the int8 pool, and ``prefill_suffix`` within ``test_torch_model.py``'s
atol 1e-3, unpacked and packed; the greedy tokens of short prompts (a
longer one may flip a near-tied argmax: ROADMAP Queue 3, "Seen") through
the static engine and the continuous scheduler equal to JAX's; and the
serve CLI runs each arch on the CPU.
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
from repro.models import common as jcm
from repro.models import transformer as jtf
from repro.serving import ContinuousScheduler as JaxScheduler
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch import convert
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core.precision import parse_policy_spec
from repro_torch.core.quantized_linear import quantize_params_for_serving
from repro_torch.models import build_model
from repro_torch.models import common as tcm
from repro_torch.models import kv_cache as tkv
from repro_torch.models import transformer as ttf
from repro_torch.serving import ContinuousScheduler, Request, ServingEngine
from torch_parity import assert_packed_equal, leaves, to_numpy_tree

ATOL = 1e-3
POLICY = "w4a8;wo=w8a8"
MIXED = "w4a6r25;wo=w8a8"
ARCHS = ["nemotron-4-15b", "stablelm-12b"]
TABLE = [[1, 2, 3, -1], [4, 5, -1, -1]]
PROMPTS = [np.arange(10) * 7 % 512, (np.arange(5) * 13 + 3) % 512,
           (np.arange(7) * 5 + 1) % 512]

pytestmark = pytest.mark.parametrize("arch", ARCHS)


@pytest.fixture(scope="module")
def models():
    """Per arch: (JAX cfg, JAX raw params, JAX params packed under POLICY,
    port cfg), float32, built once for the module."""
    out = {}
    for arch in ARCHS:
        jcfg = dataclasses.replace(jax_reduced(arch), dtype="float32")
        tcfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
        raw = jax_build(jcfg).init(jax.random.PRNGKey(0))
        out[arch] = (jcfg, raw, jax_pack(raw, jax_policy(POLICY), min_size=1024), tcfg)
    return out


def _pair(models, arch, packed, kv_int8=False):
    """(JAX cfg, JAX params, port cfg, the same params in the port)."""
    jcfg, raw, jpacked, tcfg = models[arch]
    jparams = jpacked if packed else raw
    jcfg = dataclasses.replace(jcfg, kv_cache_quant=kv_int8)
    tcfg = dataclasses.replace(tcfg, kv_cache_quant=kv_int8)
    return jcfg, jparams, tcfg, convert.params_from_numpy(to_numpy_tree(jparams), "cpu")


def test_configs_are_jax_configs(arch):
    from repro.configs import get_config as jax_config

    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_config(arch))
    assert dataclasses.asdict(get_reduced_config(arch)) == dataclasses.asdict(jax_reduced(arch))


def test_init_tree_has_jax_layout(arch, models):
    """Keys, shapes and dtypes of the port's init are JAX's (q_norm/k_norm
    (L, head_dim) zeros with qk-norm, layernorm scale and bias, the
    untied head); the carried tree keeps every leaf unchanged."""
    jcfg, raw, _, tcfg = models[arch]
    mine = build_model(tcfg).init(seed=0, device="cpu")
    jl = {p: np.asarray(a) for p, a in leaves(raw)}
    tl = dict(leaves(mine))
    assert sorted(tl) == sorted(jl)
    for p, a in tl.items():
        assert tuple(a.shape) == jl[p].shape and str(a.dtype)[6:] == jl[p].dtype.name, p
    assert ("blocks/q_norm" in tl) == tcfg.qk_norm == ("blocks/k_norm" in tl)
    if tcfg.qk_norm:
        assert tl["blocks/q_norm"].shape == (tcfg.num_layers, tcfg.head_dim)
        assert not tl["blocks/q_norm"].any()
    carried = dict(leaves(convert.params_from_numpy(to_numpy_tree(raw), "cpu")))
    for p in ("head", "blocks/ln1/bias", "blocks/ln2/scale") + (
            ("blocks/q_norm", "blocks/k_norm") if tcfg.qk_norm else ()):
        assert np.array_equal(carried[p].numpy(), jl[p]), p


@pytest.mark.parametrize("policy", [POLICY, MIXED])
def test_packed_bytes_bitwise(arch, models, policy):
    """The port packs JAX's raw weights into JAX's bytes and scales (every
    packed leaf, Table III's two groups included); q_norm, k_norm, the
    norms and the head stay float."""
    _, raw, _, _ = models[arch]
    jp = jax_pack(raw, jax_policy(policy), min_size=1024)
    tp = quantize_params_for_serving(convert.params_from_numpy(to_numpy_tree(raw), "cpu"),
                                     parse_policy_spec(policy), min_size=1024)
    jl, tl = dict(leaves(jp)), dict(leaves(tp))
    assert sorted(jl) == sorted(tl)
    n = 0
    for p, leaf in tl.items():
        if isinstance(leaf, torch.Tensor):
            assert np.array_equal(leaf.numpy(), np.asarray(jl[p])), p
        else:
            assert_packed_equal(jl[p], leaf, p)
            n += 1
    assert n == (7 if arch == "stablelm-12b" else 6)


def test_rms_head_norm_matches_jax(arch, models):
    tcfg = models[arch][3]
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 5, tcfg.n_heads, tcfg.head_dim)) * 3).astype(np.float32)
    scale = (rng.standard_normal(tcfg.head_dim) * 0.1).astype(np.float32)
    want = np.asarray(jcm.rms_head_norm(jnp.asarray(x), jnp.asarray(scale)))
    got = tcm.rms_head_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # bf16 rows: float32 inside, one rounding out.
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gb = tcm.rms_head_norm(xb, torch.from_numpy(scale))
    assert gb.dtype == torch.bfloat16
    wb = jcm.rms_head_norm(jnp.asarray(xb.float().numpy(), jnp.bfloat16), jnp.asarray(scale))
    np.testing.assert_array_equal(gb.float().numpy(), np.asarray(wb.astype(jnp.float32)))


def _batch(prompts, L):
    toks = np.zeros((len(prompts), L), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    return toks, np.asarray([len(p) for p in prompts], np.int32)


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "w4a8"])
def test_prefill_and_contiguous_decode_match_jax(arch, models, packed):
    jcfg, jparams, tcfg, tparams = _pair(models, arch, packed)
    toks, lens = _batch(PROMPTS, 16)
    jcache, lj = jax.jit(jtf.prefill, static_argnums=(1,))(
        jparams, jcfg, {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lens)})
    tcache, lt = ttf.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks.astype(np.int64)),
                                             "lengths": torch.from_numpy(lens)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)
    live = tcache.kv.slot_pos.numpy() >= 0
    for t, j in ((tcache.kv.k, jcache.kv.k), (tcache.kv.v, jcache.kv.v)):
        assert np.abs(t.numpy() - np.asarray(j))[live].max() <= ATOL
    jdecode = jax.jit(jtf.decode_step, static_argnums=(1,))
    cur = np.asarray(lj)[:, -1].argmax(-1)[:, None].astype(np.int32)
    for _ in range(3):
        jcache, lj = jdecode(jparams, jcfg, jcache, jnp.asarray(cur))
        tcache, lt = ttf.decode_step(tparams, tcfg, tcache, torch.from_numpy(cur))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)
        cur = np.asarray(lj)[:, -1].argmax(-1)[:, None].astype(np.int32)
    assert tcache.pos.tolist() == np.asarray(jcache.pos).tolist() == (lens + 3).tolist()


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "w4a8"])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32-pool", "int8-pool"])
def test_prefill_chunks_and_paged_decode_match_jax(arch, models, packed, kv_int8):
    jcfg, jparams, tcfg, tparams = _pair(models, arch, packed, kv_int8)
    jcache = jtf.init_paged_cache(jcfg, batch=2, num_blocks=9, block_size=4, max_blocks=4)
    jcache = dataclasses.replace(jcache, kv=dataclasses.replace(
        jcache.kv, block_table=jnp.asarray(TABLE, jnp.int32)))
    tcache = ttf.init_paged_cache(tcfg, 2, 9, 4, 4, device="cpu")
    tcache.kv.block_table.copy_(torch.tensor(TABLE))
    jchunk = jax.jit(jtf.prefill_chunk, static_argnums=(1,))
    lc = 8
    for slot, prompt in enumerate(PROMPTS[:2]):
        blocks = np.asarray([b for b in TABLE[slot] if b >= 0], np.int32)
        for start in range(0, len(prompt), lc):
            t = min(lc, len(prompt) - start)
            toks = np.zeros((1, lc), np.int32)
            toks[0, :t] = prompt[start:start + t]
            jcache, lj = jchunk(jparams, jcfg, jcache, {
                "tokens": jnp.asarray(toks), "lengths": jnp.asarray([t], jnp.int32),
                "start": jnp.int32(start), "slot": jnp.int32(slot),
                "blocks": jnp.asarray(blocks)})
            tcache, lt = ttf.prefill_chunk(tparams, tcfg, tcache, {
                "tokens": torch.from_numpy(toks.astype(np.int64)), "lengths": [t],
                "start": start, "slot": slot, "blocks": torch.from_numpy(blocks)})
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)
    jdecode = jax.jit(jtf.decode_step, static_argnums=(1,))
    cur = np.asarray([[3], [5]], np.int32)
    for _ in range(3):
        jcache, lj = jdecode(jparams, jcfg, jcache, jnp.asarray(cur))
        tcache, lt = ttf.decode_step(tparams, tcfg, tcache, torch.from_numpy(cur))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)
        cur = np.asarray(lj)[:, -1].argmax(-1)[:, None].astype(np.int32)
    assert tcache.pos.tolist() == np.asarray(jcache.pos).tolist() == [13, 8]
    live = [b for row in TABLE for b in row if b >= 0]
    diff = np.abs(tcache.kv.k.numpy()[:, live].astype(np.float32)
                  - np.asarray(jcache.kv.k)[:, live].astype(np.float32))
    assert diff.max() <= (1 if kv_int8 else ATOL)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32-pool", "int8-pool"])
def test_prefill_suffix_matches_jax(arch, models, kv_int8):
    """A 13-token prompt prefilled cold into a pool of 4-token blocks, then
    its suffix from position 8 and its last token alone through
    ``prefill_suffix``: logits within atol of JAX's on the same pool, and
    bitwise the port's cold prefill."""
    jcfg, jparams, tcfg, tparams = _pair(models, arch, True, kv_int8)
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
        batch = {"tokens": torch.from_numpy(stoks), "lengths": [ls], "start": start,
                 "pool_k": kv.k, "pool_v": kv.v,
                 "prefix_blocks": torch.from_numpy(row[:-(-start // 4)])}
        jbatch = {"tokens": jnp.asarray(stoks, jnp.int32),
                  "lengths": jnp.asarray([ls], jnp.int32), "start": jnp.int32(start),
                  "pool_k": jnp.asarray(kv.k.numpy()), "pool_v": jnp.asarray(kv.v.numpy()),
                  "prefix_blocks": jnp.asarray(row)}
        if kv_int8:
            batch.update(pool_k_scale=kv.k_scale, pool_v_scale=kv.v_scale)
            jbatch.update(pool_k_scale=jnp.asarray(kv.k_scale.numpy()),
                          pool_v_scale=jnp.asarray(kv.v_scale.numpy()))
        _, logits = ttf.prefill_suffix(tparams, tcfg, batch)
        _, jlogits = jsuffix(jparams, jcfg, jbatch)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0)
        assert torch.equal(logits, cold_logits), f"start={start}"


@pytest.mark.parametrize("engine", ["static", "continuous"])
def test_greedy_tokens_match_jax(arch, models, engine):
    """Three greedy requests of 5-10 tokens through two slots under
    ``w4a8;wo=w8a8``: the static engine (a second batch of one) and the
    continuous scheduler (chunked prefill, the third admitted mid-decode)
    emit JAX's tokens."""
    jcfg, raw, _, tcfg = models[arch]
    traw = convert.params_from_numpy(to_numpy_tree(raw), "cpu")
    reqs = lambda R: [R(i, p, max_new_tokens=6) for i, p in enumerate(PROMPTS)]
    if engine == "static":
        want = JaxEngine(jcfg, raw, max_batch=2, quant=jax_policy(POLICY),
                         bucket=16).generate_static(reqs(JaxRequest))
        got = ServingEngine(tcfg, traw, max_batch=2, quant=parse_policy_spec(POLICY),
                            bucket=16, device="cpu").generate_static(reqs(Request))
    else:
        kw = dict(max_batch=2, max_ctx=48, block_size=4, prefill_budget=8, preempt=False)
        want = JaxScheduler(jcfg, raw, quant=jax_policy(POLICY), bucket=16, paged=True,
                            prefix_cache=False, chunked_prefill=True,
                            **kw).run(reqs(JaxRequest))
        got = ContinuousScheduler(tcfg, traw, quant=parse_policy_spec(POLICY),
                                  device="cpu", **kw).run(reqs(Request))
    want = {r.rid: r.out_tokens for r in want}
    assert {r.rid: r.out_tokens for r in got} == want
    assert all(len(t) == 6 for t in want.values())


def test_serve_cli_runs_on_cpu(arch, capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", arch, "--reduced", "--continuous", "--device", "cpu",
                "--policy", POLICY, "--requests", "3", "--max-new", "4",
                "--max-batch", "2", "--block-size", "4", "--prefill-budget", "4"]
               + (["--kv-int8"] if arch == "stablelm-12b" else []))
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "chunked prefill:" in out
    assert "req 2: [" in out
