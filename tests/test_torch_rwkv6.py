"""The RWKV-6 family of the PyTorch port: the ``wkv6`` kernel's plain
versions and the rwkv6 model held against the JAX package, and the
port's own serving contracts for it (bucketed ≡ exact-length prefill,
mid-flight join ≡ solo, static ≡ continuous), the serve CLI and its
refusal of a precision policy.

Tolerances. ``ops.wkv6`` against JAX's Pallas kernel (interpret mode)
and the sequential scan: 3e-4, as the JAX package's own test holds its
kernel (the chunked and the sequential form round differently); 1e-3 for
decays of 1e-6. The port's chunked algebra against JAX's
``wkv6_chunked`` with a carried state: 1e-5 (the same algebra; float32
rounding of other summation orders). The model against JAX on a float32
copy of the reduced config, JAX weights carried across: logits within
1e-4 (the port fixes the chunk at ``rwkv_chunk`` where JAX shrinks it to
T, which changes only the rounding). Inside the port the contracts are
bitwise (logits and state) or identical tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import build_model as jax_build
from repro.models import rwkv6 as jrwkv
from repro_torch import convert
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core.precision import parse_policy_spec
from repro_torch.kernels import ops, ref
from repro_torch.models import build_model
from repro_torch.models import rwkv6 as trwkv
from repro_torch.serving import ContinuousScheduler, Request, ServingEngine
from torch_parity import to_numpy_tree

RNG = np.random.default_rng(13)
PROMPTS = [np.arange(10) * 7 % 512, (np.arange(7) * 13 + 3) % 512,
           (np.arange(23) * 5 + 1) % 512]


def _inputs(T, H, K, V, rng=RNG):
    r, k = (rng.standard_normal((T, H, K)).astype(np.float32) * 0.5 for _ in range(2))
    v = rng.standard_normal((T, H, V)).astype(np.float32) * 0.5
    w = rng.uniform(0.5, 0.999, (T, H, K)).astype(np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32) * 0.5
    return r, k, v, w, u


# -- the wkv6 kernel's plain versions ----------------------------------------

@pytest.mark.parametrize("T,H,K,V", [(64, 2, 16, 16), (96, 1, 8, 8), (33, 3, 32, 32)])
@pytest.mark.parametrize("chunk", [16, 32])
def test_wkv6_matches_jax_kernel_and_scan(T, H, K, V, chunk):
    """``ops.wkv6`` (zero state, the JAX signature) against JAX's Pallas
    kernel in interpret mode and the sequential scan, at the JAX test's
    shapes and chunks: within 3e-4."""
    a = _inputs(T, H, K, V)
    got = ops.wkv6(*(torch.from_numpy(x) for x in a), chunk=chunk).numpy()
    want_kernel = np.asarray(jops.wkv6(*(jnp.asarray(x) for x in a), chunk=chunk))
    want_scan = np.asarray(jref.wkv6_ref(*(jnp.asarray(x) for x in a)))
    np.testing.assert_allclose(got, want_kernel, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(got, want_scan, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(ref.wkv6_ref(*(torch.from_numpy(x) for x in a)).numpy(),
                               want_scan, rtol=3e-4, atol=3e-4)


def test_wkv6_extreme_decay_stability():
    """Decays of 1e-6 stay finite (every exponent is <= 0): within 1e-3 of
    the scan."""
    T, H, K = 64, 1, 8
    ones = np.ones((T, H, K), np.float32)
    a = (ones, ones, ones, np.full((T, H, K), 1e-6, np.float32),
         np.zeros((H, K), np.float32))
    got = ops.wkv6(*(torch.from_numpy(x) for x in a), chunk=16).numpy()
    assert np.all(np.isfinite(got))
    want = np.asarray(jref.wkv6_ref(*(jnp.asarray(x) for x in a)))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("T,chunk", [(64, 16), (40, 16), (64, 64)])
def test_wkv6_chunked_carries_state_like_jax(T, chunk):
    """The state-carrying entry the model calls against JAX's
    ``rwkv6.wkv6_chunked`` with a nonzero carried state: outputs and final
    state within 1e-5 (T = 40 is not a multiple of the chunk)."""
    B, H, K = 2, 2, 16
    r, k, v, w = (np.stack([x] * B) for x in _inputs(T, H, K, K)[:4])
    u = RNG.standard_normal((H, K)).astype(np.float32) * 0.5
    s0 = RNG.standard_normal((B, H, K, K)).astype(np.float32) * 0.3
    oj, sj = jrwkv.wkv6_chunked(*(jnp.asarray(x) for x in (r, k, v, w, u, s0)),
                                chunk=chunk)
    ot, st = ops.wkv6_chunked(*(torch.from_numpy(x) for x in (r, k, v, w, u, s0)),
                              chunk=chunk)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5, atol=1e-5)


def test_wkv6_step_is_one_chunked_token():
    """A decode step (``ops.wkv6_step``) equals the chunked entry at T = 1
    with the same carried state, and JAX's ``wkv6_step``: within 1e-6."""
    B, H, K = 3, 2, 16
    r, k, v, w = (np.stack([x[0]] * B) for x in _inputs(1, H, K, K)[:4])
    u = RNG.standard_normal((H, K)).astype(np.float32)
    s0 = RNG.standard_normal((B, H, K, K)).astype(np.float32)
    ot, st = ops.wkv6_step(*(torch.from_numpy(x) for x in (r, k, v, w, u, s0)))
    oc, sc = ops.wkv6_chunked(*(torch.from_numpy(x[:, None]) for x in (r, k, v, w)),
                              torch.from_numpy(u), torch.from_numpy(s0), chunk=64)
    oj, sj = jrwkv.wkv6_step(*(jnp.asarray(x) for x in (r, k, v, w, u, s0)))
    for o, s in ((oc[:, 0], sc), (torch.from_numpy(np.array(oj)),
                                  torch.from_numpy(np.array(sj)))):
        np.testing.assert_allclose(ot.numpy(), o.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(st.numpy(), s.numpy(), rtol=1e-6, atol=1e-6)


def test_cuda_tensors_never_fall_back():
    """A non-CPU tensor goes to the wkv6 kernel or raises; it never runs
    the plain version."""
    z = torch.zeros((1, 4, 2, 8), device="meta")
    u = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.wkv6_chunked(z, z, z, z, u, torch.zeros((1, 2, 8, 8), device="meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.wkv6_step(z[:, 0], z[:, 0], z[:, 0], z[:, 0], u,
                      torch.zeros((1, 2, 8, 8), device="meta"))


# -- the model against JAX ------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """(JAX cfg, JAX params, port cfg, the same params in the port), float32."""
    jcfg = dataclasses.replace(jax_reduced("rwkv6-3b"), dtype="float32")
    tcfg = dataclasses.replace(get_reduced_config("rwkv6-3b"), dtype="float32")
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, convert.params_from_numpy(to_numpy_tree(jparams), "cpu")


def _batch(prompts, L):
    toks = np.zeros((len(prompts), L), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    return toks, np.asarray([len(p) for p in prompts], np.int32)


def test_prefill_and_decode_match_jax(pair):
    """Right-padded prefill of three prompts and three decode steps:
    logits within 1e-4 of JAX's ``prefill`` / ``decode_step``, the carried
    wkv state and token-shift tails too."""
    jcfg, jparams, tcfg, tparams = pair
    toks, lens = _batch(PROMPTS, 32)
    jcache, lj = jax.jit(jrwkv.prefill, static_argnums=(1,))(
        jparams, jcfg, {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lens)})
    tcache, lt = trwkv.prefill(tparams, tcfg, {
        "tokens": torch.from_numpy(toks.astype(np.int64)), "lengths": torch.from_numpy(lens)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=0)
    for name in ("wkv", "tm_shift", "cm_shift"):
        np.testing.assert_allclose(getattr(tcache.rwkv, name).numpy(),
                                   np.asarray(getattr(jcache.rwkv, name)),
                                   atol=1e-4, rtol=0, err_msg=name)
    assert tcache.pos.tolist() == lens.tolist()
    jdecode = jax.jit(jrwkv.decode_step, static_argnums=(1,))
    cur = np.asarray(lj)[:, -1].argmax(-1)[:, None].astype(np.int32)
    for _ in range(3):
        jcache, lj = jdecode(jparams, jcfg, jcache, jnp.asarray(cur))
        tcache, lt = trwkv.decode_step(tparams, tcfg, tcache, torch.from_numpy(cur))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=0)
        cur = np.asarray(lj)[:, -1].argmax(-1)[:, None].astype(np.int32)
    assert tcache.pos.tolist() == (lens + 3).tolist()


# -- the port's own contracts ---------------------------------------------------

@pytest.fixture(scope="module")
def rwkv():
    cfg = get_reduced_config("rwkv6-3b")
    return cfg, build_model(cfg).init(seed=0, device="cpu")


@pytest.mark.parametrize("bucket", [32, 64, 128])
def test_bucketed_prefill_is_exact_length_prefill(rwkv, bucket):
    """A prompt right-padded to any bucket (across chunk boundaries)
    prefills bitwise as at its own length: logits, wkv state and both
    token-shift tails."""
    cfg, params = rwkv
    model = build_model(cfg)
    p = PROMPTS[2]
    exact = model.prefill(params, {"tokens": torch.from_numpy(p[None].astype(np.int64))})
    toks = np.zeros((1, bucket), np.int64)
    toks[0, :len(p)] = p
    padded = model.prefill(params, {"tokens": torch.from_numpy(toks),
                                    "lengths": torch.tensor([len(p)], dtype=torch.int32)})
    assert torch.equal(exact[1], padded[1])
    for name in ("wkv", "tm_shift", "cm_shift"):
        assert torch.equal(getattr(exact[0].rwkv, name), getattr(padded[0].rwkv, name)), name
    assert padded[0].pos.tolist() == [len(p)]


def test_midflight_join_matches_solo(rwkv):
    """A request admitted while another row decodes (its row of the
    recurrent state overwritten by the solo prefill's scatter) emits the
    tokens it emits alone, greedy and sampled."""
    cfg, params = rwkv
    kw = dict(max_batch=2, max_ctx=32, bucket=16, device="cpu")
    for temp in (0.0, 0.8):
        alone = ContinuousScheduler(cfg, params, **kw).run(
            [Request(1, PROMPTS[1], max_new_tokens=6, temperature=temp)])[0].out_tokens
        sched = ContinuousScheduler(cfg, params, **kw)
        assert not sched.paged and not sched.chunked_prefill
        sched.submit(Request(0, PROMPTS[0], max_new_tokens=9))
        for _ in range(3):
            sched.step()
        joined = Request(1, PROMPTS[1], max_new_tokens=6, temperature=temp)
        sched.submit(joined)
        while sched.num_active or sched.num_waiting:
            sched.step()
        assert joined.out_tokens == alone


def test_static_matches_continuous(rwkv):
    """Static batches and continuous batching with whole-prompt admission
    emit the same tokens, greedy and sampled; a long prompt is never
    refused for context (the state is constant-size)."""
    cfg, params = rwkv
    reqs = lambda: [Request(0, PROMPTS[0], max_new_tokens=9),
                    Request(1, PROMPTS[1], max_new_tokens=6, temperature=0.8, top_k=40),
                    Request(2, PROMPTS[2], max_new_tokens=7)]
    eng = ServingEngine(cfg, params, max_batch=2, bucket=16, device="cpu")
    static = {r.rid: r.out_tokens for r in eng.generate_static(reqs())}
    cont = {r.rid: r.out_tokens for r in eng.generate(reqs())}
    assert cont == static
    stats = eng.pool_stats()
    assert stats["paged"] is False and stats["chunked_prefill"] is False
    long = eng.scheduler().run([Request(9, np.arange(200) % 512, max_new_tokens=3)])[0]
    assert not long.failed and len(long.out_tokens) == 3


@pytest.mark.parametrize("kw,match", [
    (dict(paged=True), "paged KV cache requires"),
    (dict(chunked_prefill=True), "chunked prefill requires"),
    (dict(quant=parse_policy_spec("w4a8")), "serves rwkv6 unquantized"),
])
def test_scheduler_refuses_paging_chunking_and_policies(rwkv, kw, match):
    cfg, params = rwkv
    with pytest.raises(ValueError, match=match):
        ContinuousScheduler(cfg, params, device="cpu", **kw)
    if "quant" in kw:
        with pytest.raises(ValueError, match=match):
            ServingEngine(cfg, params, device="cpu", **kw)


@pytest.mark.parametrize("flags,report", [
    (["--static"], "[static]"),
    (["--continuous", "--kv-int8"], "recurrent state:"),
])
def test_serve_cli(capsys, flags, report):
    from repro_torch.launch import serve

    serve.main(["--arch", "rwkv6-3b", "--reduced", "--device", "cpu", "--requests", "3",
                "--max-new", "4", "--max-batch", "2", *flags])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and report in out and "req 2: [" in out


@pytest.mark.parametrize("flag", ["--policy", "--quant"])
def test_serve_cli_refuses_a_policy(flag):
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match="serves rwkv6 unquantized"):
        serve.main(["--arch", "rwkv6-3b", "--reduced", "--device", "cpu", flag, "w4a8"])


def test_full_config_is_jax_s():
    """The registered rwkv6-3b is the JAX package's config, field by field."""
    from repro.configs import get_config as jax_config

    cfg, jcfg = get_config("rwkv6-3b"), jax_config("rwkv6-3b")
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert (cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab) == (32, 2560, 8960, 65536)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_dense_matmul_cpu_is_the_plain_product(dtype, lead):
    """On the CPU ops.dense_matmul is bitwise ``x @ w.to(x.dtype)``, the
    product rwkv6 ran before the kernel, so every CPU parity test keeps
    its bits."""
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal((*lead, 64)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((64, 40)).astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(ops.dense_matmul(x, w), x @ w.to(dtype))


def test_dense_matmul_never_falls_back():
    x = torch.zeros((2, 8), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.dense_matmul(x, torch.zeros((8, 8), dtype=torch.bfloat16))
