"""paligemma-3b (VLM: patch stub, prefix-LM attention) and hubert-xlarge
(encoder: frame stub, bidirectional attention) in the port, held against
the JAX package on float32 copies of their reduced configs.

Weights are JAX's (``init`` from PRNGKey 0), carried across with
``repro_torch.convert``, raw or packed by JAX under ``w4a8;wo=w8a8`` at
``min_size=1024``; inputs are drawn with numpy. Held: the configs and the
init tree (``patch_proj`` / ``frame_proj`` with JAX's shapes, hubert's
unused ``embed`` leaf) are JAX's and stay unpacked; the port packs JAX's
bytes; ``forward_hidden`` → ``compute_logits`` within 1e-4 of JAX for
both archs; paligemma's right-padded ``prefill`` and three greedy
``decode_step``s within 1e-4, its greedy tokens equal, and within
``test_torch_dense_families.py``'s atol 1e-3 on packed weights (the
activation codes and integer products of the packed linear bitwise);
the prefix-LM and bidirectional visibility on the port's own rows; the
model API gates and the serve CLI's refusals.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced_config as jax_reduced
from repro.core.precision import parse_policy_spec as jax_policy
from repro.core.quantized_linear import quantize_params_for_serving as jax_pack
from repro.kernels import ops as jops
from repro.models import build_model as jax_build
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core.precision import parse_policy_spec
from repro_torch.core.quantized_linear import PackedWeight, quantize_params_for_serving
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import transformer as ttf
from torch_parity import assert_packed_equal, leaves, to_numpy_tree

ATOL = 1e-4          # float32 end to end, sums in other orders
PACKED_ATOL = 1e-3   # test_torch_dense_families.py's packed tolerance
POLICY = "w4a8;wo=w8a8"
VLM, ENC = "paligemma-3b", "hubert-xlarge"
ARCHS = [VLM, ENC]
TEXT_LENS = (10, 6)   # paligemma's two rows of text, right-padded to 12
FRAMES_T = 20


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


def _port(jparams):
    return convert.params_from_numpy(to_numpy_tree(jparams), "cpu")


def _vlm_batch(cfg, seed=0, lens=TEXT_LENS, L=12):
    """numpy (patches (B, P, frontend_dim), tokens (B, L) right-padded,
    lengths (B,) counting the patches)."""
    rng = np.random.default_rng(seed)
    B, P = len(lens), cfg.num_prefix_embeds
    patches = rng.standard_normal((B, P, cfg.frontend_dim)).astype(np.float32)
    toks = np.zeros((B, L), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab, n)
    return patches, toks, np.asarray([P + n for n in lens], np.int32)


def _frames(cfg, seed=1, B=2, T=FRAMES_T):
    return np.random.default_rng(seed).standard_normal(
        (B, T, cfg.frontend_dim)).astype(np.float32)


def _jbatch(patches=None, toks=None, frames=None, lengths=None):
    b = {}
    if patches is not None:
        b["patches"], b["tokens"] = jnp.asarray(patches), jnp.asarray(toks)
    if frames is not None:
        b["frames"] = jnp.asarray(frames)
    if lengths is not None:
        b["lengths"] = jnp.asarray(lengths)
    return b


def _tbatch(patches=None, toks=None, frames=None, lengths=None):
    b = {}
    if patches is not None:
        b["patches"] = torch.from_numpy(patches)
        b["tokens"] = torch.from_numpy(toks.astype(np.int64))
    if frames is not None:
        b["frames"] = torch.from_numpy(frames)
    if lengths is not None:
        b["lengths"] = torch.from_numpy(lengths)
    return b


# -- configs, init tree, packing ---------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_jax_configs(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_config(arch))
    assert dataclasses.asdict(get_reduced_config(arch)) == dataclasses.asdict(jax_reduced(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_has_jax_layout(arch, models):
    """Keys, shapes and dtypes of the port's init are JAX's: the frontend
    projection (frontend_dim, d_model), hubert's untied head and its
    (unused) embedding; the carried tree keeps those leaves unchanged."""
    _, raw, _, tcfg = models[arch]
    mine = build_model(tcfg).init(seed=0, device="cpu")
    jl = {p: np.asarray(a) for p, a in leaves(raw)}
    tl = dict(leaves(mine))
    assert sorted(tl) == sorted(jl)
    for p, a in tl.items():
        assert tuple(a.shape) == jl[p].shape and str(a.dtype)[6:] == jl[p].dtype.name, p
    proj = "patch_proj" if arch == VLM else "frame_proj"
    assert tl[proj].shape == (tcfg.frontend_dim, tcfg.d_model)
    assert ("head" in tl) == (arch == ENC)
    carried = dict(leaves(_port(raw)))
    for p in (proj, "embed") + (("head",) if arch == ENC else ()):
        assert np.array_equal(carried[p].numpy(), jl[p]), p


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_bytes_bitwise_and_frontends_unpacked(arch, models):
    """The port packs JAX's raw weights into JAX's bytes and scales; the
    frontend projection, the embedding and the head stay float, in both
    packages (``_NO_PACK``)."""
    _, raw, jp, _ = models[arch]
    tp = quantize_params_for_serving(_port(raw), parse_policy_spec(POLICY), min_size=1024)
    jl, tl = dict(leaves(jp)), dict(leaves(tp))
    assert sorted(jl) == sorted(tl)
    n = 0
    for p, leaf in tl.items():
        if isinstance(leaf, torch.Tensor):
            assert np.array_equal(leaf.numpy(), np.asarray(jl[p])), p
        else:
            assert_packed_equal(jl[p], leaf, p)
            n += 1
    assert n > 0
    proj = "patch_proj" if arch == VLM else "frame_proj"
    assert isinstance(tl[proj], torch.Tensor) and not isinstance(tl[proj], PackedWeight)
    assert isinstance(tl["embed"], torch.Tensor)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_api_withholds_chunk_suffix_and_verify(arch, models):
    """A frontend arch gets no chunk, suffix or verify entry, as in JAX."""
    jm, tm = jax_build(models[arch][0]), build_model(models[arch][3])
    for name in ("prefill_chunk", "prefill_suffix", "prefill_chunk_logits",
                 "prefill_chunk_logits_multi"):
        assert not hasattr(tm, name) and not hasattr(jm, name), name
    for name in ("init", "prefill", "decode_step", "init_cache", "init_paged_cache"):
        assert hasattr(tm, name), name


def test_dense_archs_keep_their_gates_and_scale():
    """The dense archs keep every serving entry and unscaled embeddings;
    the VLM alone scales its token embeddings by sqrt(d_model), as JAX."""
    olmo = build_model(get_reduced_config("olmo-1b"))
    assert hasattr(olmo, "prefill_chunk") and hasattr(olmo, "prefill_suffix")
    assert [ttf._embed_scale(get_config(a)) for a in ("olmo-1b", "nemotron-4-15b", VLM, ENC)] \
        == [jtf._embed_scale(jax_config(a)) for a in ("olmo-1b", "nemotron-4-15b", VLM, ENC)] \
        == [False, False, True, False]
    for a in ("olmo-1b", VLM, ENC):
        assert ttf._mask_for(get_config(a)).__dict__ == jtf._mask_for(jax_config(a)).__dict__


# -- paligemma-3b against JAX --------------------------------------------------


@pytest.mark.parametrize("packed", [False, True], ids=["f32", "w4a8"])
def test_paligemma_forward_matches_jax(models, packed):
    """forward_hidden → compute_logits on (patches, tokens): hidden states
    and logits of every position within 1e-4 of JAX (1e-3 packed)."""
    jcfg, raw, jp, tcfg = models[VLM]
    jparams = jp if packed else raw
    tparams = _port(jparams)
    patches, toks, _ = _vlm_batch(tcfg)
    jh, _ = jtf.forward_hidden(jparams, jcfg, _jbatch(patches, toks))
    jl = jtf.compute_logits(jparams, jcfg, jh)
    th = ttf.forward_hidden(tparams, tcfg, _tbatch(patches, toks))
    tl = ttf.compute_logits(tparams, tcfg, th)
    tol = PACKED_ATOL if packed else ATOL
    assert th.shape == (2, tcfg.num_prefix_embeds + toks.shape[1], tcfg.d_model)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=tol, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol, rtol=0)


@pytest.mark.parametrize("packed", [False, True], ids=["f32", "w4a8"])
def test_paligemma_prefill_and_decode_match_jax(models, packed):
    """Right-padded prefill with patches (lengths count the patches), then
    three greedy decode steps: logits within 1e-4 of JAX (1e-3 packed),
    the greedy tokens equal, the cache positions JAX's."""
    jcfg, raw, jp, tcfg = models[VLM]
    jparams = jp if packed else raw
    tparams = _port(jparams)
    patches, toks, lens = _vlm_batch(tcfg)
    tol = PACKED_ATOL if packed else ATOL
    jcache, lj = jax.jit(jtf.prefill, static_argnums=(1,))(
        jparams, jcfg, _jbatch(patches, toks, lengths=lens))
    tcache, lt = ttf.prefill(tparams, tcfg, _tbatch(patches, toks, lengths=lens))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=tol, rtol=0)
    jdecode = jax.jit(jtf.decode_step, static_argnums=(1,))
    jcur = tcur = np.asarray(lj)[:, -1].argmax(-1)[:, None].astype(np.int32)
    for _ in range(3):
        jcache, lj = jdecode(jparams, jcfg, jcache, jnp.asarray(jcur))
        tcache, lt = ttf.decode_step(tparams, tcfg, tcache, torch.from_numpy(tcur))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=tol, rtol=0)
        jcur = np.asarray(lj)[:, -1].argmax(-1)[:, None].astype(np.int32)
        tcur = lt[:, -1].argmax(-1)[:, None].numpy().astype(np.int32)
        assert np.array_equal(jcur, tcur)
    assert tcache.pos.tolist() == np.asarray(jcache.pos).tolist() == (lens + 3).tolist()


def test_paligemma_packed_linear_codes_bitwise(models):
    """On paligemma's own activations (JAX's embedded (patches, tokens)
    rows): the activation codes and scales, and the packed ``wq``'s
    dequantized product of layer 0, bitwise JAX's reference."""
    jcfg, _, jp, tcfg = models[VLM]
    patches, toks, _ = _vlm_batch(tcfg)
    x, _ = jtf.embed_inputs(jp, jcfg, _jbatch(patches, toks))
    x = np.array(x).reshape(-1, tcfg.d_model)
    jc, js = jops.quantize_rows(jnp.asarray(x), bits=8, backend="reference")
    tc, ts = ops.quantize_rows(torch.from_numpy(x), bits=8)
    assert np.array_equal(np.asarray(jc), tc.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    jw = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["wq"])
    tw = _port(jp)["blocks"]["wq"].layer(0)
    want = jops.packed_matmul(jnp.asarray(x), jw.packed, jw.scale, w_bits=jw.bits,
                              a_bits=jw.a_bits, backend="reference")
    got = ops.packed_matmul(torch.from_numpy(x), tw.packed, tw.scale, w_bits=tw.bits,
                            a_bits=tw.a_bits)
    assert np.array_equal(np.asarray(want), got.numpy())


def test_paligemma_mask_is_prefix_lm(models):
    """On the port's rows: changing the last patch moves the hidden state
    at position 0 (the prefix attends bidirectionally), and changing text
    token j leaves every position before j bitwise unchanged (causal
    text); text positions see every patch."""
    _, raw, _, tcfg = models[VLM]
    tparams, P = _port(raw), tcfg.num_prefix_embeds
    patches, toks, _ = _vlm_batch(tcfg)
    base = ttf.forward_hidden(tparams, tcfg, _tbatch(patches, toks))
    p2 = patches.copy()
    p2[:, P - 1] += 1.0
    moved = ttf.forward_hidden(tparams, tcfg, _tbatch(p2, toks))
    assert not torch.equal(moved[:, 0], base[:, 0])
    assert not torch.equal(moved[:, P:], base[:, P:])
    for j in (0, 3, 7):
        t2 = toks.copy()
        t2[:, j] = (t2[:, j] + 1) % tcfg.vocab
        h = ttf.forward_hidden(tparams, tcfg, _tbatch(patches, t2))
        assert torch.equal(h[:, :P + j], base[:, :P + j]), j
        assert not torch.equal(h[:, P + j], base[:, P + j]), j


# -- hubert-xlarge against JAX -------------------------------------------------


@pytest.mark.parametrize("packed", [False, True], ids=["f32", "w4a8"])
def test_hubert_forward_and_prefill_match_jax(models, packed):
    """forward_hidden → compute_logits on frames within 1e-4 of JAX (1e-3
    packed), and ``prefill``'s last-position logits."""
    jcfg, raw, jp, tcfg = models[ENC]
    jparams = jp if packed else raw
    tparams = _port(jparams)
    frames = _frames(tcfg)
    tol = PACKED_ATOL if packed else ATOL
    jh, _ = jtf.forward_hidden(jparams, jcfg, _jbatch(frames=frames))
    jl = jtf.compute_logits(jparams, jcfg, jh)
    th = ttf.forward_hidden(tparams, tcfg, _tbatch(frames=frames))
    tl = ttf.compute_logits(tparams, tcfg, th)
    assert tl.shape == (2, FRAMES_T, tcfg.vocab)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=tol, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol, rtol=0)
    _, lj = jtf.prefill(jparams, jcfg, _jbatch(frames=frames))
    _, lt = ttf.prefill(tparams, tcfg, _tbatch(frames=frames))
    assert lt.shape == (2, 1, tcfg.vocab)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=tol, rtol=0)


def test_hubert_attention_is_bidirectional(models):
    """Changing the last frame moves the first position's hidden state."""
    _, raw, _, tcfg = models[ENC]
    tparams = _port(raw)
    frames = _frames(tcfg)
    base = ttf.forward_hidden(tparams, tcfg, _tbatch(frames=frames))
    f2 = frames.copy()
    f2[:, -1] += 1.0
    moved = ttf.forward_hidden(tparams, tcfg, _tbatch(frames=f2))
    assert not torch.equal(moved[:, 0], base[:, 0])


# -- the serve CLI --------------------------------------------------------------


@pytest.mark.parametrize("arch,msg", [
    (ENC, "encoder-only arch has no decode step"),
    (VLM, "the serving stack passes no patches")])
def test_serve_refuses_frontend_archs(arch, msg, monkeypatch):
    """Both archs exit with their message before any weights are drawn."""
    def no_init(*a, **k):
        raise AssertionError("weights drawn")

    monkeypatch.setattr(ttf, "init_params", no_init)
    with pytest.raises(SystemExit, match=msg):
        serve.main(["--arch", arch, "--reduced", "--device", "cpu"])
