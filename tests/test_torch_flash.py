"""Whole-sequence attention of the PyTorch port held against the JAX
package: ``ops.flash_attention`` (on the CPU, the plain version of the
CUDA kernel ``flash_attention``) against JAX's ``ops.flash_attention``
(its Pallas kernel in interpret mode, and its reference backend), and the
model stack's ``chunked_attention`` against JAX's.

Both sides compute softmax attention in float32 with another summation
order (one pass here, an online softmax in JAX's kernel and its chunked
attention), so outputs agree at float32 rounding: atol = rtol = 2e-5
against the kernel, as ``tests/test_kernels.py`` holds JAX's kernel
against its reference, and 3e-5 against ``chunked_attention``, as that
file holds the two JAX implementations against each other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import common as jcm
from repro_torch.kernels import ops, ref
from repro_torch.models import common as cm
from torch_parity import np_of

RNG = np.random.default_rng(13)

# (B, T, S, NQ, NKV, H, causal, window, q_offset)
CASES = [
    (2, 37, 37, 4, 2, 16, True, 0, 0),       # odd T, GQA
    (1, 33, 49, 4, 4, 16, True, 0, 16),      # q_offset: a tail over a prefix
    (2, 40, 40, 6, 2, 16, True, 8, 0),       # sliding window
    (1, 20, 36, 2, 1, 32, True, 12, 16),     # window + q_offset, MQA
    (2, 24, 24, 4, 2, 16, False, 0, 0),      # bidirectional
    (1, 1, 96, 4, 2, 16, True, 0, 95),       # one query over a long context
]


def _qkv(B, T, S, NQ, NKV, H):
    return (RNG.standard_normal((B, T, NQ, H)).astype(np.float32),
            RNG.standard_normal((B, S, NKV, H)).astype(np.float32),
            RNG.standard_normal((B, S, NKV, H)).astype(np.float32))


@pytest.mark.parametrize("case", CASES)
def test_flash_attention_matches_jax(case):
    B, T, S, NQ, NKV, H, causal, window, off = case
    q, k, v = _qkv(B, T, S, NQ, NKV, H)
    kw = dict(causal=causal, window=window, q_offset=off)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw)
    assert got.shape == (B, T, NQ, H) and got.dtype == torch.float32
    for backend in ("interpret", "reference"):
        want = np.asarray(jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                               jnp.asarray(v), bq=32, bk=32,
                                               backend=backend, **kw))
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5,
                                   err_msg=backend)


@pytest.mark.parametrize("case", CASES[:4])
def test_chunked_attention_matches_jax(case):
    B, T, S, NQ, NKV, H, causal, window, off = case
    q, k, v = _qkv(B, T, S, NQ, NKV, H)
    want = np.asarray(jcm.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jcm.AttnMask(causal=causal, window=window), q_offset=off,
        q_chunk=16, kv_chunk=16))
    got = cm.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v),
                               cm.AttnMask(causal=causal, window=window), q_offset=off)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)


def test_rows_do_not_depend_on_the_padded_length():
    """A prompt bucketed up to any length attends bitwise as at its own
    length: causal rows never see the trailing keys, and the plain version
    pads to a fixed granularity, as the kernel fixes its tiles."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 100, 100, 4, 2, 16))
    full = ops.flash_attention(q, k, v)
    for n in (1, 37, 64, 65):
        cut = ops.flash_attention(q[:, :n], k[:, :n], v[:, :n])
        assert torch.equal(full[:, :n], cut), n


def test_bf16_queries_over_float32_keys():
    """An int8 cache's prefill attends dequantized float32 K/V under
    bfloat16 queries: K/V are read in float32, never rounded to bf16, and
    the output takes q's dtype."""
    q, k, v = _qkv(1, 12, 12, 4, 2, 16)
    qb = torch.from_numpy(q).to(torch.bfloat16)
    got = ops.flash_attention(qb, torch.from_numpy(k), torch.from_numpy(v))
    assert got.dtype == torch.bfloat16
    want = ops.flash_attention(qb.to(torch.float32), torch.from_numpy(k),
                               torch.from_numpy(v))
    assert torch.equal(got, want.to(torch.bfloat16))
    rounded = ops.flash_attention(qb, torch.from_numpy(k).to(torch.bfloat16),
                                  torch.from_numpy(v).to(torch.bfloat16))
    assert not torch.equal(got, rounded)


def test_masked_out_query_outputs_zeros():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 8, 2, 2, 16))
    out = ops.flash_attention(q, k[:, :2], v[:, :2], causal=True, window=1,
                              q_offset=4)
    assert torch.all(out == 0)
    assert np.all(np.isfinite(np_of(out)))


@pytest.mark.parametrize("kw", [dict(kpos=torch.arange(8)), dict(softcap=30.0)])
def test_unported_attention_options_raise(kw):
    """Explicit key positions (the port's prefix cache gathers exactly the
    resident positions instead) and a logit softcap are not ported: they
    raise on every device alike."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 2, 2, 16))
    mask = kw.pop("mask", cm.AttnMask())
    with pytest.raises(ValueError, match="not ported"):
        cm.chunked_attention(q, k, v, mask, **kw)


# Prefix-LM (paligemma) and bidirectional (hubert) masks:
# (B, T, S, NQ, NKV, H, causal, prefix_len, window, q_offset)
MASK_CASES = [
    (2, 37, 37, 4, 2, 16, True, 0, 0, 0),     # no prefix
    (2, 37, 37, 4, 2, 16, True, 3, 0, 0),     # a short prefix
    (2, 37, 37, 4, 1, 16, True, 8, 0, 0),     # the reduced VLM's 8 patches, MQA
    (2, 37, 37, 4, 2, 16, True, 37, 0, 0),    # the prefix is the whole sequence
    (1, 36, 36, 4, 2, 16, True, 37, 0, 0),    # one longer than the sequence
    (1, 21, 37, 4, 2, 16, True, 8, 0, 16),    # a tail at q_offset 16, prefix before it
    (1, 21, 37, 4, 2, 16, True, 30, 0, 16),   # the prefix reaches into the tail
    (2, 40, 40, 4, 2, 16, True, 12, 8, 0),    # prefix-LM with a window
    (1, 24, 40, 2, 1, 16, True, 20, 6, 16),   # window + q_offset, MQA
    (2, 24, 24, 4, 4, 16, False, 0, 0, 0),    # bidirectional, MHA
    (2, 24, 24, 4, 2, 16, False, 0, 0, 0),    # bidirectional, GQA
    (1, 20, 36, 4, 2, 16, False, 0, 0, 16),   # bidirectional at q_offset 16
]


@pytest.mark.parametrize("case", MASK_CASES)
def test_masks_match_jax_chunked_attention(case):
    """The plain version against JAX's ``chunked_attention`` (XLA code: its
    Pallas kernel has no prefix-LM mask) on every mask the VLM and the
    encoder build, float32 within 1e-5, and ``chunked_attention`` passes
    ``prefix_len`` through."""
    B, T, S, NQ, NKV, H, causal, P, window, off = case
    q, k, v = _qkv(B, T, S, NQ, NKV, H)
    want = np.asarray(jcm.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jcm.AttnMask(causal=causal, window=window, prefix_len=P), q_offset=off,
        q_chunk=16, kv_chunk=16))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    got = cm.chunked_attention(qt, kt, vt, cm.AttnMask(causal=causal, window=window,
                                                       prefix_len=P), q_offset=off)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    direct = ops.flash_attention(qt, kt, vt, causal=causal, window=window, q_offset=off,
                                 prefix_len=P)
    assert torch.equal(got, direct)


@pytest.mark.parametrize("case", MASK_CASES)
def test_plain_flash_backward_matches_jax_vjp(case):
    """The parity chain of training's attention gradient: the plain version
    the card's ``flash_attention_bwd`` is held to
    (``ref.flash_attention_bwd_ref``, autograd through the plain forward)
    against ``jax.vjp`` of JAX's ``chunked_attention``, float32, dQ, dK and
    dV each within 1e-5 of its max |g| (float32 sums in another order).
    Every row of these cases sees a key: JAX masks with finfo.min, so a
    row that sees none would average every key there, where the port
    gives it zero gradients."""
    B, T, S, NQ, NKV, H, causal, P, window, off = case
    q, k, v = _qkv(B, T, S, NQ, NKV, H)
    do = RNG.standard_normal((B, T, NQ, H)).astype(np.float32)
    pos, key = off + np.arange(T)[:, None], np.arange(S)[None, :]
    seen = (key > pos - window) if window else np.ones((T, S), bool)
    if causal:
        seen &= (key <= pos) | (key < P)
    assert seen.any(axis=1).all()
    mask = jcm.AttnMask(causal=causal, window=window, prefix_len=P)
    _, vjp = jax.vjp(lambda a, b, c: jcm.chunked_attention(a, b, c, mask, q_offset=off,
                                                           q_chunk=16, kv_chunk=16),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = ref.flash_attention_bwd_ref(*(torch.from_numpy(a) for a in (q, k, v, do)),
                                      causal=causal, window=window, q_offset=off,
                                      prefix_len=P)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("prefix_len", [0, 8, 40, 64])
def test_prefix_lm_rows_do_not_depend_on_the_padded_length(prefix_len):
    """Under prefix-LM a prompt cut to n >= prefix_len positions attends
    bitwise as in its longer batch (no kept row sees a key past n), with
    the cut in another padding tile than the whole (64 vs 128 keys)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 100, 100, 4, 1, 16))
    full = ops.flash_attention(q, k, v, prefix_len=prefix_len)
    for n in (40, 64, 65):
        if n < prefix_len:
            continue
        cut = ops.flash_attention(q[:, :n], k[:, :n], v[:, :n], prefix_len=prefix_len)
        assert torch.equal(full[:, :n], cut), n


def test_bidirectional_rows_do_not_depend_on_the_query_count():
    """Bidirectional rows see every key, so only the queries may be cut: a
    row's result is bitwise the same among 1, 37, 64 or 100 queries."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 100, 100, 4, 4, 16))
    full = ops.flash_attention(q, k, v, causal=False)
    for n in (1, 37, 64, 65):
        assert torch.equal(full[:, :n], ops.flash_attention(q[:, :n], k, v, causal=False)), n


def test_non_cpu_tensors_never_fall_back():
    q = torch.zeros((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.flash_attention(q, q, q)
