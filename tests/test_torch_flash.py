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
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import common as jcm
from repro_torch.kernels import ops
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


@pytest.mark.parametrize("kw", [dict(kpos=torch.arange(8)), dict(softcap=30.0),
                                dict(mask=cm.AttnMask(prefix_len=3))])
def test_unported_attention_options_raise(kw):
    """Explicit key positions (prefix cache), prefix-LM masks and a logit
    softcap are later slices' work: they raise on every device alike."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 2, 2, 16))
    mask = kw.pop("mask", cm.AttnMask())
    with pytest.raises(ValueError, match="not ported"):
        cm.chunked_attention(q, k, v, mask, **kw)


def test_non_cpu_tensors_never_fall_back():
    q = torch.zeros((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.flash_attention(q, q, q)
