"""The Table III mixed-group matmul of the PyTorch port held against the
JAX package: the row quantizer and the unfused integer matmul (plain
versions of the CUDA kernels ``quantize_rows`` and ``bitplane_matmul``)
against JAX's Pallas kernels in interpret mode and its reference backend,
``mixed_group_matmul`` against JAX's, and a Table III ``PackedWeight``
through ``_serve_matmul``.

Integers are compared bitwise: codes (unsigned 8-bit codes stored
wrapped), per-row scales and int32 accumulators. The mixed-group output is
``acc · xs · ws`` per element on both sides from the same integers, held
at rtol = atol = 1e-5 as ``tests/test_kernels.py`` holds JAX's kernel
against its reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplane as jbp
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import quantized_linear as tql
from repro_torch.core.bitplane import pack_weights
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import ops
from torch_parity import to_numpy_tree  # noqa: F401  (sets the thread count)

RNG = np.random.default_rng(12)


def _rows(m, k):
    """Rows at several magnitudes, one of them all zero."""
    x = (RNG.standard_normal((m, k)) * RNG.uniform(0.01, 20, (m, 1))).astype(np.float32)
    x[1] = 0
    return x


@pytest.mark.parametrize("bits", range(2, 9))
@pytest.mark.parametrize("signed", [True, False])
def test_quantize_rows_bitwise(bits, signed):
    x = _rows(37, 129)
    if not signed:
        x = np.abs(x)
    got_q, got_s = ops.quantize_rows(torch.from_numpy(x), bits=bits, signed=signed)
    assert got_q.dtype == torch.int8 and got_s.shape == (37, 1)
    for backend in ("interpret", "reference"):
        want_q, want_s = jops.quantize_rows(jnp.asarray(x), bits=bits, signed=signed,
                                            backend=backend)
        assert np.array_equal(np.asarray(want_q), got_q.numpy()), backend
        assert np.array_equal(np.asarray(want_s), got_s.numpy()), backend
    assert torch.all(got_q[1] == 0) and got_s[1, 0] == 0      # all-zero row
    if bits == 8 and not signed:
        assert (got_q.numpy() < 0).any()          # 255-range codes stored wrapped


def _act_codes(m, k, a_bits, signed):
    lo, hi = (-(1 << (a_bits - 1)), 1 << (a_bits - 1)) if signed else (0, 1 << a_bits)
    return RNG.integers(lo, hi, (m, k)).astype(np.int32).astype(np.int8)  # wraps


@pytest.mark.parametrize("a_bits", range(2, 9))
@pytest.mark.parametrize("signed", [True, False])
def test_bitplane_matmul_bitwise(a_bits, signed):
    """Odd a_bits (a partial top plane in the TPU kernel), unsigned codes
    (wrapped at 8 bits), K not a multiple of the kernel's quad of codes."""
    x = _act_codes(9, 70, a_bits, signed)
    w = RNG.integers(-128, 128, (70, 13)).astype(np.int32)
    want = np.asarray(jops.bitplane_matmul(jnp.asarray(x), jnp.asarray(w),
                                           a_bits=a_bits, act_signed=signed,
                                           backend="interpret"))
    got = ops.bitplane_matmul(torch.from_numpy(x), torch.from_numpy(w),
                              a_bits=a_bits, act_signed=signed)
    assert got.dtype == torch.int32
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("w_bits,plane_lo", [(8, 1), (8, 2), (8, 3), (4, 1)])
def test_bitplane_matmul_plane_lo(w_bits, plane_lo):
    """``w_plane_lo`` shifts the weight before the contraction (the TPU
    kernel's shift before the colsum correction); the packed operand
    gives the same product as the codes."""
    x = _act_codes(6, 64, 8, True)
    lo, hi = -(1 << (w_bits - 1)), 1 << (w_bits - 1)
    w = RNG.integers(lo, hi, (64, 24)).astype(np.int32)
    want = np.asarray(jops.bitplane_matmul(jnp.asarray(x), jnp.asarray(w), a_bits=8,
                                           w_plane_lo=plane_lo, backend="interpret"))
    xt = torch.from_numpy(x)
    got = ops.bitplane_matmul(xt, torch.from_numpy(w), w_plane_lo=plane_lo)
    assert np.array_equal(want, got.numpy())
    packed = pack_weights(torch.from_numpy(w), w_bits, axis=0)
    got_p = ops.bitplane_matmul(xt, packed, w_plane_lo=plane_lo, w_bits=w_bits)
    assert np.array_equal(want, got_p.numpy())


@pytest.mark.parametrize("w_bits", [2, 4])
def test_bitplane_matmul_packed_low_group(w_bits):
    x = _act_codes(11, 96, 6, True)
    lo, hi = -(1 << (w_bits - 1)), 1 << (w_bits - 1)
    w = RNG.integers(lo, hi, (96, 33)).astype(np.int32)
    want = x.astype(np.int64) @ w
    packed = np.asarray(jbp.pack_weights(jnp.asarray(w), w_bits, axis=0))
    got = ops.bitplane_matmul(torch.from_numpy(x), convert.tensor_from_numpy(packed, "cpu"),
                              a_bits=6, w_bits=w_bits)
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("w_bits,a_bits", [(4, 6), (4, 8), (2, 4)])
def test_mixed_group_matmul_matches_jax(w_bits, a_bits):
    x = RNG.standard_normal((16, 64)).astype(np.float32)
    w8 = RNG.integers(-128, 128, (64, 16)).astype(np.int32)
    lo, hi = -(1 << (w_bits - 1)), 1 << (w_bits - 1)
    wl = RNG.integers(lo, hi, (64, 32)).astype(np.int32)
    s8 = RNG.uniform(0.001, 0.01, (16,)).astype(np.float32)
    sl = RNG.uniform(0.001, 0.01, (32,)).astype(np.float32)
    packed_l = np.asarray(jbp.pack_weights(jnp.asarray(wl), w_bits, axis=0))
    want = np.asarray(jops.mixed_group_matmul(
        jnp.asarray(x), jnp.asarray(w8), jnp.asarray(packed_l), jnp.asarray(s8),
        jnp.asarray(sl), w_bits=w_bits, a_bits=a_bits, backend="interpret"))
    got = ops.mixed_group_matmul(
        torch.from_numpy(x), torch.from_numpy(w8).to(torch.int8),
        convert.tensor_from_numpy(packed_l, "cpu"), torch.from_numpy(s8),
        torch.from_numpy(sl), w_bits=w_bits, a_bits=a_bits)
    assert got.shape == (16, 48) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_table3_leaf_routes_through_mixed_group_matmul(monkeypatch):
    """A w4a6r25 leaf (signed activations, no plane truncation) runs one
    shared row quantization and one integer matmul per group, bitwise
    equal to the fused kernel run once per group on the same rows (the
    integer products and the scale products are the same)."""
    w = torch.from_numpy((RNG.standard_normal((128, 64)) * 0.05).astype(np.float32))
    pw = tql.pack_weight(w, QuantConfig(w_bits=4, a_bits=6, mixed_ratio_8b=0.25))
    assert pw.n8 > 0 and pw.act_signed and not pw.plane_lo
    x = torch.from_numpy(RNG.standard_normal((2, 5, 128)).astype(np.float32))
    x2 = x.reshape(-1, 128)
    kw = dict(a_bits=6, act_signed=True, w_plane_lo=0)
    two_fused = torch.cat([
        ops.packed_matmul(x2, pw.packed8, pw.scale[..., :pw.n8], w_bits=8, **kw),
        ops.packed_matmul(x2, pw.packed, pw.scale[..., pw.n8:], w_bits=4, **kw)],
        dim=-1).reshape(2, 5, -1)

    def refuse(*a, **k):
        raise AssertionError("a Table III leaf took the fused route")

    monkeypatch.setattr(ops, "packed_matmul", refuse)
    got = tql.qmatmul(x, pw)
    assert got.shape == (2, 5, 64)
    assert torch.equal(got, two_fused)


def test_unsigned_table3_leaf_keeps_the_fused_route(monkeypatch):
    """JAX's mixed_group_matmul quantizes signed activations only, so an
    unsigned Table III leaf keeps one fused matmul per group."""
    w = torch.from_numpy((RNG.standard_normal((64, 32)) * 0.05).astype(np.float32))
    pw = tql.pack_weight(w, QuantConfig(w_bits=4, a_bits=6, act_signed=False,
                                        mixed_ratio_8b=0.25))
    assert pw.n8 > 0 and not pw.act_signed

    def refuse(*a, **k):
        raise AssertionError("an unsigned leaf took the mixed-group route")

    monkeypatch.setattr(ops, "mixed_group_matmul", refuse)
    x = torch.from_numpy(np.abs(RNG.standard_normal((3, 64))).astype(np.float32))
    assert tql.qmatmul(x, pw).shape == (3, 32)


def test_non_cpu_tensors_never_fall_back():
    """A tensor off the CPU goes to the kernel or raises: the plain
    versions run only for CPU tensors."""
    x = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.quantize_rows(x, bits=6)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.bitplane_matmul(x.to(torch.int8), torch.zeros((8, 4), dtype=torch.int8))
