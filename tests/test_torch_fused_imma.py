"""The fused quantize → packed matmul of the PyTorch port on the int8
tensor cores (``csrc/fused_matmul.cu``), checked on the CPU: its kernel
runs only on the card, where ``chip_smoke.py`` holds both output forms
bitwise against their plain versions.

- The serving form's plain version (``ops.packed_matmul`` on the CPU:
  ``(acc · xs) · ws`` rounded in that order, then x's dtype) is bitwise
  JAX's ``_serve_matmul(use_kernel=True)`` (Pallas in interpret mode),
  for float32 and bfloat16 rows, a plane-truncated leaf and an unsigned
  Table III leaf whose two groups land at their column offsets.
- The tile plan covers every output element and every K code once, and
  is a function of (M, K, N) alone.
- The quantization into the A fragments (the kernel's code path: rint of
  ``x · inv`` in float32, an integer clamp, 4 codes packed by byte
  permutes, the swizzled shared tile, ``ldmatrix``'s fragment layout) is
  emulated lane by lane and gives exactly ``quantize_rows_ref``'s codes.
- A model's dense (unpacked) linear runs ``ops.dense_matmul``, which on
  the CPU is the plain product.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.core import quantized_linear as jql
from repro.core.precision import parse_policy_spec as jax_policy
from repro_torch import convert
from repro_torch.core import quantized_linear as tql
from repro_torch.kernels import fused_matmul as fm
from repro_torch.kernels import ops, ref
from repro_torch.models import common
from torch_parity import to_numpy_tree

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container without hypothesis — deterministic fallback
    from hypothesis_fallback import given, settings, strategies as st

RNG = np.random.default_rng(16)


# -- the serving form against JAX ---------------------------------------------

def _leaf(cfg, plane_lo=0, K=64, N=48):
    w = (RNG.standard_normal((K, N)) * 0.05).astype(np.float32)
    pj = jql.pack_weight(jnp.asarray(w), cfg)
    if plane_lo:
        pj = jql.PackedWeight(pj.packed, pj.scale, pj.bits, pj.k, pj.n8, pj.packed8,
                              pj.a_bits, pj.act_signed, plane_lo)
    return pj, convert.params_from_numpy(to_numpy_tree(pj), "cpu")


LEAVES = {
    "w4a8": (jax_policy("w4a8").default, 0),
    "w8a8, plane_lo 1": (jax_policy("w8a8").default, 1),
    "w2a4": (jax_policy("w2a4").default, 0),
    "w4a8r25 unsigned": (jq.QuantConfig(w_bits=4, a_bits=8, act_signed=False,
                                        mixed_ratio_8b=0.25), 0),
    "w4a6r25, plane_lo 1": (jq.QuantConfig(w_bits=4, a_bits=6, mixed_ratio_8b=0.25), 1),
}


@pytest.mark.parametrize("leaf", sorted(LEAVES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_matmul_is_jax_serve_matmul_bitwise(leaf, dtype):
    """``ops.packed_matmul`` (and ``qmatmul``, which routes these leaves
    to it) bitwise equal to JAX's kernel route, in x's dtype; a two-group
    leaf's 8-bit group lands in columns [0, n8) and the low group after
    it."""
    cfg, plane_lo = LEAVES[leaf]
    pj, pt = _leaf(cfg, plane_lo)
    x = RNG.standard_normal((2, 5, 64)).astype(np.float32)
    if not pt.act_signed:
        x = np.abs(x)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    want = np.asarray(jql._serve_matmul(xj, pj, None, use_kernel=True).astype(jnp.float32))
    kw = dict(a_bits=pt.a_bits, act_signed=pt.act_signed, w_plane_lo=plane_lo)
    got = ops.packed_matmul(xt.reshape(-1, 64), pt.packed, pt.scale[..., pt.n8:],
                            w_bits=pt.bits, packed8=pt.packed8 if pt.n8 else None,
                            scale8=pt.scale[..., :pt.n8] if pt.n8 else None, **kw)
    assert got.dtype == xt.dtype and got.shape == (10, 48)
    assert np.array_equal(got.float().numpy(), want.reshape(10, 48))
    if pt.n8:
        low = ops.packed_matmul(xt.reshape(-1, 64), pt.packed, pt.scale[..., pt.n8:],
                                w_bits=pt.bits, **kw)
        assert torch.equal(got[:, pt.n8:], low)
    if not (pt.n8 and pt.act_signed and not plane_lo):   # the fused route
        assert np.array_equal(tql.qmatmul(xt, pt).float().numpy(), want)


def test_packed_matmul_ref_is_the_dequant_formula():
    """The plain dequant form: ``(acc.float() · xs) · (scale · 4**lo)``,
    then one rounding to x's dtype."""
    x = torch.from_numpy(RNG.standard_normal((7, 32)).astype(np.float32)).to(torch.bfloat16)
    codes = torch.from_numpy(RNG.integers(-8, 8, (32, 24)).astype(np.int32))
    packed = tql.bitplane.pack_weights(codes, 4, axis=0)
    scale = torch.from_numpy(RNG.uniform(0.01, 0.1, (1, 24)).astype(np.float32))
    kw = dict(w_bits=4, a_bits=8, act_signed=True, w_plane_lo=1)
    acc, xs = ref.fused_quantize_matmul_ref(x.float(), packed, **kw)
    want = (acc.float() * xs * (scale * 4)).to(torch.bfloat16)
    assert torch.equal(ref.packed_matmul_ref(x, packed, scale, **kw), want)


# -- the tile plan -------------------------------------------------------------

def _cover(p, M, K, N):
    out = np.zeros((M, N), np.int64)
    ks = np.zeros(K, np.int64)
    gx, gy, gz = p.grid
    for z in range(gz):
        for x in range(gx):
            out[z * p.bm:(z + 1) * p.bm, x * p.bn:(x + 1) * p.bn] += 1
    for y in range(gy):
        ks[y * p.kb:(y + 1) * p.kb] += 1
    return out, ks


@pytest.mark.parametrize("M", [1, 4, 17, 32, 33, 64, 65, 200, 320, 511, 512, 1280])
@pytest.mark.parametrize("K,N", [(2048, 8192), (8192, 2048), (2048, 2048), (200, 100)])
def test_fused_plan_covers_each_element_once(M, K, N):
    p = fm.plan(M, K, N)
    out, ks = _cover(p, M, K, N)
    assert (out == 1).all() and (ks == 1).all()
    assert p == fm.plan(M, K, N)


@settings(max_examples=300, deadline=None)
@given(M=st.integers(1, 4096), k16=st.integers(1, 1024), N=st.integers(1, 16384))
def test_fused_plan_grid_is_exact(M, k16, N):
    """The grid is the least that covers (M, N) with the plan's tile; the
    K slices are whole 64-code tiles, none empty, covering K once; the
    tile is one the kernel instantiates."""
    K = 16 * k16
    p = fm.plan(M, K, N)
    gx, gy, gz = p.grid
    assert (p.bm, p.bn) in ((32, 128), (64, 128), (64, 256)) and p.kb % fm.KT == 0
    assert (gx - 1) * p.bn < N <= gx * p.bn
    assert (gz - 1) * p.bm < M <= gz * p.bm
    assert (gy - 1) * p.kb < K <= gy * p.kb
    assert p.tiles == gx * gz


def test_fused_plan_switches():
    """Decode and prefill chunks take 32-row tiles and split K; a large
    prefill of a wide leaf takes 64 x 256 tiles in one K slice."""
    assert fm.plan(4, 2048, 8192)[:2] == (32, 128) and fm.plan(4, 2048, 8192).grid[1] > 1
    assert fm.plan(32, 8192, 2048).grid[1] > 1
    assert fm.plan(1280, 2048, 8192)[:2] == (64, 256)
    assert fm.plan(1280, 2048, 8192).grid[1] == 1
    assert fm.plan(1280, 2048, 2048)[:2] == (64, 128)
    assert fm.plan(320, 2048, 8192)[:2] == (64, 128)


# -- the quantization into the A fragments, lane by lane -----------------------

def _byte_perm(x, y, s):
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(s >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _a_at(r, c):
    """Byte offset of 16-byte chunk c of code row r in the shared tile."""
    return r * fm.KT + ((c ^ ((r >> 1) & 3)) << 4)


def _quantized_tile(x, scales, bits, signed):
    """The kernel's quantize step over one (rows, 64) tile: each thread
    takes 4 consecutive K of one row, rounds x · inv half to even, clamps
    in integers, packs the 4 codes with byte permutes and stores the word
    into the swizzled tile. Returns the tile's bytes."""
    qhi = (1 << (bits - 1)) - 1 if signed else (1 << bits) - 1
    qlo = -(1 << (bits - 1)) if signed else 0
    rows = x.shape[0]
    tile = np.zeros(rows * fm.KT, np.uint8)
    for idx in range(rows * (fm.KT // 4)):
        r, f = idx >> 4, idx & 15
        s = np.float32(scales[r])
        inv = np.float32(1) / s if s > 0 else np.float32(0)
        c = [int(min(max(np.rint(np.float32(x[r, 4 * f + j]) * inv), qlo), qhi)) & 0xFFFFFFFF
             for j in range(4)]
        word = _byte_perm(_byte_perm(c[0], c[1], 0x0040), _byte_perm(c[2], c[3], 0x0040), 0x5410)
        at = _a_at(r, f >> 2) + 4 * (f & 3)
        tile[at:at + 4] = np.frombuffer(np.uint32(word).tobytes(), np.uint8)
    return tile


@pytest.mark.parametrize("bits,signed,dtype", [(8, True, "float32"), (8, True, "bfloat16"),
                                               (6, True, "float32"), (4, False, "float32"),
                                               (8, False, "bfloat16")])
def test_quantized_a_fragments_are_quantize_rows_codes(bits, signed, dtype):
    """Rebuild each lane's four A registers of every m16 tile and k32 step
    as ``ldmatrix.x4`` reads them (lane l gives the address of row l % 16
    at chunk 2 ks + l / 16; register j, byte b of lane (g, t) is row g + 8
    (j % 2), K code 16 (j / 2) + 4 t + b): they are ``quantize_rows_ref``'s
    codes of the same rows, whose scales come from the row pass."""
    rows = 32
    x = RNG.standard_normal((rows, fm.KT)).astype(np.float32) * RNG.uniform(0.1, 5, (rows, 1))
    x[3] = 0                                              # an all-zero row
    if not signed:
        x = np.abs(x)
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).float()
    codes, scales = ref.quantize_pack_ref(xt, bits, signed)
    tile = _quantized_tile(xt.numpy(), scales.numpy()[:, 0], bits, signed)
    want = codes.numpy() & 0xFF
    for m0 in range(0, rows, 16):
        for ks in range(fm.KT // 32):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for j in range(4):
                    r = m0 + g + 8 * (j % 2)
                    at = _a_at(r, 2 * ks + j // 2) + 4 * t
                    k = 32 * ks + 16 * (j // 2) + 4 * t
                    assert list(tile[at:at + 4]) == list(want[r, k:k + 4]), (lane, j, r, k)


# -- an unpacked model's dense linear ------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_linear_cpu_is_the_plain_product(dtype):
    """``models.common.linear`` on a dense weight runs ``ops.dense_matmul``
    (batch-invariant on the card); on the CPU that is bitwise ``x @ w``,
    the product every CPU parity test was written against."""
    x = torch.from_numpy(RNG.standard_normal((3, 5, 64)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(RNG.standard_normal((64, 24)).astype(np.float32)).to(torch.bfloat16)
    calls = []
    real = ops.dense_matmul

    def spy(a, b):
        calls.append(a.shape)
        return real(a, b)

    ops.dense_matmul = spy
    try:
        got = common.linear(x, w)
    finally:
        ops.dense_matmul = real
    assert calls and torch.equal(got, x @ w.to(dtype))
