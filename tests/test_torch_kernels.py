"""The plain PyTorch versions of the port's three kernels held against the
JAX package: its Pallas kernels in interpret mode and ``repro.kernels.ref``.

These are the functions the port's CUDA kernels are held against on the
card (``chip_smoke.py``), and what ``repro_torch.kernels.ops`` runs for a
CPU tensor. Integers bitwise: fused-matmul accumulators and scales, int8
pool bytes and scale planes (trash block 0 skipped: its contents are
undefined). Attention outputs are bf16 in both packages, computed in
float32 with another summation order (a one-pass softmax here, an online
one in the kernels), so they are compared at atol = rtol = 1e-2: one
bf16 rounding step of the output.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplane as jbp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.kv_cache import quantize_kv as jax_quantize_kv
from repro_torch import convert
from repro_torch.kernels import ops, ref
from repro_torch.models.kv_cache import quantize_kv
from torch_parity import np_of

RNG = np.random.default_rng(5)
TOL = dict(atol=1e-2, rtol=1e-2)


def _t(a):
    return convert.tensor_from_numpy(np.asarray(a), "cpu")


# -- fused quantize → packed matmul ------------------------------------------


def _fused_case(m, k, n, w_bits, a_bits, signed, plane_lo=0):
    x = RNG.standard_normal((m, k)).astype(np.float32)
    if not signed:
        x = np.abs(x)
    lo, hi = -(1 << (w_bits - 1)), (1 << (w_bits - 1))
    codes = RNG.integers(lo, hi, (k, n)).astype(np.int32)
    packed = np.asarray(jbp.pack_weights(jnp.asarray(codes), w_bits, axis=0))
    kw = dict(a_bits=a_bits, act_signed=signed, w_plane_lo=plane_lo)
    acc_i, s_i = jops.fused_quantize_matmul(jnp.asarray(x), jnp.asarray(codes), **kw)
    acc_r, s_r = jops.fused_quantize_matmul(jnp.asarray(x), jnp.asarray(codes),
                                            backend="reference", **kw)
    acc_t, s_t = ops.fused_quantize_matmul(torch.from_numpy(x), _t(packed),
                                           w_bits=w_bits, **kw)
    for acc, s in ((acc_i, s_i), (acc_r, s_r)):
        assert np.array_equal(np.asarray(acc), acc_t.numpy())
        assert np.array_equal(np.asarray(s), s_t.numpy())


@pytest.mark.parametrize("w_bits", [2, 4, 8])
@pytest.mark.parametrize("a_bits", [2, 5, 8])
def test_fused_precisions(w_bits, a_bits):
    _fused_case(9, 72, 13, w_bits, a_bits, True)


@pytest.mark.parametrize("a_bits,signed", [(2, False), (4, False), (8, False), (8, True)])
def test_fused_signedness(a_bits, signed):
    _fused_case(17, 48, 21, 8, a_bits, signed)


@pytest.mark.parametrize("m,k,n", [(1, 8, 1), (7, 128, 33), (33, 96, 130)])
def test_fused_ragged_shapes(m, k, n):
    _fused_case(m, k, n, 4, 6, True)


@pytest.mark.parametrize("w_bits,plane_lo", [(8, 1), (8, 2), (4, 1)])
def test_fused_plane_lo(w_bits, plane_lo):
    _fused_case(5, 64, 24, w_bits, 8, True, plane_lo)


# -- paged decode attention ----------------------------------------------------


def _paged_case(seed, *, B, n_kv, group, H, bs, maxb, quantized, positions=None,
                tables=None):
    """Random pool + ragged tables (mirrors tests/test_paged_attention.py):
    row b gets tables[b] live blocks; by default the last of >= 3 rows is
    freed (table all -1)."""
    rng = np.random.default_rng(seed)
    nb = B * maxb + 1
    kf = rng.normal(size=(nb, bs, n_kv, H)).astype(np.float32)
    vf = rng.normal(size=(nb, bs, n_kv, H)).astype(np.float32)
    if quantized:
        pk, ks = (np.asarray(a) for a in jax.jit(jax_quantize_kv)(jnp.asarray(kf)))
        pv, vs = (np.asarray(a) for a in jax.jit(jax_quantize_kv)(jnp.asarray(vf)))
    else:
        pk = np.asarray(jnp.asarray(kf, jnp.bfloat16))
        pv = np.asarray(jnp.asarray(vf, jnp.bfloat16))
        ks = vs = None
    if tables is None:
        tables = [max(1, maxb - b) for b in range(B)]
        if B >= 3:
            tables[B - 1] = 0
    tbl = np.full((B, maxb), -1, np.int32)
    free = list(range(1, nb))
    rng.shuffle(free)
    for b, n in enumerate(tables):
        for j in range(n):
            tbl[b, j] = free.pop()
    if positions is None:
        positions = [max(0, n * bs - 1) for n in tables]
    q = np.asarray(jnp.asarray(rng.normal(size=(B, 1, n_kv * group, H)), jnp.bfloat16))
    return q, pk, pv, tbl, np.asarray(positions, np.int32), ks, vs


def _paged_both(case, live):
    q, pk, pv, tbl, pos, ks, vs = case
    jx = [None if a is None else jnp.asarray(a) for a in case]
    out_k = np.asarray(jops.paged_attention(*jx[:5], k_scale=jx[5], v_scale=jx[6],
                                            backend="interpret"), np.float32)
    out_r = np.asarray(jref.paged_attention_ref(*jx), np.float32)
    tx = [None if a is None else _t(a) for a in case]
    got = np_of(ops.paged_attention(*tx[:5], k_scale=tx[5], v_scale=tx[6]))
    for want in (out_k, out_r):
        np.testing.assert_allclose(got[live], want[live], **TOL)
    return got


@pytest.mark.parametrize("n_kv,group", [(4, 1), (2, 2), (2, 4)])
@pytest.mark.parametrize("quantized", [False, True])
def test_paged_attention_matches_jax(n_kv, group, quantized):
    case = _paged_case(1, B=3, n_kv=n_kv, group=group, H=16, bs=4, maxb=4,
                       quantized=quantized)
    got = _paged_both(case, live=slice(0, 2))
    assert np.all(got[2] == 0)            # freed row: zeros, like the kernel


@pytest.mark.parametrize("pos", [0, 3, 4, 7, 15])
def test_paged_attention_block_boundaries(pos):
    case = _paged_case(3, B=2, n_kv=2, group=2, H=16, bs=4, maxb=4,
                       quantized=False, tables=[4, 4], positions=[pos, pos])
    _paged_both(case, live=slice(0, 2))


def test_paged_attention_trash_block_never_leaks():
    case = list(_paged_case(4, B=3, n_kv=2, group=2, H=16, bs=4, maxb=4,
                            quantized=True))
    tx = [None if a is None else _t(a) for a in case]
    clean = ops.paged_attention(*tx[:5], k_scale=tx[5], v_scale=tx[6])
    for i in (1, 2):
        tx[i][0] = 120
    for i in (5, 6):
        tx[i][0] = 1e4
    dirty = ops.paged_attention(*tx[:5], k_scale=tx[5], v_scale=tx[6])
    assert torch.equal(clean[:2], dirty[:2])


# -- paged chunked prefill -----------------------------------------------------

BS, NKV, G, H = 4, 2, 3, 16


def _prefill_case(seed, *, quantized, start, length, lc, mb, alloc):
    """Mirrors tests/test_paged_prefill_kernel.py::_case."""
    rng = np.random.default_rng(seed)
    nb = 8
    if quantized:
        pk = rng.integers(-128, 128, (nb, BS, NKV, H)).astype(np.int8)
        pv = rng.integers(-128, 128, (nb, BS, NKV, H)).astype(np.int8)
        ks = (rng.random((nb, BS, NKV, 1)) * 0.02).astype(np.float32)
        vs = (rng.random((nb, BS, NKV, 1)) * 0.02).astype(np.float32)
    else:
        pk = np.asarray(jnp.asarray(rng.standard_normal((nb, BS, NKV, H)), jnp.bfloat16))
        pv = np.asarray(jnp.asarray(rng.standard_normal((nb, BS, NKV, H)), jnp.bfloat16))
        ks = vs = None
    bf = lambda shape: np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
    q, kn, vn = bf((1, lc, NKV * G, H)), bf((1, lc, NKV, H)), bf((1, lc, NKV, H))
    blocks = np.full(mb, -1, np.int32)
    blocks[:alloc] = rng.permutation(np.arange(1, nb))[:alloc]
    return q, kn, vn, pk, pv, blocks, start, length, ks, vs


def _prefill_check(case, softcap=0.0):
    q, kn, vn, pk, pv, blocks, start, length, ks, vs = case
    jx = [None if a is None else jnp.asarray(a) for a in case]
    jx[6], jx[7] = jnp.int32(start), jnp.int32(length)
    want_r = jax.jit(functools.partial(jref.paged_prefill_ref, softcap=softcap))(
        *jx[:8], k_scale=jx[8], v_scale=jx[9])
    want_k = jops.paged_prefill(*jx[:8], k_scale=jx[8], v_scale=jx[9],
                                softcap=softcap, backend="interpret")
    tx = [None if a is None or isinstance(a, int) else _t(a) for a in case]
    got = ops.paged_prefill(tx[0], tx[1], tx[2], tx[3], tx[4], tx[5], start, length,
                            k_scale=tx[8], v_scale=tx[9], softcap=softcap)
    for want in (want_r, want_k):
        np.testing.assert_allclose(np_of(got[0]), np.asarray(want[0], np.float32), **TOL)
        for g, w in zip(got[1:], want[1:]):
            if w is None:
                assert g is None
                continue
            g, w = np_of(g), np.asarray(w).astype(np_of(g).dtype)
            assert np.array_equal(g[1:], w[1:])       # trash block skipped
    assert np.all(np_of(got[0])[0, length:] == 0)     # padded queries
    return got


@pytest.mark.parametrize("quantized", [False, True])
def test_prefill_cold_full_chunk(quantized):
    _prefill_check(_prefill_case(0, quantized=quantized, start=0, length=8, lc=8,
                                 mb=4, alloc=2))


@pytest.mark.parametrize("quantized", [False, True])
def test_prefill_warm_partial_block_start(quantized):
    _prefill_check(_prefill_case(1, quantized=quantized, start=6, length=7, lc=8,
                                 mb=6, alloc=4))


@pytest.mark.parametrize("start,length,lc", [(0, 5, 8), (9, 1, 4), (4, 0, 4)])
def test_prefill_padded_short_and_empty_chunks(start, length, lc):
    case = _prefill_case(2, quantized=False, start=start, length=length, lc=lc,
                         mb=4, alloc=3)
    got = _prefill_check(case)
    if length == 0:
        assert np.array_equal(np_of(got[1])[1:], case[3].astype(np.float32)[1:])


def test_prefill_softcap_int8():
    _prefill_check(_prefill_case(3, quantized=True, start=3, length=6, lc=8, mb=6,
                                 alloc=3), softcap=30.0)


def test_quantize_kv_matches_jitted_jax():
    """The int8 pool's quantizer: codes and scales bitwise those of the
    jitted JAX `quantize_kv` (which multiplies by 1/127)."""
    x = (RNG.standard_normal((64, 4, 16)) * RNG.uniform(0.01, 50, (64, 4, 1))).astype(np.float32)
    cj, sj = jax.jit(jax_quantize_kv)(jnp.asarray(x))
    ct, st = quantize_kv(torch.from_numpy(x))
    assert np.array_equal(np.asarray(cj), ct.numpy())
    assert np.array_equal(np.asarray(sj), st.numpy())


def test_cuda_tensors_never_fall_back():
    """A non-CPU tensor goes to the kernel or raises: on a machine without
    the CUDA toolchain the kernel entry raises instead of running the
    plain version."""
    x = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.fused_quantize_matmul(x, torch.zeros((8, 4), dtype=torch.int8))
    assert ref.fused_quantize_matmul_ref is not None


# (wrapper module, CUDA source, C entry): the kernels' ctypes bindings. A
# module binding a second entry keeps that signature in <ENTRY>_ARGTYPES.
_BINDINGS = [("fused_matmul", "fused_matmul", "fused_quantize_matmul"),
             ("fused_matmul", "fused_matmul", "fused_dequant_matmul"),
             ("paged_attention", "paged_attention", "paged_attention"),
             ("paged_prefill", "paged_prefill", "paged_prefill"),
             ("pack_quant", "quantize_rows", "quantize_rows"),
             ("bitplane_matmul", "bitplane_matmul", "bitplane_matmul"),
             ("bitplane_matmul", "bitplane_matmul", "bitplane_dequant_matmul"),
             ("flash_attention", "flash_attention", "flash_attention"),
             ("paged_attention", "paged_attention", "contig_attention"),
             ("wkv6", "wkv6", "wkv6"),
             ("dense_matmul", "dense_matmul", "dense_matmul")]


@pytest.mark.parametrize("module,source,entry", _BINDINGS)
def test_ctypes_signature_matches_the_c_entry(module, source, entry):
    """Each wrapper's ctypes argtypes follow its C entry's parameters one
    for one (a pointer as c_void_p, an int as c_int, a float as c_float):
    ctypes cannot check them, and a CUDA kernel runs only on the card."""
    import ctypes
    import importlib
    import re

    from repro_torch.kernels import build

    src = (build.CSRC / f"{source}.cu").read_text()
    params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src).group(1).split(",")
    want = [ctypes.c_void_p if "*" in p else
            ctypes.c_float if p.split()[0] == "float" else ctypes.c_int
            for p in params]
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    assert getattr(mod, f"{entry.upper()}_ARGTYPES", mod.ARGTYPES) == want
    assert source in build.KERNELS


@pytest.mark.parametrize("H", [16, 64, 80, 128, 160, 192, 256])
def test_check_heads_takes_every_config_head_dim(H):
    """The attention kernels are instantiated for every head dim of the
    JAX package's configs (16: the reduced ones), up to 16 query heads a
    KV head."""
    from repro_torch.kernels.paged_attention import HEAD_DIMS, check_heads

    assert H in HEAD_DIMS
    check_heads(16, 1, H)
    check_heads(32, 8, H)


@pytest.mark.parametrize("NQ,NKV,H", [(4, 4, 32), (4, 4, 96), (4, 4, 512), (34, 2, 128),
                                      (6, 4, 128)])
def test_check_heads_refuses_the_rest(NQ, NKV, H):
    from repro_torch.kernels.paged_attention import check_heads

    with pytest.raises(ValueError):
        check_heads(NQ, NKV, H)


def test_split_scratch_covers_every_key():
    """bf16 decode gets one (O, m, l) slot per split of 64 keys a row may
    hold; float32 decode folds in the block and gets none."""
    from repro_torch.kernels.paged_attention import SPLIT, _scratch

    for keys in (1, 63, 64, 65, 640):
        o, ml, ns = _scratch(torch.zeros(1, dtype=torch.bfloat16), 3, 2, 80, keys)
        assert ns * SPLIT >= keys > (ns - 1) * SPLIT
        assert o.shape == (3, 2, ns, 16, 80) and ml.shape == (3, 2, ns, 16, 2)
    assert _scratch(torch.zeros(1), 3, 2, 80, 64) == (None, None, 0)
