"""Tile plans of the two tensor-core matmuls of the PyTorch port, checked
on the CPU (the kernels themselves run only on the card, where
``chip_smoke.py`` holds them bitwise against their plain versions).

``dense_matmul``: the summation order — S slices of whole K tiles — is a
function of (K, N) only, so a row's bits cannot move with M; the slices
cover K exactly once. ``bitplane_matmul``: the grid covers every output
element and every K code exactly once, and marks the single-slice plans
whose output the wrapper need not zero. The int8 kernel's B-fragment
unpack (bit-field extraction, sign extension, 4 × 4 byte transpose,
interleaved columns) is emulated lane by lane in integers and held
bitwise against the packed weights' own unpacking.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.bitplane import pack_weights
from repro_torch.kernels import bitplane_matmul as bpm
from repro_torch.kernels import dense_matmul as dense

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container without hypothesis — deterministic fallback
    from hypothesis_fallback import given, settings, strategies as st

RWKV_KN = {(2560, 2560): 4, (2560, 8960): 1, (8960, 2560): 4, (2560, 64): 20,
           (64, 2560): 1, (2560, 65536): 1}


def _slices(K, S, sk):
    return [(s * sk, min(K, (s + 1) * sk)) for s in range(S)]


@settings(max_examples=200, deadline=None)
@given(k8=st.integers(1, 8192), n8=st.integers(1, 8192), m1=st.integers(1, 4096),
       m2=st.integers(1, 4096))
def test_dense_summation_order_ignores_M(k8, n8, m1, m2):
    """Two batch sizes get the same slices: (S, slice length) come from
    (K, N) alone; only the tiling may follow M."""
    K, N = 8 * k8, 8 * n8
    assert dense.launch_plan(m1, K, N)[:2] == dense.launch_plan(m2, K, N)[:2]
    assert dense.launch_plan(m1, K, N)[:2] == (dense.plan(K, N), dense.slice_k(K, N))


@settings(max_examples=200, deadline=None)
@given(k8=st.integers(1, 8192), n8=st.integers(1, 8192))
def test_dense_slices_are_whole_tiles_covering_K_once(k8, n8):
    K, N = 8 * k8, 8 * n8
    S, sk = dense.plan(K, N), dense.slice_k(K, N)
    assert S >= 1 and sk % dense.KT == 0
    spans = _slices(K, S, sk)
    assert spans[0][0] == 0 and spans[-1][1] == K
    for (a0, a1), (b0, _) in zip(spans, spans[1:]):
        assert a1 == b0                      # adjacent, no overlap, no gap
    assert all(a1 > a0 for a0, a1 in spans)  # none empty (the C entry refuses that)


@pytest.mark.parametrize("kn", sorted(RWKV_KN))
def test_dense_plan_at_rwkv6_shapes(kn):
    """Short-N shapes split K so decode fills the SMs (S x N / 32 >= 2 per
    SM, or one slice per K tile); wide-N shapes keep one slice."""
    K, N = kn
    S = dense.plan(K, N)
    assert S == RWKV_KN[kn]
    assert S * N // dense.STRIP_N >= 2 * dense.SMS or S == -(-K // dense.KT)


@pytest.mark.parametrize("M,K,N,want", [(1, 2560, 2560, 16), (16, 8960, 2560, 16),
                                        (4, 2560, 8960, 64), (17, 2560, 2560, 64),
                                        (64, 2560, 65536, 64), (65, 2560, 65536, 128),
                                        (200, 2560, 2560, 64), (640, 2560, 2560, 128),
                                        (1280, 2560, 2560, 128), (1280, 2560, 64, 64),
                                        (80, 2560, 8960, 128)])
def test_dense_tiling_follows_M(M, K, N, want):
    """Rows per block: split decode blocks of 16 where K is split, 64-row
    strips for small batches (and unsplit decode), 128 x 128 tiles once
    they fill half the SMs."""
    assert dense.tiles(M, K, N) == want


def _cover(p, M, K, N):
    """Counts of each output element and of each (element, K code) that
    plan `p` assigns to a block."""
    out = np.zeros((M, N), np.int64)
    ks = np.zeros(K, np.int64)
    gx, gy, gz = p.grid
    for z in range(gz):
        for x in range(gx):
            out[z * p.bm:(z + 1) * p.bm, x * bpm.BN:(x + 1) * bpm.BN] += 1
    for y in range(gy):
        ks[y * p.kb:(y + 1) * p.kb] += 1
    return out, ks


@pytest.mark.parametrize("M,K,N", [(4, 2048, 6144), (17, 2048, 8192), (64, 8192, 2048),
                                   (200, 2048, 1536), (1280, 2048, 6144), (37, 200, 100),
                                   (33, 128, 128), (65, 96, 8)])
def test_bitplane_plan_covers_each_element_once(M, K, N):
    p = bpm.plan(M, K, N)
    out, ks = _cover(p, M, K, N)
    assert (out == 1).all() and (ks == 1).all()


@settings(max_examples=300, deadline=None)
@given(M=st.integers(1, 4096), k4=st.integers(1, 4096), N=st.integers(1, 16384))
def test_bitplane_plan_grid_is_exact(M, k4, N):
    """The grid is the least that covers (M, N); the K slices are whole
    tiles, none empty, covering K once; ``single_slice`` says when the
    kernel stores every element itself."""
    K = 4 * k4
    p = bpm.plan(M, K, N)
    gx, gy, gz = p.grid
    assert p.bm in (32, 64, 128) and p.kb % bpm.KT == 0
    assert (gx - 1) * bpm.BN < N <= gx * bpm.BN
    assert (gz - 1) * p.bm < M <= gz * p.bm
    assert (gy - 1) * p.kb < K <= gy * p.kb
    assert p.single_slice == (gy == 1)


def test_bitplane_plan_switches():
    """Rows per block follow M (32 / 64 / 128); the static prefill of a
    Table III leaf is one slice (no zero fill), decode splits K."""
    assert [bpm.plan(m, 2048, 6144).bm for m in (4, 17, 32, 33, 64, 65, 200, 1280)] == \
        [32, 32, 32, 64, 64, 128, 128, 128]
    assert bpm.plan(1280, 2048, 6144).single_slice
    assert not bpm.plan(4, 2048, 6144).single_slice


# -- the int8 kernel's B fragments, emulated lane by lane ---------------------

def _byte_perm(x, y, s):
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(s >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _fragments(packed, bits, shift, wn, ks, g, t):
    """bf[j][h] of lane (g, t) of warp column wn at k32 step ks, as
    csrc/bitplane_matmul.cu builds them from the packed tile."""
    rpq, epb = bits // 2, 8 // bits
    b = bits - shift
    fmask = ((1 << b) - 1) * 0x01010101
    fsign = (1 << (b - 1)) * 0x01010101
    fmult = (1 << (9 - b)) - 2
    bf = [[0, 0] for _ in range(4)]
    for h in range(2):
        q = ks * 8 + 4 * h + t
        col = wn * 32 + 4 * g
        W = [int.from_bytes(packed[q * rpq + r, col:col + 4].tobytes(), "little")
             for r in range(rpq)]
        F = []
        for kk in range(4):
            x = (W[kk // epb] >> ((kk % epb) * bits + shift)) & fmask
            F.append((x | ((x & fsign) * fmult)) & 0xFFFFFFFF)
        lo01, hi01 = _byte_perm(F[0], F[1], 0x5140), _byte_perm(F[0], F[1], 0x7362)
        lo23, hi23 = _byte_perm(F[2], F[3], 0x5140), _byte_perm(F[2], F[3], 0x7362)
        bf[0][h] = _byte_perm(lo01, lo23, 0x5410)
        bf[1][h] = _byte_perm(lo01, lo23, 0x7632)
        bf[2][h] = _byte_perm(hi01, hi23, 0x5410)
        bf[3][h] = _byte_perm(hi01, hi23, 0x7632)
    return bf


@pytest.mark.parametrize("bits,plane_lo", [(2, 0), (4, 0), (4, 1), (8, 0), (8, 1), (8, 3)])
def test_imma_fragments_are_the_unpacked_codes(bits, plane_lo):
    """Rebuild each n8 tile's 32 x 8 B operand from the lanes' fragments
    (PTX m16n8k32 layout: lane (g, t), register h, byte kk is K row
    16 h + 4 t + kk of column g), multiply by an A tile, and scatter the C
    columns as the kernel's epilogue does (tile j, column c → 4 c + j):
    the result is A @ (codes >> 2 plane_lo) of the warp's 32 columns."""
    rng = np.random.default_rng(bits * 10 + plane_lo)
    K, N, shift = bpm.KT, bpm.BN, 2 * plane_lo
    codes = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), (K, N))
    packed = pack_weights(torch.from_numpy(codes).to(torch.int32), bits, axis=0)
    packed = packed.numpy().view(np.uint8)
    want_w = codes >> shift
    for wn in range(4):
        for ks in range(K // 32):
            a = rng.integers(-128, 128, (16, 32))
            out = np.zeros((16, 32), np.int64)
            tiles = np.zeros((4, 32, 8), np.int64)
            for g in range(8):
                for t in range(4):
                    bf = _fragments(packed, bits, shift, wn, ks, g, t)
                    for j in range(4):
                        for h in range(2):
                            for kk in range(4):
                                byte = (bf[j][h] >> (8 * kk)) & 0xFF
                                tiles[j, 16 * h + 4 * t + kk, g] = byte - 256 * (byte >= 128)
            for j in range(4):
                c = a @ tiles[j]
                for t in range(4):
                    out[:, 8 * t + j] = c[:, 2 * t]
                    out[:, 8 * t + 4 + j] = c[:, 2 * t + 1]
            w = want_w[ks * 32:(ks + 1) * 32, wn * 32:(wn + 1) * 32]
            assert np.array_equal(out, a @ w)
