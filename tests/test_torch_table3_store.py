"""The Table III leaf as the card runs it: one row pass, then one integer
matmul per filter group with the dequant in its store.

- ``ops.quantize_rows`` takes bfloat16 rows as they are: its codes and
  scales are bitwise those of the same values as float32, and bitwise
  JAX's Pallas ``quantize_rows`` (interpret mode) on ``x.astype(f32)``.
- A lane-by-lane torch emulation of ``bitplane_matmul``'s dequant store
  on the plan ``bitplane_matmul.plan(M, K, N)``: the mma fragments each
  lane hands to the store, the partial tiles of a K split in scratch
  that starts as garbage, summed in slice order by the last block of a
  tile to arrive (M <= 8, blocks in a random order, counters left zero)
  or by the fold, then ``(acc · xs) · ws`` in float32 and one rounding,
  written at row · ldy + column of a column offset. It is bitwise the
  plain ``ref.mixed_group_matmul_ref`` at olmo-1b's three Table III
  shapes and a ragged one, and touches nothing else of the output.
- ``ops.mixed_group_matmul`` on bfloat16 x equals JAX's on the same
  values (rtol = atol = 1e-5, as ``test_torch_mixed_matmul.py`` holds
  the float32 case).
- The card route's composition, with each kernel replaced by its plain
  version: one ``quantize_rows`` call on x as it is, two dequant calls
  writing columns [0, N8) and [N8, N8 + NL) of one output in x's dtype,
  and no concatenation, bitwise the CPU route.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplane as jbp
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core.bitplane import pack_weights
from repro_torch.kernels import bitplane_matmul as bpm
from repro_torch.kernels import ops, ref
from torch_parity import np_of  # noqa: F401  (sets the thread count)

RNG = np.random.default_rng(17)

# olmo-1b's Table III leaves at w4a6r25: (K, N8, NL) of wq/wk/wv, w_gate /
# w_up and w_down.
OLMO_LEAVES = {"wq": (2048, 512, 1536), "w_up": (2048, 2048, 6144),
               "w_down": (8192, 512, 1536)}
# And a ragged leaf: K and N clipped inside a tile.
STORE_LEAVES = {**OLMO_LEAVES, "ragged": (200, 40, 100)}


def _rows(m, k):
    """Rows at several magnitudes, one of them all zero, as bfloat16."""
    x = (RNG.standard_normal((m, k)) * RNG.uniform(0.01, 20, (m, 1))).astype(np.float32)
    x[1] = 0
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("bits", range(2, 9))
@pytest.mark.parametrize("signed", [True, False])
def test_quantize_rows_reads_bf16_rows_as_float32(bits, signed):
    xb = _rows(37, 200)
    if not signed:
        xb = xb.abs()
    got_q, got_s = ops.quantize_rows(xb, bits=bits, signed=signed)
    f32_q, f32_s = ops.quantize_rows(xb.to(torch.float32), bits=bits, signed=signed)
    assert torch.equal(got_q, f32_q) and torch.equal(got_s, f32_s)
    want_q, want_s = jops.quantize_rows(jnp.asarray(xb.to(torch.float32).numpy()),
                                        bits=bits, signed=signed, backend="interpret")
    assert np.array_equal(np.asarray(want_q), got_q.numpy())
    assert np.array_equal(np.asarray(want_s), got_s.numpy())
    assert torch.all(got_q[1] == 0) and got_s[1, 0] == 0      # all-zero row


def _exact(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int codes (float64 is exact here)."""
    return (xq.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)


LAST_BLOCK_ROWS = 8     # split_store.cuh's kLastBlockRows


@functools.lru_cache(maxsize=None)
def _lanes(bm, nx):
    """Where a block row's lanes put their values, for every N tile bx,
    warp (wm, wn), lane (g, t), m16 tile i, half h and o[e]: o[j] =
    d[i][j][2h] and o[4 + j] = d[i][j][2h + 1], where the mma's C fragment
    d[i][j][q] is row g + 8 (q / 2), C column 2t + q % 2 of n8 tile j,
    which the interleaved B columns make column 8t + j + 4 (q % 2) of the
    warp's 32. The store puts o[e] at row 16 MI wm + 16 i + g + 8 h of the
    block, column c0 + e, c0 = n0 + 32 wn + 8 t. Returns, flattened: the
    warp's first row, the row and column stored, and the row and column
    of the product read (rows from the block's first)."""
    mi = bm // 32
    ar = torch.arange
    bx, wm, wn, g, t, i, h, e = torch.meshgrid(
        ar(nx), ar(2), ar(4), ar(8), ar(4), ar(mi), ar(2), ar(8), indexing="ij")
    n0, base = bx * bpm.BN, wm * 16 * mi + i * 16
    j, q = e % 4, 2 * h + e // 4
    src_row, src_col = base + g + 8 * (q // 2), n0 + wn * 32 + 8 * t + j + 4 * (q % 2)
    row, col = base + g + 8 * h, n0 + wn * 32 + 8 * t + e
    return tuple(a.reshape(-1) for a in (wm * 16 * mi, row, col, src_row, src_col))


def _lane_values(P, M, N, bm, nx, bz):
    """What block row bz's lanes hand to ``store8`` / ``store_part8`` for
    the (M, N) int32 tile product P (``_lanes``); a warp past M, a row
    past M or a column past N stores nothing. Returns (rows, columns,
    values)."""
    warp0, row, col, src_row, src_col = _lanes(bm, nx)
    m0 = bz * bm
    keep = (m0 + warp0 < M) & (m0 + row < M) & (col < N)
    return m0 + row[keep], col[keep], P[m0 + src_row[keep], src_col[keep]]


def dequant_store(xq, xs, w_codes, ws, out, col, M, rows):
    """The dequant entry of ``csrc/bitplane_matmul.cu`` emulated on the
    plan of (M, K, N), lane by lane: each K slice's int32 tile products as
    the lanes hold them (``_lane_values``); one slice stores them, a split
    writes them to partial tiles in scratch that starts as garbage
    (``store_part8``: (slice, M, N)), summed in slice order by the last
    block of each output tile to arrive (M <= 8; the blocks arrive in a
    random order, and the counters must end at zero) or by the fold over
    all M·N elements; then ``store1``'s ``(acc · xs) · ws`` (two float32
    products in that order) rounded once to out's dtype at element row ·
    ldy + column of y, y being out's data at column ``col``. xq and xs
    hold the (M, K) codes and (M, 1) scales of the listed rows only; the
    other rows are zero."""
    K, N = w_codes.shape
    p = bpm.plan(M, K, N)
    nx, S, nz = p.grid
    ldy, y = out.stride(0), out.view(-1)[col:]
    rows = torch.as_tensor(rows)
    xs_all = torch.zeros((M, 1), dtype=torch.float32)
    xs_all[rows] = xs

    def store(r, c, v):                      # store1 / store8
        y[r * ldy + c] = ((v.to(torch.float32) * xs_all[r, 0]) * ws.reshape(-1)[c]).to(y.dtype)

    prods = []
    for s in range(S):
        P = torch.zeros((M, N), dtype=torch.int32)
        P[rows] = _exact(xq[:, s * p.kb:min(K, (s + 1) * p.kb)], w_codes[s * p.kb:(s + 1) * p.kb])
        prods.append(P)
    part = torch.from_numpy(RNG.integers(-2 ** 31, 2 ** 31, S * M * N, dtype=np.int64)
                            .astype(np.int32))
    for bz in range(nz):
        for s in range(S):
            r, c, v = _lane_values(prods[s], M, N, p.bm, nx, bz)
            if S == 1:
                store(r, c, v)
            else:                            # store_part8
                part[(s * M + r) * N + c] = v
    if S == 1:
        return
    if M > LAST_BLOCK_ROWS:                  # fold_kernel over i < M·N
        i = torch.arange(M * N)
        acc = torch.zeros(M * N, dtype=torch.int32)
        for s in range(S):
            acc += part[s * M * N + i]
        store(i // N, i % N, acc)
        return
    counters = torch.zeros(nx * nz, dtype=torch.int64)
    blocks = [(bx, s, bz) for bx in range(nx) for s in range(S) for bz in range(nz)]
    for k in RNG.permutation(len(blocks)):   # last_block_store, blocks in any order
        bx, _, bz = blocks[k]
        tile = bz * nx + bx
        last = int(counters[tile]) == S - 1
        counters[tile] += 1
        if not last:
            continue
        m0, n0 = bz * p.bm, bx * bpm.BN
        nrows, ncols = min(p.bm, M - m0), min(bpm.BN, N - n0)
        i = torch.arange(nrows * bpm.BN)
        r, c = i // bpm.BN, i % bpm.BN
        r, c = m0 + r[c < ncols], n0 + c[c < ncols]
        acc = torch.zeros(r.shape, dtype=torch.int32)
        for sl in range(S):
            acc += part[(sl * M + r) * N + c]
        store(r, c, acc)
        counters[tile] = 0
    assert not counters.any()


@pytest.mark.parametrize("M", [4, 8, 9, 200, 1280])
@pytest.mark.parametrize("leaf", sorted(STORE_LEAVES))
def test_dequant_store_split_is_the_plain_mixed_group_matmul(leaf, M):
    """Both groups through the emulated store, for float32 output at
    column 0 and bfloat16 output at column 24 of a wider output with an
    odd row stride, bitwise the plain version, and every other element of
    the output untouched. Rows past 24 are sampled (first, last, and
    between); the other rows are zero."""
    K, n8, nl = STORE_LEAVES[leaf]
    w8 = torch.from_numpy(RNG.integers(-128, 128, (K, n8)).astype(np.int32))
    wl = torch.from_numpy(RNG.integers(-8, 8, (K, nl)).astype(np.int32))
    s8 = torch.from_numpy(RNG.uniform(1e-4, 1e-2, (1, n8)).astype(np.float32))
    sl = torch.from_numpy(RNG.uniform(1e-4, 1e-2, (1, nl)).astype(np.float32))
    rows = np.arange(M) if M <= 24 else np.unique(np.r_[0, 1, M - 1, RNG.choice(M, 21)])
    x = torch.from_numpy((RNG.standard_normal((M, K)) * 3).astype(np.float32))[rows]
    x = x.to(torch.bfloat16).to(torch.float32)      # the same rows in either dtype
    xq, xs = ops.quantize_rows(x, bits=6, signed=True)
    # Every group splits K but w_up's low group at M = 1280 (480 tiles).
    splits = [bpm.plan(M, K, n).grid[1] > 1 for n in (n8, nl)]
    assert splits == ([True, False] if (leaf, M) == ("w_up", 1280) else [True, True])
    for dtype, col, pad in ((torch.float32, 0, 0), (torch.bfloat16, 24, 7)):
        out = torch.full((M, col + n8 + nl + pad), float("nan"), dtype=dtype)
        dequant_store(xq, xs, w8, s8, out, col, M, rows)
        dequant_store(xq, xs, wl, sl, out, col + n8, M, rows)
        want = ref.mixed_group_matmul_ref(x.to(dtype), w8.to(torch.int8), wl, s8, sl, 6)
        assert torch.equal(out[rows, col:col + n8 + nl], want.to(dtype))
        assert out[:, :col].isnan().all() and out[:, col + n8 + nl:].isnan().all()
        others = np.setdiff1d(np.arange(M), rows)
        assert torch.equal(out[others, col:col + n8 + nl],
                           torch.zeros((len(others), n8 + nl), dtype=dtype))


def _leaf_np(K, n8, nl, w_bits):
    lo, hi = -(1 << (w_bits - 1)), 1 << (w_bits - 1)
    w8 = RNG.integers(-128, 128, (K, n8)).astype(np.int32)
    wl = RNG.integers(lo, hi, (K, nl)).astype(np.int32)
    s8 = RNG.uniform(0.001, 0.01, (n8,)).astype(np.float32)
    sl = RNG.uniform(0.001, 0.01, (nl,)).astype(np.float32)
    return w8, wl, s8, sl


@pytest.mark.parametrize("w_bits,a_bits", [(4, 6), (4, 8), (2, 4)])
def test_mixed_group_matmul_bf16_matches_jax(w_bits, a_bits):
    xb = _rows(24, 128)
    w8, wl, s8, sl = _leaf_np(128, 16, 40, w_bits)
    packed_l = np.asarray(jbp.pack_weights(jnp.asarray(wl), w_bits, axis=0))
    want = jops.mixed_group_matmul(
        jnp.asarray(xb.to(torch.float32).numpy()).astype(jnp.bfloat16), jnp.asarray(w8),
        jnp.asarray(packed_l), jnp.asarray(s8), jnp.asarray(sl), w_bits=w_bits,
        a_bits=a_bits, backend="interpret")
    assert want.dtype == jnp.bfloat16
    got = ops.mixed_group_matmul(
        xb, torch.from_numpy(w8).to(torch.int8), convert.tensor_from_numpy(packed_l, "cpu"),
        torch.from_numpy(s8), torch.from_numpy(sl), w_bits=w_bits, a_bits=a_bits)
    assert got.shape == (24, 56) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want.astype(jnp.float32)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [4, 37])
def test_card_route_is_one_row_pass_and_two_dequant_stores(monkeypatch, dtype, M):
    """``mixed_group_matmul``'s card route with each kernel swapped for its
    plain version: exactly one quantize_rows call on x as it is, two
    dequant calls writing their columns of one output in x's dtype, no
    concatenation; bitwise the CPU route."""
    from repro_torch.kernels import pack_quant
    from repro_torch.kernels.registry import get_registry

    K, n8, nl = 256, 64, 96
    w8, wl, s8, sl = _leaf_np(K, n8, nl, 4)
    args = (torch.from_numpy(w8).to(torch.int8), pack_weights(torch.from_numpy(wl), 4, axis=0),
            torch.from_numpy(s8), torch.from_numpy(sl))
    x = _rows(M, K).to(dtype)
    want = ops.mixed_group_matmul(x, *args, w_bits=4, a_bits=6)

    calls = []

    def quantize(xk, *, bits, signed):
        calls.append(("quantize_rows", xk.dtype))
        return ref.quantize_rows_ref(xk, bits, signed)

    def dequant(xq, w, xs, scale, out, *, col=0, w_bits, a_bits, backend=None):
        calls.append(("dequant", col, out.dtype, out.data_ptr()))
        acc = ref.bitplane_matmul_ref(xq, w, a_bits, True, w_bits=w_bits)
        dequant_out = (acc.to(torch.float32) * xs) * scale.reshape(1, -1)
        out[:, col:col + w.shape[1]] = dequant_out.to(out.dtype)

    def no_cat(*a, **k):
        raise AssertionError("the card route concatenates")

    monkeypatch.setattr(pack_quant, "launch", quantize)
    monkeypatch.setattr(bpm, "launch_dequant", dequant)
    cuda = get_registry().get("cuda")
    monkeypatch.setattr(ops, "_backend", lambda t, name, backend: cuda)
    monkeypatch.setattr(torch, "cat", no_cat)
    got = ops.mixed_group_matmul(x, *args, w_bits=4, a_bits=6)
    assert calls[0] == ("quantize_rows", dtype) and len(calls) == 3
    assert [c[1:3] for c in calls[1:]] == [(0, dtype), (n8, dtype)]
    assert calls[1][3] == calls[2][3] == got.data_ptr()
    assert got.dtype == dtype and torch.equal(got, want)
