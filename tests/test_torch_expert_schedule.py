"""expert_matmul's schedule on the CPU: the shared memory it asks for, the
summation order it keeps (dense_matmul's slice plan of (K, N)), a grid
that depends on the shapes alone, and the persistent walk over the live
tiles. The walk is an emulation in Python of csrc/expert_matmul.cu's
(``locate``, the column parts of the last round, the zeroed rows), kept
in step with the source by hand: ``test_walk_emulates_the_source`` pins
the source lines it copies, so that a change to the kernel's walk fails
it until the emulation follows. Only the card checks the kernel's own
walk (chip_smoke's check_expert_matmul: every element against the plain
version, the zero rows, rows alone at other capacities)."""
from __future__ import annotations

import re

import numpy as np
import pytest

from repro_torch.kernels import build, dense_matmul, expert_matmul
from repro_torch.kernels.common import cdiv

# (E, cap, K, N): chip_smoke's EXPERT_CASES at their capacities (mixtral's
# decode and prefill gate and down, llama4's decode and prefill gate), then
# ragged K and N.
SHAPES = [(8, 8, 6144, 16384), (8, 8, 16384, 6144), (8, 400, 6144, 16384),
          (8, 400, 16384, 6144), (128, 8, 5120, 8192), (128, 16, 5120, 8192),
          (4, 8, 136, 72), (3, 100, 1000, 200), (2, 65, 8, 8), (16, 64, 2056, 4104)]


def _source():
    return (build.CSRC / "expert_matmul.cu").read_text()


@pytest.mark.parametrize("shape", SHAPES)
def test_schedule_fits_shared_memory(shape):
    E, cap, K, N = shape
    sch = expert_matmul.schedule(E, cap, K, N)
    bn = sch.bn
    assert sch.smem <= 232448
    assert sch.smem == expert_matmul.smem_bytes(sch.bm, bn, sch.a_rows, sch.stages, E)
    assert 2 <= sch.stages <= expert_matmul.MAX_STAGES
    # As many stages as fit, up to the cap.
    assert (sch.stages == expert_matmul.MAX_STAGES or expert_matmul.smem_bytes(
        sch.bm, bn, sch.a_rows, sch.stages + 1, E) > 232448)
    # An A box: 64 rows with two consumers, else cap rounded up to 8.
    assert sch.a_rows == (64 if sch.bm == 128 else min(64, -(-cap // 8) * 8))


@pytest.mark.parametrize("shape", SHAPES)
def test_schedule_widths(shape):
    """The width follows cap: 64 up to cap 8, 128 up to cap 64, 192
    above. The source instantiates this shape's (width, rows, K split),
    and no other plan than those the schedule reaches."""
    E, cap, K, N = shape
    sch = expert_matmul.schedule(E, cap, K, N)
    one = dense_matmul.plan(K, N) == 1
    assert sch.bn == (64 if cap <= 8 else 128 if cap <= 64 else 192)
    src = _source()
    assert f"EXPERT_PLAN({sch.bn}, {sch.bm}, {'false' if one else 'true'})" in src
    plans = set(re.findall(r"^  EXPERT_PLAN\((\d+), (\d+), (\w+)\)$", src, re.M))
    assert plans == {(bn, bm, split) for bn, bm in (("64", "64"), ("128", "64"), ("192", "128"))
                     for split in ("false", "true")}


@pytest.mark.parametrize("shape", SHAPES)
def test_schedule_keeps_the_slice_plan(shape):
    E, cap, K, N = shape
    S, sk, bm = expert_matmul.launch_plan(cap, K, N)
    assert (S, sk) == (dense_matmul.plan(K, N), dense_matmul.slice_k(K, N))
    assert bm == expert_matmul.schedule(E, cap, K, N).bm == (128 if cap > 64 else 64)
    # The slices cover padded K in whole 128-wide tiles, none empty.
    assert sk % 128 == 0 and sk * S >= K and sk * (S - 1) < K


@pytest.mark.parametrize("shape", SHAPES)
def test_grid_follows_the_shapes_alone(shape):
    E, cap, K, N = shape
    sch = expert_matmul.schedule(E, cap, K, N)
    assert "counts" not in expert_matmul.schedule.__wrapped__.__code__.co_varnames
    assert sch == expert_matmul.schedule.__wrapped__(E, cap, K, N)
    assert sch.grid == min(expert_matmul.SMS, E * cdiv(cap, sch.bm) * cdiv(N, sch.bn))
    assert 1 <= sch.grid <= 132


def test_source_constants_match_the_schedule():
    """The C source sizes shared memory as ``smem_bytes`` does and takes
    the schedule's fields."""
    src = _source()
    assert "constexpr int kMaxSmem = %d;" % expert_matmul.SMEM in src
    assert "static constexpr int BK = WGS == 1 ? 128 : 64;" in src
    assert (expert_matmul.stage_k(64), expert_matmul.stage_k(128)) == (128, 64)
    body = re.search(r"inline long long smem_bytes\([^)]*\) \{\s*const int bk = wgs == 1 "
                     r"\? 128 : 64;\s*return ([^;]*);", src).group(1)
    assert re.sub(r"\s+", " ", body) == (
        "1024LL + (long long)stages * (wgs * bk / 64 * a_rows * 128 + bn / 64 * bk * 128 + "
        "16) + 4LL * (2 * E + 1)")
    params = re.search(r'extern "C" int expert_matmul\(([^)]*)\)', src).group(1)
    names = [p.split()[-1].lstrip("*") for p in params.split(",")]
    assert names[-6:] == ["bm", "bn", "a_rows", "stages", "grid", "stream"]


def _walk(E, cap, N, kept, sch):
    """The kernel's walk: each block's units u = block, + grid, ... over the
    live (expert, column tile, row tile) tiles, the last partial round's
    tiles cut into f column parts, and the rows each consumer warpgroup
    computes, stores as zeros, or that the dead-region pass zeroes.
    Returns (units by block as (e, mt, n0, columns), computed, zeroed),
    the last two as (E, cap, N) counts of writes."""
    bm, bn, G = sch.bm, sch.bn, sch.grid
    n_tiles, boxes = cdiv(N, bn), bn // 64
    live = [cdiv(m, bm) for m in kept]
    pre = np.concatenate([[0], np.cumsum(live)])
    tiles = int(pre[-1]) * n_tiles
    full_units = tiles // G * G
    r = tiles - full_units
    f = next((d for d in range(boxes, 1, -1) if boxes % d == 0 and r * d <= G), 1)
    computed = np.zeros((E, cap, N), np.int32)
    zeroed = np.zeros((E, cap, N), np.int32)
    by_block = []
    for b in range(G):
        e, mine = 0, []
        for u in range(b, full_units + r * f, G):
            t, part, nb = u, 0, boxes
            if u >= full_units:
                t, part, nb = full_units + (u - full_units) // f, (u - full_units) % f, boxes // f
            while pre[e + 1] * n_tiles <= t:
                e += 1
            local = t - pre[e] * n_tiles
            mt, n0 = local % live[e], local // live[e] * bn + part * nb * 64
            mine.append((e, mt, n0, nb * 64))
            cols = slice(n0, min(n0 + nb * 64, N))
            for wg in range(bm // 64):
                r0 = mt * bm + wg * 64
                rows = slice(r0, min(r0 + 64, cap))
                if r0 < kept[e]:
                    computed[e, rows.start:min(rows.stop, kept[e]), cols] += 1
                    zeroed[e, kept[e]:rows.stop, cols] += 1
                else:
                    zeroed[e, rows, cols] += 1
        by_block.append(mine)
    for e in range(E):
        zeroed[e, min(live[e] * bm, cap):] += 1
    return by_block, computed, zeroed


@pytest.mark.parametrize("E,cap,K,N,seed", [
    (8, 400, 128, 640, 0), (8, 8, 128, 384, 1), (128, 16, 128, 256, 2), (5, 130, 128, 72, 3),
    (4, 64, 128, 136, 4), (8, 400, 16384, 6144, 5), (8, 8, 16384, 6144, 6),
    (8, 400, 6144, 16384, 7)])
def test_walk_covers_each_element_once(E, cap, K, N, seed):
    """Every kept row's element is computed exactly once, every element
    past the count written as zero exactly once, by some block; an expert
    without rows has no tile; an expert's row tiles are adjacent in the
    walk; the last round reaches no block twice."""
    rng = np.random.default_rng(seed)
    kept = [int(min(c, cap)) for c in rng.integers(0, 2 * cap, E)]
    kept[0], kept[-1] = 0, cap
    sch = expert_matmul.schedule(E, cap, K, N)
    if N > 1024:          # the walk at its real grid, a narrow slice of the columns
        N, sch = 1024 if sch.bn != 192 else 1152, sch._replace(grid=sch.grid // 8)
    by_block, computed, zeroed = _walk(E, cap, N, kept, sch)
    want = np.arange(cap)[None, :, None] < np.asarray(kept)[:, None, None]
    want = np.broadcast_to(want, (E, cap, N))
    assert (computed == want).all() and (zeroed == ~want).all()
    units = sorted(t for mine in by_block for t in mine)
    assert len(units) == len(set(units)) and all(kept[e] for e, _, _, _ in units)
    order = [t for i in range(max(map(len, by_block)))
             for t in (mine[i] for mine in by_block if i < len(mine))]
    assert [(e, n0 // sch.bn, mt) for e, mt, n0, _ in order] == sorted(
        (e, n0 // sch.bn, mt) for e, mt, n0, _ in order)
    assert max(map(len, by_block)) - min(map(len, by_block)) <= 1


def test_last_round_cut_into_column_parts():
    """mixtral's w_down at cap 16 (128-column tiles), six experts live:
    288 tiles on 132 blocks leave 24 for a third round; cut in two, they
    reach 48 blocks, 64 columns each."""
    sch = expert_matmul.schedule(8, 16, 16384, 6144)
    kept = [1, 2, 1, 16, 2, 1, 0, 0]
    assert sch.bn == 128
    by_block, _, _ = _walk(8, 16, 6144, kept, sch)
    assert sch.grid == 132 and sum(map(len, by_block)) == 264 + 48
    assert sorted({len(m) for m in by_block}) == [2, 3]
    assert all(m[2][3] == 64 for m in by_block if len(m) == 3)


def test_every_count_zero_walks_no_tile():
    sch = expert_matmul.schedule(8, 8, 6144, 16384)
    by_block, computed, zeroed = _walk(8, 8, 256, [0] * 8, sch._replace(grid=4))
    assert not any(by_block) and not computed.any() and (zeroed == 1).all()


def test_walk_emulates_the_source():
    """The source lines that ``_walk`` copies, word for word: the units
    of the full rounds and the last one's column parts, ``locate``, the
    consumer that computes, and the rows zeroed before the walk. A change
    to any of them fails here until ``_walk`` follows it."""
    src = re.sub(r"\s+", " ", _source())
    for line in (
            "const int G = gridDim.x, tiles = pre[E] * n_tiles;",
            "const int full_units = tiles / G * G, r = tiles - full_units;",
            "int f = 1; for (int d = kBoxes; d > 1; --d) if (kBoxes % d == 0 && r * d <= G) "
            "{ f = d; break; }",
            "const int units = full_units + r * f;",
            "auto locate = [&](int u, int& e, int& mt, int& n0, int& nb) { int t = u, part = 0; "
            "nb = kBoxes; if (u >= full_units) { t = full_units + (u - full_units) / f; "
            "part = (u - full_units) % f; nb = kBoxes / f; } "
            "while (pre[e + 1] * n_tiles <= t) ++e; "
            "const int local = t - pre[e] * n_tiles, live = pre[e + 1] - pre[e]; "
            "mt = local % live; n0 = local / live * BN + part * nb * 64; };",
            "for (int u = blockIdx.x; u < n_units; u += G) {",
            "const int m0 = mt * BM + wg * kRows; const bool busy = m0 < m;",
            "const int r0 = min((pre[e + 1] - pre[e]) * BM, cap);",
            "int v = e < E ? (rows[e] + BM - 1) / BM : 0;"):
        assert line in src, line
