"""CUDA wrapper of the grouped bf16 expert product ``ye[e] = xe[e] @ W[e]``.

Not a port of a Pallas kernel: the JAX package's ``_expert_ffn``
(``repro/models/moe.py:41-55``) leaves it to XLA's ``einsum("ecd,edf->
ecf")``, which multiplies every expert's whole capacity buffer. The
kernel (``csrc/expert_matmul.cu``) is a persistent walk over the live
(expert, column tile, row tile) tiles only, with each expert's row count
read on the device: TMA loads feed ``wgmma`` through a ring of shared
memory. Row r < min(counts[e], cap) is one chain of k16 steps on that row
and W[e] in the slice plan of (K, N)
(:func:`repro_torch.kernels.dense_matmul.plan`), so its bits never follow
the capacity its batch gave the buffer, the counts, E or the tile plan;
on the H100 they are ``dense_matmul``'s bits of the row alone (a ``wgmma``
k16 step rounds as ``mma.sync``'s; ``chip_smoke.check_expert_matmul``
holds it). Rows past the count are zeros, and an expert without rows
reads no weight. So a decode step reads only the experts its rows were
routed to.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import dense_matmul as _dense
from repro_torch.kernels.common import cdiv

#: Launches of the CUDA kernel since the last reset (see ops.launch_counts).
launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
#: ctypes signature of the C entry ``expert_matmul`` (checked against its
#: source by the tests).
ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]

SMS = _dense.SMS        # streaming multiprocessors of an H100 SXM
SMEM = 232448           # shared bytes a block may use on the H100
MAX_STAGES = 24
DECODE_CAP = 8          # buffers this shallow take 64-column tiles


def launch_plan(cap: int, K: int, N: int):
    """(S, slice length, rows per block): the summation order from (K, N)
    alone, as ``dense_matmul`` sums a row; the rows of a block from cap:
    64 (one consumer warpgroup) up to cap = 64 (a decode step's buffers),
    128 (two) above. Both walk every K slice in one block, in the same
    order on the same instruction: no tiling changes a bit."""
    return _dense.plan(K, N), _dense.slice_k(K, N), _rows(cap)


def _rows(cap: int) -> int:
    return _dense.WIDE if cap > 64 else 64


class Schedule(NamedTuple):
    """How the kernel walks (E, cap, K, N): ``bn`` columns a tile, ``bm``
    rows (launch_plan's), ``a_rows`` rows of an A box, ``stages`` of the
    TMA ring, ``smem`` dynamic shared bytes a block, ``grid`` persistent
    blocks (at most one an SM)."""
    bm: int
    bn: int
    a_rows: int
    stages: int
    smem: int
    grid: int


def stage_k(bm: int) -> int:
    """K elements a ring stage: 128 with one consumer warpgroup (twice the
    weight bytes a barrier round trip at decode), 64 with two."""
    return 128 if bm == 64 else 64


def smem_bytes(bm: int, bn: int, a_rows: int, stages: int, E: int) -> int:
    """The kernel's dynamic shared memory (``smem_bytes`` in the source):
    1024 for alignment, the ring (for each of the bm / 64 consumers,
    stage_k / 64 A boxes of ``a_rows`` rows x 64 K; bn / 64 B boxes of
    stage_k rows x 64 columns) with two barriers a stage, and 2 E + 1
    ints of counts."""
    bk = stage_k(bm)
    return (1024 + stages * (bm // 64 * bk // 64 * a_rows * 128 + bn // 64 * bk * 128 + 16)
            + 4 * (2 * E + 1))


@functools.lru_cache(maxsize=None)
def schedule(E: int, cap: int, K: int, N: int) -> Schedule:
    """The schedule of an (E, cap, K, N) product; it never reads the
    counts. Tiles of 64 columns up to cap 8 (a decode step's buffer,
    where a product is a few experts' weight strips and narrower tiles
    spread them over more SMs), 128 up to cap 64, 192 above (fewer bytes
    from L2 an operation than 128, and five ring stages where 256 leaves
    room for four; PERF.md records the other widths' times on the H100);
    A boxes of cap rounded up to 8 rows (at most 64) with one consumer,
    so the ring holds more weight bytes; as many stages as fit the shared
    memory, up to 24; one block an SM, fewer where the buffer holds fewer
    tiles. Every width runs the same chain (:func:`launch_plan`)."""
    bm = _rows(cap)
    bn = (64 if cap <= DECODE_CAP else 128) if bm == 64 else 192
    a_rows = 64 if bm == 128 else min(64, cdiv(cap, 8) * 8)
    per_stage = smem_bytes(bm, bn, a_rows, 1, 0) - smem_bytes(bm, bn, a_rows, 0, 0)
    stages = min(MAX_STAGES, (SMEM - smem_bytes(bm, bn, a_rows, 0, E)) // per_stage)
    if stages < 2:
        raise ValueError(f"expert_matmul: {E} experts leave no room for the ring")
    grid = min(SMS, E * cdiv(cap, bm) * cdiv(N, bn))
    return Schedule(bm, bn, a_rows, stages, smem_bytes(bm, bn, a_rows, stages, E), grid)


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("expert_matmul").expert_matmul
    fn.argtypes = ARGTYPES
    fn.restype = _I
    return fn


def launch(xe: torch.Tensor, w: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """xe (E, cap, K) and w (E, K, N) bfloat16, counts (E,) integer, all on
    one CUDA device → (E, cap, N) bfloat16. Rows at or past an expert's
    count are zeros; the counts are never read on the host."""
    global launches
    if xe.ndim != 3 or w.ndim != 3 or xe.shape[0] != w.shape[0] or xe.shape[2] != w.shape[1]:
        raise ValueError(f"expert_matmul expects xe (E, cap, K) and w (E, K, N), got "
                         f"{tuple(xe.shape)} and {tuple(w.shape)}")
    E, cap, K = xe.shape
    N = w.shape[2]
    if K % 8 or N % 8:
        raise ValueError(f"K and N must be multiples of 8, got {K}, {N}")
    if xe.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"expert_matmul kernel takes bfloat16, got {xe.dtype}, {w.dtype}")
    if counts.shape != (E,):
        raise ValueError(f"counts must be ({E},), got {tuple(counts.shape)}")
    if not (xe.is_cuda and w.device == xe.device and counts.device == xe.device):
        raise ValueError("expert_matmul kernel needs CUDA tensors on one device")
    xe, w = xe.contiguous(), w.contiguous()
    counts = counts.to(torch.int32).contiguous()
    S, sk, bm = launch_plan(cap, K, N)
    sch = schedule(E, cap, K, N)
    y = torch.empty((E, cap, N), dtype=torch.bfloat16, device=xe.device)
    rc = _fn()(xe.data_ptr(), w.data_ptr(), y.data_ptr(), counts.data_ptr(), E, cap, K, N,
               S, sk, bm, sch.bn, sch.a_rows, sch.stages, sch.grid,
               torch.cuda.current_stream(xe.device).cuda_stream)
    build.check(rc, "expert_matmul")
    launches += 1
    return y
