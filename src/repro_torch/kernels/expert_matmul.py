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

Training adds the product's gradient (:class:`ExpertMatmul`, whose
backward is ``csrc/expert_matmul_bwd.cu``: :func:`launch_dx` for dX = dY
W^T on the kept rows, :func:`launch_dw` for dW = X^T dY over the kept
rows only), the counts read on the device there too, every sum one chain
in a fixed order inside one block, so a repeat gives the same bits.
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
#: Launches of the backward's two entries (dX and dW) since the last reset
#: (``expert_matmul_bwd`` in ops.launch_counts).
bwd_launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
#: ctypes signature of the C entry ``expert_matmul`` (checked against its
#: source by the tests).
ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
#: ctypes signatures of the backward's C entries ``expert_matmul_bwd_dx``
#: and ``expert_matmul_bwd_dw`` (checked against their source by the tests).
BWD_ARGTYPES = {"expert_matmul_bwd_dx": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
                "expert_matmul_bwd_dw": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]}

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


def _check(what, a, b, counts, K: int, N: int, fits: bool):
    """Validate an entry's operands: bfloat16 3-D CUDA tensors on one
    device whose shapes fit (`fits`), K and N multiples of 8, counts
    (E,). Raises ValueError; no entry falls back to the plain version."""
    if not fits:
        raise ValueError(f"{what}: operands {tuple(a.shape)} and {tuple(b.shape)} do not fit")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise ValueError(f"{what} kernel takes bfloat16, got {a.dtype}, {b.dtype}")
    if K % 8 or N % 8:
        raise ValueError(f"{what}: K and N must be multiples of 8, got {K}, {N}")
    if counts.shape != (a.shape[0],):
        raise ValueError(f"counts must be ({a.shape[0]},), got {tuple(counts.shape)}")
    if not (a.is_cuda and b.device == a.device and counts.device == a.device):
        raise ValueError(f"{what} kernel needs CUDA tensors on one device")


def launch(xe: torch.Tensor, w: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """xe (E, cap, K) and w (E, K, N) bfloat16, counts (E,) integer, all on
    one CUDA device → (E, cap, N) bfloat16. Rows at or past an expert's
    count are zeros; the counts are never read on the host."""
    global launches
    fits = xe.ndim == 3 and w.ndim == 3 and xe.shape[0] == w.shape[0] and \
        xe.shape[2] == w.shape[1]
    _check("expert_matmul", xe, w, counts, xe.shape[-1], w.shape[-1], fits)
    E, cap, K = xe.shape
    N = w.shape[2]
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


# -- the gradient ---------------------------------------------------------------

BWD_BN = 128          # output columns a backward block
BWD_MAX_STAGES = 8


class BwdSchedule(NamedTuple):
    """How a backward entry covers its output: ``bm`` rows and 128 columns
    a block, ``stages`` of the TMA ring (64 reduced elements each). The C
    entry derives its grid (column tiles, row tiles, E) and shared bytes
    from these and the shape."""
    bm: int
    stages: int


def bwd_smem_bytes(bm: int, stages: int) -> int:
    """The backward's dynamic shared memory (``smem_bytes`` in the source):
    1024 for alignment, then a stage a 64 x 64 bf16 box for each of the bm
    / 64 consumers, the 128 x 64 B tile and two barriers."""
    return 1024 + stages * (bm // 64 * 8192 + BWD_BN * 128 + 16)


def _bwd_schedule(bm: int) -> BwdSchedule:
    per = bwd_smem_bytes(bm, 1) - bwd_smem_bytes(bm, 0)
    return BwdSchedule(bm, min(BWD_MAX_STAGES, (SMEM - bwd_smem_bytes(bm, 0)) // per))


@functools.lru_cache(maxsize=None)
def schedule_dx(E: int, cap: int, K: int, N: int) -> BwdSchedule:
    """dX's blocks: a row tile of the buffer (64 rows up to cap 64, 128
    above: the forward's rule) by 128 columns of K, every expert; the tiles
    past an expert's count store zeros and read nothing. Never the
    counts."""
    return _bwd_schedule(_rows(cap))


@functools.lru_cache(maxsize=None)
def schedule_dw(E: int, cap: int, K: int, N: int) -> BwdSchedule:
    """dW's blocks: 128 rows of K by 128 columns of N, every expert, each
    summing over the expert's kept rows only. Never the counts."""
    return _bwd_schedule(128)


@functools.lru_cache(maxsize=None)
def _bwd_fn(entry: str):
    fn = getattr(build.load("expert_matmul_bwd"), entry)
    fn.argtypes = BWD_ARGTYPES[entry]
    fn.restype = _I
    return fn


def launch_dx(dy: torch.Tensor, w: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """dy (E, cap, N) and w (E, K, N) bfloat16, counts (E,) integer, on one
    CUDA device → dx (E, cap, K) bfloat16: dy[e] w[e]^T on the rows below
    each expert's count, zeros from it on."""
    global bwd_launches
    fits = dy.ndim == 3 and w.ndim == 3 and dy.shape[0] == w.shape[0] and \
        dy.shape[2] == w.shape[2]
    _check("expert_matmul_bwd_dx", dy, w, counts, w.shape[1] if fits else 0,
               dy.shape[-1], fits)
    dy, w = dy.contiguous(), w.contiguous()
    counts = counts.to(torch.int32).contiguous()
    E, cap, N = dy.shape
    K = w.shape[1]
    sch = schedule_dx(E, cap, K, N)
    dx = torch.empty((E, cap, K), dtype=torch.bfloat16, device=dy.device)
    rc = _bwd_fn("expert_matmul_bwd_dx")(
        dy.data_ptr(), w.data_ptr(), dx.data_ptr(), counts.data_ptr(), E, cap, K, N, sch.bm,
        sch.stages, torch.cuda.current_stream(dy.device).cuda_stream)
    build.check(rc, "expert_matmul_bwd_dx")
    bwd_launches += 1
    return dx


def launch_dw(xe: torch.Tensor, dy: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """xe (E, cap, K) and dy (E, cap, N) bfloat16, counts (E,) integer, on
    one CUDA device → dw (E, K, N) bfloat16: xe[e]^T dy[e] over the rows
    below each expert's count only (the kernel masks the rest, whatever
    they hold); zeros for an expert with count 0."""
    global bwd_launches
    fits = xe.ndim == 3 and dy.ndim == 3 and xe.shape[:2] == dy.shape[:2]
    _check("expert_matmul_bwd_dw", xe, dy, counts, xe.shape[-1], dy.shape[-1], fits)
    xe, dy = xe.contiguous(), dy.contiguous()
    counts = counts.to(torch.int32).contiguous()
    E, cap, K = xe.shape
    N = dy.shape[2]
    sch = schedule_dw(E, cap, K, N)
    dw = torch.empty((E, K, N), dtype=torch.bfloat16, device=xe.device)
    rc = _bwd_fn("expert_matmul_bwd_dw")(
        xe.data_ptr(), dy.data_ptr(), dw.data_ptr(), counts.data_ptr(), E, cap, K, N,
        sch.stages, torch.cuda.current_stream(xe.device).cuda_stream)
    build.check(rc, "expert_matmul_bwd_dw")
    bwd_launches += 1
    return dw


class ExpertMatmul(torch.autograd.Function):
    """:func:`launch` with its gradient: the backward runs
    :func:`launch_dx` and :func:`launch_dw` (each only where its input
    needs a gradient). The counts get none."""

    @staticmethod
    def forward(ctx, xe, w, counts):
        ctx.save_for_backward(xe, w, counts)
        return launch(xe, w, counts)

    @staticmethod
    def backward(ctx, g):
        xe, w, counts = ctx.saved_tensors
        dx = launch_dx(g, w, counts) if ctx.needs_input_grad[0] else None
        dw = launch_dw(xe, g, counts) if ctx.needs_input_grad[1] else None
        return dx, dw, None
