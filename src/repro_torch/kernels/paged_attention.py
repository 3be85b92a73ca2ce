"""CUDA wrapper of the paged flash-decode attention kernel.

Replaces ``repro/kernels/paged_attention.py::paged_attention``: one query
token per row attends the paged KV pool through its block table, with
in-kernel dequantization of an int8 pool (``csrc/paged_attention.cu``).
In bf16 the kernel runs split over the context (one warp per row, KV
head and split of ``SPLIT`` keys, partial results in scratch allocated
here) and a second launch folds the splits in order.

The same kernel code has a second entry, :func:`launch_contig`: one
token per row attends one layer of the contiguous cache (B, S, NKV, H),
each row's slots standing in for its blocks. The static engine and the
contiguous scheduler decode through it, so contiguous and paged decode
sum in one order. With a ``window`` it runs the ring entry over a ring
cache (Griffin's local attention): the row sees the positions of its
window, position p in slot p % S iff the slot's slot_pos is p, in the
same tiles and splits at absolute positions. Its plain version is
``models.common.decode_attention``, which the JAX package computes
outside any Pallas kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: Launches of the CUDA kernel since the last reset (see ops.launch_counts),
#: through any entry; ``contig_launches`` is the full contiguous entry's
#: share, ``ring_launches`` the ring entry's.
launches = 0
contig_launches = 0
ring_launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: ctypes signatures of the C entries (checked against their source by the
#: tests): ``paged_attention``, ``contig_attention`` and ``ring_attention``.
ARGTYPES = [_P] * 10 + [_I] * 9 + [_F, _F, _P]
CONTIG_ATTENTION_ARGTYPES = [_P] * 10 + [_I] * 8 + [_F, _F, _P]
RING_ATTENTION_ARGTYPES = [_P] * 10 + [_I] * 9 + [_F, _F, _P]
_ENTRY_ARGTYPES = {"paged_attention": ARGTYPES,
                   "contig_attention": CONTIG_ATTENTION_ARGTYPES,
                   "ring_attention": RING_ATTENTION_ARGTYPES}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Keys per tile of every attention kernel (csrc/attend_tile.cuh): tiles sit
#: at absolute positions, whatever the pool's block size.
TILE = 32
#: Keys per split (csrc/attend_tile.cuh): bf16 decode runs one warp per
#: (row, KV head, split) and folds the splits in a second launch.
SPLIT = 64
_G_MAX = 16     # query heads per KV head a 16-row tile holds
#: Head dims the attention kernels are instantiated for: every config of
#: the JAX package, full (64-256) and reduced (16).
HEAD_DIMS = (16, 64, 80, 128, 160, 192, 256)


def check_block_size(block_size: int) -> None:
    """A pool block must divide the 32-key tile or be a multiple of it, so
    a tile gathers whole blocks or a block holds whole tiles: any other
    size would change the kernels' summation order, so it raises."""
    if block_size < 1 or (TILE % block_size and block_size % TILE):
        raise ValueError(f"block size {block_size} must divide or be a multiple "
                         f"of the attention kernels' {TILE}-key tile")


def check_heads(NQ: int, NKV: int, H: int) -> None:
    if NQ % NKV or NQ // NKV > _G_MAX or H not in HEAD_DIMS:
        raise ValueError(f"query heads {NQ} must be a multiple (<= {_G_MAX}x) of "
                         f"KV heads {NKV}, head dim one of {HEAD_DIMS} (got {H})")


def ring_splits(window: int) -> int:
    """Splits a window of `window` positions may span, wherever it starts."""
    return -(-(window - 1) // SPLIT) + 1


def _scratch(q, B, NKV, H, keys, window: int = 0):
    """Split scratch of bf16 decode (None, None for float32): each split's
    (O, (m, l)) for the 16 rows of a (row, KV head) tile, float32; one
    slot per split of the `keys` a row may hold, or of one window."""
    if q.dtype != torch.bfloat16:
        return None, None, 0
    ns = ring_splits(window) if window else max(1, -(-keys // SPLIT))
    part_o = torch.empty((B, NKV, ns, 16, H), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B, NKV, ns, 16, 2), dtype=torch.float32, device=q.device)
    return part_o, part_ml, ns


@functools.lru_cache(maxsize=None)
def _fn(entry: str = "paged_attention"):
    fn = getattr(build.load("paged_attention"), entry)
    fn.argtypes = _ENTRY_ARGTYPES[entry]
    fn.restype = _I
    return fn


def check_pool(q, pool_k, pool_v, k_scale, v_scale):
    """Shared dtype/layout checks of the paged kernels' operands."""
    if q.dtype not in _DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    quant = k_scale is not None
    want = torch.int8 if quant else q.dtype
    if pool_k.dtype != want or pool_v.dtype != want:
        raise ValueError(f"pool must be {want} for q {q.dtype} "
                         f"({'int8' if quant else 'unquantized'} pool)")
    tensors = [q, pool_k, pool_v] + ([k_scale, v_scale] if quant else [])
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged kernels need CUDA tensors on one device")
    if not all(t.is_contiguous() for t in tensors[1:]):
        raise ValueError("pool planes must be contiguous (they are written "
                         "or read in place)")
    if quant and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise ValueError("scale planes must be float32")
    return quant


def launch(q, pool_k, pool_v, block_table, q_pos, k_scale=None, v_scale=None,
           softcap: float = 0.0) -> torch.Tensor:
    """q (B, 1, NQ, H); pools (num_blocks, bs, NKV, H); block_table
    (B, max_blocks) int32; q_pos (B,) → (B, 1, NQ, H) in q's dtype."""
    global launches
    quant = check_pool(q, pool_k, pool_v, k_scale, v_scale)
    B, _, NQ, H = q.shape
    nb, bs, NKV, _ = pool_k.shape
    check_heads(NQ, NKV, H)
    check_block_size(bs)
    q = q.contiguous()
    table = block_table.to(device=q.device, dtype=torch.int32).contiguous()
    pos = torch.as_tensor(q_pos).to(device=q.device, dtype=torch.int32).reshape(B)
    out = torch.empty_like(q)
    part_o, part_ml, ns = _scratch(q, B, NKV, H, table.shape[1] * bs)
    null = 0
    rc = _fn()(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
               k_scale.data_ptr() if quant else null,
               v_scale.data_ptr() if quant else null,
               table.data_ptr(), pos.contiguous().data_ptr(), out.data_ptr(),
               null if part_o is None else part_o.data_ptr(),
               null if part_ml is None else part_ml.data_ptr(),
               B, NQ, NKV, H, bs, table.shape[1], ns, _DTYPES[q.dtype], int(quant),
               H ** -0.5, softcap,
               torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "paged_attention")
    launches += 1
    return out


def launch_contig(q, k_cache, v_cache, slot_pos, q_pos, k_scale=None, v_scale=None,
                  softcap: float = 0.0, window: int = 0) -> torch.Tensor:
    """q (B, 1, NQ, H); k/v_cache (B, S, NKV, H); slot_pos (B, S) int32
    (-1 = empty, else the slot's own position; with ``window`` > 0 a ring:
    position p in slot p % S iff slot_pos there is p); q_pos (B,) → (B,
    1, NQ, H) in q's dtype. A window limits row b to the positions
    q_pos[b] - window + 1 .. q_pos[b]."""
    global launches, contig_launches, ring_launches
    quant = check_pool(q, k_cache, v_cache, k_scale, v_scale)
    B, _, NQ, H = q.shape
    _, S, NKV, _ = k_cache.shape
    check_heads(NQ, NKV, H)
    if slot_pos.shape != (B, S):
        raise ValueError(f"slot_pos must be ({B}, {S}), got {tuple(slot_pos.shape)}")
    q = q.contiguous()
    sp = slot_pos.to(device=q.device, dtype=torch.int32).contiguous()
    pos = torch.as_tensor(q_pos).to(device=q.device, dtype=torch.int32).reshape(B)
    out = torch.empty_like(q)
    window = int(window)
    part_o, part_ml, ns = _scratch(q, B, NKV, H, S, window)
    null = 0
    entry = "ring_attention" if window else "contig_attention"
    extent = (S, window) if window else (S,)
    rc = _fn(entry)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quant else null, v_scale.data_ptr() if quant else null,
        sp.data_ptr(), pos.contiguous().data_ptr(), out.data_ptr(),
        null if part_o is None else part_o.data_ptr(),
        null if part_ml is None else part_ml.data_ptr(),
        B, NQ, NKV, H, *extent, ns, _DTYPES[q.dtype], int(quant), H ** -0.5, softcap,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, entry)
    launches += 1
    if window:
        ring_launches += 1
    else:
        contig_launches += 1
    return out
