"""Decode-time state: the contiguous KV cache (full or a ring buffer),
the paged KV pool, the Griffin and RWKV recurrent states and the decode
carry.

Port of ``repro.models.kv_cache``. The contiguous cache is ``(L, B, S,
NKV, H)`` with per-row slot positions (-1 = empty). A full cache keeps
absolute position p in slot p (slot == position); a windowed cache
(``window > 0``, Griffin's local attention) is a ring of S = window
slots that keeps position p in slot p % window (``ring_align``,
``write_slot``), so a live position never collides with another one the
window still sees. The pool is ``(L, num_blocks,
block_size, NKV, H)`` shared by every batch slot, with a ``(B,
max_blocks)`` block table per slot (-1 = unallocated). Pool block 0 is
the reserved trash block: writes from free slots and unallocated virtual
blocks land there and are never read.

Unlike the JAX arrays, the port's caches are written IN PLACE: a decode
step's one-token write, a prefill chunk's kernel epilogue and an
admission's scatter update the tensors they are given, and the cache
object is mutated rather than rebuilt — one resident copy, as the donated
JAX buffers had. Only ``grow_cache`` builds new (larger) tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.quant import reciprocal_f32


@dataclasses.dataclass
class KVCache:
    """k/v: (L, B, S, NKV, H); slot_pos: (L, B, S) absolute position of each
    cache slot per batch row (-1 = empty); length: (B,) tokens written per
    row; k_scale/v_scale (L, B, S, NKV, 1) float32 for an int8 cache.
    Every batch row advances independently, so the continuous scheduler
    holds rows at different depths and admission rewrites one row."""

    k: torch.Tensor
    v: torch.Tensor
    slot_pos: torch.Tensor
    length: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    window: int = 0

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def layer(self, i: int):
        """Layer `i`'s (k, v, slot_pos, k_scale, v_scale) views."""
        if self.quantized:
            return (self.k[i], self.v[i], self.slot_pos[i], self.k_scale[i],
                    self.v_scale[i])
        return self.k[i], self.v[i], self.slot_pos[i], None, None

    @staticmethod
    def init(layers: int, batch: int, size: int, n_kv: int, head_dim: int,
             window: int = 0, dtype=torch.bfloat16, quantized: bool = False,
             device=None) -> "KVCache":
        # A windowed cache is always a window-sized ring (slot p % window
        # must never hold two positions the window still sees), whatever
        # `size` asks for, as in JAX.
        size = window if window else size
        kd = torch.int8 if quantized else dtype
        shape = (layers, batch, size, n_kv, head_dim)
        sshape = (layers, batch, size, n_kv, 1)
        return KVCache(
            k=torch.zeros(shape, dtype=kd, device=device),
            v=torch.zeros(shape, dtype=kd, device=device),
            slot_pos=torch.full((layers, batch, size), -1, dtype=torch.int32,
                                device=device),
            length=torch.zeros((batch,), dtype=torch.int32, device=device),
            k_scale=(torch.zeros(sshape, dtype=torch.float32, device=device)
                     if quantized else None),
            v_scale=(torch.zeros(sshape, dtype=torch.float32, device=device)
                     if quantized else None),
            window=window,
        )


@dataclasses.dataclass
class PagedKVCache:
    """k/v: (L, num_blocks, block_size, NKV, H); block_table (B,
    max_blocks) int32; length (B,) tokens written per row; k_scale/v_scale
    (L, num_blocks, block_size, NKV, 1) float32 for an int8 pool."""

    k: torch.Tensor
    v: torch.Tensor
    block_table: torch.Tensor
    length: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    block_size: int = 16

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def layer(self, i: int):
        """Layer `i`'s (pool_k, pool_v, k_scale, v_scale) views."""
        if self.quantized:
            return self.k[i], self.v[i], self.k_scale[i], self.v_scale[i]
        return self.k[i], self.v[i], None, None

    @staticmethod
    def init(layers: int, batch: int, num_blocks: int, block_size: int,
             max_blocks: int, n_kv: int, head_dim: int,
             dtype=torch.bfloat16, quantized: bool = False,
             device=None) -> "PagedKVCache":
        from repro_torch.kernels.paged_attention import check_block_size

        check_block_size(block_size)
        kd = torch.int8 if quantized else dtype
        shape = (layers, num_blocks, block_size, n_kv, head_dim)
        sshape = (layers, num_blocks, block_size, n_kv, 1)
        return PagedKVCache(
            k=torch.zeros(shape, dtype=kd, device=device),
            v=torch.zeros(shape, dtype=kd, device=device),
            block_table=torch.full((batch, max_blocks), -1, dtype=torch.int32,
                                   device=device),
            length=torch.zeros((batch,), dtype=torch.int32, device=device),
            k_scale=(torch.zeros(sshape, dtype=torch.float32, device=device)
                     if quantized else None),
            v_scale=(torch.zeros(sshape, dtype=torch.float32, device=device)
                     if quantized else None),
            block_size=block_size,
        )


@dataclasses.dataclass
class RecurrentState:
    """Griffin recurrent-block state, stacked over the recurrent layers in
    execution order: h (n_rec, B, W) float32, the RG-LRU hidden state;
    conv_tail (n_rec, B, conv_width - 1, W), the causal conv's last
    inputs. Constant size whatever the context."""

    h: torch.Tensor
    conv_tail: torch.Tensor


@dataclasses.dataclass
class RwkvState:
    """RWKV-6 recurrent state, stacked over layers: wkv (L, B, H, K, V)
    float32, tm_shift / cm_shift (L, B, d) the last token of each row's
    time-mix and channel-mix inputs. Constant size whatever the context."""

    wkv: torch.Tensor
    tm_shift: torch.Tensor
    cm_shift: torch.Tensor


@dataclasses.dataclass
class DecodeCache:
    """Top-level decode carry: pos (B,) int32, the absolute position each
    batch slot decodes at, plus the contiguous cache or the paged pool
    (attention), the Griffin recurrent state beside a ring cache (hybrid)
    or the RWKV state."""

    pos: torch.Tensor
    kv: Optional[Union[KVCache, PagedKVCache]] = None
    rec: Optional[RecurrentState] = None
    rwkv: Optional[RwkvState] = None


def quantize_kv(x: torch.Tensor):
    """Per-(token, head) int8 symmetric quantization of (..., NKV, H):
    scale = absmax * (1/127) — the strength-reduced form the jitted JAX
    code computes, so pool bytes and scales match it bitwise."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = absmax * reciprocal_f32(127)
    inv = torch.where(scale > 0, torch.ones_like(scale) / scale,
                      torch.zeros_like(scale))
    codes = torch.clamp(torch.round(xf * inv), -128, 127)
    return codes.to(torch.int8), scale


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.float32) * scale


def full_slot_pos(layers: int, batch: int, size: int, lengths,
                  device=None) -> torch.Tensor:
    """slot_pos (layers, batch, size) of a full (non-ring) cache, where
    slot == absolute position; slots at or past a row's length (right-pad
    slots, decode headroom) are empty (-1)."""
    s = torch.arange(size, dtype=torch.int32, device=device)
    if lengths is None:
        sp = s[None, :].expand(batch, size)
    else:
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=device)
        sp = torch.where(s[None, :] < lengths[:, None], s[None, :],
                         torch.full_like(s, -1)[None, :])
    return sp[None].expand(layers, batch, size).contiguous()


def ring_align(k_full, v_full, lengths, window: int):
    """Pack whole-prompt K/V (L, B, S, NKV, H) into a ring of `window`
    slots, the invariant ``cache_write`` keeps: position p lives in slot
    p % window. ``lengths`` (B,) counts each row's real (right-padded)
    tokens, None for every row at S. Each row keeps its own last
    min(length, window) positions; empty slots carry slot_pos -1 (their
    values are never read). Returns (k (L, B, window, NKV, H), v,
    slot_pos (L, B, window) int32)."""
    L, Bk, S = k_full.shape[:3]
    dev = k_full.device
    if lengths is None:
        lengths = torch.full((Bk,), S, dtype=torch.int32, device=dev)
    lengths = torch.as_tensor(lengths, dtype=torch.int32).to(dev)
    B = max(Bk, lengths.shape[0])       # degenerate layer stacks keep batch 1
    r = torch.arange(window, dtype=torch.int32, device=dev)
    base = torch.clamp(lengths - window, min=0)[:, None]          # (B, 1)
    # p[b, r]: the one position of [len - window, len) in ring slot r.
    p = base + torch.remainder(r[None, :] - base, window)         # (B, window)
    idx = torch.clamp(p, max=S - 1).long()
    rows = torch.clamp(torch.arange(B, device=dev), max=Bk - 1)[:, None]
    slot_pos = torch.where(p < lengths[:, None], p, torch.full_like(p, -1))
    return (k_full[:, rows, idx], v_full[:, rows, idx],
            slot_pos[None].expand(L, B, window).contiguous())


def write_slot(pos, size: int, window: int):
    """Cache slot of absolute position(s) `pos`: pos itself (clamped to
    the last slot) for a full cache, pos % size for a ring buffer."""
    return pos % size if window > 0 else torch.clamp(pos, max=size - 1)


def row_write(cache, new, slot):
    """Per-row slot write, in place: cache (B, S, ...), new (B, 1, ...),
    slot (B,) — row b writes its own slot."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, slot.long()] = new[:, 0].to(cache.dtype)
    return cache


def cache_write(k_cache, v_cache, slot_pos, k_new, v_new, pos, window: int):
    """Write one token's k/v (B, 1, NKV, H) at per-row absolute positions
    `pos` (B,), in place (one layer's (B, S, ...) views). Returns
    (k_cache, v_cache, slot_pos)."""
    slot = write_slot(pos, k_cache.shape[1], window)
    row_write(k_cache, k_new, slot)
    row_write(v_cache, v_new, slot)
    row_write(slot_pos, pos[:, None].to(torch.int32), slot)
    return k_cache, v_cache, slot_pos


def paged_slot(block_table, pos, block_size: int):
    """Per-row absolute positions (B,) → (pool block (B,), offset (B,));
    unallocated virtual blocks resolve to the trash block 0."""
    idx = torch.clamp(pos // block_size, 0, block_table.shape[1] - 1).long()
    blk = block_table.gather(1, idx[:, None])[:, 0]
    return blk.clamp(min=0).long(), (pos % block_size).long()


def paged_cache_write(pool_k, pool_v, block_table, k_new, v_new, pos,
                      block_size: int, k_scale=None, v_scale=None):
    """Write one token's k/v (B, 1, NKV, H) into one layer's pool at
    per-row positions `pos` (B,), in place; an int8 pool quantizes on the
    way in. Returns (pool_k, pool_v, k_scale, v_scale)."""
    blk, off = paged_slot(block_table, pos, block_size)
    if k_scale is not None:
        k_new, ks = quantize_kv(k_new)
        v_new, vs = quantize_kv(v_new)
        k_scale[blk, off] = ks[:, 0]
        v_scale[blk, off] = vs[:, 0]
    pool_k[blk, off] = k_new[:, 0].to(pool_k.dtype)
    pool_v[blk, off] = v_new[:, 0].to(pool_v.dtype)
    return pool_k, pool_v, k_scale, v_scale


def paged_chunk_write(pool_k, pool_v, blocks, k_new, v_new, start: int,
                      length: int, block_size: int, k_scale=None, v_scale=None):
    """Write one row's chunk (1, Lc, NKV, H) into one layer's pool at
    positions [start, start + length) through the row's table `blocks`
    (mb,), in place. Padded chunk slots and positions whose block is
    unallocated go to the trash block 0. int8 pools quantize on write."""
    Lc = k_new.shape[1]
    dev = pool_k.device
    pos = start + torch.arange(Lc, dtype=torch.int64, device=dev)
    valid = torch.arange(Lc, device=dev) < length
    idx = torch.clamp(pos // block_size, 0, blocks.shape[0] - 1)
    blk = torch.where(valid, blocks.long()[idx].clamp(min=0),
                      torch.zeros_like(idx))
    off = pos % block_size
    k_new, v_new = k_new[0], v_new[0]
    if k_scale is not None:
        k_new, ks = quantize_kv(k_new)
        v_new, vs = quantize_kv(v_new)
        k_scale[blk, off] = ks
        v_scale[blk, off] = vs
    pool_k[blk, off] = k_new.to(pool_k.dtype)
    pool_v[blk, off] = v_new.to(pool_v.dtype)
    return pool_k, pool_v, k_scale, v_scale


def paged_gather(pool_k, pool_v, block_table, k_scale=None, v_scale=None,
                 max_blocks: Optional[int] = None):
    """Gather each row's blocks in table order from one layer's pool:
    (k (B, S, NKV, H), v, kpos (B, S), k_scale, v_scale), S = blocks ·
    block_size, kpos[b, p] = p where row b's block is allocated, else -1."""
    if max_blocks is not None:
        block_table = block_table[:, :max_blocks]
    B, n_blocks = block_table.shape
    bs = pool_k.shape[1]
    tbl = block_table.clamp(min=0).long()
    k_rows = pool_k[tbl].reshape(B, n_blocks * bs, *pool_k.shape[2:])
    v_rows = pool_v[tbl].reshape(B, n_blocks * bs, *pool_v.shape[2:])
    virt = torch.arange(n_blocks * bs, dtype=torch.int32, device=pool_k.device)
    alloc = (block_table >= 0).repeat_interleave(bs, dim=1)
    kpos = torch.where(alloc, virt[None, :], torch.full_like(virt, -1)[None, :])
    ks_rows = vs_rows = None
    if k_scale is not None:
        ks_rows = k_scale[tbl].reshape(B, n_blocks * bs, *k_scale.shape[2:])
        vs_rows = v_scale[tbl].reshape(B, n_blocks * bs, *v_scale.shape[2:])
    return k_rows, v_rows, kpos, ks_rows, vs_rows


def scatter_into_slot(batch: DecodeCache, solo: DecodeCache, slot: int) -> DecodeCache:
    """Admit a solo-prefilled request (batch axis of size 1) into row
    `slot` of a live contiguous decode cache and/or recurrent state, in
    place. Only row `slot` changes: its KV slots past the solo cache's
    are emptied (a ring row is replaced whole: both rings hold `window`
    slots), its Griffin h and conv tail, or its wkv state and both
    token-shift tails, are replaced; every other row's state and
    position is untouched."""
    if batch.kv is not None:
        big, small = batch.kv, solo.kv
        size, s = big.k.shape[2], small.k.shape[2]
        if s > size:
            raise ValueError(f"prefilled cache ({s} slots) exceeds batch cache "
                             f"capacity ({size}); raise the scheduler's max_ctx")
        pairs = [(big.k, small.k, 0), (big.v, small.v, 0),
                 (big.slot_pos, small.slot_pos, -1)]
        if big.quantized:
            pairs += [(big.k_scale, small.k_scale, 0.0),
                      (big.v_scale, small.v_scale, 0.0)]
        for dst, src, fill in pairs:
            dst[:, slot, :s] = src[:, 0].to(dst.dtype)
            dst[:, slot, s:] = fill
        big.length[slot] = small.length[0]
    if batch.rec is not None:
        for name in ("h", "conv_tail"):
            dst = getattr(batch.rec, name)
            dst[:, slot] = getattr(solo.rec, name)[:, 0].to(dst.dtype)
    if batch.rwkv is not None:
        for name in ("wkv", "tm_shift", "cm_shift"):
            dst = getattr(batch.rwkv, name)
            dst[:, slot] = getattr(solo.rwkv, name)[:, 0].to(dst.dtype)
    batch.pos[slot] = solo.pos[0]
    return batch


def scatter_into_paged(batch: DecodeCache, solo: DecodeCache, slot: int,
                       row_blocks) -> DecodeCache:
    """Admit a solo-prefilled request into the paged pool, in place.
    `solo` carries a contiguous full cache (right-padded: slot ==
    absolute position); its virtual block j goes to pool block
    row_blocks[j]. Entries past the allocated prompt blocks are -1 and
    land in the trash block (they hold only right-pad / headroom slots).
    Also writes the row's block table, length and position."""
    return scatter_suffix_into_paged(batch, solo, slot, row_blocks, 0)


def scatter_suffix_into_paged(batch: DecodeCache, solo: DecodeCache, slot: int,
                              row_blocks, start_block: int) -> DecodeCache:
    """Admit a *suffix-only* prefill (a prefix-cache hit) into the paged
    pool, in place. `solo` holds only the uncached tail: its cache slot t
    is absolute position ``start_block * bs + t`` (a suffix always starts
    at a block boundary — only whole prompt blocks are shared), so its
    virtual block j goes to pool block ``row_blocks[start_block + j]``;
    entries past the row's table, or -1, land in the trash block. int8
    pools move their scale planes with the codes. Also writes the row's
    whole block table (shared prefix blocks included), length and
    position."""
    kv: PagedKVCache = batch.kv
    bs = kv.block_size
    s_solo = solo.kv.k.shape[2]
    nb = -(-s_solo // bs)
    pad = nb * bs - s_solo
    row_blocks = torch.as_tensor(row_blocks, dtype=torch.int32).to(kv.k.device)

    def as_blocks(a):
        a = a[:, 0]
        if pad:
            a = torch.nn.functional.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
        return a.reshape(a.shape[0], nb, bs, *a.shape[2:])

    dst = torch.full((nb,), -1, dtype=torch.long, device=kv.k.device)
    n = max(0, min(nb, row_blocks.shape[0] - start_block))
    dst[:n] = row_blocks[start_block:start_block + n].long()
    dst = dst.clamp(min=0)
    kv.k[:, dst] = as_blocks(solo.kv.k).to(kv.k.dtype)
    kv.v[:, dst] = as_blocks(solo.kv.v).to(kv.v.dtype)
    if kv.quantized:
        kv.k_scale[:, dst] = as_blocks(solo.kv.k_scale)
        kv.v_scale[:, dst] = as_blocks(solo.kv.v_scale)
    return set_paged_row(batch, solo, slot, row_blocks)


def set_paged_row(batch: DecodeCache, solo: DecodeCache, slot: int,
                  row_blocks) -> DecodeCache:
    """Admission metadata of a *fully* prefix-cached prompt, in place:
    every prompt position is already resident in shared pool blocks, so
    only row `slot`'s block table, length and decode position change —
    no KV moves. (`solo` is the one-token suffix prefill; only its
    length and position are read.)"""
    kv: PagedKVCache = batch.kv
    mb = kv.block_table.shape[1]
    kv.block_table[slot] = torch.as_tensor(row_blocks, dtype=torch.int32)[:mb].to(
        kv.block_table.device)
    kv.length[slot] = solo.kv.length[0]
    batch.pos[slot] = solo.pos[0]
    return batch


def set_decode_positions(cache: DecodeCache, pos, length) -> DecodeCache:
    """Overwrite every row's decode position and live length, in place, in
    one host-to-device write — the speculative-decode rollback.

    Drafting advances each row's ``pos``/``length`` one token per draft
    step (the decode step advances *all* rows) and the verify chunk sets
    its slot past every drafted position; after greedy acceptance the host
    knows the true position of every row and restores it here. Rejected
    positions' pool bytes are left stale — the position mask hides them
    from every later read, and the row's next writes land there anyway,
    so the whole rollback IS this metadata write."""
    kv: PagedKVCache = cache.kv
    both = torch.as_tensor(np.stack([np.asarray(pos), np.asarray(length)]),
                           dtype=torch.int32).to(cache.pos.device)
    cache.pos.copy_(both[0])
    kv.length.copy_(both[1])
    return cache


def copy_pool_block(cache: DecodeCache, src: int, dst: int) -> DecodeCache:
    """Copy-on-write: duplicate pool block `src` into `dst` in every layer
    (k, v and an int8 pool's scale planes), in place. The allocator calls
    it before a row appends into a block it shares with other rows or
    with the prefix cache: the sharers keep the pristine block, the
    appender writes its private copy. Copying the whole block (slots past
    the row's position included) is safe — a row reads only slots below
    its own position and its next writes overwrite the rest."""
    kv: PagedKVCache = cache.kv
    planes = (kv.k, kv.v) + ((kv.k_scale, kv.v_scale) if kv.quantized else ())
    idx = torch.tensor([dst], dtype=torch.long, device=kv.k.device)
    for a in planes:
        # A copy of the source: with one layer its view is contiguous, and
        # index_copy_ refuses a source that overlaps the tensor it writes.
        a.index_copy_(1, idx, a[:, src:src + 1].clone())
    return cache


def write_pool_block(cache: DecodeCache, dst: int, k, v, k_scale=None,
                     v_scale=None) -> DecodeCache:
    """Write one block's K/V into pool block `dst` in every layer, in
    place: the swap-in half of the host-RAM block tier. `k`/`v` are
    ``(L, block_size, NKV, H)`` in the pool's dtype (int8 codes on a
    quantized pool, with its float32 ``(L, block_size, NKV, 1)`` scale
    planes); they come back verbatim from the host copy the spill took, so
    the block's bytes are the ones it held before. A pinned CPU source
    is copied without blocking the host: the copy is ordered on the
    current stream, and PyTorch's pinned allocator keeps the source's
    memory until the copy has run."""
    kv: PagedKVCache = cache.kv
    planes = (kv.k, kv.v) + ((kv.k_scale, kv.v_scale) if kv.quantized else ())
    blocks = (k, v) + ((k_scale, v_scale) if kv.quantized else ())
    for a, blk in zip(planes, blocks):
        a[:, dst].copy_(torch.as_tensor(blk), non_blocking=True)
    return cache


def grow_cache(cache: DecodeCache, size: int) -> DecodeCache:
    """Extend a full-attention contiguous cache's slot axis to at least
    `size` empty slots, so the static engine decodes past the prefill
    headroom instead of rewriting the last slot through write_slot's
    clamp. Other caches (the paged pool, a recurrent state) pass through
    untouched."""
    kv = cache.kv
    if not isinstance(kv, KVCache) or kv.window or kv.k.shape[2] >= size:
        return cache
    pad = size - kv.k.shape[2]

    def grow(a, fill):
        ext = torch.full((*a.shape[:2], pad, *a.shape[3:]), fill, dtype=a.dtype,
                         device=a.device)
        return torch.cat([a, ext], dim=2)

    return dataclasses.replace(cache, kv=KVCache(
        k=grow(kv.k, 0), v=grow(kv.v, 0), slot_pos=grow(kv.slot_pos, -1),
        length=kv.length,
        k_scale=grow(kv.k_scale, 0.0) if kv.quantized else None,
        v_scale=grow(kv.v_scale, 0.0) if kv.quantized else None,
        window=kv.window))
