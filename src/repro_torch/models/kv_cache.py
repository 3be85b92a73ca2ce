"""Decode-time state: the paged KV pool and the decode carry.

Port of the paged half of ``repro.models.kv_cache``. The pool is
``(L, num_blocks, block_size, NKV, H)`` shared by every batch slot, with a
``(B, max_blocks)`` block table per slot (-1 = unallocated). Pool block 0
is the reserved trash block: writes from free slots and unallocated
virtual blocks land there and are never read.

Unlike the JAX arrays, the port's pool is written IN PLACE: a decode
step's one-token write and a prefill chunk's kernel epilogue update the
pool tensors they are given, and the cache object is mutated rather than
rebuilt — one resident copy of the pool, as the donated JAX buffers had.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.quant import reciprocal_f32


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
class DecodeCache:
    """Top-level decode carry: pos (B,) int32, the absolute position each
    batch slot decodes at, plus the paged KV pool."""

    pos: torch.Tensor
    kv: Optional[PagedKVCache] = None


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
