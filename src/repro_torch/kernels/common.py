"""Tile arithmetic shared by the port's kernel wrappers.

Port of ``repro.kernels.common``: ``round_up``, and the ceiling division
that ``fused_matmul``, ``bitplane_matmul`` and ``dense_matmul`` plan
their grids with; ``k_slice_lengths``, the K splits the integer
kernels' autotune candidates try. The JAX module's TPU compiler-params
shim has no counterpart here. Beside them ``aligned16``, the 16-byte
alignment the recurrences' kernels load their rows at.
"""
from __future__ import annotations


def cdiv(a: int, b: int) -> int:
    """Ceiling of a / b for positive b."""
    return -(-a // b)


def round_up(x: int, mult: int) -> int:
    """Smallest multiple of `mult` that is >= x."""
    return cdiv(x, mult) * mult


def k_slice_lengths(K: int, tile: int):
    """K-slice lengths, longest first, that cut K into 1, 2, 4, ..., 32
    slices of whole `tile`-wide tiles (no more slices than tiles)."""
    tiles = cdiv(K, tile)
    return sorted({cdiv(tiles, s) * tile for s in (1, 2, 4, 8, 16, 32) if s <= tiles},
                  reverse=True)


def aligned16(t):
    """Tensor `t` contiguous at a 16-byte aligned address (a copy only
    where it is not): the kernels that load 4 elements at once, or copy
    tiles with the TMA, need their rows there."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
