"""Tile arithmetic shared by the port's kernel wrappers.

Port of ``repro.kernels.common``: ``round_up``, and the ceiling division
that ``fused_matmul``, ``bitplane_matmul`` and ``dense_matmul`` plan
their grids with; ``k_slice_lengths``, the K splits the integer
kernels' autotune candidates try. The JAX module's TPU compiler-params
shim has no counterpart here.
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
