"""Sub-byte weight packing: 2-/4-bit signed codes in int8 storage.

Port of the packing half of ``repro.core.bitplane``. Element j of a packed
byte occupies bits [j*b, (j+1)*b) (little-endian), sign-extended on
unpack — the layout of the paper's 32-bit weight vector. Packed bytes are
bitwise those of the JAX package. Packing runs along K (axis 0 of a
(K, N) weight), so a CUDA thread that owns a column reads one byte per
8/b consecutive K elements.
"""
from __future__ import annotations

import torch


def _to_int8(u: torch.Tensor) -> torch.Tensor:
    """uint8-valued int tensor → int8 storage with the same bit pattern."""
    return u.to(torch.uint8).view(torch.int8)


def pack_int4(q: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack int codes in [-8, 7] into int8, two per byte, along `axis`."""
    q = q.movedim(axis, -1)
    if q.shape[-1] % 2:
        raise ValueError("pack_int4 needs an even packing dimension")
    lo = q[..., 0::2] & 0xF
    hi = q[..., 1::2] & 0xF
    return _to_int8(lo | (hi << 4)).movedim(-1, axis)


def unpack_int4(packed: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of pack_int4: int8 storage → int32 sign-extended codes."""
    p = packed.movedim(axis, -1).view(torch.uint8).to(torch.int32)
    lo, hi = p & 0xF, (p >> 4) & 0xF
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    out = torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1], p.shape[-1] * 2)
    return out.movedim(-1, axis)


def pack_int2(q: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack int codes in [-2, 1] into int8, four per byte, along `axis`."""
    q = q.movedim(axis, -1)
    if q.shape[-1] % 4:
        raise ValueError("pack_int2 needs a packing dimension divisible by 4")
    b = [q[..., i::4] & 0x3 for i in range(4)]
    return _to_int8(b[0] | (b[1] << 2) | (b[2] << 4) | (b[3] << 6)).movedim(-1, axis)


def unpack_int2(packed: torch.Tensor, axis: int = -1) -> torch.Tensor:
    p = packed.movedim(axis, -1).view(torch.uint8).to(torch.int32)
    outs = []
    for i in range(4):
        v = (p >> (2 * i)) & 0x3
        outs.append(torch.where(v >= 2, v - 4, v))
    out = torch.stack(outs, dim=-1).reshape(*p.shape[:-1], p.shape[-1] * 4)
    return out.movedim(-1, axis)


def pack_weights(q: torch.Tensor, bits: int, axis: int = 0) -> torch.Tensor:
    """Pack `bits`-bit weight codes for storage; int8 passthrough for 8-bit."""
    if bits == 8:
        return q.to(torch.int8)
    if bits == 4:
        return pack_int4(q, axis=axis)
    if bits == 2:
        return pack_int2(q, axis=axis)
    raise ValueError(f"unsupported weight bits {bits}")


def unpack_weights(packed: torch.Tensor, bits: int, axis: int = 0) -> torch.Tensor:
    if bits == 8:
        return packed.to(torch.int32)
    if bits == 4:
        return unpack_int4(packed, axis=axis)
    if bits == 2:
        return unpack_int2(packed, axis=axis)
    raise ValueError(f"unsupported weight bits {bits}")
