"""Gradient compression with error feedback: port of the compression half
of ``repro.parallel.collectives``.

int8 block-quantized gradients with error feedback: the residual of each
compression round is added back before the next, so the scheme is
unbiased in the long run. The train step applies the decompressed value,
what every peer reconstructs after an all-reduce of the quantized
payload; on one card it models the value semantics, as in JAX.
``hierarchical_psum`` (a shard_map collective there) waits for the
port's multi-card tooling (ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

import torch

from repro_torch import tree as tr
from repro_torch.core.quant import qmax


def quantize_block(x: torch.Tensor, bits: int = 8, block: int = 256):
    """Per-block symmetric quantization of a flat float32 vector →
    (int8 codes (n_blocks, block), float32 scales (n_blocks, 1))."""
    n = x.numel()
    pad = (-n) % block
    xf = torch.nn.functional.pad(x.reshape(-1).to(torch.float32), (0, pad))
    xb = xf.reshape(-1, block)
    scale = torch.amax(torch.abs(xb), dim=1, keepdim=True) / qmax(bits)
    inv = torch.where(scale > 0, 1.0 / scale, torch.zeros_like(scale))
    q = torch.clamp(torch.round(xb * inv), -qmax(bits) - 1, qmax(bits)).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_block(q: torch.Tensor, scale: torch.Tensor, shape, block: int = 256):
    xb = q.to(torch.float32) * scale
    n = 1
    for s in shape:
        n *= s
    return xb.reshape(-1)[:n].reshape(shape)


def compress_gradients(grads, error, bits: int = 8, block: int = 256):
    """Error-feedback compression → (the compressed tree of (q, scale),
    the new error tree, the decompressed gradients in each leaf's
    dtype)."""
    def one(g, e):
        gf = g.to(torch.float32) + e
        q, s = quantize_block(gf, bits, block)
        deq = dequantize_block(q, s, g.shape, block)
        return (q, s), gf - deq, deq.to(g.dtype)

    flat = [one(g, e) for g, e in zip(tr.leaves(grads), tr.leaves(error))]
    return (tr.unflatten_like(grads, [o[0] for o in flat]),
            tr.unflatten_like(grads, [o[1] for o in flat]),
            tr.unflatten_like(grads, [o[2] for o in flat]))


def init_error(params):
    return tr.map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)


def compressed_bytes(grads, bits: int = 8, block: int = 256) -> int:
    """Wire bytes of the compressed payload (for the roofline accounting)."""
    total = 0
    for g in tr.leaves(grads):
        n = g.numel()
        nb = -(-n // block)
        total += n * bits // 8 + nb * 4
    return total
