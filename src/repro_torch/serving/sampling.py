"""Vectorized sampling for the serving stack: greedy, temperature and
top-k with per-slot parameters, in one call for the whole batch.

Reproducibility contract (as in ``repro.serving.sampling``): a request's
sample stream is a pure function of ``(seed, rid, step)``. The random
numbers come from a counter-based generator — a 32-bit integer hash of
(request key, step, vocabulary index) evaluated with integer tensor ops —
so they do not depend on batch composition, slot assignment, admission
order, or on the device. Sampling is Gumbel-max over the top-k-masked,
temperature-scaled logits. The bits differ from JAX's threefry stream;
greedy slots (temperature <= 0) are exact argmaxes in both.
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _mix32(x):
    """lowbias32 integer hash (Wellons), on uint32 values held in int64
    tensors or Python ints; products wrap and are masked back to 32 bits."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def request_key(seed: int, rid: int) -> np.ndarray:
    """Per-request base key (2,) uint32; the stream identity is (seed, rid)."""
    k0 = _mix32(_mix32(seed & _M32) ^ (rid & _M32))
    k1 = _mix32(k0 ^ 0x9E3779B9 ^ ((rid >> 32) & _M32))
    return np.asarray([k0, k1], np.uint32)


def uniforms(keys: torch.Tensor, steps: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B, V) float32 uniforms in (0, 1) for keys (B, 2) and steps (B,):
    element (b, v) is a hash of (keys[b], steps[b], v) alone."""
    dev = keys.device
    k0, k1 = keys[:, 0:1], keys[:, 1:2]
    s = _mix32(k0 ^ _mix32(steps[:, None] + k1))
    v = torch.arange(vocab, dtype=torch.int64, device=dev)[None, :]
    h = _mix32(s ^ _mix32(v * 0x9E3779B1 + k1))
    # 24 high bits → (0, 1): exact in float32, never 0 or 1.
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def sample_tokens(logits, temperatures, top_ks, base_keys, steps) -> torch.Tensor:
    """logits (B, V) float; temperatures (B,); top_ks (B,) int; base_keys
    (B, 2) uint32; steps (B,) int → tokens (B,) int32. temperature <= 0
    means greedy for that slot (its key and step are unused)."""
    logits = logits.to(torch.float32)
    dev = logits.device
    B, V = logits.shape
    temps = torch.as_tensor(np.asarray(temperatures, np.float32), device=dev)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not bool((temps > 0).any()):
        return greedy
    top_ks = torch.as_tensor(np.asarray(top_ks, np.int64), device=dev)
    keys = torch.as_tensor(np.asarray(base_keys, np.int64), device=dev)
    steps = torch.as_tensor(np.asarray(steps, np.int64), device=dev)
    # top-k: keep logits >= the k-th largest; k <= 0 or k >= V keeps all.
    kk = torch.where((top_ks <= 0) | (top_ks >= V), torch.full_like(top_ks, V), top_ks)
    srt = torch.sort(logits, dim=-1, descending=True).values
    thresh = srt.gather(1, (kk - 1).clamp(min=0)[:, None])
    masked = torch.where(logits >= thresh, logits,
                         torch.full_like(logits, torch.finfo(torch.float32).min))
    gumbel = -torch.log(-torch.log(uniforms(keys, steps, V)))
    temp = temps.clamp(min=1e-6)[:, None]
    sampled = torch.argmax(masked / temp + gumbel, dim=-1).to(torch.int32)
    return torch.where(temps > 0, sampled, greedy)
