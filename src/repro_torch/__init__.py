"""PyTorch/CUDA port of the M4BRAM serving stack (``repro``).

The module tree mirrors ``repro``: ``configs``, ``core`` (quantization,
bit-plane packing, precision policies, packed linear layers), ``kernels``
(hand-written CUDA kernels for Hopper plus their plain PyTorch versions),
``models`` (the dense transformer on the paged KV pool), ``serving``
(continuous-batching scheduler and engine) and ``launch`` (the serve CLI).

Nothing here imports JAX or the ``repro`` package. Entry points run on
CUDA unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another device. Asking for CUDA on a machine without a GPU raises —
    nothing silently falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or "
            "--device cpu) to run the plain PyTorch versions on the CPU")
    return dev
