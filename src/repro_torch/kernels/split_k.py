"""Scratch of the int8 matmuls' K split, shared by ``fused_matmul`` and
``bitplane_matmul``'s dequant entry (``csrc/split_store.cuh``).

A plan that splits K writes int32 partial tiles, one (M, N) plane per
slice, which are summed in slice order before the dequantized store: by
the last block of each output tile to arrive (decode), found through a
counter per tile that the block resets, or by a fold launch. The
counters are zeroed once per (device, stream) and left zeroed by every
launch, so no launch needs a fill.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def scratch(grid: Tuple[int, int, int], m: int, n: int, device,
            stream: int) -> Tuple[Optional[torch.Tensor], int, int]:
    """For a plan's grid (N tiles, K slices, M tiles): (partial tiles,
    their pointer, the counters' pointer), or (None, 0, 0) for one K
    slice. The partial tiles must live until the launch has run, so the
    caller holds the tensor across it."""
    if grid[1] == 1:
        return None, 0, 0
    tiles = grid[0] * grid[2]
    key = (device.index, stream)
    ctr = _counters.get(key)
    if ctr is None or ctr.numel() < tiles:
        ctr = torch.zeros(max(tiles, 4096), dtype=torch.int32, device=device)
        _counters[key] = ctr
    part = torch.empty((grid[1], m, n), dtype=torch.int32, device=device)
    return part, part.data_ptr(), ctr.data_ptr()
