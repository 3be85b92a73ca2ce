// The keys a query row of whole-prompt attention sees, shared by the
// flash forward (flash_attention.cu, FlashRows) and its backward
// (flash_attention_bwd.cu), so both walk one mask.
//
// Key j (j < Tk) is visible to query position p iff j >= row_lo(p) and
// j <= row_hi(p): j > p - window when window > 0; under causal j <= p,
// or j < prefix_len (prefix-LM: the prefix attends bidirectionally, the
// rule JAX computes in XLA, repro/models/common.py::_mask_block). One
// contiguous range a row, and both ends are nondecreasing in p, so the
// rows of a tile see keys within [row_lo(first row), row_hi(last row)].
#pragma once

namespace flash {

__device__ __forceinline__ int row_lo(int p, int window) {
  return window ? max(0, p - window + 1) : 0;
}

__device__ __forceinline__ int row_hi(int p, int Tk, int causal, int prefix_len) {
  return causal ? min(max(p, prefix_len - 1), Tk - 1) : Tk - 1;
}

}  // namespace flash
