// Shared pieces of the decode and chunked-prefill attention kernels: the
// key sources (the paged pool through a row's block table, one row of the
// full contiguous cache, or one row of a ring cache) and the query rows of
// a thread block.
//
// A key source maps an absolute key position to its token slot (-1: an
// unallocated block or an empty slot), so a tile of attn::kBK keys at
// absolute positions gathers its keys from the pool blocks it spans (a
// block size must divide the tile or be a multiple of it: the wrappers
// refuse any other) or from the contiguous row. Every kernel then folds
// the tiles through the drivers of attend_tile.cuh, so the sums run in
// one order whatever the pool's block size, and paged decode, contiguous
// decode and chunked prefill give the bits of whole-prompt prefill for a
// row that sees the same keys. The math is the TPU kernels'
// (repro/kernels/paged_attention.py _paged_kernel,
// repro/kernels/paged_prefill.py _chunk_kernel): scores on the cache's
// values (int8 codes times the per-key scale for an int8 cache), times
// H^-0.5, optional tanh softcap, probabilities times the per-value scale
// for an int8 cache; keys in unallocated (-1) blocks or empty (-1) slots
// are masked and staged as zeros, wholly unallocated tiles are never
// loaded; rows that see no key output zeros.
#pragma once

#include "attend_tile.cuh"

namespace paged {

constexpr int kGMax = 16;                // query heads per KV head
using attn::kBK;

// Keys of one row in the paged pool: position pos lives in token slot
// tbl[pos / bs] * bs + pos % bs, or nowhere (-1) if its block is unallocated.
struct PagedSrc {
  const int* tbl;
  int ntbl, bs;
  __device__ long slot(int pos) const {
    const int jb = pos / bs;
    if (jb >= ntbl) return -1;
    const int blk = tbl[jb];
    return blk < 0 ? -1 : (long)blk * bs + pos % bs;
  }
  // Whether any key of tile kt may be live (block-uniform, no sync).
  __device__ bool tile_live(int kt) const {
    const int lo = kt * kBK / bs, hi = (kt * kBK + kBK - 1) / bs;
    for (int jb = lo; jb <= hi && jb < ntbl; ++jb)
      if (tbl[jb] >= 0) return true;
    return false;
  }
};

// Keys of row b of a full contiguous cache (B, S, NKV, H): slot ==
// position, a slot whose slot_pos is -1 is empty.
struct ContigSrc {
  const int* slot_pos;   // the row's (S,) slot positions
  int S;
  long base;             // b * S
  __device__ long slot(int pos) const {
    return pos < S && slot_pos[pos] >= 0 ? base + pos : -1;
  }
  __device__ bool tile_live(int kt) const { return kt * kBK < S; }
};

// Keys of row b of a ring cache (B, S, NKV, H) (a windowed cache, S =
// window): position pos lives in slot pos % S iff that slot's slot_pos is
// pos; otherwise the slot holds another position of the ring or is empty
// (-1) and pos has no key. Tiles stay at absolute positions, so a ring row
// folds its keys in the order a full row (or flash) folds the same keys.
struct RingSrc {
  const int* slot_pos;   // the row's (S,) slot positions
  int S;
  long base;             // b * S
  __device__ long slot(int pos) const {
    const int s = pos % S;
    return slot_pos[s] == pos ? base + s : -1;
  }
  __device__ bool tile_live(int) const { return true; }
};

// Query rows of a block: row r = ii * G + g (r < R) reads q at
// ii * ii_stride + g * H (relative to the block's base) and sits at
// absolute position pos0 + ii * pos_step if ii < n_valid; a padded query
// (ii >= n_valid) sees no key. out has q's layout.
struct Rows {
  long ii_stride;
  int R, G, H, pos0, pos_step, n_valid;
  __device__ bool exists(int r) const { return r < R; }
  __device__ int lo(int) const { return 0; }
  __device__ int hi(int r) const {
    const int ii = r / G;
    return ii < n_valid ? pos0 + ii * pos_step : -1;
  }
  __device__ long q_off(int r) const { return (long)(r / G) * ii_stride + (long)(r % G) * H; }
};

// The one query position of a decode row (Rows with n_valid 1) and the
// first key position it sees: `first` is 0 for a full cache and
// max(0, q_pos - window + 1) under a sliding window.
struct DecodeRows : Rows {
  int first;
  __device__ int lo(int) const { return first; }
};

}  // namespace paged
