// Shared pieces of the decode and chunked-prefill attention kernels: the
// key sources (the paged pool through a row's block table, or one row of
// the contiguous cache) and the block-level loop over a row's key tiles.
//
// A thread block attends up to kRowsMax query rows that share one KV head.
// It walks the keys in tiles of attn::kBK at absolute positions, the tiles
// of whole-prompt flash attention, gathering each tile's keys from the
// pool blocks it spans (a block size must divide the tile or be a
// multiple of it: the wrappers refuse any other) or from the contiguous
// row, and folds each tile into its rows through attn::attend_tile. So
// the sums run in one order whatever the pool's block size, and paged
// decode, contiguous decode and chunked prefill give the bits of
// whole-prompt prefill for a row that sees the same keys. The math is the
// TPU kernels' (repro/kernels/paged_attention.py _paged_kernel,
// repro/kernels/paged_prefill.py _chunk_kernel): scores on the cache's
// values (int8 codes times the per-key scale for an int8 cache), times
// H^-0.5, optional tanh softcap, probabilities times the per-value scale
// for an int8 cache; keys in unallocated (-1) blocks or empty (-1) slots
// are masked and never loaded as a whole tile; rows that see no key
// output zeros. Tiles past the last query position are never loaded.
#pragma once

#include "attend_tile.cuh"

namespace paged {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsMax = 16;             // query rows per block
constexpr int kRPW = kRowsMax / kWarps;  // rows per warp

using attn::kBK;
using attn::to_f;

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

// Rows: row r = ii * G + g reads q at q_base + ii * ii_stride + g * H and
// sits at absolute position qpos(ii) = ii < n_valid ? pos0 + ii * pos_step
// : -1 (no key visible). out has q's layout. nI * G <= kRowsMax.
template <typename QT, typename KT, bool QUANT, typename Src>
__device__ void attend_rows(const QT* __restrict__ q_base, QT* __restrict__ out_base,
                            long ii_stride, int nI, int G, int H,
                            int pos0, int pos_step, int n_valid,
                            const KT* __restrict__ pool_k, const KT* __restrict__ pool_v,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale, Src src, int NKV,
                            int head, float scale, float softcap) {
  __shared__ float q_s[kRowsMax][attn::kHMax];
  __shared__ attn::Tile tile;
  __shared__ int live_s[kBK];
  const int R = nI * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < R * H; i += kThreads) {
    const int r = i / H, h = i % H;
    q_s[r][h] = to_f(q_base[(long)(r / G) * ii_stride + (r % G) * H + h]);
  }
  attn::Row st[kRPW];
#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) attn::row_init(st[rr]);
  const int n_live = min(nI, n_valid);
  const int last = n_live > 0 ? pos0 + (n_live - 1) * pos_step : -1;
  const int ntiles = last < 0 ? 0 : last / kBK + 1;

  for (int kt = 0; kt < ntiles; ++kt) {
    if (!src.tile_live(kt)) continue;   // wholly unallocated: never loaded
    const int k_lo = kt * kBK;
    __syncthreads();                    // the previous tile's readers are done
    for (int i = tid; i < kBK * H; i += kThreads) {
      const int j = i / H, d = i % H;
      const long sl = src.slot(k_lo + j);
      const long off = (sl * NKV + head) * H + d;
      tile.k[j][d] = sl >= 0 ? to_f(pool_k[off]) : 0.f;
      tile.v[j][d] = sl >= 0 ? to_f(pool_v[off]) : 0.f;
    }
    for (int j = tid; j < kBK; j += kThreads) {
      const long sl = src.slot(k_lo + j);
      live_s[j] = sl >= 0;
      if (QUANT) {
        tile.ks[j] = sl >= 0 ? k_scale[sl * NKV + head] : 0.f;
        tile.vs[j] = sl >= 0 ? v_scale[sl * NKV + head] : 0.f;
      }
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < kRPW; ++rr) {
      const int r = warp * kRPW + rr;
      if (r >= R) continue;                         // warp-uniform
      const int ii = r / G;
      const int qpos = ii < n_valid ? pos0 + ii * pos_step : -1;
      const int jhi = min(kBK - 1, qpos - k_lo);
      attn::attend_tile<QUANT>(st[rr], q_s[r], tile, H, lane <= jhi && live_s[lane],
                               0, jhi, scale, softcap, lane);
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) {
    const int r = warp * kRPW + rr;
    if (r >= R) continue;
    attn::row_store(st[rr], out_base + (long)(r / G) * ii_stride + (r % G) * H, H, lane);
  }
}

}  // namespace paged
