// One attention order for every attention kernel of the port.
//
// Whole-prompt flash attention (flash_attention.cu), paged chunked prefill
// (paged_prefill.cu) and decode over the paged pool or the contiguous
// cache (paged_attention.cu) fold keys into a query row's softmax in one
// order, defined here, so a row that sees the same keys with the same
// values gets the same bits on every path: chunked prefill is bitwise
// whole-prompt prefill, paged decode bitwise contiguous decode and both
// bitwise flash's rows.
//
// The order:
//  1. Tiles. Keys come in tiles of kBK = 32 at absolute positions
//     [kt * 32, kt * 32 + 32), whatever the pool's block size (a block
//     size divides 32 or is a multiple of it; the wrappers refuse others).
//  2. Splits. Tiles are grouped into splits of kSplit = 64 keys at
//     absolute positions. kSplit is a constant of the order, never taken
//     from the batch: 64 gives decode at the serve shapes (contexts of a
//     few hundred keys, B = 4, 16 KV heads) 5-8 splits a row, so its grid
//     (B, NKV, splits) fills the card, while each split still amortises
//     its fold over two tiles.
//  3. Within a split a row's (m, l, O) starts at (-inf, 0, 0) and folds
//     the split's tiles in increasing order (the tile step of
//     attend_mma.cuh for bf16, tile_f32 in attend_f32.cuh for float32).
//  4. Across splits each finished split folds into the row's total in
//     increasing split order by fold_ml / fold_o, explicit __fmaf_rn /
//     __fmul_rn / __fadd_rn. Flash and prefill fold inside the block;
//     decode writes each split to scratch and a second launch folds them
//     with the same functions.
//  5. At the end O / max(l, 1e-30): a row that saw no key outputs 0.
// A tile or split in which a row sees no key leaves its state as it was
// (alpha = expf(0) = 1, p = 0), so a kernel that skips such a tile (flash
// outside its causal range, a wholly unallocated paged tile) and one that
// runs it agree.
//
// The bf16 tile step (attend_mma) runs on the tensor cores by
// mma.sync.m16n8k16 (bf16 in, fp32 out), one warp per 16 query rows:
//   S = Q K^T, H/16 k-steps in order; times the int8 cache's per-key
//   scale, then H^-0.5, then the optional tanh softcap; masked keys -inf
//   by select; the row max and row sum over each thread's fragment values
//   in a fixed order, then a quad butterfly; p = expf(s - m), times the
//   int8 per-value scale, rounded to bf16; O += P V by mma with P's
//   S-accumulator fragment reused as the A operand and V read by
//   ldmatrix.trans. mma.sync, not wgmma: wgmma needs 64-row warpgroup
//   tiles that decode (at most 16 query heads a KV head) cannot fill,
//   nothing guarantees its per-element sums are mma.sync's bits, and the
//   order must be one instruction for all three kernels.
// K/V tiles are staged as bf16 (int8 codes widened exactly) by cp.async
// 16-byte copies into a 2-stage ring: the next tile loads while this one
// computes. A key that is masked for every row of the block (unallocated
// or empty slot, past the end, past the block's last query) is staged as
// zeros: the mma multiplies every key of the tile, and 0 * NaN is NaN.
//
// float32 inputs (the card-vs-CPU float32 models, and flash over an int8
// cache's dequantized float32 K/V, which is never rounded to bf16) keep a
// scalar tile step (tile_f32) inside the same split and fold driver: lane
// j scores key j (the dot over d in order), butterfly max and sum over
// the 32 lanes, P.V over the visible keys in order. One order per dtype.
//
// Head dims: every H of the JAX package's configs, 64, 80, 128, 160, 192
// and 256, and 16, the head dim of every reduced config (the card-vs-CPU
// checks run those); each is a template instance (head_dim_ok), and
// tiles above 48 KB live in dynamic shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace attn {

using mma::cp16;
using mma::cp_commit;
using mma::cp_wait_all;
using mma::ldm_x4;
using mma::ldm_x4_t;
using mma::mma16816;
using mma::pack_bf16;

constexpr int kBK = 32;                   // keys per tile
constexpr int kSplit = 64;                // keys per split
constexpr int kTPS = kSplit / kBK;        // tiles per split

inline bool head_dim_ok(int H) {
  return H == 16 || H == 64 || H == 80 || H == 128 || H == 160 || H == 192 || H == 256;
}

// Calls f(Int<H>{}) so f sees the head dim as a compile-time constant;
// cudaErrorInvalidValue for a head dim with no instance.
template <int V> struct Int { static constexpr int value = V; };
template <typename F>
int with_head_dim(int H, F&& f) {
  switch (H) {
    case 16: return f(Int<16>{});
    case 64: return f(Int<64>{});
    case 80: return f(Int<80>{});
    case 128: return f(Int<128>{});
    case 160: return f(Int<160>{});
    case 192: return f(Int<192>{});
    case 256: return f(Int<256>{});
  }
  return (int)cudaErrorInvalidValue;
}

// Allow `bytes` of dynamic shared memory for `kernel` (above 48 KB it
// must be asked for).
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

template <typename T> __device__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ---- the fold across splits (step 4) and the end (step 5) ----------------

// Fold a split's (m, l) into the total (M, L); a and b scale the total's
// and the split's O (fold_o).
__device__ __forceinline__ void fold_ml(float& M, float& L, float m, float l, float& a,
                                        float& b) {
  const float mn = fmaxf(M, m);
  const float mu = mn == -INFINITY ? 0.f : mn;
  a = expf(__fsub_rn(M, mu));
  b = expf(__fsub_rn(m, mu));
  L = __fmaf_rn(L, a, __fmul_rn(l, b));
  M = mn;
}

__device__ __forceinline__ float fold_o(float O, float o, float a, float b) {
  return __fmaf_rn(O, a, __fmul_rn(o, b));
}

__device__ __forceinline__ float finish(float O, float L) {
  return __fdiv_rn(O, fmaxf(L, 1e-30f));
}

// The tile range [kt0, kt1) a block of rows needs (kt1 = kt0 when no row
// sees a key), and the last key position any row sees. Rows: exists(r),
// lo(r) / hi(r) the first / last key position row r may see (hi < lo:
// none), q_off(r) the offset of its H values in q and out.
template <typename Rows>
__device__ __forceinline__ void row_span(const Rows& rows, int nrows, int& kt0, int& kt1,
                                         int& last) {
  int lo = 1 << 30, hi = -1;
  for (int r = 0; r < nrows; ++r) {
    if (!rows.exists(r) || rows.hi(r) < rows.lo(r)) continue;
    lo = min(lo, rows.lo(r));
    hi = max(hi, rows.hi(r));
  }
  last = hi;
  kt0 = hi < 0 ? 0 : lo / kBK;
  kt1 = hi < 0 ? 0 : hi / kBK + 1;
}

// The first tile after kt, before kt1, that may hold a key of the source
// (a wholly unallocated or past-the-end tile is skipped: for every row it
// is the identity).
template <typename Src>
__device__ __forceinline__ int next_live(const Src& src, int kt, int kt1) {
  for (++kt; kt < kt1; ++kt)
    if (src.tile_live(kt)) return kt;
  return kt1;
}

}  // namespace attn

#include "attend_mma.cuh"
#include "attend_f32.cuh"
