// One attention tile routine for every attention kernel of the port.
//
// Whole-prompt flash attention (flash_attention.cu), paged chunked prefill
// (paged_prefill.cu) and decode over the paged pool or the contiguous
// cache (paged_attention.cu) all fold keys into a query row's online
// softmax through attend_tile below, on key tiles of kBK keys at absolute
// positions [kt * kBK, kt * kBK + kBK). So a row that sees the same keys
// with the same values gets the same bits on every path: chunked prefill
// is bitwise whole-prompt prefill, and paged decode bitwise contiguous
// decode. The order of every reduction is fixed here, with explicit
// round-to-nearest intrinsics so that no call site lets the compiler
// contract or reorder differently:
//   * the score: the dot over d in order 0..H-1 in one lane (lane j holds
//     key j of the tile), times the per-key scale of an int8 cache, times
//     H^-0.5, then the optional tanh softcap;
//   * the tile max and the row sum of p: a butterfly over the 32 lanes;
//   * P.V: each lane owns output dims lane + 32 i and adds p_j v_j for the
//     tile's visible keys j in increasing order.
// A masked key (outside the causal / window range, past the end, or in an
// unallocated or empty slot) contributes nothing: its score is -inf, kept
// out of the max, its p is 0. A tile in which a row sees no key leaves
// that row's (m, l, acc) untouched. Rows that never see a key output 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr int kBK = 32;             // keys per tile: one per lane
constexpr int kHMax = 128;          // head dim a tile holds
constexpr int kDPL = kHMax / 32;    // output dims per lane

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One tile of keys staged in shared memory as float32 (K rows padded to
// kHMax + 1 floats so lanes reading different keys hit different banks);
// ks/vs are the per-key scales of an int8 cache.
struct Tile {
  float k[kBK][kHMax + 1];
  float v[kBK][kHMax];
  float ks[kBK];
  float vs[kBK];
};

// The online-softmax state of one query row, held by one warp: lane owns
// acc[i] for output dim lane + 32 i.
struct Row {
  float m, l, acc[kDPL];
};

__device__ __forceinline__ void row_init(Row& st) {
  st.m = -INFINITY;
  st.l = 0.f;
#pragma unroll
  for (int i = 0; i < kDPL; ++i) st.acc[i] = 0.f;
}

// Fold the tile into one row (called by the whole warp). q: the row's
// query in shared memory, float32. vis: whether this lane's key is
// visible to the row; jlo..jhi bound the visible keys (every visible j
// lies in it). QUANT: scores on int8 codes times ks, probabilities times vs.
template <bool QUANT>
__device__ __forceinline__ void attend_tile(Row& st, const float* __restrict__ q,
                                            const Tile& t, int H, bool vis, int jlo,
                                            int jhi, float scale, float softcap,
                                            int lane) {
  if (!__any_sync(0xffffffffu, vis)) return;     // the row sees no key here
  float s = -INFINITY;
  if (vis) {
    float dot = 0.f;
    for (int d = 0; d < H; ++d) dot = __fmaf_rn(q[d], t.k[lane][d], dot);
    if (QUANT) dot = __fmul_rn(dot, t.ks[lane]);
    s = __fmul_rn(dot, scale);
    if (softcap > 0.f) s = __fmul_rn(softcap, tanhf(__fdiv_rn(s, softcap)));
  }
  const float m_new = fmaxf(st.m, warp_max(s));
  float p = vis ? expf(__fsub_rn(s, m_new)) : 0.f;
  const float alpha = st.m == -INFINITY ? 0.f : expf(__fsub_rn(st.m, m_new));
  st.l = __fmaf_rn(st.l, alpha, warp_sum(p));
  if (QUANT) p = __fmul_rn(p, t.vs[lane]);
#pragma unroll
  for (int i = 0; i < kDPL; ++i) st.acc[i] = __fmul_rn(st.acc[i], alpha);
  for (int j = jlo; j <= jhi; ++j) {
    const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int d = lane + 32 * i;
      if (d < H) st.acc[i] = __fmaf_rn(pj, t.v[j][d], st.acc[i]);
    }
  }
  st.m = m_new;
}

// Write the row's output (H values at o) in the output type.
template <typename OT>
__device__ __forceinline__ void row_store(const Row& st, OT* __restrict__ o, int H,
                                          int lane) {
  const float lz = fmaxf(st.l, 1e-30f);
#pragma unroll
  for (int i = 0; i < kDPL; ++i) {
    const int d = lane + 32 * i;
    if (d < H) o[d] = from_f<OT>(__fdiv_rn(st.acc[i], lz));
  }
}

}  // namespace attn
