// Flash-attention forward for Hopper: whole-prompt prefill attention.
//
// Replaces repro/kernels/flash_attention.py::flash_attention (_flash_kernel)
// with the GQA dispatch of repro/kernels/ops.py::flash_attention folded in:
// q (B, Tq, NQ, H) attends k/v (B, Tk, NKV, H), query head h reading KV
// head h / (NQ / NKV) (no repeated K/V in device memory). Key j is
// visible to query i iff j < Tk, j <= q_offset + i (causal) and
// j > q_offset + i - window (window > 0). Scores q.k * H^-0.5 and an
// online softmax in float32, masked keys excluded, a row that sees no key
// outputs zeros; the output has q's dtype. K/V may be float32 while q is
// bf16 (an int8 cache's prefill reads dequantized K/V): they are read in
// their own type, never rounded to bf16.
//
// Bound on the H100: at the prefill shapes (B*NQ = 64 heads of 128, 320
// tokens, bf16) it must read q, k, v and write out once, ~21 MB (6 us at
// 3.35 TB/s), against ~1.7 GFLOP of causal products (2 us at the bf16
// peak), so the bytes bound it. The design is the
// simple one: a block owns (batch*head, 16 query rows), 4 warps of 4 rows
// each; the block stages its queries and 32-key K/V tiles in shared memory
// (float32), and each warp folds each tile into its rows through
// attend_tile.cuh, the routine the paged kernels share, so chunked prefill
// and decode sum in exactly this order. Tiles wholly outside the block's
// causal/window range are never loaded.
//
// Tiles are fixed (16 queries, 32 keys at absolute positions), not sized
// from T: a row's result depends only on its own query and the keys it
// sees, never on the length its batch was padded to, so bucketed prefill
// is bitwise exact-length prefill on the card.

#include "attend_tile.cuh"

namespace {

using attn::kBK;
using attn::kHMax;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 16;             // query rows per block
constexpr int kRPW = kBQ / kWarps;  // rows per warp

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
             const KT* __restrict__ v, QT* __restrict__ out, int Tq, int Tk,
             int NQ, int NKV, int H, int causal, int window, int q_offset,
             float scale) {
  __shared__ float q_s[kBQ][kHMax];
  __shared__ attn::Tile tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y / NQ, h = blockIdx.y % NQ;
  const int kvh = h / (NQ / NKV);
  const int t0 = blockIdx.x * kBQ;
  const int nrows = min(kBQ, Tq - t0);

  for (int i = tid; i < kBQ * H; i += kThreads) {
    const int r = i / H, d = i % H;
    q_s[r][d] = r < nrows ? attn::to_f(q[(((size_t)b * Tq + t0 + r) * NQ + h) * H + d]) : 0.f;
  }

  attn::Row st[kRPW];
#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) attn::row_init(st[rr]);

  // Key tiles any row of this block can see.
  const int q_lo = q_offset + t0, q_hi = q_offset + t0 + nrows - 1;
  int kt0 = 0, kt1 = (Tk + kBK - 1) / kBK;
  if (causal) kt1 = min(kt1, q_hi / kBK + 1);
  if (window && q_lo - window + 1 > 0) kt0 = (q_lo - window + 1) / kBK;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k_lo = kt * kBK;
    __syncthreads();              // the previous tile's readers are done
    for (int i = tid; i < kBK * H; i += kThreads) {
      const int j = i / H, d = i % H, key = k_lo + j;
      const size_t off = (((size_t)b * Tk + key) * NKV + kvh) * H + d;
      tile.k[j][d] = key < Tk ? attn::to_f(k[off]) : 0.f;
      tile.v[j][d] = key < Tk ? attn::to_f(v[off]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < kRPW; ++rr) {
      const int r = warp * kRPW + rr;
      if (r >= nrows) continue;                  // warp-uniform
      const int qpos = q_offset + t0 + r;
      int jhi = min(kBK - 1, Tk - 1 - k_lo);
      if (causal) jhi = min(jhi, qpos - k_lo);
      const int jlo = window ? max(0, qpos - window + 1 - k_lo) : 0;
      attn::attend_tile<false>(st[rr], q_s[r], tile, H, lane >= jlo && lane <= jhi,
                               jlo, jhi, scale, 0.f, lane);
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) {
    const int r = warp * kRPW + rr;
    if (r >= nrows) continue;
    attn::row_store(st[rr], out + (((size_t)b * Tq + t0 + r) * NQ + h) * H, H, lane);
  }
}

template <typename QT, typename KT>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Tq,
           int Tk, int NQ, int NKV, int H, int causal, int window, int q_offset,
           float scale, cudaStream_t st) {
  const dim3 grid((Tq + kBQ - 1) / kBQ, B * NQ);
  flash_kernel<QT, KT><<<grid, kThreads, 0, st>>>(
      (const QT*)q, (const KT*)k, (const KT*)v, (QT*)out, Tq, Tk, NQ, NKV, H,
      causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/out (B, Tq, NQ, H), k/v (B, Tk, NKV, H), all contiguous; q_dtype and
// kv_dtype are 0 = float32, 1 = bfloat16; H <= 128, NQ % NKV == 0.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Tq, int Tk, int NQ, int NKV,
                               int H, int q_dtype, int kv_dtype, int causal,
                               int window, int q_offset, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || Tq <= 0) return (int)cudaGetLastError();
  if (H > kHMax || H <= 0 || NKV <= 0 || NQ % NKV) return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  const int sel = 2 * q_dtype + kv_dtype;
  if (sel == 0) return launch<float, float>(q, k, v, out, B, Tq, Tk, NQ, NKV, H, causal, window, q_offset, scale, st);
  if (sel == 1) return launch<float, bf>(q, k, v, out, B, Tq, Tk, NQ, NKV, H, causal, window, q_offset, scale, st);
  if (sel == 2) return launch<bf, float>(q, k, v, out, B, Tq, Tk, NQ, NKV, H, causal, window, q_offset, scale, st);
  if (sel == 3) return launch<bf, bf>(q, k, v, out, B, Tq, Tk, NQ, NKV, H, causal, window, q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}
