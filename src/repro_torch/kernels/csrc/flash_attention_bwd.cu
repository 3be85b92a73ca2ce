// Flash-attention backward for Hopper: dQ, dK and dV of whole-prompt
// attention, the gradient of flash_attention.cu under autograd.
//
// Replaces no Pallas kernel: the JAX package differentiates its XLA
// attention (repro/models/common.py::chunked_attention) and no Pallas
// kernel there has a VJP. The port's forward is the flash kernel, so its
// gradient is a kernel too. q/dO/O/dQ (B, Tq, NQ, H), k/v/dK/dV (B, Tk,
// NKV, H), all float32 or all bfloat16; query head h reads KV head
// h / (NQ / NKV). Every mask of the forward: causal, bidirectional,
// prefix-LM, window, q_offset (flash_rows.cuh, the forward's ranges).
//
// With P = softmax(Q K^T * s) over the visible keys (s = H^-0.5),
// O = P V and dO given:
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D) with D = rowsum(dO * O),
//   dQ = s * dS K,  dK = s * dS^T Q.
// P is exp(S s - lse), the row's log-sum-exp recomputed here from Q and K
// (the forward writes none, so it runs unchanged). A row that sees no key
// has lse = +inf and P = 0 by select: its dQ is 0 and it adds nothing to
// dK, dV (zero gradients, never NaN). Two routes, one a dtype, each in an
// order fixed by the shapes: no atomics, the same bits on every run.
//
// bfloat16: the tensor cores (mma.sync m16n8k16, bf16 operands, float32
// accumulators, operands read by ldmatrix / ldmatrix.trans: the forward's
// idiom, attend_mma.cuh). Two kernels, launched in order on one stream:
//  (a) rows: one block per (b, query head, 64 query rows), 4 warps of 16
//      rows, Q and dO resident in shared memory, K/V tiles in a 2-stage
//      cp.async ring. D = rowsum(dO * O) first; then one walk over the
//      rows' visible key tiles: S = Q K^T and dP = dO V^T, each row's max
//      and sum folded online as in the forward, and dQ with them (the
//      partial sum rescaled when the max moves, divided by the sum at the
//      end), dS rounded to bf16 straight from the S fragments into the A
//      operand of dQ += dS K. lse and D go to float32 scratch for (b).
//      dQ by design (a), a walk of its own, not (b), dS written to
//      scratch: the walk recomputes S and dP, about 8.6 GFLOP at the
//      training shape (under 10 us of tensor cores), where a bf16 dS
//      would cost B * NQ * Tq * Tk * 2 bytes (67 MB there, 34 MB of it
//      visible) written and read back, and memory that grows with T^2.
//  (b) dkdv: one block per (b, KV head, 32 or 64 keys), two warps per 16
//      keys. K and V stay in shared memory as bf16 for the block's life.
//      Tiles of 64 query rows of Q and dO, with their lse and D, stream
//      through a 2-stage cp.async ring: the G query heads of the KV head
//      in order and, in each, the query tiles that can see the block's
//      keys in order, so the GQA sum is the walk itself. A step: (A) the
//      warp pair of keys [16 k, +16) scores them against rows [0, 32) and
//      [32, 64): S^T = K Q^T, dP^T = V dO^T, P^T and dS^T in float32,
//      written to shared memory as bf16; (B) after the pair's own named
//      barrier, each of the two sums dV += P^T dO and dK += dS^T Q for the
//      16 keys and one half of the H columns: split over two warps, the
//      accumulators take H / 2 registers a thread, so H 256 fits. dK and
//      dV are written once, dK times s.
//  Scores run in base 2 (S * s * log2 e, exp2f; lse in the scratch is
//  base 2). Rows are padded to H + 8 bf16 (64 + 8 for P^T, dS^T), as
//  MmaSmem pads them: the 8 rows an ldmatrix reads hit 8 distinct bank
//  groups. Tiles the mask hides entirely are never loaded. Keys past Tk
//  and rows past Tq are staged as zeros (0 * NaN is NaN). The tile plan
//  (BWD_BF16_PLANS) is keyed by H alone, never by B, T, G or the mask, so
//  a (batch, head)'s gradients are the same bits alone or in a batch.
//
// float32: the first design's scalar kernels, kept with their bits (the
// card-vs-CPU training gates hold them to 1e-4; bf16 or TF32 operands
// could not): (a) lse_rows: one block per (b, query head, 32 query rows)
// recomputes each row's lse (a half-warp a row) and D; (b) dkdv: one
// block per (b, KV head, 32 keys) walks the G query heads and their
// visible query tiles in order; (c) dq: one block per (b, query head, 32
// rows) walks its visible key tiles. 32 x 32 tiles in shared memory as
// float32 (rows padded to H + 1 floats), scalar FMAs, each of 256 threads
// a 2 x 2 register tile of the score steps and two rows of the gradient
// sums, the score tile recomputed in each kernel.
//
// Bound on the H100: at olmo-1b's training shape (B 8, 16 heads of 128,
// T 512, causal, bf16) the function must read q, k, v, O, dO and write
// dQ, dK, dV once, ~134 MB (40 us at 3.35 TB/s), against ~21.5 GFLOP of
// products (five of 2 * visible pairs * H: S, dP, dV, dQ, dK; 22 us at
// the bf16 tensor-core peak), so the bytes bound it. The bf16 route runs
// seven products, not five (S and dP in both kernels): ~30 GFLOP, 30 us
// at the peak, of which mma.sync reaches a part; its ldmatrix traffic (a
// warp's 16-row tiles reread shared operands) and latency bound it.

#include <type_traits>

#include "attend_tile.cuh"
#include "flash_rows.cuh"

namespace {

using bf = __nv_bfloat16;
constexpr int kT = 32;          // query rows and keys a float32 tile
constexpr int kThreads = 256;   // 8 warps a float32 block
constexpr int kWarps = kThreads / 32;

struct Dims {
  int B, Tq, Tk, NQ, NKV, causal, window, q_offset, prefix_len;
  float scale;
  __device__ bool visible(int p, int j) const {
    return j >= flash::row_lo(p, window) && j <= flash::row_hi(p, Tk, causal, prefix_len);
  }
  // The key tiles rows [p0, p1] may see: [lo, hi] (empty when lo > hi).
  __device__ int tile_lo(int p0) const { return flash::row_lo(p0, window) / kT; }
  __device__ int key_hi(int p1) const { return flash::row_hi(p1, Tk, causal, prefix_len); }
};

// ---- the float32 route: scalar kernels -------------------------------------

template <int H>
struct Smem {
  static constexpr int kStride = H + 1;           // floats a staged row
  static constexpr int kTile = kT * kStride;      // floats a staged tile
};

// Rows [0, n) of a tile into shared memory as float32 (row r from
// src + off + r * stride), rows past n as zeros.
template <int H, typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, long off,
                                      long stride, int n) {
  for (int i = threadIdx.x; i < kT * H; i += kThreads) {
    const int r = i / H, d = i - r * H;
    dst[r * Smem<H>::kStride + d] = r < n ? attn::to_f(src[off + r * stride + d]) : 0.f;
  }
}

__device__ __forceinline__ float half_max(float v) {   // over the 16 lanes of a half-warp
#pragma unroll
  for (int o = 8; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The register tile of the score steps: thread t holds rows {ty, ty + 16}
// of the staged query tile against columns {tx, tx + 16} of the staged
// key tile (ty = t / 16, tx = t % 16), so each shared-memory read feeds
// two products. acc[i][j] += a[row i] . b[col j], d in order.
template <int H>
__device__ __forceinline__ void dot2x2(const float* a, const float* b, float acc[2][2]) {
  constexpr int kS = Smem<H>::kStride;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float *a0 = a + ty * kS, *a1 = a0 + 16 * kS, *b0 = b + tx * kS, *b1 = b0 + 16 * kS;
#pragma unroll 8
  for (int d = 0; d < H; ++d) {
    const float x0 = a0[d], x1 = a1[d], y0 = b0[d], y1 = b1[d];
    acc[0][0] = fmaf(x0, y0, acc[0][0]);
    acc[0][1] = fmaf(x0, y1, acc[0][1]);
    acc[1][0] = fmaf(x1, y0, acc[1][0]);
    acc[1][1] = fmaf(x1, y1, acc[1][1]);
  }
}

// (a) Each row's log-sum-exp over its visible keys (+inf for a row that
// sees none) and D = rowsum(dO * O), into lse / dsum (B, NQ, Tq). A row's
// max and sum fold over its 16 lanes of a half-warp, a tile at a time.
template <int H, typename T>
__global__ void __launch_bounds__(kThreads)
lse_rows_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
                const T* __restrict__ dout, float* __restrict__ lse,
                float* __restrict__ dsum, Dims s) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + Smem<H>::kTile;
  const int b = blockIdx.y / s.NQ, h = blockIdx.y % s.NQ, kvh = h / (s.NQ / s.NKV);
  const int t0 = blockIdx.x * kT, n = min(kT, s.Tq - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long qoff = (((long)b * s.Tq + t0) * s.NQ + h) * H, qstride = (long)s.NQ * H;
  const long row_out = ((long)b * s.NQ + h) * s.Tq + t0;
  stage<H>(Qs, q, qoff, qstride, n);
  for (int r = warp; r < kT; r += kWarps) {
    float acc = 0.f;
    if (r < n)
      for (int d = lane; d < H; d += 32)
        acc = fmaf(attn::to_f(dout[qoff + r * qstride + d]),
                   attn::to_f(o[qoff + r * qstride + d]), acc);
    acc = warp_sum(acc);
    if (lane == 0 && r < n) dsum[row_out + r] = acc;
  }
  const int p0 = s.q_offset + t0;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int jhi = s.key_hi(p0 + n - 1);
  for (int kt = s.tile_lo(p0); kt * kT <= jhi; ++kt) {
    const int j0 = kt * kT, nk = min(kT, s.Tk - j0);
    __syncthreads();
    stage<H>(Ks, k, (((long)b * s.Tk + j0) * s.NKV + kvh) * H, (long)s.NKV * H, nk);
    __syncthreads();
    float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    dot2x2<H>(Qs, Ks, acc);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty + 16 * i;
      float sc[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int c = tx + 16 * jj;
        sc[jj] = r < n && c < nk && s.visible(p0 + r, j0 + c) ? acc[i][jj] * s.scale
                                                              : -INFINITY;
      }
      const float mn = fmaxf(m[i], half_max(fmaxf(sc[0], sc[1])));
      const float part = (sc[0] == -INFINITY ? 0.f : expf(sc[0] - mn)) +
                         (sc[1] == -INFINITY ? 0.f : expf(sc[1] - mn));
      const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - mn);
      l[i] = l[i] * alpha + half_sum(part);
      m[i] = mn;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty + 16 * i;
    if (tx == 0 && r < n) lse[row_out + r] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
  }
}

// The tile step both gradient kernels share: P[r][c] (if Ps) and dS[r][c]
// of the staged query rows r against the staged keys c into shared
// memory, each thread its 2 x 2 register tile; masked pairs get 0.
template <int H>
__device__ __forceinline__ void score_tile(const float* Qs, const float* dOs, const float* Ks,
                                           const float* Vs, const float* lse_t,
                                           const float* d_t, float* Ps, float* dSs, int n,
                                           int nk, int p0, int j0, const Dims& s) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float sc[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  dot2x2<H>(Qs, Ks, sc);
  dot2x2<H>(dOs, Vs, dp);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int r = ty + 16 * i, c = tx + 16 * jj;
      float p = 0.f, ds = 0.f;
      if (r < n && c < nk && s.visible(p0 + r, j0 + c)) {
        p = expf(sc[i][jj] * s.scale - lse_t[r]);
        ds = p * (dp[i][jj] - d_t[r]);
      }
      if (Ps) Ps[r * (kT + 1) + c] = p;
      dSs[r * (kT + 1) + c] = ds;
    }
  }
}

// (b) dK, dV of 32 keys of (b, KV head): every visible query row of the
// KV head's G query heads, heads in order, query tiles in order. Thread t
// sums key rows {t / 16, t / 16 + 16} at columns t % 16 + 16 i.
template <int H, typename T>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv, Dims s) {
  extern __shared__ float smem[];
  constexpr int kTile = Smem<H>::kTile, kS = Smem<H>::kStride, kD = H / 16;
  float* Ks = smem;
  float* Vs = Ks + kTile;
  float* Qs = Vs + kTile;
  float* dOs = Qs + kTile;
  float* Ps = dOs + kTile;
  float* dSs = Ps + kT * (kT + 1);
  float* lse_t = dSs + kT * (kT + 1);
  float* d_t = lse_t + kT;
  const int b = blockIdx.y / s.NKV, kvh = blockIdx.y % s.NKV, G = s.NQ / s.NKV;
  const int j0 = blockIdx.x * kT, nk = min(kT, s.Tk - j0), jl = j0 + nk - 1;
  const long koff = (((long)b * s.Tk + j0) * s.NKV + kvh) * H, kstride = (long)s.NKV * H;
  stage<H>(Ks, k, koff, kstride, nk);
  stage<H>(Vs, v, koff, kstride, nk);
  const int c0 = threadIdx.x >> 4, d0 = threadIdx.x & 15;
  float ak[2][kD], av[2][kD];
#pragma unroll
  for (int i = 0; i < kD; ++i) ak[0][i] = ak[1][i] = av[0][i] = av[1][i] = 0.f;
  const long qstride = (long)s.NQ * H;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int t0 = 0; t0 < s.Tq; t0 += kT) {
      const int n = min(kT, s.Tq - t0), p0 = s.q_offset + t0;
      if (flash::row_lo(p0, s.window) > jl || s.key_hi(p0 + n - 1) < j0) continue;
      const long qoff = (((long)b * s.Tq + t0) * s.NQ + h) * H;
      const long row = ((long)b * s.NQ + h) * s.Tq + t0;
      __syncthreads();
      stage<H>(Qs, q, qoff, qstride, n);
      stage<H>(dOs, dout, qoff, qstride, n);
      if (threadIdx.x < kT) {
        lse_t[threadIdx.x] = threadIdx.x < n ? lse[row + threadIdx.x] : INFINITY;
        d_t[threadIdx.x] = threadIdx.x < n ? dsum[row + threadIdx.x] : 0.f;
      }
      __syncthreads();
      score_tile<H>(Qs, dOs, Ks, Vs, lse_t, d_t, Ps, dSs, n, nk, p0, j0, s);
      __syncthreads();
      for (int r = 0; r < n; ++r) {
        const float* pr = Ps + r * (kT + 1);
        const float* gr = dSs + r * (kT + 1);
        const float p0v = pr[c0], p1v = pr[c0 + 16], g0 = gr[c0], g1 = gr[c0 + 16];
#pragma unroll
        for (int i = 0; i < kD; ++i) {
          const float od = dOs[r * kS + d0 + 16 * i], qd = Qs[r * kS + d0 + 16 * i];
          av[0][i] = fmaf(p0v, od, av[0][i]);
          av[1][i] = fmaf(p1v, od, av[1][i]);
          ak[0][i] = fmaf(g0, qd, ak[0][i]);
          ak[1][i] = fmaf(g1, qd, ak[1][i]);
        }
      }
    }
  }
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int c = c0 + 16 * jj;
    if (c >= nk) continue;
    const long off = koff + c * kstride;
#pragma unroll
    for (int i = 0; i < kD; ++i) {
      dk[off + d0 + 16 * i] = attn::from_f<T>(ak[jj][i] * s.scale);
      dv[off + d0 + 16 * i] = attn::from_f<T>(av[jj][i]);
    }
  }
}

// (c) dQ of 32 query rows of (b, query head): its visible key tiles in
// order. Thread t sums rows {t / 16, t / 16 + 16} at columns t % 16 + 16 i.
template <int H, typename T>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ dsum, T* __restrict__ dq, Dims s) {
  extern __shared__ float smem[];
  constexpr int kTile = Smem<H>::kTile, kS = Smem<H>::kStride, kD = H / 16;
  float* Qs = smem;
  float* dOs = Qs + kTile;
  float* Ks = dOs + kTile;
  float* Vs = Ks + kTile;
  float* dSs = Vs + kTile;
  float* lse_t = dSs + kT * (kT + 1);
  float* d_t = lse_t + kT;
  const int b = blockIdx.y / s.NQ, h = blockIdx.y % s.NQ, kvh = h / (s.NQ / s.NKV);
  const int t0 = blockIdx.x * kT, n = min(kT, s.Tq - t0), p0 = s.q_offset + t0;
  const long qoff = (((long)b * s.Tq + t0) * s.NQ + h) * H, qstride = (long)s.NQ * H;
  const long row = ((long)b * s.NQ + h) * s.Tq + t0;
  stage<H>(Qs, q, qoff, qstride, n);
  stage<H>(dOs, dout, qoff, qstride, n);
  if (threadIdx.x < kT) {
    lse_t[threadIdx.x] = threadIdx.x < n ? lse[row + threadIdx.x] : INFINITY;
    d_t[threadIdx.x] = threadIdx.x < n ? dsum[row + threadIdx.x] : 0.f;
  }
  const int r0 = threadIdx.x >> 4, d0 = threadIdx.x & 15;
  float aq[2][kD];
#pragma unroll
  for (int i = 0; i < kD; ++i) aq[0][i] = aq[1][i] = 0.f;
  const int jhi = s.key_hi(p0 + n - 1);
  for (int kt = s.tile_lo(p0); kt * kT <= jhi; ++kt) {
    const int j0 = kt * kT, nk = min(kT, s.Tk - j0);
    const long koff = (((long)b * s.Tk + j0) * s.NKV + kvh) * H;
    __syncthreads();
    stage<H>(Ks, k, koff, (long)s.NKV * H, nk);
    stage<H>(Vs, v, koff, (long)s.NKV * H, nk);
    __syncthreads();
    score_tile<H>(Qs, dOs, Ks, Vs, lse_t, d_t, nullptr, dSs, n, nk, p0, j0, s);
    __syncthreads();
    for (int cc = 0; cc < nk; ++cc) {
      const float g0 = dSs[r0 * (kT + 1) + cc], g1 = dSs[(r0 + 16) * (kT + 1) + cc];
#pragma unroll
      for (int i = 0; i < kD; ++i) {
        const float kd = Ks[cc * kS + d0 + 16 * i];
        aq[0][i] = fmaf(g0, kd, aq[0][i]);
        aq[1][i] = fmaf(g1, kd, aq[1][i]);
      }
    }
  }
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int r = r0 + 16 * ii;
    if (r >= n) continue;
#pragma unroll
    for (int i = 0; i < kD; ++i)
      dq[qoff + r * qstride + d0 + 16 * i] = attn::from_f<T>(aq[ii][i] * s.scale);
  }
}

// ---- the bf16 route: tensor cores ------------------------------------------

using mma::cp16;
using mma::cp4;
using mma::cp_commit;
using mma::cp_wait_all;
using mma::ldm_x4;
using mma::ldm_x4_t;
using mma::mma16816;
using mma::pack_bf16;

constexpr float kLog2e = 1.4426950408889634f;

// The bf16 route's tile plan, keyed by the head dim alone. Columns: H;
// keys a dkdv block (16 a key slice, two warps a slice); query rows a
// dkdv step; query rows a rows block (16 a warp); keys a rows step (32
// above H 128, where dQ's accumulators take H / 2 registers a thread).
// 32-key dkdv blocks from H 128 up: two blocks of 4 warps a SM where
// shared memory allows, and twice the blocks under MQA (timed against 64
// keys on the H100: faster at H 128, far faster at H 256 under MQA; 64
// stays faster at H 80). tests/test_torch_train.py parses this table.
#define BWD_BF16_PLANS(X) \
  X(16, 64, 64, 64, 64)   \
  X(64, 64, 64, 64, 64)   \
  X(80, 64, 64, 64, 64)   \
  X(128, 32, 64, 64, 64)  \
  X(160, 32, 64, 64, 32)  \
  X(192, 32, 64, 64, 32)  \
  X(256, 32, 64, 64, 32)

template <int H> struct Plan;
#define BWD_PLAN_ROW(h, kvk, kvr, qr, qk)                            \
  template <> struct Plan<h> {                                       \
    static constexpr int KVK = kvk, KVR = kvr, QR = qr, QK = qk;     \
  };
BWD_BF16_PLANS(BWD_PLAN_ROW)
#undef BWD_PLAN_ROW

// Shared memory of the two kernels in bytes from the base (every offset a
// multiple of 16: rows of H + 8 bf16, H a multiple of 16).
template <int H>
struct RowsSmem {
  using P = Plan<H>;
  static constexpr int LD = H + 8;
  static constexpr size_t q = 0;                                      // [QR][LD] bf16
  static constexpr size_t dout = q + (size_t)P::QR * LD * 2;          // [QR][LD] bf16
  static constexpr size_t kv = dout + (size_t)P::QR * LD * 2;         // [2][k, v][QK][LD]
  static constexpr size_t bytes = kv + (size_t)2 * 2 * P::QK * LD * 2;
};
template <int H>
struct DkdvSmem {
  using P = Plan<H>;
  static constexpr int LD = H + 8, LP = P::KVR + 8;
  static constexpr size_t k = 0;                                      // [KVK][LD] bf16
  static constexpr size_t v = k + (size_t)P::KVK * LD * 2;            // [KVK][LD] bf16
  static constexpr size_t qd = v + (size_t)P::KVK * LD * 2;           // [2][q, dO][KVR][LD]
  static constexpr size_t ps = qd + (size_t)2 * 2 * P::KVR * LD * 2;  // P^T [KVK][LP] bf16
  static constexpr size_t ds = ps + (size_t)P::KVK * LP * 2;          // dS^T [KVK][LP] bf16
  static constexpr size_t ld = ds + (size_t)P::KVK * LP * 2;          // [2][lse, D][KVR] f32
  static constexpr size_t bytes = ld + (size_t)2 * 2 * P::KVR * 4;
};
#define BWD_PLAN_CHECK(h, kvk, kvr, qr, qk)                                           \
  static_assert(kvk % 16 == 0 && kvr % 32 == 0 && qr % 16 == 0 && qk % 16 == 0,       \
                "bf16 backward tiles are whole mma tiles");                          \
  static_assert(RowsSmem<h>::bytes <= 232448 && DkdvSmem<h>::bytes <= 232448,         \
                "bf16 backward tiles exceed the 227 KB of shared memory a block");
BWD_BF16_PLANS(BWD_PLAN_CHECK)
#undef BWD_PLAN_CHECK

// acc[j] = A B^T over the H columns, for one warp: A's 16 rows at a and
// B's 8 * NB rows at b (rows LD = H + 8 apart); H / 16 k-steps in order.
template <int H, int NB>
__device__ __forceinline__ void scores16(const bf* a, const bf* b, float (&acc)[NB][4]) {
  constexpr int LD = H + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk) {
    uint32_t fa[4];
    ldm_x4(fa, a + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int jp = 0; jp < NB / 2; ++jp) {
      uint32_t fb[4];
      ldm_x4(fb, b + (jp * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * LD + kk * 16 +
                     ((lane >> 3) & 1) * 8);
      mma16816(acc[2 * jp], fa, fb[0], fb[1]);
      mma16816(acc[2 * jp + 1], fa, fb[2], fb[3]);
    }
  }
}

// (a) lse and D of QR query rows of (b, query head) into lse / dsum (B, NQ,
// Tq), and their dQ, in one walk over the rows' visible key tiles. Each
// row's max m and sum l fold online as in the forward, and dQ with them:
// with p = exp(S s - m) under the running max m,
//   dQ = s * sum_j P_j (dP_j - D) K_j = s / l * sum_j p_j (dP_j - D) K_j,
// the partial sum rescaled by exp(m_old - m_new) when the max moves, as
// the forward rescales O. Scores are taken in base 2 (S * s * log2 e,
// exp2f) and lse goes to scratch in base 2, for (b). Thread (warp w, lane
// 4 g + t) holds rows 16 w + g and 16 w + g + 8 of the block, as the m16n8
// fragments place them.
template <int H>
__global__ void __launch_bounds__(Plan<H>::QR * 2)
rows_bf16_kernel(const bf* __restrict__ q, const bf* __restrict__ k, const bf* __restrict__ v,
                 const bf* __restrict__ o, const bf* __restrict__ dout,
                 float* __restrict__ lse, float* __restrict__ dsum, bf* __restrict__ dq,
                 Dims s) {
  using P = Plan<H>;
  using SM = RowsSmem<H>;
  constexpr int LD = SM::LD, QR = P::QR, QK = P::QK, NB = QK / 8, NTH = QR * 2, CPR = H / 8;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf* q_s = (bf*)(smem_tc + SM::q);
  bf* do_s = (bf*)(smem_tc + SM::dout);
  bf* kv_s = (bf*)(smem_tc + SM::kv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / s.NQ, h = blockIdx.y % s.NQ, kvh = h / (s.NQ / s.NKV);
  const int t0 = blockIdx.x * QR, n = min(QR, s.Tq - t0), p0 = s.q_offset + t0;
  const long qstride = (long)s.NQ * H, qoff = (((long)b * s.Tq + t0) * s.NQ + h) * H;
  const long row = ((long)b * s.NQ + h) * s.Tq + t0;
  for (int i = tid; i < QR * CPR; i += NTH) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = r < n;
    const long off = ok ? qoff + r * qstride + c * 8 : 0;
    cp16(q_s + r * LD + c * 8, q + off, ok);
    cp16(do_s + r * LD + c * 8, dout + off, ok);
  }
  // Key tiles [kt0, kt1) hold every key a row of the block may see.
  const int kt0 = flash::row_lo(p0, s.window) / QK, kt1 = s.key_hi(p0 + n - 1) / QK + 1;
  // K and V of tile kt into ring buffer buf; keys past Tk zeros.
  auto stage = [&](int buf, int kt) {
    const int j0 = kt * QK;
    bf* kb = kv_s + buf * 2 * QK * LD;
    for (int i = tid; i < QK * CPR; i += NTH) {
      const int j = i / CPR, c = i % CPR;
      const bool ok = j0 + j < s.Tk;
      const long off = ok ? (((long)b * s.Tk + j0 + j) * s.NKV + kvh) * H + c * 8 : 0;
      cp16(kb + j * LD + c * 8, k + off, ok);
      cp16(kb + (QK + j) * LD + c * 8, v + off, ok);
    }
  };
  if (kt0 < kt1) stage(0, kt0);
  cp_commit();
  // D = rowsum(dO * O) of the warp's 16 rows (rows past n: 0): lanes 2 i
  // and 2 i + 1 sum the two halves of row i in 16-byte loads; this thread
  // keeps its two rows' D.
  float drow[2];
  {
    const int r = warp * 16 + (lane >> 1);
    float acc = 0.f;
    if (r < n) {
      const bf* a = dout + qoff + r * qstride + (lane & 1) * (H / 2);
      const bf* c = o + qoff + r * qstride + (lane & 1) * (H / 2);
      uint4 va[H / 16], vc[H / 16];
#pragma unroll
      for (int i = 0; i < H / 16; ++i) {
        va[i] = reinterpret_cast<const uint4*>(a)[i];
        vc[i] = reinterpret_cast<const uint4*>(c)[i];
      }
#pragma unroll
      for (int i = 0; i < H / 16; ++i) {
        const bf* x = reinterpret_cast<const bf*>(&va[i]);
        const bf* y = reinterpret_cast<const bf*>(&vc[i]);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc = fmaf(__bfloat162float(x[e]), __bfloat162float(y[e]), acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((lane & 1) == 0 && r < n) dsum[row + r] = acc;
    drow[0] = __shfl_sync(0xffffffffu, acc, 2 * g);
    drow[1] = __shfl_sync(0xffffffffu, acc, 2 * g + 16);
  }
  // This thread's two rows: the keys each may see ([lo, hi], empty past n).
  int lo[2], hi[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh;
    lo[hh] = r < n ? flash::row_lo(p0 + r, s.window) : 1;
    hi[hh] = r < n ? s.key_hi(p0 + r) : 0;
  }
  const bf* qw = q_s + warp * 16 * LD;
  const bf* dow = do_s + warp * 16 * LD;
  const float sl2 = s.scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[H / 8][4];
#pragma unroll
  for (int nn = 0; nn < H / 8; ++nn)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nn][c] = 0.f;
  for (int kt = kt0, it = 0; kt < kt1; ++kt, ++it) {
    cp_wait_all();
    __syncthreads();       // tile kt landed; everyone is done with the other buffer
    if (kt + 1 < kt1) stage((it + 1) & 1, kt + 1);
    cp_commit();
    const bf* kb = kv_s + (it & 1) * 2 * QK * LD;
    const bf* vb = kb + QK * LD;
    const int j0 = kt * QK;
    float sc[NB][4], dp[NB][4];
    scores16<H, NB>(qw, kb, sc);
    scores16<H, NB>(dow, vb, dp);
    // Scale into base 2, mask; the rows' new max.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jt = 0; jt < NB; ++jt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int hh = c >> 1, j = j0 + 8 * jt + 2 * t + (c & 1);
        const float x = j >= lo[hh] && j <= hi[hh] ? sc[jt][c] * sl2 : -INFINITY;
        sc[jt][c] = x;
        mx[hh] = fmaxf(mx[hh], x);
      }
    float mu[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float mn = fmaxf(m[hh], mx[hh]);
      mu[hh] = mn == -INFINITY ? 0.f : mn;
      alpha[hh] = exp2f(m[hh] - mu[hh]);
      m[hh] = mn;
    }
    // p = exp(S s - m); dS = p (dP - D) as the A operand of k16 step jt / 2.
    uint32_t da[NB / 2][4];
#pragma unroll
    for (int jt = 0; jt < NB; ++jt) {
      float ds[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int hh = c >> 1;
        const float p = exp2f(sc[jt][c] - mu[hh]);
        sum[hh] += p;
        ds[c] = p * (dp[jt][c] - drow[hh]);
      }
      da[jt >> 1][(jt & 1) * 2] = pack_bf16(ds[0], ds[1]);
      da[jt >> 1][(jt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
      l[hh] = l[hh] * alpha[hh] + sum[hh];
    }
#pragma unroll
    for (int nn = 0; nn < H / 8; ++nn)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[nn][c] *= alpha[c >> 1];
    // dQ += dS K: the tile's keys in k16 steps, in order.
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk)
#pragma unroll
      for (int dn = 0; dn < H / 16; ++dn) {
        uint32_t fb[4];
        ldm_x4_t(fb, kb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dn * 16 +
                         (lane >> 4) * 8);
        mma16816(acc[2 * dn], da[kk], fb[0], fb[1]);
        mma16816(acc[2 * dn + 1], da[kk], fb[2], fb[3]);
      }
  }
  cp_wait_all();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh;
    if (r >= n) continue;
    if (t == 0) lse[row + r] = l[hh] > 0.f ? m[hh] + log2f(l[hh]) : INFINITY;
    const float f = l[hh] > 0.f ? s.scale / l[hh] : 0.f;
    bf* out = dq + qoff + r * qstride + 2 * t;
#pragma unroll
    for (int nn = 0; nn < H / 8; ++nn)
      *reinterpret_cast<__nv_bfloat162*>(out + nn * 8) =
          __floats2bfloat162_rn(acc[nn][2 * hh] * f, acc[nn][2 * hh + 1] * f);
  }
}

// (b) dK, dV of KVK keys of (b, KV head): the G query heads in order and,
// in each, the query tiles that can see the keys in order.
template <int H>
__global__ void __launch_bounds__(Plan<H>::KVK * 4)
dkdv_bf16_kernel(const bf* __restrict__ q, const bf* __restrict__ k, const bf* __restrict__ v,
                 const bf* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ dsum, bf* __restrict__ dk, bf* __restrict__ dv,
                 Dims s) {
  using P = Plan<H>;
  using SM = DkdvSmem<H>;
  constexpr int LD = SM::LD, LP = SM::LP, KVK = P::KVK, KVR = P::KVR, NWK = KVK / 16;
  constexpr int NTH = KVK * 4, CPR = H / 8, NA = KVR / 16, NH = H / 16;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf* k_s = (bf*)(smem_tc + SM::k);
  bf* v_s = (bf*)(smem_tc + SM::v);
  bf* qd_s = (bf*)(smem_tc + SM::qd);
  bf* p_s = (bf*)(smem_tc + SM::ps);
  bf* ds_s = (bf*)(smem_tc + SM::ds);
  float* ld_s = (float*)(smem_tc + SM::ld);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int ks = warp % NWK, half = warp / NWK;
  const int b = blockIdx.y / s.NKV, kvh = blockIdx.y % s.NKV, G = s.NQ / s.NKV;
  const int j0 = blockIdx.x * KVK, nk = min(KVK, s.Tk - j0), jl = j0 + nk - 1;
  const long kstride = (long)s.NKV * H, koff = (((long)b * s.Tk + j0) * s.NKV + kvh) * H;
  const long qstride = (long)s.NQ * H;
  const float sl2 = s.scale * kLog2e;
  for (int i = tid; i < KVK * CPR; i += NTH) {
    const int j = i / CPR, c = i % CPR;
    const bool ok = j < nk;
    const long off = ok ? koff + j * kstride + c * 8 : 0;
    cp16(k_s + j * LD + c * 8, k + off, ok);
    cp16(v_s + j * LD + c * 8, v + off, ok);
  }
  // Query tile qt (rows [qt * KVR, +KVR)) has a row that sees a key here.
  const int nqt = (s.Tq + KVR - 1) / KVR;
  auto seen = [&](int qt) {
    const int pa = s.q_offset + qt * KVR, pb = s.q_offset + min(s.Tq, qt * KVR + KVR) - 1;
    return flash::row_lo(pa, s.window) <= jl && s.key_hi(pb) >= j0;
  };
  auto next_tile = [&](int qt) {
    for (++qt; qt < nqt; ++qt)
      if (seen(qt)) return qt;
    return nqt;
  };
  // Q, dO, lse and D of query tile qt of head kvh * G + gh into buffer buf;
  // rows past Tq zeros.
  auto stage = [&](int buf, int gh, int qt) {
    const int hq = kvh * G + gh, t0 = qt * KVR, n = min(KVR, s.Tq - t0);
    const long qoff = (((long)b * s.Tq + t0) * s.NQ + hq) * H;
    const long row = ((long)b * s.NQ + hq) * s.Tq + t0;
    bf* qb = qd_s + buf * 2 * KVR * LD;
    for (int i = tid; i < KVR * CPR; i += NTH) {
      const int r = i / CPR, c = i % CPR;
      const bool ok = r < n;
      const long off = ok ? qoff + r * qstride + c * 8 : 0;
      cp16(qb + r * LD + c * 8, q + off, ok);
      cp16(qb + (KVR + r) * LD + c * 8, dout + off, ok);
    }
    float* lb = ld_s + buf * 2 * KVR;
    for (int r = tid; r < KVR; r += NTH) {
      const bool ok = r < n;
      cp4(lb + r, lse + (ok ? row + r : 0), ok);
      cp4(lb + KVR + r, dsum + (ok ? row + r : 0), ok);
    }
  };

  float adk[NH][4], adv[NH][4];
#pragma unroll
  for (int jn = 0; jn < NH; ++jn)
#pragma unroll
    for (int c = 0; c < 4; ++c) adk[jn][c] = adv[jn][c] = 0.f;
  const int qfirst = next_tile(-1);
  if (qfirst < nqt) stage(0, 0, qfirst);
  cp_commit();
  for (int it = 0, gh = 0, qt = qfirst; qfirst < nqt && gh < G; ++it) {
    int ng = gh, nq = next_tile(qt);
    if (nq == nqt) {
      ++ng;
      nq = qfirst;
    }
    cp_wait_all();
    __syncthreads();       // tile (gh, qt) landed; everyone is done with the other buffer
    if (ng < G) stage((it + 1) & 1, ng, nq);
    cp_commit();
    const bf* qb = qd_s + (it & 1) * 2 * KVR * LD;
    const bf* dob = qb + KVR * LD;
    const float* lb = ld_s + (it & 1) * 2 * KVR;
    const float* db = lb + KVR;
    const int n = min(KVR, s.Tq - qt * KVR), p0 = s.q_offset + qt * KVR;
    {  // (A) keys [16 ks, +16) against rows [rb, rb + KVR / 2): P^T, dS^T
      const int rb = half * (KVR / 2);
      float sc[NA][4], dp[NA][4];
      scores16<H, NA>(k_s + ks * 16 * LD, qb + rb * LD, sc);
      scores16<H, NA>(v_s + ks * 16 * LD, dob + rb * LD, dp);
      const int j = j0 + ks * 16 + g;      // this thread's keys: j and j + 8
#pragma unroll
      for (int jt = 0; jt < NA; ++jt) {
        float pe[2][2], de[2][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {      // query row r, the column of c = e and 2 + e
          const int r = rb + 8 * jt + 2 * t + e, p = p0 + r;
          const int rlo = r < n ? flash::row_lo(p, s.window) : 1;
          const int rhi = r < n ? s.key_hi(p) : 0;
          const float ls = lb[r], dd = db[r];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int jj = j + 8 * hh;
            const float x = exp2f(sc[jt][2 * hh + e] * sl2 - ls);
            pe[hh][e] = jj >= rlo && jj <= rhi ? x : 0.f;
            de[hh][e] = pe[hh][e] * (dp[jt][2 * hh + e] - dd);
          }
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int at = (ks * 16 + g + 8 * hh) * LP + rb + 8 * jt + 2 * t;
          *reinterpret_cast<uint32_t*>(p_s + at) = pack_bf16(pe[hh][0], pe[hh][1]);
          *reinterpret_cast<uint32_t*>(ds_s + at) = pack_bf16(de[hh][0], de[hh][1]);
        }
      }
    }
    // P^T and dS^T rows of keys [16 ks, +16) are complete: the two warps
    // that wrote them are the two that read them (named barrier 1 + ks).
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + ks) : "memory");
    {  // (B) dV += P^T dO, dK += dS^T Q: keys [16 ks, +16), columns of half `half`
      uint32_t ap[KVR / 16][4], as[KVR / 16][4];
#pragma unroll
      for (int kk = 0; kk < KVR / 16; ++kk) {
        const int at = (ks * 16 + (lane & 15)) * LP + kk * 16 + (lane >> 4) * 8;
        ldm_x4(ap[kk], p_s + at);
        ldm_x4(as[kk], ds_s + at);
      }
#pragma unroll
      for (int jn = 0; jn < NH; ++jn) {
        const int col = (half * NH + jn) * 8;
#pragma unroll
        for (int kp = 0; kp < KVR / 32; ++kp) {   // rows [32 kp, +32): two k16 steps
          uint32_t fo[4], fq[4];
          ldm_x4_t(fo, dob + (kp * 32 + lane) * LD + col);
          ldm_x4_t(fq, qb + (kp * 32 + lane) * LD + col);
          mma16816(adv[jn], ap[2 * kp], fo[0], fo[1]);
          mma16816(adv[jn], ap[2 * kp + 1], fo[2], fo[3]);
          mma16816(adk[jn], as[2 * kp], fq[0], fq[1]);
          mma16816(adk[jn], as[2 * kp + 1], fq[2], fq[3]);
        }
      }
    }
    gh = ng;
    qt = nq;
  }
  cp_wait_all();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = ks * 16 + g + 8 * hh;
    if (key >= nk) continue;
    const long off = koff + key * kstride + half * NH * 8 + 2 * t;
#pragma unroll
    for (int jn = 0; jn < NH; ++jn) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + jn * 8) = __floats2bfloat162_rn(
          adk[jn][2 * hh] * s.scale, adk[jn][2 * hh + 1] * s.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + jn * 8) =
          __floats2bfloat162_rn(adv[jn][2 * hh], adv[jn][2 * hh + 1]);
    }
  }
}

template <int H>
int launch_bf16(const bf* q, const bf* k, const bf* v, const bf* o, const bf* dout, bf* dq,
                bf* dk, bf* dv, float* lse, float* dsum, const Dims& s, cudaStream_t st) {
  using P = Plan<H>;
  int e;
  if (s.Tq > 0) {
    auto ka = rows_bf16_kernel<H>;
    constexpr size_t bytes = RowsSmem<H>::bytes;
    if ((e = attn::allow_smem(ka, bytes))) return e;
    ka<<<dim3((s.Tq + P::QR - 1) / P::QR, s.B * s.NQ), P::QR * 2, bytes, st>>>(
        q, k, v, o, dout, lse, dsum, dq, s);
    if ((e = (int)cudaGetLastError())) return e;
  }
  auto kb = dkdv_bf16_kernel<H>;
  constexpr size_t bytes = DkdvSmem<H>::bytes;
  if ((e = attn::allow_smem(kb, bytes))) return e;
  kb<<<dim3((s.Tk + P::KVK - 1) / P::KVK, s.B * s.NKV), P::KVK * 4, bytes, st>>>(
      q, k, v, dout, lse, dsum, dk, dv, s);
  return (int)cudaGetLastError();
}

// ---- the float32 route's launches -------------------------------------------

template <int H, typename T>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* dout, void* dq, void* dk, void* dv, float* lse, float* dsum,
               const Dims& s, cudaStream_t st) {
  constexpr size_t tile = sizeof(float) * Smem<H>::kTile;
  constexpr size_t small = sizeof(float) * (kT * (kT + 1) + 2 * kT);
  const T *Q = (const T*)q, *K = (const T*)k, *V = (const T*)v, *O = (const T*)o,
          *dO = (const T*)dout;
  int e;
  if (s.Tq > 0) {
    auto ka = lse_rows_kernel<H, T>;
    if ((e = attn::allow_smem(ka, 2 * tile))) return e;
    ka<<<dim3((s.Tq + kT - 1) / kT, s.B * s.NQ), kThreads, 2 * tile, st>>>(Q, K, O, dO, lse,
                                                                           dsum, s);
    if ((e = (int)cudaGetLastError())) return e;
    auto kc = dq_kernel<H, T>;
    if ((e = attn::allow_smem(kc, 4 * tile + small))) return e;
    kc<<<dim3((s.Tq + kT - 1) / kT, s.B * s.NQ), kThreads, 4 * tile + small, st>>>(
        Q, K, V, dO, lse, dsum, (T*)dq, s);
    if ((e = (int)cudaGetLastError())) return e;
  }
  auto kb = dkdv_kernel<H, T>;
  const size_t bytes = 4 * tile + small + sizeof(float) * kT * (kT + 1);
  if ((e = attn::allow_smem(kb, bytes))) return e;
  kb<<<dim3((s.Tk + kT - 1) / kT, s.B * s.NKV), kThreads, bytes, st>>>(Q, K, V, dO, lse, dsum,
                                                                        (T*)dk, (T*)dv, s);
  return (int)cudaGetLastError();
}

}  // namespace

// q/o/dout/dq (B, Tq, NQ, H), k/v/dk/dv (B, Tk, NKV, H), all contiguous,
// of one dtype (0 = float32, 1 = bfloat16); lse and dsum float32 scratch
// of B * NQ * Tq each; H in {16, 64, 80, 128, 160, 192, 256}, NQ % NKV ==
// 0; the mask as the forward's. Returns the CUDA error code of the
// launches (0 = launched).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, void* dq, void* dk,
                                   void* dv, void* lse, void* dsum, int B, int Tq, int Tk,
                                   int NQ, int NKV, int H, int dtype, int causal, int window,
                                   int q_offset, int prefix_len, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || Tk <= 0) return (int)cudaGetLastError();
  if (!attn::head_dim_ok(H) || NKV <= 0 || NQ % NKV || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Dims s{B, Tq, Tk, NQ, NKV, causal, window, q_offset, prefix_len, scale};
  return attn::with_head_dim(H, [&](auto hd) -> int {
    constexpr int HH = decltype(hd)::value;
    if (dtype == 0)
      return launch_f32<HH, float>(q, k, v, o, dout, dq, dk, dv, (float*)lse, (float*)dsum,
                                   s, st);
    return launch_bf16<HH>((const bf*)q, (const bf*)k, (const bf*)v, (const bf*)o,
                           (const bf*)dout, (bf*)dq, (bf*)dk, (bf*)dv, (float*)lse,
                           (float*)dsum, s, st);
  });
}
