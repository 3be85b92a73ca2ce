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
// Three kernels, launched in order on one stream:
//  (a) lse_rows: one block per (b, query head, 32 query rows) walks the
//      rows' visible key tiles and recomputes each row's log-sum-exp
//      (an online max and sum over the tiles, a half-warp a row); with D
//      it goes to float32 scratch. Recomputing leaves the forward
//      untouched.
//  (b) dkdv: one block per (b, KV head, 32 keys) holds its K/V tile and
//      walks the G query heads of its KV head and, for each, the query
//      tiles that can see its keys, in a fixed order; dK and dV sum on
//      chip and are written once. The GQA sum needs no atomics, so the
//      result is the same on every run.
//  (c) dq: one block per (b, query head, 32 query rows) walks the rows'
//      visible key tiles, dQ summed on chip, written once.
// Scores, P and every sum in float32 (bf16 inputs widen exactly); P is
// exp(s - lse) with expf. A row that sees no key has lse = +inf, so its
// P, dS and dQ are 0 and it adds nothing to dK, dV: zero gradients,
// never NaN.
//
// Bound on the H100: at olmo-1b's training shape (B 8, 16 heads of 128,
// T 512, causal, bf16) the function must read q, k, v, O, dO and write
// dQ, dK, dV once, ~134 MB (40 us at 3.35 TB/s), against ~21.5 GFLOP of
// products (five of 2 * visible pairs * H: S, dP, dV, dQ, dK; 22 us at
// the bf16 tensor-core peak), so the bytes bound it. This first design
// is simple and right, not fast: 32 x 32 tiles in shared memory as
// float32 (rows padded to H + 1 floats, so 16 or 32 lanes reading 16 or
// 32 rows hit distinct banks), scalar FMAs (no tensor cores), each of
// 256 threads a 2 x 2 register tile of the score steps and two rows of
// the gradient sums (each shared-memory read feeds two products: the
// scalar steps are bound by shared-memory reads), the score tile
// recomputed once in each of the three kernels.

#include <type_traits>

#include "attend_tile.cuh"
#include "flash_rows.cuh"

namespace {

using bf = __nv_bfloat16;
constexpr int kT = 32;          // query rows and keys a tile
constexpr int kThreads = 256;   // 8 warps
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

template <int H, typename T>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           void* dq, void* dk, void* dv, float* lse, float* dsum, const Dims& s,
           cudaStream_t st) {
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
      return launch<HH, float>(q, k, v, o, dout, dq, dk, dv, (float*)lse, (float*)dsum, s, st);
    return launch<HH, bf>(q, k, v, o, dout, dq, dk, dv, (float*)lse, (float*)dsum, s, st);
  });
}
