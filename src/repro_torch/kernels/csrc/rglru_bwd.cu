// The gradient of the RG-LRU (csrc/rglru.cu) for Hopper.
//
// Replaces no Pallas kernel: the JAX package differentiates its XLA code
// (repro/models/griffin.py _rglru_coeffs and the associative scan
// _rglru_scan) with autodiff. Each (row, channel) walks t in reverse over
// the forward's saved h:
//   g_t = dh_t + a_t+1 g_t+1,  da_t = g_t h_t-1 (h_-1 = h0, or zero),  db_t = g_t
// and dh0 = a_0 g_0; then back through the coefficients, recomputed with the
// forward's own arithmetic (rglru_gates.cuh, so a is the forward's a bit for
// bit): with r = sigmoid(ga + b_r), i = sigmoid(gi + b_i), a = exp(neg r),
// neg = -8 softplus(Lambda), b = sqrt(max(1 - a^2, 1e-12)) (i y):
//   d(1 - a^2) = db (i y) / (2 sqrt(1 - a^2)) where 1 - a^2 > 1e-12, else 0
//   dx = (da - 2 a d(1 - a^2)) a,  dga = dx neg r (1 - r),  dgi = db sqrt(.) y i (1 - i)
//   dy = db sqrt(.) i,  d b_r += dga,  d b_i += dgi,  d neg += dx r
// and d Lambda = (d neg) (-8) sigmoid(Lambda) (softplus' derivative).
//
// Order: every operation rounded on its own, each element's as one thread
// a channel walking t down computes it, so the outputs are those bits at
// every tiling; g_t in decreasing t a channel; the (W,) sums per (row,
// channel) in decreasing t by one thread across all chunks, then over the
// rows in order by a second launch (no atomics: two calls give the same
// bits, and a row's dga, dgi, dy and dh0 never depend on its batch).
//
// Bound on the H100 at Griffin's training shape (B = 8, T = 512, W = 4096,
// bf16 y): it reads ga, gi, h, dh (float32) and y and writes dga, dgi
// (float32) and dy, 28 bytes an element, ~0.47 GB (0.14 ms at 3.35 TB/s);
// ~100 instructions an element (the gates' IEEE exp, divisions and square
// root, the output's division) spread over every SM are below that, so
// loads, gates, the chain and the outputs must overlap: a thread a
// channel with 16 positions' loads in flight, then the dependent chain,
// takes loads and arithmetic in turns, 2.9x the bound.
//
// The design is the forward's ring (rglru.cu) walked in reverse. A block owns (one
// row, a tile of C channels) and streams T in chunks of kTC positions, the
// last chunk first, through a ring of kStages shared-memory stages with
// five mbarriers a stage and no block-wide barrier after the start. The
// host's plan picks (C, M) by B and the SM count (rglru.plan_bwd): (64, 4)
// where two blocks share an SM (B 8: 512 blocks), (64, 8) at B 2, (32, 8)
// at B 1. Warp roles, each on its own barriers:
//   - one lane of the load warp copies a chunk's ga, gi, dh, h shifted by
//     one position (h_t-1; the row before t = 0 reads as zero) and y into
//     a free stage, one TMA tensor copy each, completing on `full`; once a
//     stage's sums are taken (`empty`) it copies the stage's dga, dgi and
//     dy out (three tensor copies) and refills it;
//   - M gate warps compute r, i and a of their elements (every input read
//     first, so the elements' chains overlap), write r over ga, i over gi,
//     a into the stage's spare plane, and arrive on `ready`;
//   - C / 32 fold warps, a lane a channel, run g_t = dh_t + a_t+1 g_t+1
//     over the chunk from registers, write g over dh and arrive on
//     `folded`; then take the previous chunk's sums (below);
//   - M output warps recompute 1 - a^2 and its root from a (the same two
//     operations), compute dga, dgi, dy and dx r from g, h_t-1, r, i and y,
//     write them over r, i, y and a, and arrive on `done`;
//   - the fold lanes add a chunk's dga, dgi and dx r into their channel's
//     three sums in decreasing t and arrive on `empty`.
// So the loads of later chunks, the gates of the next, the fold of this
// one and the outputs of the one before run together. The tiling never
// changes an element's arithmetic or the order of a sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "rglru_gates.cuh"
#include "tma.cuh"

namespace {

using rglru_gates::kC;
using rglru_gates::neg_rate;
using rglru_gates::one_minus_sq;
using rglru_gates::rates;
using rglru_gates::root;
using rglru_gates::sigmoid;
using tma::bar_wait;
using tma::warp_arrive;

__device__ __forceinline__ float load(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void put(float* p, long i, float x) { p[i] = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, long i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

constexpr int kTC = 16;       // positions a chunk (a ring stage)
constexpr int kStages = 4;    // ring stages

// A stage's planes (kTC x C each): 0 ga, then r, then dga; 1 gi, then i,
// then dgi; 2 dh, then g; 3 h_t-1; 4 a, then dx r; then y, then dy, in
// y's type.
enum Plane { kGa = 0, kGi = 1, kDh = 2, kHp = 3, kSpare = 4, kPlanes = 5 };

// C channels a block, M gate warps and M output warps.
template <typename YT, int C, int M>
struct Layout {
  static constexpr int kFold = C / 32;                        // fold warps
  static constexpr int kLoad = kFold;                         // the load warp
  static constexpr int kGate = kFold + 1;                     // first gate warp
  static constexpr int kOut = kGate + M;                      // first output warp
  static constexpr int kThreads = 32 * (kOut + M);
  static constexpr int kTile = kTC * C;                       // elements a chunk
  static constexpr int kStage = kTile * (4 * kPlanes + (int)sizeof(YT));   // bytes a stage
  static constexpr int kLoaded = kTile * (16 + (int)sizeof(YT));          // bytes copied in
  static constexpr int kPer = kTile / (M * 32);               // elements a gate / output thread
  static constexpr int kRows = M * 32 / C;                    // positions apart, a thread's elements
  static constexpr int kBytes = kStages * (kStage + 5 * 8);   // the ring, 5 barriers a stage
  static constexpr int kMinBlocks = M == 4 ? 2 : 1;           // blocks an SM the plan wants
};

// part: 3 (B, W) planes, each (row, channel)'s sums over t of dga, dgi and
// dx r.
template <typename YT, int C, int M>
__global__ void __launch_bounds__(Layout<YT, C, M>::kThreads, Layout<YT, C, M>::kMinBlocks)
rglru_bwd_kernel(const float* __restrict__ a_bias, const float* __restrict__ i_bias,
                 const float* __restrict__ lam, const float* __restrict__ h0,
                 float* __restrict__ dh0, float* __restrict__ part,
                 const __grid_constant__ CUtensorMap ga_map,
                 const __grid_constant__ CUtensorMap gi_map,
                 const __grid_constant__ CUtensorMap dh_map,
                 const __grid_constant__ CUtensorMap h_map,
                 const __grid_constant__ CUtensorMap y_map,
                 const __grid_constant__ CUtensorMap dga_map,
                 const __grid_constant__ CUtensorMap dgi_map,
                 const __grid_constant__ CUtensorMap dy_map, int B, int T, int W) {
  using L = Layout<YT, C, M>;
  constexpr int kTile = L::kTile;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  uint64_t* full = (uint64_t*)(smem + kStages * L::kStage);   // loads landed
  uint64_t* ready = full + kStages;                           // r, i, a written
  uint64_t* folded = ready + kStages;                         // g written
  uint64_t* done = folded + kStages;                          // outputs written
  uint64_t* empty = done + kStages;                           // sums taken

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * C, b = blockIdx.y;
  const int cw = min(C, W - c0);               // the tile's channels, a multiple of 8
  const int chunks = (T + kTC - 1) / kTC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tma::bar_init(&full[s], 1);
      tma::bar_init(&ready[s], M);
      tma::bar_init(&folded[s], L::kFold);
      tma::bar_init(&done[s], M);
      tma::bar_init(&empty[s], L::kFold);
    }
    tma::fence_init();
  }
  __syncthreads();

  // Step k of every role takes chunk chunks - 1 - k (from the last down)
  // in stage k % kStages, at phase parity (k / kStages) & 1.
  if (warp == L::kLoad) {
    if (lane == 0) {
      for (int k = 0; k < chunks + kStages; ++k) {
        const int s = k % kStages;
        unsigned char* st = ring + s * L::kStage;
        if (k >= kStages) {
          const int t0 = (chunks - 1 - (k - kStages)) * kTC;
          bar_wait(&empty[s], ((k / kStages) & 1) ^ 1);
          tma::store(&dga_map, st + kGa * kTile * 4, c0, t0, b);
          tma::store(&dgi_map, st + kGi * kTile * 4, c0, t0, b);
          tma::store(&dy_map, st + kPlanes * kTile * 4, c0, t0, b);
          tma::store_wait_read();
        }
        if (k < chunks) {
          const int t0 = (chunks - 1 - k) * kTC;
          tma::bar_expect(&full[s], L::kLoaded);
          tma::load(st + kGa * kTile * 4, &ga_map, c0, t0, b, &full[s]);
          tma::load(st + kGi * kTile * 4, &gi_map, c0, t0, b, &full[s]);
          tma::load(st + kDh * kTile * 4, &dh_map, c0, t0, b, &full[s]);
          tma::load(st + kHp * kTile * 4, &h_map, c0, t0 - 1, b, &full[s]);
          tma::load(st + kPlanes * kTile * 4, &y_map, c0, t0, b, &full[s]);
        }
      }
    }
  } else if (warp >= L::kGate && warp < L::kOut) {
    // Gates: thread m on channel m % C, positions m / C + kRows i.
    const int m = threadIdx.x - 32 * L::kGate, ch = m % C, c = c0 + ch;
    const bool ok = ch < cw;
    const float neg = ok ? neg_rate(lam[c]) : 0.f;
    const float ab = ok ? a_bias[c] : 0.f, ib = ok ? i_bias[c] : 0.f;
    for (int k = 0; k < chunks; ++k) {
      const int s = k % kStages;
      float* st = (float*)(ring + s * L::kStage);
      float xa[L::kPer], xi[L::kPer];
      bar_wait(&full[s], (k / kStages) & 1);
#pragma unroll
      for (int i = 0; i < L::kPer; ++i) {
        const int e = (m / C + i * L::kRows) * C + ch;
        xa[i] = st[kGa * kTile + e];
        xi[i] = st[kGi * kTile + e];
      }
#pragma unroll
      for (int i = 0; i < L::kPer; ++i) {
        const int e = (m / C + i * L::kRows) * C + ch;
        const float3 g = rates(xa[i], xi[i], neg, ab, ib);
        st[kGa * kTile + e] = g.x;
        st[kGi * kTile + e] = g.y;
        st[kSpare * kTile + e] = g.z;
      }
      tma::fence_async();
      warp_arrive(&ready[s]);
    }
  } else if (warp >= L::kOut) {
    // Outputs, on the gate warps' elements: dga over r, dgi over i, dy
    // over y, dx r over a.
    const int m = threadIdx.x - 32 * L::kOut, ch = m % C, c = c0 + ch;
    const bool ok = ch < cw;
    const float neg = ok ? neg_rate(lam[c]) : 0.f;
    const float hp0 = ok && h0 ? h0[(long)b * W + c] : 0.f;
    for (int k = 0; k < chunks; ++k) {
      const int s = k % kStages, t0 = (chunks - 1 - k) * kTC;
      float* st = (float*)(ring + s * L::kStage);
      YT* ys = (YT*)(st + kPlanes * kTile);
      float r[L::kPer], iv[L::kPer], a[L::kPer], g[L::kPer], hp[L::kPer], yv[L::kPer];
      bar_wait(&folded[s], (k / kStages) & 1);
#pragma unroll
      for (int i = 0; i < L::kPer; ++i) {
        const int j = m / C + i * L::kRows, e = j * C + ch;
        r[i] = st[kGa * kTile + e];
        iv[i] = st[kGi * kTile + e];
        a[i] = st[kSpare * kTile + e];
        g[i] = st[kDh * kTile + e];
        hp[i] = t0 + j > 0 ? st[kHp * kTile + e] : hp0;
        yv[i] = load(ys, e);
      }
#pragma unroll
      for (int i = 0; i < L::kPer; ++i) {
        const int e = (m / C + i * L::kRows) * C + ch;
        const float om = one_minus_sq(a[i]);
        const float sq = root(om);
        const float da = __fmul_rn(g[i], hp[i]);
        const float dsq = __fmul_rn(g[i], __fmul_rn(iv[i], yv[i]));
        const float diy = __fmul_rn(g[i], sq);
        const float dom = om > 1e-12f ? __fdiv_rn(__fmul_rn(dsq, 0.5f), sq) : 0.f;
        const float dx = __fmul_rn(__fsub_rn(da, __fmul_rn(__fmul_rn(2.f, a[i]), dom)), a[i]);
        st[kGa * kTile + e] =
            __fmul_rn(__fmul_rn(dx, neg), __fmul_rn(r[i], __fsub_rn(1.f, r[i])));
        st[kGi * kTile + e] =
            __fmul_rn(__fmul_rn(diy, yv[i]), __fmul_rn(iv[i], __fsub_rn(1.f, iv[i])));
        put(ys, e, __fmul_rn(diy, iv[i]));
        st[kSpare * kTile + e] = __fmul_rn(dx, r[i]);
      }
      tma::fence_async();
      warp_arrive(&done[s]);
    }
  } else {
    // Fold and sums: lane per channel, t in decreasing order. Positions
    // past T (the last chunk's tail, read as zeros) are skipped.
    const int ch = warp * 32 + lane, c = c0 + ch;
    const bool ok = ch < cw;
    float g = 0.f, a_next = 0.f, s_ab = 0.f, s_ib = 0.f, s_neg = 0.f;
    for (int k = 0; k <= chunks; ++k) {
      if (k < chunks) {
        const int s = k % kStages, n = min(kTC, T - (chunks - 1 - k) * kTC);
        float* st = (float*)(ring + s * L::kStage);
        float av[kTC], gv[kTC];
        bar_wait(&ready[s], (k / kStages) & 1);
#pragma unroll
        for (int j = 0; j < kTC; ++j) {
          av[j] = st[kSpare * kTile + j * C + ch];
          gv[j] = st[kDh * kTile + j * C + ch];
        }
#pragma unroll
        for (int j = kTC - 1; j >= 0; --j) {
          if (j >= n) continue;
          g = __fadd_rn(gv[j], __fmul_rn(a_next, g));
          gv[j] = g;
          a_next = av[j];
        }
#pragma unroll
        for (int j = 0; j < kTC; ++j) st[kDh * kTile + j * C + ch] = gv[j];
        tma::fence_async();
        warp_arrive(&folded[s]);
      }
      if (k > 0) {
        const int kp = k - 1, s = kp % kStages, n = min(kTC, T - (chunks - 1 - kp) * kTC);
        const float* st = (const float*)(ring + s * L::kStage);
        float xa[kTC], xi[kTC], xn[kTC];
        bar_wait(&done[s], (kp / kStages) & 1);
#pragma unroll
        for (int j = 0; j < kTC; ++j) {
          xa[j] = st[kGa * kTile + j * C + ch];
          xi[j] = st[kGi * kTile + j * C + ch];
          xn[j] = st[kSpare * kTile + j * C + ch];
        }
#pragma unroll
        for (int j = kTC - 1; j >= 0; --j) {
          if (j >= n) continue;
          s_ab = __fadd_rn(s_ab, xa[j]);
          s_ib = __fadd_rn(s_ib, xi[j]);
          s_neg = __fadd_rn(s_neg, xn[j]);
        }
        tma::fence_async();
        warp_arrive(&empty[s]);
      }
    }
    if (ok) {
      if (dh0) dh0[(long)b * W + c] = __fmul_rn(a_next, g);
      const long pw = (long)B * W, at = (long)b * W + c;
      part[at] = s_ab;
      part[pw + at] = s_ib;
      part[2 * pw + at] = s_neg;
    }
  }
}

// The (W,) gradients: each plane's partials summed over the rows in order;
// d Lambda = (sum of dx r) (-8) sigmoid(Lambda).
__global__ void rglru_bwd_sum_kernel(const float* __restrict__ part,
                                     const float* __restrict__ lam, float* __restrict__ da_bias,
                                     float* __restrict__ di_bias, float* __restrict__ dlam,
                                     int B, int W) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= W) return;
  const long pw = (long)B * W;
  float s[3] = {0.f, 0.f, 0.f};
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int q = 0; q < 3; ++q) s[q] = __fadd_rn(s[q], part[q * pw + (long)b * W + c]);
  da_bias[c] = s[0];
  di_bias[c] = s[1];
  dlam[c] = __fmul_rn(__fmul_rn(s[2], -kC), sigmoid(lam[c]));
}

template <typename YT, int C, int M>
cudaError_t launch(const void* ga, const void* gi, const void* y, const void* a_bias,
                   const void* i_bias, const void* lam, const void* h0, const void* h,
                   const void* dh, void* dga, void* dgi, void* dy, void* da_bias,
                   void* di_bias, void* dlam, void* dh0, void* scratch, int B, int T, int W,
                   cudaStream_t st) {
  using L = Layout<YT, C, M>;
  const CUtensorMapDataType yt =
      sizeof(YT) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const int ys = (int)sizeof(YT);
  CUtensorMap m[8];
  const void* ptr[8] = {ga, gi, dh, h, y, dga, dgi, dy};
  for (int q = 0; q < 8; ++q)
    if (!tma::tensor_map(&m[q], ptr[q], q == 4 || q == 7 ? yt : f32, q == 4 || q == 7 ? ys : 4,
                         B, T, W, C, kTC))
      return cudaErrorInvalidValue;
  const int bytes = L::kBytes;
  auto kern = rglru_bwd_kernel<YT, C, M>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();   // reported here; leave no error for the next launch
    return e;
  }
  kern<<<dim3((W + C - 1) / C, B), L::kThreads, bytes, st>>>(
      (const float*)a_bias, (const float*)i_bias, (const float*)lam, (const float*)h0,
      (float*)dh0, (float*)scratch, m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], B, T, W);
  rglru_bwd_sum_kernel<<<(W + 127) / 128, 128, 0, st>>>(
      (const float*)scratch, (const float*)lam, (float*)da_bias, (float*)di_bias, (float*)dlam,
      B, W);
  return cudaGetLastError();
}

template <typename YT>
cudaError_t dispatch(int tile, int warps, const void* ga, const void* gi, const void* y,
                     const void* a_bias, const void* i_bias, const void* lam, const void* h0,
                     const void* h, const void* dh, void* dga, void* dgi, void* dy,
                     void* da_bias, void* di_bias, void* dlam, void* dh0, void* scratch, int B,
                     int T, int W, cudaStream_t st) {
#define RGLRU_BWD_PLAN(C, M)                                                              \
  if (tile == C && warps == M)                                                           \
    return launch<YT, C, M>(ga, gi, y, a_bias, i_bias, lam, h0, h, dh, dga, dgi, dy,     \
                            da_bias, di_bias, dlam, dh0, scratch, B, T, W, st);
  RGLRU_BWD_PLAN(32, 8)
  RGLRU_BWD_PLAN(64, 4)
  RGLRU_BWD_PLAN(64, 8)
#undef RGLRU_BWD_PLAN
  return cudaErrorInvalidValue;
}

}  // namespace

// ga, gi (B, T, W) float32; y (B, T, W) float32 (y_dtype 0) or bfloat16
// (1); a_bias, i_bias, lam (W,) float32; h0 (B, W) float32 or null (zero
// state); h (B, T, W) the forward's output and dh its gradient, float32.
// Outputs: dga, dgi (B, T, W) float32, dy in y's type, da_bias, di_bias,
// dlam (W,) float32, dh0 (B, W) float32 (null when h0 is). scratch: 3 B W
// float32. All contiguous; the (B, T, W) tensors 16-byte aligned; B, T >=
// 1, W a multiple of 8; (tile, warps), the channels a block and its gate
// (and output) warps, one of (32, 8), (64, 4), (64, 8) from the host's
// plan. Returns the CUDA error code of the launches.
extern "C" int rglru_bwd(const void* ga, const void* gi, const void* y, const void* a_bias,
                         const void* i_bias, const void* lam, const void* h0, const void* h,
                         const void* dh, void* dga, void* dgi, void* dy, void* da_bias,
                         void* di_bias, void* dlam, void* dh0, void* scratch, int B, int T,
                         int W, int y_dtype, int tile, int warps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || T < 1 || W < 1 || W % 8 || (y_dtype != 0 && y_dtype != 1) ||
      (h0 == nullptr) != (dh0 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (y_dtype == 1)
    return (int)dispatch<__nv_bfloat16>(tile, warps, ga, gi, y, a_bias, i_bias, lam, h0, h, dh,
                                        dga, dgi, dy, da_bias, di_bias, dlam, dh0, scratch, B,
                                        T, W, st);
  return (int)dispatch<float>(tile, warps, ga, gi, y, a_bias, i_bias, lam, h0, h, dh, dga, dgi,
                              dy, da_bias, di_bias, dlam, dh0, scratch, B, T, W, st);
}
