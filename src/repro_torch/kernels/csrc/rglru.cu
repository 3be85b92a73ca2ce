// The RG-LRU of Griffin (recurrentgemma) for Hopper: the gate
// nonlinearities and the recurrence in one pass.
//
// Replaces no Pallas kernel: the JAX package computes it with XLA,
// repro/models/griffin.py _rglru_coeffs and _rglru_scan (a
// jax.lax.associative_scan). From the two float32 gate projections
// ga = y A_r and gi = y A_i (dense_matmul's fp32 store), y, the biases
// and Lambda, per element:
//   r = sigmoid(ga + b_r), i = sigmoid(gi + b_i)
//   a = exp((-8 softplus(Lambda)) r), b = sqrt(max(1 - a^2, 1e-12)) (i y)
//   h_t = a_t h_{t-1} + b_t, h_{-1} = h0 (zero without one)
// it writes h at every t (float32) and h at each row's lengths - 1 (the
// state a right-padded prompt carries out; T - 1 without lengths).
//
// Order: each (row, channel) folds t in increasing order (one lane per
// channel), every operation rounded on its own (no contraction, no fast
// math), so h_t depends only on the row's own inputs up to t: a row's
// result is the same bits at every padded length, batch size and tiling,
// a prompt run in two calls with the carry is bitwise one call, and the
// decode step (T = 1 with the carried h) computes the same element. JAX's
// associative scan rounds in another order; the port holds the two within
// a tolerance.
//
// Bound on the H100: the bytes, each read and written once. At B = 4, T =
// 320, W = 4096: ga and gi (float32) 42 MB, y (bf16) 10.5 MB, h (float32)
// 21 MB, ~73 MB, 22 us at 3.35 TB/s. The gates' IEEE exp, division and
// square root cost ~80 instructions an element, about two thirds of that
// time spread over every SM, so loads, gates and the fold must overlap.
//
// Prefill (T > 1): a block owns (one row, a tile of C channels) and streams
// T in chunks of kTC positions through one ring of kStages shared-memory
// stages, three mbarriers a stage and no block-wide barrier after the
// start. The host's plan picks (C, M) of three so that the card is full:
// (32, 16) at B = 1 (128 blocks, one an SM), (64, 16) at B = 2 (128
// blocks), (64, 8) at B = 4 (256 blocks, two an SM). Warp roles, each on
// its own barriers:
//   - one lane of the load warp copies a chunk's ga, gi and y (y in its
//     own type) into a free stage, one TMA tensor copy each, completing on
//     the stage's `full` barrier;
//   - M gate warps wait on `full`, read every input of their kPer
//     elements first (so the elements' chains overlap), write a over ga
//     and b over gi in place, fence those writes against the next tensor
//     copy into the stage, and arrive on `ready`; each thread keeps one
//     channel's -8 softplus(Lambda) and biases in registers;
//   - C / 32 fold warps, one lane a channel, wait on `ready`, read kSub
//     positions of (a, b) into registers ahead of the dependent chain, fold
//     them, write h over a and arrive on `empty`;
//   - the load lane waits on `empty`, copies that chunk's h out of the
//     stage (one TMA tensor copy), and refills it.
// So the loads of later chunks, the gates of the next and the fold of this
// one run together. The tiling never changes an element's arithmetic or its
// fold order. Timed against this layout and slower: a cp.async.bulk per row
// and 16-byte cp.async by the load warp's lanes (both keep the load warp
// issuing), a second ring for (a, b) (two more handoffs a chunk), h stored
// by the fold warps (the stores stall their chain), and 8 gate warps for a
// block alone on an SM (the gates' latency shows).
//
// Step (T = 1): its own kernel, one thread per (row, channel), no shared
// memory and no barrier: every load first, then the arithmetic, then one
// store of h (h at lengths - 1 is that same h).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "rglru_gates.cuh"
#include "tma.cuh"

namespace {

__device__ __forceinline__ float load(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}

using rglru_gates::gates;
using rglru_gates::neg_rate;
using tma::bar_wait;
using tma::warp_arrive;

// -- prefill: the streaming kernel ---------------------------------------------------

constexpr int kTC = 32;       // positions a chunk (a ring stage)
constexpr int kSub = 16;      // positions the fold holds in registers at a time
constexpr int kStages = 4;    // ring stages (more timed no faster, and cost
                              // blocks an SM)

// C channels a block, M gate warps.
template <typename YT, int C, int M>
struct Layout {
  static constexpr int kFold = C / 32;                      // fold warps
  static constexpr int kMath = M;                           // gate warps
  static constexpr int kThreads = 32 * (kFold + 1 + kMath);
  static constexpr int kTile = kTC * C;                     // elements a chunk
  static constexpr int kStage = kTile * (8 + (int)sizeof(YT));   // bytes a stage
  static constexpr int kPer = kTile / (kMath * 32);         // elements a gate thread
  static constexpr int kBytes = kStages * (kStage + 3 * 8);  // the ring, 3 barriers a stage
};

template <typename YT, int C, int M>
__global__ void __launch_bounds__(Layout<YT, C, M>::kThreads)
rglru_kernel(const float* __restrict__ a_bias,
             const float* __restrict__ i_bias, const float* __restrict__ lam,
             const float* __restrict__ h0, const int* __restrict__ lengths,
             float* __restrict__ h_last, const __grid_constant__ CUtensorMap ga_map,
             const __grid_constant__ CUtensorMap gi_map,
             const __grid_constant__ CUtensorMap y_map,
             const __grid_constant__ CUtensorMap h_map, int T, int W) {
  using L = Layout<YT, C, M>;
  constexpr int kTile = L::kTile, kFold = L::kFold, kMath = L::kMath;
  extern __shared__ __align__(128) unsigned char smem[];
  // A stage holds a chunk's [ga | gi | y] rows. The gate warps overwrite ga
  // with a and gi with b, the fold overwrites a with h, and the load lane
  // copies h out before it refills the stage: one ring carries it all.
  unsigned char* ring = smem;
  uint64_t* full = (uint64_t*)(smem + kStages * L::kStage);    // loads landed
  uint64_t* ready = full + kStages;                            // (a, b) written
  uint64_t* empty = ready + kStages;                           // h written, a and b read

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * C, b = blockIdx.y;
  const int cw = min(C, W - c0);               // the tile's channels, a multiple of 8
  const int chunks = (T + kTC - 1) / kTC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tma::bar_init(&full[s], 1);
      tma::bar_init(&ready[s], kMath);
      tma::bar_init(&empty[s], kFold);
    }
    tma::fence_init();
  }
  __syncthreads();

  if (warp == kFold) {
    // Loads and h stores, by one lane. Chunk k goes into stage k % kStages
    // once chunk k - kStages is folded: first that chunk's h goes out of the
    // stage (one tensor copy), then chunk k's ga, gi and y come in (one
    // tensor copy each; rows past T and channels past W read as zeros),
    // completing on the stage's full barrier.
    if (lane == 0) {
      for (int k = 0; k < chunks + kStages; ++k) {
        const int s = k % kStages;
        unsigned char* st = ring + s * L::kStage;
        if (k >= kStages) {
          bar_wait(&empty[s], ((k / kStages) & 1) ^ 1);
          tma::store(&h_map, st, c0, (k - kStages) * kTC, b);
          tma::store_wait_read();
        }
        if (k < chunks) {
          tma::bar_expect(&full[s], L::kStage);
          tma::load(st, &ga_map, c0, k * kTC, b, &full[s]);
          tma::load(st + kTile * 4, &gi_map, c0, k * kTC, b, &full[s]);
          tma::load(st + kTile * 8, &y_map, c0, k * kTC, b, &full[s]);
        }
      }
    }
  } else if (warp > kFold) {
    // Gates: thread m on channel m % C, positions m / C + kRows i. Every
    // input is read before any gate is computed, so the kPer elements'
    // chains overlap.
    constexpr int kRows = kMath * 32 / C;
    const int m = threadIdx.x - 32 * (kFold + 1), ch = m % C, c = c0 + ch;
    const bool ok = ch < cw;
    const float neg = ok ? neg_rate(lam[c]) : 0.f;
    const float ab = ok ? a_bias[c] : 0.f, ib = ok ? i_bias[c] : 0.f;
    for (int k = 0; k < chunks; ++k) {
      const int s = k % kStages;
      float* st = (float*)(ring + s * L::kStage);
      const YT* ys = (const YT*)(st + 2 * kTile);
      float xa[L::kPer], xi[L::kPer], yv[L::kPer];
      bar_wait(&full[s], (k / kStages) & 1);
#pragma unroll
      for (int i = 0; i < L::kPer; ++i) {
        const int e = (m / C + i * kRows) * C + ch;
        xa[i] = st[e];
        xi[i] = st[kTile + e];
        yv[i] = load(ys, e);
      }
#pragma unroll
      for (int i = 0; i < L::kPer; ++i) {
        const int e = (m / C + i * kRows) * C + ch;
        const float2 g = gates(xa[i], xi[i], yv[i], neg, ab, ib);
        st[e] = g.x;
        st[kTile + e] = g.y;
      }
      // a and b, before the load lane's next tensor copy overwrites them.
      tma::fence_async();
      warp_arrive(&ready[s]);
    }
  } else {
    // Fold: lane per channel, h_t = a_t h_{t-1} + b_t in increasing t,
    // kSub positions at a time from registers, h written over a. Past T
    // (a last partial chunk) the rows were read as zeros and the tensor
    // copy drops their h.
    const int ch = warp * 32 + lane, c = c0 + ch;
    const bool ok = ch < cw;
    const int last = lengths ? max(lengths[b] - 1, 0) : T - 1;
    float hv = ok && h0 ? h0[(long)b * W + c] : 0.f;
    for (int k = 0; k < chunks; ++k) {
      const int s = k % kStages, t0 = k * kTC, n = min(kTC, T - t0);
      float* st = (float*)(ring + s * L::kStage);
      bar_wait(&ready[s], (k / kStages) & 1);
#pragma unroll
      for (int j0 = 0; j0 < kTC; j0 += kSub) {
        float av[kSub], bv[kSub];
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          av[j] = st[(j0 + j) * C + ch];
          bv[j] = st[kTile + (j0 + j) * C + ch];
        }
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          hv = __fadd_rn(__fmul_rn(av[j], hv), bv[j]);
          av[j] = hv;
        }
#pragma unroll
        for (int j = 0; j < kSub; ++j) st[(j0 + j) * C + ch] = av[j];
      }
      if (ok && last >= t0 && last < t0 + n) h_last[(long)b * W + c] = st[(last - t0) * C + ch];
      tma::fence_async();   // h, for the store
      warp_arrive(&empty[s]);
    }
  }
}

template <typename YT, int C, int M>
cudaError_t launch_scan(const void* ga, const void* gi, const void* y, const void* a_bias,
                        const void* i_bias, const void* lam, const void* h0,
                        const void* lengths, void* h, void* h_last, int B, int T, int W,
                        cudaStream_t st) {
  using L = Layout<YT, C, M>;
  const bool bf16 = sizeof(YT) == 2;
  CUtensorMap ga_map, gi_map, y_map, h_map;
  if (!tma::tensor_map(&ga_map, ga, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, B, T, W, C, kTC) ||
      !tma::tensor_map(&gi_map, gi, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, B, T, W, C, kTC) ||
      !tma::tensor_map(&y_map, y,
                  bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                  (int)sizeof(YT), B, T, W, C, kTC) ||
      !tma::tensor_map(&h_map, h, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, B, T, W, C, kTC))
    return cudaErrorInvalidValue;
  const int bytes = L::kBytes;
  auto kern = rglru_kernel<YT, C, M>;
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) {
      cudaGetLastError();   // reported here; leave no error for the next launch
      return e;
    }
  }
  kern<<<dim3((W + C - 1) / C, B), L::kThreads, bytes, st>>>(
      (const float*)a_bias, (const float*)i_bias, (const float*)lam, (const float*)h0,
      (const int*)lengths, (float*)h_last, ga_map, gi_map, y_map, h_map, T, W);
  return cudaGetLastError();
}

template <typename YT>
cudaError_t dispatch_tile(int tile, int warps, const void* ga, const void* gi, const void* y,
                          const void* a_bias, const void* i_bias, const void* lam,
                          const void* h0, const void* lengths, void* h, void* h_last, int B,
                          int T, int W, cudaStream_t st) {
#define RGLRU_PLAN(C, M)                                                                  \
  if (tile == C && warps == M)                                                           \
    return launch_scan<YT, C, M>(ga, gi, y, a_bias, i_bias, lam, h0, lengths, h, h_last, \
                                 B, T, W, st);
  RGLRU_PLAN(32, 16)
  RGLRU_PLAN(64, 8)
  RGLRU_PLAN(64, 16)
#undef RGLRU_PLAN
  return cudaErrorInvalidValue;
}

// -- the decode step -----------------------------------------------------------------

template <typename YT>
__global__ void __launch_bounds__(128)
rglru_step_kernel(const float* __restrict__ ga, const float* __restrict__ gi,
                  const YT* __restrict__ y, const float* __restrict__ a_bias,
                  const float* __restrict__ i_bias, const float* __restrict__ lam,
                  const float* __restrict__ h0, float* __restrict__ h, int B, int W) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)B * W) return;
  const int c = (int)(i % W);
  const float l = lam[c], ab = a_bias[c], ib = i_bias[c];
  const float hp = h0 ? h0[i] : 0.f;
  const float xa = ga[i], xi = gi[i], yv = load(y, i);
  const float2 g = gates(xa, xi, yv, neg_rate(l), ab, ib);
  h[i] = __fadd_rn(__fmul_rn(g.x, hp), g.y);
}

}  // namespace

// ga, gi (B, T, W) float32; y (B, T, W) float32 (y_dtype 0) or bfloat16
// (1); a_bias, i_bias, lam (W,) float32; h0 (B, W) float32 or null (zero
// state); lengths (B,) int32 or null (every row T long); h (B, T, W) and
// h_last (B, W) float32 outputs; all contiguous, ga, gi, y and h 16-byte
// aligned. T >= 1, W a multiple of 8; (tile, warps), the channels a block
// and its gate warps, one of (32, 16), (64, 16), (64, 8) from the host's
// plan. Returns the CUDA error code of the launch.
extern "C" int rglru(const void* ga, const void* gi, const void* y, const void* a_bias,
                     const void* i_bias, const void* lam, const void* h0,
                     const void* lengths, void* h, void* h_last, int B, int T, int W,
                     int y_dtype, int tile, int warps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || W <= 0) return (int)cudaGetLastError();
  if (T <= 0 || W % 8 != 0 || (y_dtype != 0 && y_dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (y_dtype == 1)
    return (int)dispatch_tile<__nv_bfloat16>(tile, warps, ga, gi, y, a_bias, i_bias, lam, h0,
                                             lengths, h, h_last, B, T, W, st);
  return (int)dispatch_tile<float>(tile, warps, ga, gi, y, a_bias, i_bias, lam, h0, lengths, h,
                                   h_last, B, T, W, st);
}

// The T = 1 step: ga, gi, y (B, W) as above; h0 (B, W) float32 or null; h
// (B, W) float32 output (also h at lengths - 1). Returns the CUDA error
// code of the launch.
extern "C" int rglru_step(const void* ga, const void* gi, const void* y, const void* a_bias,
                          const void* i_bias, const void* lam, const void* h0, void* h,
                          int B, int W, int y_dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || W <= 0) return (int)cudaGetLastError();
  if (y_dtype != 0 && y_dtype != 1) return (int)cudaErrorInvalidValue;
  const long n = (long)B * W;
  const dim3 grid((unsigned)((n + 127) / 128));
  if (y_dtype == 1)
    rglru_step_kernel<__nv_bfloat16><<<grid, 128, 0, st>>>(
        (const float*)ga, (const float*)gi, (const __nv_bfloat16*)y, (const float*)a_bias,
        (const float*)i_bias, (const float*)lam, (const float*)h0, (float*)h, B, W);
  else
    rglru_step_kernel<float><<<grid, 128, 0, st>>>(
        (const float*)ga, (const float*)gi, (const float*)y, (const float*)a_bias,
        (const float*)i_bias, (const float*)lam, (const float*)h0, (float*)h, B, W);
  return (int)cudaGetLastError();
}
