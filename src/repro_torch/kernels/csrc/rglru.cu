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
// Order: each (row, channel) folds t in increasing order (one lane of a
// block's warp 0 per channel), every operation rounded on its own (no
// contraction), so h_t depends only on
// the row's own inputs up to t: a row's result is the same bits at every
// padded length and batch size, a prompt run in two calls with the carry
// is bitwise one call, and the decode step (T = 1 with the carried h) runs
// this same code. JAX's associative scan rounds in another order; the port
// holds the two within a tolerance.
//
// Bound on the H100: the bytes, each read and written once. At B = 4, T =
// 320, W = 4096: ga and gi (float32) 42 MB, y (bf16) 10.5 MB, h (float32)
// 21 MB, ~73 MB, 22 us at 3.35 TB/s; about 20 flops and 4
// transcendentals an element are far below the compute rate. But a walk
// of one thread per (row, channel) has only B W = 16 384 threads, 4 warps
// an SM, too few to hide the latency of the gates' ~150 dependent
// instructions a step. So a block owns (row, 32 channels) and walks T in
// chunks of 64 positions: its 8 warps compute the chunk's (a, b) in
// parallel into shared memory (the gates hold no recurrence), then warp 0
// folds the chunk's 64 steps h = a h + b while the other warps compute the
// next chunk into the second buffer. The arithmetic of every element and
// the order of the fold are those of the one-thread walk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kC = 8.0f;       // the RG-LRU's c

__device__ __forceinline__ float load(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

// log(1 + e^x) as jax.nn.softplus computes it (logaddexp(x, 0)):
// max(x, 0) + log1p(exp(-|x|)).
__device__ __forceinline__ float softplus(float x) {
  return __fadd_rn(fmaxf(x, 0.f), log1pf(expf(-fabsf(x))));
}

constexpr int kCh = 32;       // channels a block: warp 0's lanes in the fold
constexpr int kWarps = 8;     // warps computing a chunk's gates
constexpr int kTC = 64;       // positions a chunk

template <typename YT>
__global__ void __launch_bounds__(kCh * kWarps)
rglru_kernel(const float* __restrict__ ga, const float* __restrict__ gi,
             const YT* __restrict__ y, const float* __restrict__ a_bias,
             const float* __restrict__ i_bias, const float* __restrict__ lam,
             const float* __restrict__ h0, const int* __restrict__ lengths,
             float* __restrict__ h, float* __restrict__ h_last, int T, int W) {
  __shared__ float a_s[2][kTC][kCh], b_s[2][kTC][kCh];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int c = blockIdx.x * kCh + lane, b = blockIdx.y;
  const bool ok = c < W;
  const float neg = ok ? __fmul_rn(-kC, softplus(lam[c])) : 0.f;
  const float ab = ok ? a_bias[c] : 0.f, ib = ok ? i_bias[c] : 0.f;
  const int last = lengths ? max(lengths[b] - 1, 0) : T - 1;
  const long row = (long)b * W + c, base = (long)b * T * W + c;
  float hv = ok && h0 ? h0[row] : 0.f;
  for (int t0 = 0, buf = 0; t0 < T; t0 += kTC, buf ^= 1) {
    const int n = min(kTC, T - t0);
    // The chunk's gates, 8 positions a warp: a and b = sqrt(1 - a^2) (i y).
    for (int j = warp; j < n; j += kWarps) {
      const long o = base + (long)(t0 + j) * W;
      float a = 0.f, g = 0.f;
      if (ok) {
        const float r = sigmoid(__fadd_rn(ga[o], ab));
        const float i = sigmoid(__fadd_rn(gi[o], ib));
        a = expf(__fmul_rn(neg, r));
        g = __fmul_rn(sqrtf(fmaxf(__fsub_rn(1.f, __fmul_rn(a, a)), 1e-12f)),
                      __fmul_rn(i, load(y, o)));
      }
      a_s[buf][j][lane] = a;
      b_s[buf][j][lane] = g;
    }
    __syncthreads();   // this chunk is staged; warp 0 is done with the other buffer
    if (warp == 0 && ok) {
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        hv = __fadd_rn(__fmul_rn(a_s[buf][j][lane], hv), b_s[buf][j][lane]);
        h[base + (long)(t0 + j) * W] = hv;
        if (t0 + j == last) h_last[row] = hv;
      }
    }
  }
}

template <typename YT>
int launch(const void* ga, const void* gi, const void* y, const void* a_bias,
           const void* i_bias, const void* lam, const void* h0, const void* lengths,
           void* h, void* h_last, int B, int T, int W, cudaStream_t st) {
  rglru_kernel<YT><<<dim3((W + kCh - 1) / kCh, B), dim3(kCh, kWarps), 0, st>>>(
      (const float*)ga, (const float*)gi, (const YT*)y, (const float*)a_bias,
      (const float*)i_bias, (const float*)lam, (const float*)h0, (const int*)lengths,
      (float*)h, (float*)h_last, T, W);
  return (int)cudaGetLastError();
}

}  // namespace

// ga, gi (B, T, W) float32; y (B, T, W) float32 (y_dtype 0) or bfloat16
// (1); a_bias, i_bias, lam (W,) float32; h0 (B, W) float32 or null (zero
// state); lengths (B,) int32 or null (every row T long); h (B, T, W) and
// h_last (B, W) float32 outputs; all contiguous. T >= 1. Returns the CUDA
// error code of the launch.
extern "C" int rglru(const void* ga, const void* gi, const void* y, const void* a_bias,
                     const void* i_bias, const void* lam, const void* h0,
                     const void* lengths, void* h, void* h_last, int B, int T, int W,
                     int y_dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || W <= 0) return (int)cudaGetLastError();
  if (T <= 0 || (y_dtype != 0 && y_dtype != 1)) return (int)cudaErrorInvalidValue;
  if (y_dtype == 1)
    return launch<__nv_bfloat16>(ga, gi, y, a_bias, i_bias, lam, h0, lengths, h, h_last, B,
                                 T, W, st);
  return launch<float>(ga, gi, y, a_bias, i_bias, lam, h0, lengths, h, h_last, B, T, W, st);
}
