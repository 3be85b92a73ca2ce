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
// Order: a thread per (row, channel), t from T - 1 down, every operation
// rounded on its own; the (W,) sums per (row, channel) in that order, then
// over the rows in order by a second launch (no atomics: two calls give the
// same bits, and a row's dga, dgi, dy and dh0 never depend on its batch).
//
// A simple first design: one thread a channel over a 64-channel tile (as
// the forward's first design did), 16 positions' loads in flight before the
// dependent chain walks them. Bound on the H100 at Griffin's training shape
// (B = 8, T = 512, W = 4096, bf16 y): it reads ga, gi, h, dh (float32) and y
// and writes dga, dgi (float32) and dy, 28 bytes an element, ~0.47 GB (0.14
// ms at 3.35 TB/s); ~60 float32 operations an element (the gates' IEEE exp,
// division and square root again) are below that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "rglru_gates.cuh"

namespace {

using rglru_gates::kC;
using rglru_gates::neg_rate;
using rglru_gates::sigmoid;

constexpr int kTileC = 64;    // channels a block
constexpr int kSub = 16;      // positions whose loads are in flight together

__device__ __forceinline__ float load(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void put(float* p, long i, float x) { p[i] = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, long i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

// part: 3 (B, W) planes, each (row, channel)'s sums over t of dga, dgi and
// dx r.
template <typename YT>
__global__ void __launch_bounds__(kTileC)
rglru_bwd_kernel(const float* __restrict__ ga, const float* __restrict__ gi,
                 const YT* __restrict__ y, const float* __restrict__ a_bias,
                 const float* __restrict__ i_bias, const float* __restrict__ lam,
                 const float* __restrict__ h0, const float* __restrict__ h,
                 const float* __restrict__ dh, float* __restrict__ dga, float* __restrict__ dgi,
                 YT* __restrict__ dy, float* __restrict__ dh0, float* __restrict__ part, int B,
                 int T, int W) {
  const int c = blockIdx.x * kTileC + threadIdx.x, b = blockIdx.y;
  if (c >= W) return;
  const float neg = neg_rate(lam[c]), ab = a_bias[c], ib = i_bias[c];
  const long row = (long)b * T * W + c;
  float g = 0.f, a_next = 0.f, s_ab = 0.f, s_ib = 0.f, s_neg = 0.f;
  for (int t1 = T; t1 > 0; t1 -= kSub) {
    const int t0 = max(t1 - kSub, 0), m = t1 - t0;
    float xa[kSub], xi[kSub], yv[kSub], hp[kSub], gh[kSub];
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      if (j >= m) break;
      const int t = t1 - 1 - j;
      const long at = row + (long)t * W;
      xa[j] = ga[at];
      xi[j] = gi[at];
      yv[j] = load(y, at);
      gh[j] = dh[at];
      hp[j] = t > 0 ? h[at - W] : (h0 ? h0[(long)b * W + c] : 0.f);
    }
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      if (j >= m) break;
      const long at = row + (long)(t1 - 1 - j) * W;
      g = __fadd_rn(gh[j], __fmul_rn(a_next, g));
      const float r = sigmoid(__fadd_rn(xa[j], ab));
      const float i = sigmoid(__fadd_rn(xi[j], ib));
      const float a = expf(__fmul_rn(neg, r));
      const float om = __fsub_rn(1.f, __fmul_rn(a, a));
      const float sq = sqrtf(fmaxf(om, 1e-12f));
      const float da = __fmul_rn(g, hp[j]);
      const float dsq = __fmul_rn(g, __fmul_rn(i, yv[j]));
      const float diy = __fmul_rn(g, sq);
      const float dom = om > 1e-12f ? __fdiv_rn(__fmul_rn(dsq, 0.5f), sq) : 0.f;
      const float dx = __fmul_rn(__fsub_rn(da, __fmul_rn(__fmul_rn(2.f, a), dom)), a);
      const float dza = __fmul_rn(__fmul_rn(dx, neg), __fmul_rn(r, __fsub_rn(1.f, r)));
      const float dzi = __fmul_rn(__fmul_rn(diy, yv[j]), __fmul_rn(i, __fsub_rn(1.f, i)));
      dga[at] = dza;
      dgi[at] = dzi;
      put(dy, at, __fmul_rn(diy, i));
      s_ab = __fadd_rn(s_ab, dza);
      s_ib = __fadd_rn(s_ib, dzi);
      s_neg = __fadd_rn(s_neg, __fmul_rn(dx, r));
      a_next = a;
    }
  }
  if (dh0) dh0[(long)b * W + c] = __fmul_rn(a_next, g);
  const long pw = (long)B * W, at = (long)b * W + c;
  part[at] = s_ab;
  part[pw + at] = s_ib;
  part[2 * pw + at] = s_neg;
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

template <typename YT>
int launch(const void* ga, const void* gi, const void* y, const void* a_bias,
           const void* i_bias, const void* lam, const void* h0, const void* h, const void* dh,
           void* dga, void* dgi, void* dy, void* da_bias, void* di_bias, void* dlam, void* dh0,
           void* scratch, int B, int T, int W, cudaStream_t st) {
  rglru_bwd_kernel<YT><<<dim3((W + kTileC - 1) / kTileC, B), kTileC, 0, st>>>(
      (const float*)ga, (const float*)gi, (const YT*)y, (const float*)a_bias,
      (const float*)i_bias, (const float*)lam, (const float*)h0, (const float*)h,
      (const float*)dh, (float*)dga, (float*)dgi, (YT*)dy, (float*)dh0, (float*)scratch, B, T,
      W);
  rglru_bwd_sum_kernel<<<(W + 127) / 128, 128, 0, st>>>(
      (const float*)scratch, (const float*)lam, (float*)da_bias, (float*)di_bias, (float*)dlam,
      B, W);
  return (int)cudaGetLastError();
}

}  // namespace

// ga, gi (B, T, W) float32; y (B, T, W) float32 (y_dtype 0) or bfloat16
// (1); a_bias, i_bias, lam (W,) float32; h0 (B, W) float32 or null (zero
// state); h (B, T, W) the forward's output and dh its gradient, float32.
// Outputs: dga, dgi (B, T, W) float32, dy in y's type, da_bias, di_bias,
// dlam (W,) float32, dh0 (B, W) float32 (null when h0 is). scratch: 3 B W
// float32. All contiguous; B, T, W >= 1. Returns the CUDA error code of
// the launches.
extern "C" int rglru_bwd(const void* ga, const void* gi, const void* y, const void* a_bias,
                         const void* i_bias, const void* lam, const void* h0, const void* h,
                         const void* dh, void* dga, void* dgi, void* dy, void* da_bias,
                         void* di_bias, void* dlam, void* dh0, void* scratch, int B, int T,
                         int W, int y_dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || T < 1 || W < 1 || (y_dtype != 0 && y_dtype != 1) ||
      (h0 == nullptr) != (dh0 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (y_dtype == 1)
    return launch<__nv_bfloat16>(ga, gi, y, a_bias, i_bias, lam, h0, h, dh, dga, dgi, dy,
                                 da_bias, di_bias, dlam, dh0, scratch, B, T, W, st);
  return launch<float>(ga, gi, y, a_bias, i_bias, lam, h0, h, dh, dga, dgi, dy, da_bias,
                       di_bias, dlam, dh0, scratch, B, T, W, st);
}
