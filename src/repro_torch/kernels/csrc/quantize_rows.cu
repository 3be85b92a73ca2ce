// Per-row symmetric absmax quantization for Hopper.
//
// Replaces repro/kernels/pack_quant.py::quantize_rows
// (_quantize_rows_kernel): (M, K) float32 activations become int8 codes
// and (M,) float32 per-row scales, the activation half of the Table III
// mixed-group matmul (one quantization shared by both filter groups).
//
// Arithmetic, bitwise the JAX kernel's: scale = absmax * (1/qhi) (the
// strength-reduced form jitted XLA computes; 1/qhi is rounded once on the
// host), inv = 1/scale with a correctly rounded division (0 for an
// all-zero row), codes = clamp(rint(x * inv), qlo, qhi) with the product
// kept out of any FMA (__fmul_rn) and rint rounding half to even like
// jnp.round. A code is stored through an int hop so that unsigned 8-bit
// codes wrap (255 is stored as -1) instead of saturating.
//
// Bound on the H100: it reads 4 bytes and writes 1 byte per element and
// does a handful of operations each, so it is bound by bytes. The design
// is one block per row: the row's absmax is reduced with warp shuffles
// and shared memory, then the same block reads the row again (from L1/L2,
// a row is at most a few KB) and writes its codes, coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const float* __restrict__ x, int K, float rq, int qlo,
                     int qhi, int8_t* __restrict__ codes,
                     float* __restrict__ scales) {
  const float* row = x + (size_t)blockIdx.x * K;
  int8_t* out = codes + (size_t)blockIdx.x * K;
  __shared__ float red[kThreads / 32];
  __shared__ float inv_s;

  float mx = 0.f;
  for (int k = threadIdx.x; k < K; k += kThreads) mx = fmaxf(mx, fabsf(row[k]));
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  if (warp == 0) {
    mx = lane < kThreads / 32 ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) {
      const float s = __fmul_rn(mx, rq);
      scales[blockIdx.x] = s;
      inv_s = s > 0.f ? __fdiv_rn(1.0f, s) : 0.f;
    }
  }
  __syncthreads();

  const float inv = inv_s;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const float t = rintf(__fmul_rn(row[k], inv));
    const int c = (int)fminf(fmaxf(t, (float)qlo), (float)qhi);
    out[k] = (int8_t)(uint8_t)(c & 0xff);
  }
}

}  // namespace

// x (M, K) float32 → codes (M, K) int8, scales (M,) float32. Returns the
// CUDA error code of the launch (0 = launched).
extern "C" int quantize_rows(const float* x, int M, int K, int bits, int signed_,
                             int8_t* codes, float* scales, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 0) return (int)cudaGetLastError();
  const int qhi = signed_ ? (1 << (bits - 1)) - 1 : (1 << bits) - 1;
  const int qlo = signed_ ? -(1 << (bits - 1)) : 0;
  const float rq = 1.0f / (float)qhi;
  quantize_rows_kernel<<<M, kThreads, 0, st>>>(x, K, rq, qlo, qhi, codes, scales);
  return (int)cudaGetLastError();
}
