// Per-row symmetric absmax quantization for Hopper.
//
// Replaces repro/kernels/pack_quant.py::quantize_rows
// (_quantize_rows_kernel): (M, K) float32 or bfloat16 activations become
// int8 codes and (M,) float32 per-row scales, the activation half of the
// Table III mixed-group matmul (one quantization shared by both filter
// groups). bfloat16 rows are read as they are: bf16 -> f32 is exact, so
// the codes are bitwise those of the JAX kernel on x.astype(float32).
//
// Arithmetic, bitwise the JAX kernel's: scale = absmax * (1/qhi) (the
// strength-reduced form jitted XLA computes; 1/qhi is rounded once on the
// host), inv = 1/scale with a correctly rounded division (0 for an
// all-zero row), codes = clamp(rint(x * inv), qlo, qhi) with the product
// kept out of any FMA (__fmul_rn) and rint rounding half to even like
// jnp.round. A code is stored through an int hop so that unsigned 8-bit
// codes wrap (255 is stored as -1) instead of saturating.
//
// Bound on the H100: bytes. It reads each element once (4 or 2 bytes) and
// writes one byte and a scale per row, with a handful of operations an
// element. Design: a row stays in registers between its absmax and its
// codes, so device memory is read once. A group of TPR threads (a power
// of two, sized by K, at most 1 024) owns a row; each thread issues NV
// 16-byte loads (4 float32 or 8 bfloat16 values each, 16 values a
// thread) before it uses any, the group reduces the absmax with warp
// shuffles (through shared memory when it spans several warps), and each
// thread stores its codes 4 or 8 bytes at a time. A row longer than one
// span of 1 024 x 16 values is walked span by span twice, once for the
// absmax and once for the codes, the second read mostly from L2. A
// 256-thread block holds 256 / TPR rows: M = 1280 at K = 2048 is 640
// blocks (one wave on 132 SMs), decode (M = 4) one block. Of 8, 16 and
// 32 values a thread, only 16 was near the fastest at both K = 2048 and
// K = 8192 in a sweep on the H100. Rows whose bytes are not a whole
// number of 16-byte vectors, or not 16-byte aligned, take element loads
// and byte stores through the same registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;     // threads a block, unless one row needs more
constexpr int kMaxTPR = 1024;   // threads a row at most

constexpr int kValues = 16;     // values a thread holds at a time

// Values per 16-byte vector.
template <typename XT> constexpr int kE = 16 / (int)sizeof(XT);

__device__ __forceinline__ void unpack(const uint4& q, float* e, float) {
  e[0] = __uint_as_float(q.x); e[1] = __uint_as_float(q.y);
  e[2] = __uint_as_float(q.z); e[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack(const uint4& q, float* e, __nv_bfloat16) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    e[2 * i] = __uint_as_float(w[i] << 16);
    e[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// A group of 2^tpr_log2 threads owns a row; the row is walked in
// `chunks` spans of tpr * kValues values (one span up to K = 16 384).
template <typename XT, bool VEC>
__global__ void __launch_bounds__(kMaxTPR)
quantize_rows_kernel(const XT* __restrict__ x, int M, int K, int tpr_log2, int chunks,
                     float rq, int qlo, int qhi, int8_t* __restrict__ codes,
                     float* __restrict__ scales) {
  constexpr int E = kE<XT>;
  constexpr int NV = kValues / E;   // 16-byte vectors a thread holds
  const int tpr = 1 << tpr_log2;
  const int span = tpr * kValues;
  const int li = threadIdx.x & (tpr - 1);
  const int row = blockIdx.x * (blockDim.x >> tpr_log2) + (threadIdx.x >> tpr_log2);
  const bool live = row < M;
  const XT* src = x + (size_t)row * K;

  // Thread li holds vectors li, li + tpr, ... of a span: all loads first.
  float v[NV][E];
  auto load = [&](int c) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int k0 = c * span + (li + j * tpr) * E;
      if constexpr (VEC) {
        uint4 q = make_uint4(0u, 0u, 0u, 0u);
        if (live && k0 < K) q = *reinterpret_cast<const uint4*>(src + k0);
        unpack(q, v[j], XT());
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) v[j][e] = live && k0 + e < K ? to_f(src[k0 + e]) : 0.f;
      }
    }
  };
  float mx = 0.f;
  for (int c = 0; c < chunks; ++c) {
    load(c);
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < E; ++e) mx = fmaxf(mx, fabsf(v[j][e]));
  }

  // The row's absmax: lanes of one group exchange within their warp;
  // a group wider than a warp meets in shared memory.
  for (int o = min(tpr, 32) >> 1; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (tpr > 32) {
    __shared__ float red[kMaxTPR / 32];
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
    __syncthreads();
    const int w0 = (threadIdx.x >> tpr_log2) << (tpr_log2 - 5);
    for (int w = 0; w < tpr >> 5; ++w) mx = fmaxf(mx, red[w0 + w]);
  }
  if (!live) return;
  const float s = __fmul_rn(mx, rq);
  const float inv = s > 0.f ? __fdiv_rn(1.0f, s) : 0.f;
  if (li == 0) scales[row] = s;

  int8_t* dst = codes + (size_t)row * K;
  for (int c = 0; c < chunks; ++c) {
    if (chunks > 1) load(c);   // a row past the registers is read again (from L2)
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int k0 = c * span + (li + j * tpr) * E;
      uint32_t b[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float t = rintf(__fmul_rn(v[j][e], inv));
        b[e] = (uint32_t)((int)fminf(fmaxf(t, (float)qlo), (float)qhi) & 0xff);
      }
      if constexpr (VEC) {
        if (k0 >= K) continue;
        if constexpr (E == 4) {
          *reinterpret_cast<uint32_t*>(dst + k0) = b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24;
        } else {
          *reinterpret_cast<uint2*>(dst + k0) =
              make_uint2(b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24,
                         b[4] | b[5] << 8 | b[6] << 16 | b[7] << 24);
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (k0 + e < K) dst[k0 + e] = (int8_t)(uint8_t)b[e];
      }
    }
  }
}

template <typename XT>
int launch(const XT* x, int M, int K, float rq, int qlo, int qhi, int8_t* codes,
           float* scales, cudaStream_t st) {
  const long long need = ((long long)K + kValues - 1) / kValues;   // threads a row
  int lg = 0;
  while ((1LL << lg) < need && (1 << lg) < kMaxTPR) ++lg;
  const int chunks = (int)(((long long)K + (kValues << lg) - 1) / (kValues << lg));
  const int threads = max(kBlock, 1 << lg);
  const int grid = (M + (threads >> lg) - 1) / (threads >> lg);
  const bool vec = ((long long)K * (long long)sizeof(XT)) % 16 == 0 &&
                   (uintptr_t)x % 16 == 0 && (uintptr_t)codes % 16 == 0;
  if (vec)
    quantize_rows_kernel<XT, true><<<grid, threads, 0, st>>>(x, M, K, lg, chunks, rq, qlo,
                                                            qhi, codes, scales);
  else
    quantize_rows_kernel<XT, false><<<grid, threads, 0, st>>>(x, M, K, lg, chunks, rq, qlo,
                                                             qhi, codes, scales);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) float32 (x_dtype 0) or bfloat16 (1) → codes (M, K) int8,
// scales (M,) float32, any K. Returns the CUDA error code of the launch
// (0 = launched).
extern "C" int quantize_rows(const void* x, int x_dtype, int M, int K, int bits,
                             int signed_, int8_t* codes, float* scales, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bits < 2 || bits > 8 || K < 0 || (x_dtype != 0 && x_dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (M <= 0) return (int)cudaGetLastError();
  const int qhi = signed_ ? (1 << (bits - 1)) - 1 : (1 << bits) - 1;
  const int qlo = signed_ ? -(1 << (bits - 1)) : 0;
  const float rq = 1.0f / (float)qhi;
  if (x_dtype == 0)
    return launch(static_cast<const float*>(x), M, K, rq, qlo, qhi, codes, scales, st);
  return launch(static_cast<const __nv_bfloat16*>(x), M, K, rq, qlo, qhi, codes, scales, st);
}
