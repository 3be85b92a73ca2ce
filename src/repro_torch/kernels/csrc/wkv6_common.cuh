// What the RWKV-6 kernels (wkv6.cu, wkv6_bwd.cu) share: the (B, T, H, D)
// token indexing, loads of four consecutive elements as float32, and the
// exp of an exponent that is a sum of log-decays <= 0.
#pragma once

#include <cuda_bf16.h>

namespace wkv6_common {

struct Dims {
  int B, Tn, H, K, V, C, nc;
};

__device__ __forceinline__ long tok(const Dims& d, int b, int t, int h) {
  return ((long)b * d.Tn + t) * d.H + h;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// e^min(x, 0): every exponent is <= 0 up to rounding. __expf (ex2.approx
// of x log2 e): its relative error is ~2^-22 plus |x| 2^-24, and below
// e^-10 a term is too small to reach the 1e-4 tolerance.
__device__ __forceinline__ float e0(float x) { return __expf(fminf(x, 0.f)); }

// Four consecutive elements from device memory as float32 (16-byte /
// 8-byte aligned: K and V are multiples of 4).
__device__ __forceinline__ void ldg4(const float* p, float* e) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  e[0] = q.x; e[1] = q.y; e[2] = q.z; e[3] = q.w;
}
__device__ __forceinline__ void ldg4(const __nv_bfloat16* p, float* e) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  e[0] = __uint_as_float(q.x << 16);
  e[1] = __uint_as_float(q.x & 0xffff0000u);
  e[2] = __uint_as_float(q.y << 16);
  e[3] = __uint_as_float(q.y & 0xffff0000u);
}

}  // namespace wkv6_common
