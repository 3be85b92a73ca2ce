// The RG-LRU's gate arithmetic, shared by its forward (rglru.cu) and its
// gradient (rglru_bwd.cu), so the backward recomputes the forward's a bit
// for bit. Every operation rounds on its own (no contraction).
#pragma once

#include <math.h>

namespace rglru_gates {

constexpr float kC = 8.0f;       // the RG-LRU's c

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

// log(1 + e^x) as jax.nn.softplus computes it (logaddexp(x, 0)):
// max(x, 0) + log1p(exp(-|x|)).
__device__ __forceinline__ float softplus(float x) {
  return __fadd_rn(fmaxf(x, 0.f), log1pf(expf(-fabsf(x))));
}

// -c softplus(Lambda): a = exp(neg r).
__device__ __forceinline__ float neg_rate(float lam) { return __fmul_rn(-kC, softplus(lam)); }

// One element's rates: r = sigmoid(ga + b_r), i = sigmoid(gi + b_i) and
// a = exp(neg r), as (r, i, a).
__device__ __forceinline__ float3 rates(float xa, float xi, float neg, float ab, float ib) {
  const float r = sigmoid(__fadd_rn(xa, ab));
  const float i = sigmoid(__fadd_rn(xi, ib));
  return make_float3(r, i, expf(__fmul_rn(neg, r)));
}

// 1 - a^2, and sqrt(max(1 - a^2, 1e-12)).
__device__ __forceinline__ float one_minus_sq(float a) { return __fsub_rn(1.f, __fmul_rn(a, a)); }
__device__ __forceinline__ float root(float om) { return sqrtf(fmaxf(om, 1e-12f)); }

// One element's gates: a, and b = sqrt(max(1 - a^2, 1e-12)) (i y).
__device__ __forceinline__ float2 gates(float xa, float xi, float yv, float neg, float ab,
                                        float ib) {
  const float3 g = rates(xa, xi, neg, ab, ib);
  return make_float2(g.z, __fmul_rn(root(one_minus_sq(g.z)), __fmul_rn(g.y, yv)));
}

}  // namespace rglru_gates
