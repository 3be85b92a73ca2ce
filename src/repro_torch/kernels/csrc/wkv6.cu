// RWKV-6 (Finch) chunked recurrence for Hopper.
//
// Replaces repro/kernels/wkv6.py::wkv6 (_wkv6_kernel), with the state
// carried in and out as repro/models/rwkv6.py::wkv6_chunked carries it:
// per head, S (K x V) and, for each token t,
//     o_t = r_t (S + diag(u) k_t v_t^T),   S <- diag(w_t) S + k_t v_t^T,
// computed chunk by chunk (chunk boundaries at absolute positions 0, C,
// 2C, ...). Per chunk, with lw = log(max(w, 1e-12)), L its inclusive
// prefix over the chunk and Lsh = L - lw:
//     term1  = (r * e^Lsh) S
//     P[t,s] = sum_k r[t,k] k[s,k] e^(Lsh[t,k] - L[s,k])   (s < t)
//     P[t,t] = sum_k r[t,k] u[k] k[t,k]
//     o      = term1 + P v
//     S     <- e^L_last * S + (k * e^(L_last - L))^T v
// Every exponent is <= 0 (decays lie in (0, 1]), so nothing overflows for
// any decay, 1e-6 included: the factorized (r e^L)(k e^-L)^T is never
// formed. The (C, C, K) gate of the TPU kernel is never materialized:
// each P entry is summed over k in one thread.
//
// Rows past T in the last chunk are pad tokens (k = 0, w = 1) and are
// skipped; a pad token given as input (bucketed prefill: k = 0, w = 1)
// adds exact zeros to the state and leaves L unchanged, and a row's
// output never reads a later row. So a prompt's outputs and final state
// do not depend on the length it was padded to, and at T = 1 this is one
// step of the recurrence (Lsh = 0, P = the u diagonal) with the carried
// state — the decode step.
//
// Bound on the H100: at the prefill shape (B = 4, T = 320, H = 40, K = V
// = 64, bf16 r/k/v, f32 w) it reads r, k, v, w and the state once and
// writes out and the state once, ~38 MB (11 us at 3.35 TB/s), against
// ~1.7 G float32 operations (~25 us at 67 TFLOP/s outside the tensor
// cores), dominated by the pairwise P (an exp and a product per pair and
// key), so the operations bound it. The design is the simple one: one
// thread block per (head, row) keeps S in shared memory across the
// chunks, stages a chunk's r, k, v, L, Lsh in shared memory, and runs the
// five steps above one after another, one output element per thread at a
// time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDim = 64;     // K, V and the chunk length the kernel takes

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ w, const float* __restrict__ u,
            const float* __restrict__ state_in, float* __restrict__ out,
            float* __restrict__ state_out, int Tn, int H, int K, int V, int C) {
  extern __shared__ float sm[];
  float* S = sm;               // K * V
  float* rs = S + K * V;       // C * K: r, then r * e^Lsh
  float* ks = rs + C * K;      // C * K: k, then k * e^(L_last - L)
  float* vs = ks + C * K;      // C * V
  float* Ls = vs + C * V;      // C * K: inclusive log-decay prefix
  float* Lsh = Ls + C * K;     // C * K: lw, then L - lw
  float* P = Lsh + C * K;      // C * C
  float* us = P + C * C;       // K
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const long sbase = ((long)b * H + h) * K * V;

  for (int i = tid; i < K * V; i += kThreads) S[i] = state_in[sbase + i];
  for (int i = tid; i < K; i += kThreads) us[i] = u[h * K + i];

  for (int c0 = 0; c0 < Tn; c0 += C) {
    const int n = min(C, Tn - c0);     // rows of this chunk; the rest are pads
    __syncthreads();                   // S written, the previous chunk read
    for (int i = tid; i < n * K; i += kThreads) {
      const int t = i / K, kk = i % K;
      const long off = (((long)b * Tn + c0 + t) * H + h) * K + kk;
      rs[i] = to_f(r[off]);
      ks[i] = to_f(k[off]);
      Lsh[i] = logf(fmaxf(w[off], 1e-12f));
    }
    for (int i = tid; i < n * V; i += kThreads) {
      const int t = i / V, vv = i % V;
      vs[i] = to_f(v[(((long)b * Tn + c0 + t) * H + h) * V + vv]);
    }
    __syncthreads();

    for (int kk = tid; kk < K; kk += kThreads) {
      float acc = 0.f;
      for (int t = 0; t < n; ++t) {
        const float lw = Lsh[t * K + kk];
        acc = __fadd_rn(acc, lw);
        Ls[t * K + kk] = acc;
        Lsh[t * K + kk] = __fsub_rn(acc, lw);
      }
    }
    __syncthreads();

    for (int i = tid; i < n * n; i += kThreads) {
      const int t = i / n, s = i % n;
      if (s > t) continue;
      float p = 0.f;
      const float* rt = rs + t * K;
      const float* kv = ks + s * K;
      if (s < t) {
        const float* lt = Lsh + t * K;
        const float* ls = Ls + s * K;
        for (int kk = 0; kk < K; ++kk)
          p = __fmaf_rn(__fmul_rn(rt[kk], kv[kk]),
                        expf(fminf(__fsub_rn(lt[kk], ls[kk]), 0.f)), p);
      } else {
        for (int kk = 0; kk < K; ++kk)
          p = __fmaf_rn(__fmul_rn(rt[kk], us[kk]), kv[kk], p);
      }
      P[t * C + s] = p;
    }
    __syncthreads();

    for (int i = tid; i < n * K; i += kThreads) rs[i] = __fmul_rn(rs[i], expf(Lsh[i]));
    __syncthreads();

    for (int i = tid; i < n * V; i += kThreads) {
      const int t = i / V, vv = i % V;
      float o = 0.f;
      for (int kk = 0; kk < K; ++kk) o = __fmaf_rn(rs[t * K + kk], S[kk * V + vv], o);
      for (int s = 0; s <= t; ++s) o = __fmaf_rn(P[t * C + s], vs[s * V + vv], o);
      out[(((long)b * Tn + c0 + t) * H + h) * V + vv] = o;
    }
    __syncthreads();               // term1 has read S, P has read ks

    const float* Llast = Ls + (n - 1) * K;
    for (int i = tid; i < n * K; i += kThreads)
      ks[i] = __fmul_rn(ks[i], expf(__fsub_rn(Llast[i % K], Ls[i])));
    __syncthreads();

    for (int i = tid; i < K * V; i += kThreads) {
      const int kk = i / V, vv = i % V;
      float acc = __fmul_rn(expf(Llast[kk]), S[i]);
      for (int s = 0; s < n; ++s) acc = __fmaf_rn(ks[s * K + kk], vs[s * V + vv], acc);
      S[i] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < K * V; i += kThreads) state_out[sbase + i] = S[i];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w, const float* u,
           const float* state_in, float* out, float* state_out, int B, int Tn, int H,
           int K, int V, int C, cudaStream_t st) {
  const size_t smem = sizeof(float) *
      ((size_t)K * V + 4 * (size_t)C * K + (size_t)C * V + (size_t)C * C + K);
  auto kern = wkv6_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(H, B), kThreads, smem, st>>>((const T*)r, (const T*)k, (const T*)v, w, u,
                                           state_in, out, state_out, Tn, H, K, V, C);
  return (int)cudaGetLastError();
}

}  // namespace

// r/k (B, T, H, K) and v (B, T, H, V) in `dtype` (0 = float32, 1 =
// bfloat16); w (B, T, H, K), u (H, K), state_in/state_out (B, H, K, V)
// and out (B, T, H, V) float32; all contiguous. K, V, chunk in 1..64.
// Returns the CUDA error code of the launch.
extern "C" int wkv6(const void* r, const void* k, const void* v, const float* w,
                    const float* u, const float* state_in, float* out,
                    float* state_out, int B, int T, int H, int K, int V, int chunk,
                    int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (K < 1 || K > kMaxDim || V < 1 || V > kMaxDim || chunk < 1 || chunk > kMaxDim ||
      B < 0 || T < 0 || H < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, state_in, out, state_out, B, T, H, K,
                                 V, chunk, st);
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, state_in, out, state_out, B, T, H, K, V, chunk,
                         st);
  return (int)cudaErrorInvalidValue;
}
