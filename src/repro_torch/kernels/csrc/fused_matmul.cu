// Fused activation-quantize -> packed-weight integer matmul for Hopper.
//
// Replaces repro/kernels/fused_matmul.py::fused_quantize_matmul
// (_fused_kernel): (M, K) float32 activations times (K, N) weight codes
// give an exact (M, N) int32 accumulator and (M,) float32 per-row scales.
// The weights are read as PackedWeight.packed itself (2/4/8-bit codes
// packed along K, little-endian in the byte, sign-extended on unpack) and
// unpacked in registers, so device memory only ever holds packed bytes.
//
// Bound on the H100: decode (M = 4) and prefill chunks (M = 32) stream
// K*N*bits/8 weight bytes and do 2*M*K*N integer operations, far below
// the int8 ridge point, so the kernel is bound by the weight bytes. The
// design spreads the weight stream over every SM: a block owns 128
// output columns and one slice of K (split-K), and the 8 warps of a block
// walk the slice's K quads (packed_matmul.cuh). Whole-prompt prefill runs it at M = B*L (up to
// 1280 rows); the integer product is exact, so rows stay independent of M.
//
// Quantization is the JAX kernel's prologue: scale = absmax * (1/qhi)
// (the strength-reduced form jitted XLA computes), inv = 1/scale with a
// correctly rounded division, codes = clamp(rint(x * inv)) with the
// product kept out of any FMA (__fmul_rn) and rint rounding half to
// even like jnp.round. A first pass reduces each row's absmax; the
// matmul blocks quantize their activation tile in shared memory as they
// load it, so no int8 activation tensor reaches device memory.
// The contraction is dp4a on 4 consecutive K codes: signed activations
// use dp4a.s32.s32, unsigned ones (codes up to 255) dp4a.u32.s32.

#include "packed_matmul.cuh"

namespace {

using pm::kBN;
using pm::kKBMax;
using pm::kThreads;

__global__ void row_scale_kernel(const float* __restrict__ x, int K,
                                 float rq, float* __restrict__ scales) {
  const float* row = x + (size_t)blockIdx.x * K;
  float mx = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) mx = fmaxf(mx, fabsf(row[k]));
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  __shared__ float red[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  if (warp == 0) {
    mx = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) scales[blockIdx.x] = __fmul_rn(mx, rq);
  }
}

template <int BITS, int BM, bool SIGNED>
__global__ void __launch_bounds__(kThreads)
fused_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ wp,
                    const float* __restrict__ scales, int M, int K, int N,
                    int kb, int qlo, int qhi, int shift, int vec_loads,
                    int32_t* __restrict__ acc) {
  __shared__ uint32_t xq[BM][kKBMax / 4];
  __shared__ int accs[BM][kBN];
  __shared__ float inv_s[BM];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  const int k0 = blockIdx.y * kb;
  const int k1 = min(K, k0 + kb);
  const int m0 = blockIdx.z * BM;
  const int nq = (k1 - k0 + 3) / 4;

  if (tid < BM) {
    const int m = m0 + tid;
    const float s = m < M ? scales[m] : 0.f;
    inv_s[tid] = s > 0.f ? __fdiv_rn(1.0f, s) : 0.f;
  }
  for (int i = tid; i < BM * kBN; i += kThreads) accs[i / kBN][i % kBN] = 0;
  __syncthreads();

  // Quantize prologue: this block's (BM, k0:k1) activation tile → codes.
  for (int i = tid; i < BM * nq; i += kThreads) {
    const int r = i / nq, w = i % nq, m = m0 + r;
    int c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + 4 * w + j;
      const float v = (m < M && k < k1) ? x[(size_t)m * K + k] : 0.f;
      const float t = rintf(__fmul_rn(v, inv_s[r]));
      c[j] = (int)fminf(fmaxf(t, (float)qlo), (float)qhi);
    }
    xq[r][w] = pm::pack4(c[0], c[1], c[2], c[3]);
  }
  __syncthreads();

  pm::contract_tile<BITS, BM, SIGNED>(xq, accs, wp, M, K, N, k0, nq, n0, m0,
                                      shift, vec_loads, acc);
}

template <int BITS, int BM>
void launch_bm(dim3 grid, bool sgn, cudaStream_t st, const float* x,
               const int8_t* wp, const float* scales, int M, int K, int N,
               int kb, int qlo, int qhi, int shift, int vec, int32_t* acc) {
  if (sgn)
    fused_matmul_kernel<BITS, BM, true><<<grid, kThreads, 0, st>>>(
        x, wp, scales, M, K, N, kb, qlo, qhi, shift, vec, acc);
  else
    fused_matmul_kernel<BITS, BM, false><<<grid, kThreads, 0, st>>>(
        x, wp, scales, M, K, N, kb, qlo, qhi, shift, vec, acc);
}

template <int BITS>
void launch_bits(int bm, dim3 grid, bool sgn, cudaStream_t st, const float* x,
                 const int8_t* wp, const float* scales, int M, int K, int N,
                 int kb, int qlo, int qhi, int shift, int vec, int32_t* acc) {
  if (bm == 4)
    launch_bm<BITS, 4>(grid, sgn, st, x, wp, scales, M, K, N, kb, qlo, qhi, shift, vec, acc);
  else if (bm == 8)
    launch_bm<BITS, 8>(grid, sgn, st, x, wp, scales, M, K, N, kb, qlo, qhi, shift, vec, acc);
  else
    launch_bm<BITS, 16>(grid, sgn, st, x, wp, scales, M, K, N, kb, qlo, qhi, shift, vec, acc);
}

}  // namespace

// x (M, K) float32; wp (K*bits/8, N) int8 packed codes; acc (M, N) int32,
// zero-filled by the caller; scales (M,) float32. Returns the CUDA error
// code of the launches (0 = launched).
extern "C" int fused_quantize_matmul(const float* x, const int8_t* wp, int M,
                                     int K, int N, int bits, int a_bits,
                                     int act_signed, int w_plane_lo,
                                     float* scales, int32_t* acc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  const int qhi = act_signed ? (1 << (a_bits - 1)) - 1 : (1 << a_bits) - 1;
  const int qlo = act_signed ? -(1 << (a_bits - 1)) : 0;
  const float rq = 1.0f / (float)qhi;
  row_scale_kernel<<<M, 256, 0, st>>>(x, K, rq, scales);

  const pm::Plan p = pm::plan(M, K, N);
  const int shift = 2 * w_plane_lo;
  const int vec = (N % 4 == 0) ? 1 : 0;
  const bool sgn = act_signed != 0;
  if (bits == 8)
    launch_bits<8>(p.bm, p.grid, sgn, st, x, wp, scales, M, K, N, p.kb, qlo, qhi, shift, vec, acc);
  else if (bits == 4)
    launch_bits<4>(p.bm, p.grid, sgn, st, x, wp, scales, M, K, N, p.kb, qlo, qhi, shift, vec, acc);
  else if (bits == 2)
    launch_bits<2>(p.bm, p.grid, sgn, st, x, wp, scales, M, K, N, p.kb, qlo, qhi, shift, vec, acc);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
