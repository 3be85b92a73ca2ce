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
// output columns and one slice of K (split-K), each thread loads 32-bit
// words holding 4 columns' bytes (a warp reads 128 contiguous bytes per
// packed row), and the 8 warps of a block walk the slice's K quads.
// Integer addition is exact and associative, so the split-K atomics give
// bitwise the same accumulator in any order: a row's result never
// depends on M, on the split or on the other rows.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 128;        // output columns per block: 32 lanes x 4
constexpr int kKBMax = 512;     // K elements per block (split-K slice)

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

template <bool SIGNED>
__device__ __forceinline__ int dot4(uint32_t a, uint32_t b, int c) {
  int d;
  if (SIGNED) {
    asm("dp4a.s32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  } else {
    asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  }
  return d;
}

// Sign-extended `bits`-wide field at bit `pos` of w.
template <int BITS>
__device__ __forceinline__ int field(uint32_t w, int pos) {
  return ((int)(w << (32 - pos - BITS))) >> (32 - BITS);
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) |
         ((uint32_t)(c & 0xff) << 16) | ((uint32_t)(d & 0xff) << 24);
}

template <int BITS, int BM, bool SIGNED>
__global__ void __launch_bounds__(kThreads)
fused_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ wp,
                    const float* __restrict__ scales, int M, int K, int N,
                    int kb, int qlo, int qhi, int shift, int vec_loads,
                    int32_t* __restrict__ acc) {
  constexpr int RPQ = BITS / 2;     // packed rows per quad of K
  constexpr int EPB = 8 / BITS;     // codes per byte
  __shared__ uint32_t xq[BM][kKBMax / 4];
  __shared__ int accs[BM][kBN];
  __shared__ float inv_s[BM];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kBN;
  const int k0 = blockIdx.y * kb;
  const int k1 = min(K, k0 + kb);
  const int m0 = blockIdx.z * BM;
  const int nq = (k1 - k0 + 3) / 4;
  const int kp_rows = K * BITS / 8;

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
    xq[r][w] = pack4(c[0], c[1], c[2], c[3]);
  }
  __syncthreads();

  int a[BM][4];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) a[m][c] = 0;

  const int c0 = n0 + 4 * lane;
  for (int q = warp; q < nq; q += kWarps) {
    const int rb = (k0 + 4 * q) * BITS / 8;
    uint32_t W[RPQ];
#pragma unroll
    for (int r = 0; r < RPQ; ++r) {
      const int row = rb + r;
      uint32_t w = 0;
      if (row < kp_rows) {
        const int8_t* p = wp + (size_t)row * N + c0;
        if (vec_loads && c0 + 3 < N) {
          w = *reinterpret_cast<const uint32_t*>(p);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c0 + c < N) w |= (uint32_t)(uint8_t)p[c] << (8 * c);
        }
      }
      W[r] = w;
    }
    uint32_t wv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int code[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        code[kk] = field<BITS>(W[kk / EPB], 8 * c + (kk % EPB) * BITS) >> shift;
      wv[c] = pack4(code[0], code[1], code[2], code[3]);
    }
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      const uint32_t xa = xq[m][q];
#pragma unroll
      for (int c = 0; c < 4; ++c) a[m][c] = dot4<SIGNED>(xa, wv[c], a[m][c]);
    }
  }

#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) atomicAdd(&accs[m][4 * lane + c], a[m][c]);
  __syncthreads();

  const bool split = gridDim.y > 1;
  for (int i = tid; i < BM * kBN; i += kThreads) {
    const int m = m0 + i / kBN, n = n0 + i % kBN;
    if (m < M && n < N) {
      int32_t* dst = acc + (size_t)m * N + n;
      if (split) atomicAdd(dst, accs[i / kBN][i % kBN]);
      else *dst = accs[i / kBN][i % kBN];
    }
  }
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

  const int bm = M <= 4 ? 4 : (M <= 8 ? 8 : 16);
  const int n_tiles = (N + kBN - 1) / kBN;
  const int m_tiles = (M + bm - 1) / bm;
  // Split K until ~2 blocks per SM are in flight, each slice >= 256 K.
  const int target = 2 * 132;
  int ksplit = (target + n_tiles * m_tiles - 1) / (n_tiles * m_tiles);
  const int max_split = (K + 255) / 256;
  if (ksplit > max_split) ksplit = max_split;
  if (ksplit < 1) ksplit = 1;
  int kb = (K + ksplit - 1) / ksplit;
  kb = (kb + 15) / 16 * 16;
  if (kb > kKBMax) kb = kKBMax;
  if (kb < 16) kb = 16;
  ksplit = (K + kb - 1) / kb;
  const dim3 grid(n_tiles, ksplit, m_tiles);
  const int shift = 2 * w_plane_lo;
  const int vec = (N % 4 == 0) ? 1 : 0;
  const bool sgn = act_signed != 0;
  if (bits == 8)
    launch_bits<8>(bm, grid, sgn, st, x, wp, scales, M, K, N, kb, qlo, qhi, shift, vec, acc);
  else if (bits == 4)
    launch_bits<4>(bm, grid, sgn, st, x, wp, scales, M, K, N, kb, qlo, qhi, shift, vec, acc);
  else if (bits == 2)
    launch_bits<2>(bm, grid, sgn, st, x, wp, scales, M, K, N, kb, qlo, qhi, shift, vec, acc);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
