// Exact integer matmul of int8 activation codes by packed weight codes,
// for Hopper.
//
// Replaces repro/kernels/bitplane_matmul.py::bitplane_matmul
// (_bitplane_matmul_kernel): (M, K) activation codes times (K, N) weight
// codes give the exact (M, N) int32 product. The TPU kernel splits the
// activations into 2-bit offset-binary planes, runs one MXU pass per
// plane and subtracts offset * colsum(W); the sum it builds is x @ W, and
// dp4a computes that product directly, so no plane, offset or colsum
// exists here: odd a_bits need no partial top plane, and zero padding
// (codes past K or N) contributes exact zeros. The weights arrive as
// PackedWeight bytes (2/4/8 bits, little-endian along K; w_bits = 8 is the
// (K, N) codes themselves) and are unpacked in registers, so the low-bit
// group of a Table III layer is never unpacked in device memory.
// w_plane_lo is an arithmetic shift of each unpacked weight code before
// it enters the product, the TPU kernel's "shift before the colsum
// correction". Unsigned activation codes may arrive wrapped (an 8-bit 255
// is stored as int8 -1): they are read mod 2^a_bits and contracted with
// dp4a.u32.s32.
//
// Bound on the H100: the Table III matmul at decode and prefill shapes
// streams K*N*bits/8 weight bytes against M*K code bytes; like the fused
// kernel it is bound by the weight bytes at small M. The design is the
// fused kernel's (packed_matmul.cuh: 128 columns and one K slice per
// block, split-K with integer atomics, so a row's result never depends on
// M); only the prologue differs: it stages the block's int8 code tile in
// shared memory instead of quantizing floats.

#include "packed_matmul.cuh"

namespace {

using pm::kBN;
using pm::kKBMax;
using pm::kThreads;

template <int BITS, int BM, bool SIGNED>
__global__ void __launch_bounds__(kThreads)
bitplane_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wp,
                       int M, int K, int N, int kb, int amask, int shift,
                       int vec_loads, int32_t* __restrict__ acc) {
  __shared__ uint32_t xq[BM][kKBMax / 4];
  __shared__ int accs[BM][kBN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  const int k0 = blockIdx.y * kb;
  const int k1 = min(K, k0 + kb);
  const int m0 = blockIdx.z * BM;
  const int nq = (k1 - k0 + 3) / 4;

  for (int i = tid; i < BM * kBN; i += kThreads) accs[i / kBN][i % kBN] = 0;
  for (int i = tid; i < BM * nq; i += kThreads) {
    const int r = i / nq, w = i % nq, m = m0 + r;
    int c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + 4 * w + j;
      const int v = (m < M && k < k1) ? (int)x[(size_t)m * K + k] : 0;
      c[j] = SIGNED ? v : (v & amask);
    }
    xq[r][w] = pm::pack4(c[0], c[1], c[2], c[3]);
  }
  __syncthreads();

  pm::contract_tile<BITS, BM, SIGNED>(xq, accs, wp, M, K, N, k0, nq, n0, m0,
                                      shift, vec_loads, acc);
}

template <int BITS, int BM>
void launch_bm(dim3 grid, bool sgn, cudaStream_t st, const int8_t* x,
               const int8_t* wp, int M, int K, int N, int kb, int amask,
               int shift, int vec, int32_t* acc) {
  if (sgn)
    bitplane_matmul_kernel<BITS, BM, true><<<grid, kThreads, 0, st>>>(
        x, wp, M, K, N, kb, amask, shift, vec, acc);
  else
    bitplane_matmul_kernel<BITS, BM, false><<<grid, kThreads, 0, st>>>(
        x, wp, M, K, N, kb, amask, shift, vec, acc);
}

template <int BITS>
void launch_bits(int bm, dim3 grid, bool sgn, cudaStream_t st, const int8_t* x,
                 const int8_t* wp, int M, int K, int N, int kb, int amask,
                 int shift, int vec, int32_t* acc) {
  if (bm == 4)
    launch_bm<BITS, 4>(grid, sgn, st, x, wp, M, K, N, kb, amask, shift, vec, acc);
  else if (bm == 8)
    launch_bm<BITS, 8>(grid, sgn, st, x, wp, M, K, N, kb, amask, shift, vec, acc);
  else
    launch_bm<BITS, 16>(grid, sgn, st, x, wp, M, K, N, kb, amask, shift, vec, acc);
}

}  // namespace

// x (M, K) int8 activation codes; wp (K*bits/8, N) int8 packed weight
// codes; acc (M, N) int32, zero-filled by the caller. Returns the CUDA
// error code of the launch (0 = launched).
extern "C" int bitplane_matmul(const int8_t* x, const int8_t* wp, int M, int K,
                               int N, int bits, int a_bits, int act_signed,
                               int w_plane_lo, int32_t* acc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  const pm::Plan p = pm::plan(M, K, N);
  const int amask = (1 << a_bits) - 1;
  const int shift = 2 * w_plane_lo;
  const int vec = (N % 4 == 0) ? 1 : 0;
  const bool sgn = act_signed != 0;
  if (bits == 8)
    launch_bits<8>(p.bm, p.grid, sgn, st, x, wp, M, K, N, p.kb, amask, shift, vec, acc);
  else if (bits == 4)
    launch_bits<4>(p.bm, p.grid, sgn, st, x, wp, M, K, N, p.kb, amask, shift, vec, acc);
  else if (bits == 2)
    launch_bits<2>(p.bm, p.grid, sgn, st, x, wp, M, K, N, p.kb, amask, shift, vec, acc);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
