// Batch-invariant bf16 matrix product for Hopper: y = x @ W.
//
// Not a port of a Pallas kernel: the JAX package leaves rwkv6's dense
// products to XLA. It exists for one contract. rwkv6's static batch and
// solo prefill (and so static and continuous serving) must give a row the
// same bits whatever the number of rows M in its product. cuBLAS picks its
// algorithm from M and splits K at small M, so a row's sum moved with M.
//
// x (M, K) bf16, W (K, N) bf16 row-major, fp32 accumulation, y (M, N) bf16
// rounded to nearest. One tile plan for every M: a block owns a 64 x 32
// tile of y (4 warps, 16 rows each, four m16n8 tiles per warp), and walks
// K in increasing order in tiles of 128, each as eight k16 steps of
// `mma.sync.aligned.m16n8k16` bf16 -> fp32 in order, accumulating in
// registers. No split over K, no atomics, no stream-K: a row of y is the
// same chain of mma instructions on the same operands at M = 1 and at
// M = 1280, so its bits do not depend on M. Rows past M and the K / N
// tails are staged as zeros (cp.async zero fill), which add exactly 0.
//
// Bound on the H100: at decode (M <= 16) it must read W once, 2 K N bytes
// (13 MB for 2560 x 2560, 3.9 us at 3.35 TB/s), so bytes bound it; the
// narrow 32-column strips give N / 32 blocks (80 for N = 2560, 2048 for
// the 65536-wide head) and a 3-stage cp.async ring keeps 128 x 32 tiles
// of W in flight (dynamic shared memory); the K-tile width only groups
// the k16 steps, so it leaves every bit as it is. At prefill (M = 1280)
// the 2 M K N operations bound it (8.4 GFLOP for 2560 x 2560, 8.5 us at
// the bf16 peak); mma.sync on 64 x 32 tiles re-reads W once per 64 rows,
// from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using mma::cp16;
using mma::ldm_x4;
using mma::ldm_x4_t;
using mma::mma16816;

constexpr int kThreads = 128;
constexpr int kBM = 64, kBN = 32, kBK = 128, kStages = 3;   // 72 KB of tiles
constexpr int kNJ = kBN / 8;     // 16-byte chunks of a W row; n8 tiles of a warp

// Shared tiles, XOR-swizzled by 16-byte chunk so ldmatrix reads no bank
// twice: x rows are 128 bf16 (16 chunks, chunk c of row r at c ^ (r & 7)),
// W rows 32 bf16 (4 chunks, chunk c of row r at c ^ ((r >> 1) & 3)).
struct Smem {
  __nv_bfloat16 a[kStages][kBM][kBK];
  __nv_bfloat16 b[kStages][kBK][kBN];
};

__device__ __forceinline__ __nv_bfloat16* a_at(Smem& s, int st, int r, int c) {
  return &s.a[st][r][((c ^ (r & 7)) << 3)];
}
__device__ __forceinline__ __nv_bfloat16* b_at(Smem& s, int st, int r, int c) {
  return &s.b[st][r][((c ^ ((r >> 1) & 3)) << 3)];
}

__global__ void __launch_bounds__(kThreads)
dense_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ y,
                    int M, int K, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  Smem& s = *reinterpret_cast<Smem*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int nk = (K + kBK - 1) / kBK;

  auto load = [&](int st, int kt) {
    const int k0 = kt * kBK;
    // x tile: 64 rows x kBK / 8 chunks.
#pragma unroll
    for (int i = 0; i < kBM * kBK / 8 / kThreads; ++i) {
      const int idx = tid + i * kThreads, r = idx / (kBK / 8), c = idx % (kBK / 8);
      const int gm = m0 + r, gk = k0 + c * 8;
      const bool ok = gm < M && gk < K;
      cp16(a_at(s, st, r, c), ok ? x + (size_t)gm * K + gk : x, ok);
    }
    // W tile: kBK rows x 4 chunks.
#pragma unroll
    for (int i = 0; i < kBK * kNJ / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kNJ, c = idx % kNJ;
      const int gk = k0 + r, gn = n0 + c * 8;
      const bool ok = gk < K && gn < N;
      cp16(b_at(s, st, r, c), ok ? w + (size_t)gk * N + gn : w, ok);
    }
  };

  float acc[kNJ][4];
#pragma unroll
  for (int j = 0; j < kNJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load(st, st);
    mma::cp_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();   // tile kt has landed; the stage refilled below is free
    const int nxt = kt + kStages - 1;
    if (nxt < nk) load(nxt % kStages, nxt);
    mma::cp_commit();
    const int st = kt % kStages;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {     // k16 steps in increasing order
      uint32_t a[4], b[2 * kNJ];
      ldm_x4(a, a_at(s, st, warp * 16 + (lane & 15), ks * 2 + (lane >> 4)));
      const int kr = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int p = 0; p < kNJ / 2; ++p) ldm_x4_t(b + 4 * p, b_at(s, st, kr, 2 * p + (lane >> 4)));
#pragma unroll
      for (int j = 0; j < kNJ; ++j) mma16816(acc[j], a, b[2 * j], b[2 * j + 1]);
    }
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kNJ; ++j) {
    const int col = n0 + j * 8 + 2 * t;
    if (col >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + warp * 16 + g + 8 * h;
      if (row < M)
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * N + col) =
            __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
}

}  // namespace

// x (M, K), w (K, N), y (M, N): contiguous bfloat16; K and N multiples of
// 8 (16-byte rows of chunks). Returns the CUDA error code of the launch.
extern "C" int dense_matmul(const void* x, const void* w, void* y, int M, int K, int N,
                            void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (K <= 0 || K % 8 || N % 8) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  constexpr int bytes = (int)sizeof(Smem);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dense_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dense_matmul_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)y, M, K, N);
  return (int)cudaGetLastError();
}
