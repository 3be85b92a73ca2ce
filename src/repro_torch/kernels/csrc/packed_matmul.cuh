// Device code of the fused packed-weight integer matmul (fused_matmul.cu):
// the dp4a contraction of a block's activation-code tile against 2/4/8-bit
// weight codes read packed from device memory, and the grid plan it
// launches with. (The unfused bitplane_matmul.cu runs on the int8 tensor
// cores instead.)
//
// A block owns kBN = 128 output columns, BM rows and one slice of K
// (split-K). Its activation codes sit in shared memory as words of 4
// consecutive K codes (`xq`), filled by the kernel's own prologue. Each
// thread loads 32-bit words holding 4 columns' packed bytes (a warp reads
// 128 contiguous bytes per packed row), unpacks them in registers
// (sign-extended, arithmetically shifted by 2 * w_plane_lo, i.e. only the
// top weight planes are kept) and contracts 4 K codes at a time with dp4a.
// Integer addition is exact and associative, so the split-K atomics give
// bitwise the same accumulator in any order: a row's result never depends
// on M, on the split or on the other rows.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pm {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 128;        // output columns per block: 32 lanes x 4
constexpr int kKBMax = 512;     // K elements per block (split-K slice)

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

// Contract the block's code tile xq (BM rows x nq quads of K, starting at
// k0) with packed weight columns [n0, n0 + kBN), then store (one K slice)
// or atomically add (split-K) the BM x kBN tile into acc (M, N). `accs` is
// the block's shared BM x kBN scratch, zeroed by the caller before the
// __syncthreads that publishes xq. Unsigned activations (codes up to 255)
// contract with dp4a.u32.s32.
template <int BITS, int BM, bool SIGNED>
__device__ __forceinline__ void contract_tile(
    const uint32_t (*xq)[kKBMax / 4], int (*accs)[kBN],
    const int8_t* __restrict__ wp, int M, int K, int N, int k0, int nq, int n0,
    int m0, int shift, int vec_loads, int32_t* __restrict__ acc) {
  constexpr int RPQ = BITS / 2;     // packed rows per quad of K
  constexpr int EPB = 8 / BITS;     // codes per byte
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kp_rows = K * BITS / 8;

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

// Grid (N tiles, K slices, M tiles) and rows per block: split K until ~2
// blocks per SM are in flight, each slice >= 256 K and <= kKBMax.
struct Plan {
  dim3 grid;
  int bm, kb;
};

inline Plan plan(int M, int K, int N) {
  Plan p;
  p.bm = M <= 4 ? 4 : (M <= 8 ? 8 : 16);
  const int n_tiles = (N + kBN - 1) / kBN;
  const int m_tiles = (M + p.bm - 1) / p.bm;
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
  p.kb = kb;
  p.grid = dim3(n_tiles, ksplit, m_tiles);
  return p;
}

}  // namespace pm
