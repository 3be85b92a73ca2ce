// The block routine of the batch-invariant bf16 product y = x @ W, shared by
// dense_matmul.cu (one product) and expert_matmul.cu (one product an expert,
// each expert's rows counted on the device). The summation order and the tile
// plans are described in dense_matmul.cu: an element's bits depend on (K, N)
// and the slice plan alone, never on the tile plan, on M or on the block that
// computes it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace dense {

using mma::cp16;
using mma::ldm_x4;
using mma::ldm_x4_t;
using mma::mma16816;

constexpr int kSliceTile = 128;   // K slices are whole multiples of this

// A block tile: BM x BN of y, K in BK-wide tiles through a STAGES-deep
// cp.async ring, WARPS_M x WARPS_N warps each owning (BM / WARPS_M) x
// (BN / WARPS_N) as m16 x n8 mma tiles.
template <int BM_, int BN_, int BK_, int STAGES_, int WARPS_M_, int WARPS_N_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, kStages = STAGES_;
  static constexpr int kWarpsM = WARPS_M_, kWarpsN = WARPS_N_;
  static constexpr int kThreads = 32 * kWarpsM * kWarpsN;
  static constexpr int kMI = BM / kWarpsM / 16, kNJ = BN / kWarpsN / 8;
};
using Decode = Tile<16, 128, 64, 4, 1, 4>;      // 72 KB
using Strip = Tile<64, 32, 128, 3, 4, 1>;       // 72 KB
using Wide = Tile<128, 128, 64, 3, 2, 4>;       // 96 KB
using WideSplit = Tile<128, 128, 32, 3, 2, 4>;  // 48 KB + 64 KB of running totals

// How a block meets the K slices: kOne runs one slice (block z of the grid
// runs slice z); kWalkRegs / kWalkSmem walk all of them and keep the
// running total in registers / in shared memory (one slot a thread).
enum Mode { kOne, kWalkRegs, kWalkSmem };

template <typename T, int MODE>
struct Smem {
  static constexpr int kTot = MODE == kWalkSmem ? T::kMI * T::kNJ * 4 : 1;
  __nv_bfloat16 a[T::kStages][T::BM][T::BK];
  __nv_bfloat16 b[T::kStages][T::BK][T::BN];
  float tot[kTot][MODE == kWalkSmem ? T::kThreads : 1];
};

// XOR swizzle by 16-byte chunk, so ldmatrix's 8 rows hit 8 bank groups:
// chunk c of row r at c ^ (r & 7) in rows of 8 or more chunks, at
// c ^ ((r >> 1) & 3) in rows of 4.
__device__ __forceinline__ int swz(int r, int c, int chunks) {
  return chunks >= 8 ? (c ^ (r & 7)) : (c ^ ((r >> 1) & 3));
}

// Two adjacent elements of y: rounded to bf16, or the fp32 sums as they are.
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Block (bx, by, bz) owns columns [BN bx, BN bx + BN) and rows [BM by, BM by
// + BM) of y. kOne: K slice bz; y (OT) when the grid has one slice, else the
// fp32 partial part[bz]. Walk modes: every slice, y (OT). K runs to
// its padded end (a multiple of 128, staged as zeros), so every tile plan
// runs the same k16 steps.
template <typename T, int MODE, typename OT>
__device__ __forceinline__ void block_product(
    unsigned char* smem, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ w, OT* __restrict__ y, float* __restrict__ part,
    int M, int K, int N, int slice_k, int bx, int by, int bz) {
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, kStages = T::kStages;
  constexpr int kMI = T::kMI, kNJ = T::kNJ, kThreads = T::kThreads;
  constexpr int kAC = BK / 8, kBC = BN / 8;    // 16-byte chunks of an x / a W row
  Smem<T, MODE>& s = *reinterpret_cast<Smem<T, MODE>*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
  const int n0 = bx * BN, m0 = by * BM;
  const int kpad = (K + kSliceTile - 1) / kSliceTile * kSliceTile;
  const int ks0 = MODE == kOne ? bz * slice_k : 0;
  const int ks1 = MODE == kOne ? min(kpad, ks0 + slice_k) : kpad;
  const int nk = (ks1 - ks0) / BK;
  const int per = slice_k / BK;    // K tiles a slice

  auto a_at = [&](int st, int r, int c) { return &s.a[st][r][swz(r, c, kAC) << 3]; };
  auto b_at = [&](int st, int r, int c) { return &s.b[st][r][swz(r, c, kBC) << 3]; };
  auto load = [&](int st, int kt) {
    const int k0 = ks0 + kt * BK;
#pragma unroll
    for (int i = 0; i < BM * kAC / kThreads; ++i) {
      const int idx = tid + i * kThreads, r = idx / kAC, c = idx % kAC;
      const int gm = m0 + r, gk = k0 + c * 8;
      const bool ok = gm < M && gk < K;
      cp16(a_at(st, r, c), ok ? x + (size_t)gm * K + gk : x, ok);
    }
#pragma unroll
    for (int i = 0; i < BK * kBC / kThreads; ++i) {
      const int idx = tid + i * kThreads, r = idx / kBC, c = idx % kBC;
      const int gk = k0 + r, gn = n0 + c * 8;
      const bool ok = gk < K && gn < N;
      cp16(b_at(st, r, c), ok ? w + (size_t)gk * N + gn : w, ok);
    }
  };

  float acc[kMI][kNJ][4], tot[kMI][kNJ][4];   // tot: kWalkRegs only
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // A slice boundary: total = p0, then total + p_s; the partial restarts at 0.
  auto fold = [&](bool first) {
#pragma unroll
    for (int i = 0; i < kMI; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (MODE == kWalkRegs) {
            tot[i][j][e] = first ? acc[i][j][e] : __fadd_rn(tot[i][j][e], acc[i][j][e]);
          } else if constexpr (MODE == kWalkSmem) {
            float& t = s.tot[(i * kNJ + j) * 4 + e][tid];
            t = first ? acc[i][j][e] : __fadd_rn(t, acc[i][j][e]);
          }
          acc[i][j][e] = 0.f;
        }
  };

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
    if (MODE != kOne && kt > 0 && kt % per == 0) fold(kt == per);
    const int st = kt % kStages;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {     // k16 steps in increasing order
      uint32_t b[2 * kNJ];
      const int kr = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int p = 0; p < kNJ / 2; ++p)
        ldm_x4_t(b + 4 * p, b_at(st, kr, wn * kNJ + 2 * p + (lane >> 4)));
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        uint32_t a[4];
        ldm_x4(a, a_at(st, wm * kMI * 16 + i * 16 + (lane & 15), ks * 2 + (lane >> 4)));
#pragma unroll
        for (int j = 0; j < kNJ; ++j) mma16816(acc[i][j], a, b[2 * j], b[2 * j + 1]);
      }
    }
  }
  if (MODE != kOne) fold(false);

  const int g = lane >> 2, t = lane & 3;
  float* pz = MODE == kOne && part ? part + (size_t)bz * M * N : nullptr;
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int col = n0 + (wn * kNJ + j) * 8 + 2 * t;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * kMI * 16 + i * 16 + g + 8 * h;
        if (row >= M) continue;
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if constexpr (MODE == kWalkRegs) {
          v0 = tot[i][j][2 * h];
          v1 = tot[i][j][2 * h + 1];
        } else if constexpr (MODE == kWalkSmem) {
          v0 = s.tot[(i * kNJ + j) * 4 + 2 * h][tid];
          v1 = s.tot[(i * kNJ + j) * 4 + 2 * h + 1][tid];
        }
        if (pz)
          *reinterpret_cast<float2*>(pz + (size_t)row * N + col) = make_float2(v0, v1);
        else
          store2(y + (size_t)row * N + col, v0, v1);
      }
    }
}

}  // namespace dense
