// Batch-invariant bf16 matrix product for Hopper: y = x @ W.
//
// Not a port of a Pallas kernel: the JAX package leaves rwkv6's dense
// products to XLA. It exists for one contract. rwkv6's static batch and
// solo prefill (and so static and continuous serving) must give a row the
// same bits whatever the number of rows M in its product. cuBLAS picks its
// algorithm from M and splits K at small M, so a row's sum moved with M.
//
// x (M, K) bf16, W (K, N) bf16 row-major, fp32 accumulation, y (M, N) bf16
// rounded to nearest, or (the dense_matmul_f32 entry) the fp32 sums
// themselves: Griffin's RG-LRU gate projections, which the JAX package
// computes in float32 (repro/models/griffin.py:128-129, yf @ W.astype(f32),
// whose bf16 operands make every product exact), keep their fp32 sums
// in the same order, so they too are the same bits at every M. The summation order of an element depends on (K, N)
// only (kernels/dense_matmul.py::plan): K, padded with zeros to a multiple
// of 128, is cut into S slices of whole 128-wide tiles; each slice's
// partial starts from zero and runs its k16 `mma.sync.aligned.m16n8k16`
// bf16 -> fp32 steps in increasing K; the total is ((p0 + p1) + p2) + ...
// in fp32, then one rounding to bf16. Rows past M and columns past N are
// staged as zeros too.
// Every tile plan below starts its m16 and n8 mma tiles at multiples of 16
// rows and 8 columns, so an element is the same chain of mma
// instructions on the same operands whichever block computes it, at M = 1
// and at M = 1280: its bits do not depend on M.
//
// Tile plans, chosen by the caller (rows per block `bm`):
// - split decode (M <= 16, S > 1): a block owns 16 x 128 of y (4 warps of
//   16 x 32) and one K slice, K in 64-wide tiles through a 4-stage
//   cp.async ring, W rows read 256 bytes wide; each block writes its fp32
//   partial to scratch and a second launch folds them.
// - strips (small batches, unsplit decode): a block owns 64 x 32 of y (4
//   warps of 16 x 32), K in 128-wide tiles through a 3-stage ring;
// - wide tiles (prefill): a block owns 128 x 128 of y (8 warps of 64 x
//   32), K in 64-wide tiles through a 3-stage ring (32-wide when S > 1).
// Strips and wide tiles walk all S slices in one block, the running total
// in registers (strips) or in shared memory, one slot a thread (wide
// tiles, whose 64-float partial leaves no registers for it): the same adds
// in the same order, no scratch.
//
// Bound on the H100: at decode (M <= 16) it must read W once, 2 K N bytes
// (13 MB for 2560 x 2560, 3.9 us at 3.35 TB/s), so bytes bound it; the K
// split puts S x N / 128 blocks in flight for N = 2560 where a serial K
// walk leaves 80 strips. At prefill (M = 1280) the 2 M K N operations bound
// it (8.4 GFLOP for 2560 x 2560, 8.5 us at the bf16 peak); a wide warp
// tile loads 6 ldmatrix per 16 mma where a strip's loads 3 per 4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

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

// Block (x, y, z) owns columns [BN x, BN x + BN) and rows [BM y, BM y + BM)
// of y. kOne: K slice z; y (OT) when the grid has one slice along z, else
// the fp32 partial part[z]. Walk modes: every slice, y (OT). K runs to
// its padded end (a multiple of 128, staged as zeros), so every tile plan
// runs the same k16 steps.
template <typename T, int MODE, typename OT>
__global__ void __launch_bounds__(T::kThreads)
dense_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
             OT* __restrict__ y, float* __restrict__ part, int M, int K, int N,
             int slice_k) {
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, kStages = T::kStages;
  constexpr int kMI = T::kMI, kNJ = T::kNJ, kThreads = T::kThreads;
  constexpr int kAC = BK / 8, kBC = BN / 8;    // 16-byte chunks of an x / a W row
  extern __shared__ __align__(128) unsigned char smem[];
  Smem<T, MODE>& s = *reinterpret_cast<Smem<T, MODE>*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kpad = (K + kSliceTile - 1) / kSliceTile * kSliceTile;
  const int ks0 = MODE == kOne ? blockIdx.z * slice_k : 0;
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
  float* pz = MODE == kOne && part ? part + (size_t)blockIdx.z * M * N : nullptr;
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

// y = OT(((p0 + p1) + p2) + ...) over the S partials of a split decode
// (`pairs` = M N / 2 float2 a slice), two adjacent elements a thread.
template <typename OT>
__global__ void fold_kernel(const float* __restrict__ part, OT* __restrict__ y,
                            long long pairs, int slices) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < pairs;
       i += (long long)gridDim.x * blockDim.x) {
    float2 tot = reinterpret_cast<const float2*>(part)[i];
    for (int sl = 1; sl < slices; ++sl) {
      const float2 p = reinterpret_cast<const float2*>(part)[sl * pairs + i];
      tot.x = __fadd_rn(tot.x, p.x);
      tot.y = __fadd_rn(tot.y, p.y);
    }
    store2(y + 2 * i, tot.x, tot.y);
  }
}

template <typename T, int MODE, typename OT>
cudaError_t launch(const void* x, const void* w, void* y, float* part, int M, int K, int N,
                   int blocks_z, int slice_k, cudaStream_t st) {
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, blocks_z);
  constexpr int bytes = (int)sizeof(Smem<T, MODE>);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dense_kernel<T, MODE, OT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  dense_kernel<T, MODE, OT><<<grid, T::kThreads, bytes, st>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (OT*)y, part, M, K, N, slice_k);
  return cudaGetLastError();
}

// Both entries: check the plan, launch its tiling with OT stores.
template <typename OT>
int run(const void* x, const void* w, void* y, void* part, int M, int K, int N, int slices,
        int slice_k, int bm, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (K <= 0 || K % 8 || N % 8 || slices < 1 || slice_k <= 0 || slice_k % kSliceTile ||
      (long long)slice_k * slices < K || (long long)slice_k * (slices - 1) >= K ||
      (bm != Decode::BM && bm != Strip::BM && bm != Wide::BM) ||
      (bm == Decode::BM && (slices == 1 || part == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool one = slices == 1;
  if (bm == Wide::BM)
    return (int)(one ? launch<Wide, kOne, OT>(x, w, y, nullptr, M, K, N, 1, slice_k, st)
                     : launch<WideSplit, kWalkSmem, OT>(x, w, y, nullptr, M, K, N, 1,
                                                        slice_k, st));
  if (bm == Strip::BM)
    return (int)(one ? launch<Strip, kOne, OT>(x, w, y, nullptr, M, K, N, 1, slice_k, st)
                     : launch<Strip, kWalkRegs, OT>(x, w, y, nullptr, M, K, N, 1, slice_k,
                                                    st));
  // Split decode: one block per K slice, then the fold over the partials.
  float* pf = (float*)part;
  cudaError_t e = launch<Decode, kOne, OT>(x, w, y, pf, M, K, N, slices, slice_k, st);
  if (e != cudaSuccess) return (int)e;
  const long long pairs = (long long)M * N / 2;
  const int blocks = (int)((pairs + 255) / 256 < 4096 ? (pairs + 255) / 256 : 4096);
  fold_kernel<OT><<<blocks, 256, 0, st>>>(pf, (OT*)y, pairs, slices);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K), w (K, N), y (M, N): contiguous bfloat16; K and N multiples of
// 8 (16-byte rows of chunks). The plan (kernels/dense_matmul.py): `slices`
// K slices of `slice_k` (a multiple of 128) each, from (K, N) alone; `bm`
// rows per block: 16 (split decode), 64 (strips) or 128 (wide tiles).
// `part` is fp32 scratch of slices x M x N, needed only by the split
// decode (else null). Returns the CUDA error code of the launches.
extern "C" int dense_matmul(const void* x, const void* w, void* y, void* part, int M, int K,
                            int N, int slices, int slice_k, int bm, void* stream) {
  return run<__nv_bfloat16>(x, w, y, part, M, K, N, slices, slice_k, bm, stream);
}

// The same product with y (M, N) float32: the fp32 sums, unrounded.
extern "C" int dense_matmul_f32(const void* x, const void* w, void* y, void* part, int M,
                                int K, int N, int slices, int slice_k, int bm,
                                void* stream) {
  return run<float>(x, w, y, part, M, K, N, slices, slice_k, bm, stream);
}
