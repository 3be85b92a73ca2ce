// Grouped bf16 expert product for Hopper: ye[e] = xe[e] @ W[e] for every
// expert e of an MoE layer, reading only the experts its rows were routed to.
//
// Stands in for XLA's einsum("ecd,edf->ecf") in the JAX package's
// _expert_ffn (repro/models/moe.py:41-55), as dense_matmul.cu stands in for
// XLA's dense product. xe (E, cap, K) bf16 is the capacity buffer of the
// sort-based dispatch, W (E, K, N) bf16 the stacked expert weights, ye (E,
// cap, N) bf16. counts (E,) int32, on the device, holds each expert's kept
// rows; the dispatch fills rows 0 .. counts[e] - 1 of its buffer in order.
//
// Contract:
// - row r < min(counts[e], cap) of expert e is one chain of operations on
//   that row and W[e] alone, fixed by (K, N): K, padded with zeros to a
//   multiple of 128, is cut into the slices of dense_matmul's plan of
//   (K, N) (kernels/dense_matmul.py::plan); each slice's partial starts
//   from zero and runs its k16 wgmma steps in increasing K; the total is
//   ((p0 + p1) + p2) + ... in fp32 (__fadd_rn), then one rounding to bf16.
//   Every capacity, count, E, tile width and tile plan runs that chain, so
//   a row's bits never follow them. On the H100 a wgmma k16 step rounds as
//   mma.sync's m16n8k16 does, at every width (chip_smoke's
//   check_expert_matmul): a kept row is bitwise dense_matmul of that row;
// - rows at or past the count are written as zeros;
// - an expert with no rows reads no weight byte: only the live row tiles
//   are walked. A decode step that routes 4 rows to 4 of llama4's 128
//   experts reads 4 experts' weights, not 128;
// - the counts are read on the device: no host sync a layer; no atomics and
//   no split-K scratch.
//
// Design. A persistent grid, its size fixed by the SM count and the shapes,
// never by the counts. Each block reads the counts into shared memory, takes
// the prefix sum of each expert's live row tiles (ceil(min(count, cap) /
// BM)) and walks the live (expert, column tile, row tile) tiles t =
// blockIdx.x, + gridDim.x, ...: experts in order, an expert's row tiles
// next to each other, so that the blocks sharing a weight strip run at
// the same time and find it in L2. The tiles of the last, partial round
// are cut into up to BN / 64 column parts, so that it keeps as many SMs
// streaming as it can; a part runs the same instruction on its B boxes
// and stores their columns only. Before the walk the consumers store
// zeros over the rows past each expert's live tiles. A block is one
// producer warpgroup, whose one thread keeps TMA loads (128-byte swizzle;
// 3-D maps, where a box never crosses into the next expert and rows past
// cap and K past its end read as zeros; where K or N is a multiple of 64,
// 4-D maps that load a stage's whole A or B tile in one copy) in flight
// through a ring of `stages` stages on full/empty mbarriers, and one or
// two consumer warpgroups of 64 rows each (BM 64 up to cap 64, 128 above)
// that share each stage's B tile and run m64nBNk16 wgmma on it. A
// consumer whose 64 rows all lie past the count issues no wgmma (the
// producer loads no A box for it) and stores zeros. At a slice boundary a
// consumer waits for its wgmma and folds the partial into the running
// total in registers. Every value that steers the wgmma path is
// warpgroup-uniform to the compiler, every wgmma wait runs on both
// consumers (busy or not) and the epilogue reads the accumulators outside
// any branch: otherwise ptxas serializes every wgmma (its C7518 note; it
// cost 5-20 % at prefill on the H100).
//
// Bound on the H100: at decode it must read the touched experts' weights
// once, 2 K N bytes each (llama4's 5120 x 8192: 84 MB an expert, 25 us at
// 3.35 TB/s); at prefill (mixtral, cap 400 of 8 experts) the weights' 1.6
// GB and 2 (kept rows) K N operations at the bf16 peak, about equal. At
// decode a stage carries 128 of K, so each barrier round trip brings twice
// the weight bytes (the round trips, not HBM, bounded a 64-deep stage),
// and 64-column tiles at cap 8 spread a few experts' strips over more
// SMs. At prefill wgmma from swizzled shared memory feeds the tensor
// cores, 128 x 192 tiles read 0.83 of the bytes from L2 an operation that
// 128 x 128 ones do (128 x 256 ones 0.75, but only four 48 KB stages fit
// and they timed slower; neither is built), and only the live 64-row
// halves are computed.
// Stages of 32 of K timed 20-45 % slower than 64: a stage's barrier round
// trip costs about as much as its wgmma. The 4-D maps' one copy a stage an
// operand, against one a 64-wide chunk, takes 13-23 % off the prefill
// (tools/kernel_ab.py); at decode, where a B tile is one box, the two tie.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kSliceTile = 128;      // K slices are whole multiples of this
constexpr int kRows = 64;            // rows a consumer warpgroup (wgmma's M)
constexpr int kMaxSmem = 232448;

// BN columns and WGS consumer warpgroups a block; BK elements of K a ring
// stage: 128 with one consumer (a decode step's buffers: each stage carries
// twice the weight bytes for the same barrier round trip), 64 with two. A
// stage holds, for each consumer, BK / 64 A boxes (a_rows rows x 64 K, 128
// bytes a row), then BN / 64 B boxes (BK K rows x 64 columns). With one
// consumer, a_rows may be fewer than 64 (cap rounded up to 8): wgmma still
// reads 64 rows, the rows past a_rows from the boxes that follow, and their
// outputs lie past cap and are never stored.
template <int BN, int WGS>
struct Plan {
  static constexpr int BM = kRows * WGS;
  static constexpr int BK = WGS == 1 ? 128 : 64;
  static constexpr int kThreads = 128 * (WGS + 1);
};

// Dynamic shared bytes: 1024 for the ring's alignment, the ring, a full and
// an empty barrier a stage, each expert's kept rows and the prefix of its
// live row tiles (E + 1).
inline long long smem_bytes(int bn, int wgs, int a_rows, int stages, int E) {
  const int bk = wgs == 1 ? 128 : 64;
  return 1024LL + (long long)stages * (wgs * bk / 64 * a_rows * 128 + bn / 64 * bk * 128 +
                                       16) + 4LL * (2 * E + 1);
}

// SPLIT: K runs in more than one slice (a running total beside the
// partial).
template <int BN, int WGS, bool SPLIT>
__global__ void __launch_bounds__(Plan<BN, WGS>::kThreads, 1)
expert_kernel(const __grid_constant__ CUtensorMap a_map,
              const __grid_constant__ CUtensorMap a_one,
              const __grid_constant__ CUtensorMap b_map,
              const __grid_constant__ CUtensorMap b_one, int maps4,
              __nv_bfloat16* __restrict__ y,
              const int* __restrict__ counts, int E, int cap, int K, int N, int slice_k,
              int stages, int a_rows) {
  using P = Plan<BN, WGS>;
  constexpr int BM = P::BM, BK = P::BK, kAK = BK / 64, kAcc = BN / 2;
  extern __shared__ __align__(128) unsigned char raw[];
  unsigned char* ring = raw + ((1024 - (tma::smem_u32(raw) & 1023)) & 1023);
  const int a_box = a_rows * 128, b_box = BK * 128;
  const int b_off = WGS * kAK * a_box, stage = b_off + BN / 64 * b_box;
  uint64_t* full = (uint64_t*)(ring + (size_t)stages * stage);
  uint64_t* empty = full + stages;
  int* rows = (int*)(empty + stages);    // E: kept rows, min(count, cap)
  int* pre = rows + E;                   // E + 1: live row tiles before expert e

  // Warpgroup-uniform to the compiler (a shuffle from lane 0): a branch
  // that it cannot prove uniform around wgmma makes it serialize them all.
  const int tid = threadIdx.x, wg = __shfl_sync(~0u, tid / 128, 0);
  const int n_tiles = (N + BN - 1) / BN;
  const int nk = (K + kSliceTile - 1) / kSliceTile * kSliceTile / BK;
  const int per = slice_k / BK;          // K tiles (stages) a slice

  for (int e = tid; e < E; e += blockDim.x) rows[e] = min(max(counts[e], 0), cap);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      tma::bar_init(&full[s], 1);
      tma::bar_init(&empty[s], WGS);
    }
    tma::fence_init();
  }
  __syncthreads();
  if (tid < 32) {                        // warp 0: the prefix, 32 experts at a time
    int run = 0;
    for (int base = 0; base < E; base += 32) {
      const int e = base + tid;
      int v = e < E ? (rows[e] + BM - 1) / BM : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(~0u, v, o);
        if (tid >= o) v += u;
      }
      if (e < E) pre[e + 1] = run + v;
      run += __shfl_sync(~0u, v, 31);
    }
    if (tid == 0) pre[0] = 0;
  }
  __syncthreads();
  // The walk: R full rounds of the grid over the live tiles, then the r
  // tiles left, each cut into f column parts of BN / f (a multiple of 64)
  // so that the last round still reaches as many blocks as it can.
  constexpr int kBoxes = BN / 64;
  const int G = gridDim.x, tiles = pre[E] * n_tiles;
  const int full_units = tiles / G * G, r = tiles - full_units;
  int f = 1;
  for (int d = kBoxes; d > 1; --d)
    if (kBoxes % d == 0 && r * d <= G) {
      f = d;
      break;
    }
  const int units = full_units + r * f;
  // Unit u of the walk: expert e (advanced from its last value: u only
  // grows), its row tile mt, the first column n0 and the B boxes nb.
  auto locate = [&](int u, int& e, int& mt, int& n0, int& nb) {
    int t = u, part = 0;
    nb = kBoxes;
    if (u >= full_units) {
      t = full_units + (u - full_units) / f;
      part = (u - full_units) % f;
      nb = kBoxes / f;
    }
    while (pre[e + 1] * n_tiles <= t) ++e;
    const int local = t - pre[e] * n_tiles, live = pre[e + 1] - pre[e];
    mt = local % live;
    n0 = local / live * BN + part * nb * 64;
  };

  if (wg == WGS) {
    // The producer: one thread issues every load. With two consumers (384
    // threads, 168 registers each at launch) it hands its registers to them.
    if constexpr (WGS == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == WGS * 128) {
      int s = 0, e = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += G) {
        int mt, n0, nb;
        locate(u, e, mt, n0, nb);
        const int m0 = mt * BM;
        const int busy = min(WGS, (rows[e] - m0 + kRows - 1) / kRows);
        for (int kt = 0; kt < nk; ++kt) {
          tma::bar_wait(&empty[s], phase ^ 1);
          tma::bar_expect(&full[s], busy * kAK * a_box + nb * b_box);
          unsigned char* st = ring + (size_t)s * stage;
          // One copy for every busy consumer's rows and K chunks where the
          // 4-D map allows it, else a copy a 64-wide chunk.
          if ((maps4 & 1) && busy == WGS) {
            tma::load4(st, &a_map, 0, m0, kt * kAK, e, &full[s]);
          } else {
            for (int w = 0; w < busy; ++w)
              for (int a = 0; a < kAK; ++a)
                tma::load(st + (w * kAK + a) * a_box, &a_one, kt * BK + a * 64,
                          m0 + w * kRows, e, &full[s]);
          }
          if ((maps4 & 2) && nb == kBoxes) {
            tma::load4(st + b_off, &b_map, 0, kt * BK, n0 / 64, e, &full[s]);
          } else {
            for (int c = 0; c < nb; ++c)
              tma::load(st + b_off + c * b_box, &b_one, n0 + c * 64, kt * BK, e, &full[s]);
          }
          if (++s == stages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // The consumers.
  if constexpr (WGS == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int ct = tid % 128, warp = ct / 32, lane = tid % 32;
  {
    // Zeros over rows [min(live tiles x BM, cap), cap) of every expert, 16
    // bytes (8 columns, N a multiple of 8) a store.
    const int chunks = N / 8;
    const long long stride = (long long)gridDim.x * WGS * 128;
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int e = 0; e < E; ++e) {
      const int r0 = min((pre[e + 1] - pre[e]) * BM, cap);
      const long long n = (long long)(cap - r0) * chunks;
      __nv_bfloat16* ye = y + ((size_t)e * cap + r0) * N;
      for (long long i = (long long)blockIdx.x * WGS * 128 + tid; i < n; i += stride)
        *reinterpret_cast<uint4*>(ye + (i / chunks) * N + (i % chunks) * 8) = zero;
    }
  }

  float acc[kAcc], tot[SPLIT ? kAcc : 1];
  int s = 0, e = 0;
  uint32_t phase = 0;
  auto release = [&](int held) {
    if (held >= 0 && ct == 0) tma::bar_arrive(&empty[held]);
  };
  // What steers the wgmma path comes from shared memory: shuffled from
  // lane 0, it is uniform to the compiler.
  const int n_units = __shfl_sync(~0u, units, 0);
  for (int u = blockIdx.x; u < n_units; u += G) {
    int mt, n0, nb;
    locate(u, e, mt, n0, nb);
    const int m = __shfl_sync(~0u, rows[e], 0);
    mt = __shfl_sync(~0u, mt, 0);
    n0 = __shfl_sync(~0u, n0, 0);
    nb = __shfl_sync(~0u, nb, 0);
    const int m0 = mt * BM + wg * kRows;
    const bool busy = m0 < m;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    if constexpr (SPLIT) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) tot[i] = 0.f;
    }
    // Every wait below runs on both consumers, busy or not (a consumer with
    // no group in flight passes it at once): waits only on the busy path
    // would leave ptxas a path on which the accumulators are read with a
    // wgmma in flight, and it would serialize every wgmma.
    int held = -1;                       // the stage the last wgmma group reads
    for (int kt = 0; kt < nk; ++kt) {
      if constexpr (SPLIT) {
        if (kt > 0 && kt % per == 0) {
          // A slice boundary: total = p0, then total + p_s; the partial
          // restarts at 0.
          wgmma::wait<0>();
#pragma unroll
          for (int i = 0; i < kAcc; ++i) {
            wgmma::pin(acc[i]);
            tot[i] = kt == per ? acc[i] : __fadd_rn(tot[i], acc[i]);
            acc[i] = 0.f;
          }
          release(held);
          held = -1;
        }
      }
      tma::bar_wait(&full[s], phase);
      if (busy) {
        const unsigned char* st = ring + (size_t)s * stage;
        wgmma::fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)     // k16 steps in increasing order
          wgmma::mma<BN>(acc, wgmma::desc_a(st + (wg * kAK + ks / 4) * a_box, ks % 4),
                         wgmma::desc_b(st + b_off, ks, b_box));
        wgmma::commit();
      }
      wgmma::wait<1>();                  // the previous stage's group is done
      release(held);
      held = s;
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma::wait<0>();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      wgmma::pin(acc[i]);
      if constexpr (SPLIT) tot[i] = __fadd_rn(tot[i], acc[i]);
    }
    release(held);
    // The sums rounded to bf16, every register on every thread (no branch
    // reads the accumulators), then the unit's rows below cap and its nb *
    // 64 columns stored (a column part's are the instruction's first; the
    // B boxes past nb hold stale bytes and their columns are not stored):
    // the sums below the count, zeros from it on.
    uint32_t out[kAcc / 2];
#pragma unroll
    for (int i = 0; i < kAcc / 2; ++i) {
      __nv_bfloat162 v;
      if constexpr (SPLIT) v = __floats2bfloat162_rn(tot[2 * i], tot[2 * i + 1]);
      else v = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
      out[i] = *reinterpret_cast<const uint32_t*>(&v);
    }
    __nv_bfloat16* ye = y + (size_t)e * cap * N;
    const int g = lane / 4, q = lane % 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + warp * 16 + g + 8 * h;
        if (j >= nb * 8 || col >= N || row >= cap) continue;
        *reinterpret_cast<uint32_t*>(ye + (size_t)row * N + col) = row < m ? out[2 * j + h] : 0u;
      }
    }
  }
}

template <int BN, int WGS, bool SPLIT>
cudaError_t launch(const void* xe, const void* w, void* y, const int* counts, int E, int cap,
                   int K, int N, int slice_k, int stages, int a_rows, int grid,
                   cudaStream_t st) {
  using P = Plan<BN, WGS>;
  // Per-chunk 3-D maps (64-wide boxes), and where K (N) is a multiple of
  // 64 the 4-D maps whose one box holds a stage's A (B) tile: xe seen as
  // (E, K / 64, cap, 64), a box of every consumer's rows and the stage's K
  // chunks; W as (E, N / 64, K, 64), a box of the stage's K rows and the
  // tile's column chunks.
  CUtensorMap a_map, a_one, b_map, b_one;
  const uint64_t es = 2;
  const int maps4 = (K % 64 == 0 ? 1 : 0) | (N % 64 == 0 ? 2 : 0);
  if (!tma::tensor_map(&a_one, xe, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, E, cap, K, 64,
                       a_rows, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tma::tensor_map(&b_one, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, E, K, N, 64, P::BK,
                       CU_TENSOR_MAP_SWIZZLE_128B) ||
      ((maps4 & 1) &&
       !tma::tensor_map_4d(&a_map, xe, {64, (uint64_t)cap, (uint64_t)K / 64, (uint64_t)E},
                           {K * es, 64 * es, (uint64_t)cap * K * es},
                           {64, (uint32_t)(WGS * a_rows), P::BK / 64, 1})) ||
      ((maps4 & 2) &&
       !tma::tensor_map_4d(&b_map, w, {64, (uint64_t)K, (uint64_t)N / 64, (uint64_t)E},
                           {N * es, 64 * es, (uint64_t)K * N * es},
                           {64, (uint32_t)P::BK, BN / 64, 1})))
    return cudaErrorInvalidValue;
  if (!(maps4 & 1)) a_map = a_one;
  if (!(maps4 & 2)) b_map = b_one;
  const int bytes = (int)smem_bytes(BN, WGS, a_rows, stages, E);
  auto kern = expert_kernel<BN, WGS, SPLIT>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();   // reported here; leave no error for the next launch
    return err;
  }
  kern<<<grid, P::kThreads, bytes, st>>>(a_map, a_one, b_map, b_one, maps4, (__nv_bfloat16*)y,
                                         counts, E, cap, K, N, slice_k, stages, a_rows);
  return cudaGetLastError();
}

}  // namespace

// xe (E, cap, K), w (E, K, N), y (E, cap, N): contiguous bfloat16; counts (E,)
// int32 on the device. K and N multiples of 8. The summation order
// (kernels/expert_matmul.py::launch_plan): `slices` K slices of `slice_k` (a
// multiple of 128) each, dense_matmul's for (K, N); `bm` rows a block: 64
// (one consumer warpgroup) or 128 (two). The schedule
// (kernels/expert_matmul.py::schedule): `bn` columns a block (64 or 128
// with one consumer, 192 with two),
// `a_rows` rows of an A box (64 with two consumers, else cap rounded up to
// 8, at most 64), `stages` ring stages, `grid` persistent blocks. Returns
// the CUDA error code of the launch.
extern "C" int expert_matmul(const void* xe, const void* w, void* y, const void* counts,
                             int E, int cap, int K, int N, int slices, int slice_k, int bm,
                             int bn, int a_rows, int stages, int grid, void* stream) {
  if (E <= 0 || cap <= 0 || N <= 0) return (int)cudaGetLastError();
  const int wgs = bm / kRows;
  if (K <= 0 || K % 8 || N % 8 || slices < 1 || slice_k <= 0 || slice_k % kSliceTile ||
      (long long)slice_k * slices < K || (long long)slice_k * (slices - 1) >= K ||
      (bm != 64 && bm != 128) || stages < 2 || grid < 1 || a_rows < 8 || a_rows % 8 ||
      a_rows > kRows || (wgs == 2 && a_rows != kRows) ||
      smem_bytes(bn, wgs, a_rows, stages, E) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* c = (const int*)counts;
  const bool split = slices > 1;
#define EXPERT_PLAN(BN, BM, SPLIT)                                                      \
  if (bn == BN && bm == BM && split == SPLIT)                                           \
    return (int)launch<BN, BM / kRows, SPLIT>(xe, w, y, c, E, cap, K, N, slice_k, stages, \
                                              a_rows, grid, st);
  EXPERT_PLAN(64, 64, false)
  EXPERT_PLAN(64, 64, true)
  EXPERT_PLAN(128, 64, false)
  EXPERT_PLAN(128, 64, true)
  EXPERT_PLAN(192, 128, false)
  EXPERT_PLAN(192, 128, true)
#undef EXPERT_PLAN
  return (int)cudaErrorInvalidValue;
}
