// The gradient of the grouped bf16 expert product ye[e] = xe[e] @ W[e]
// (expert_matmul.cu), for every expert e of an MoE layer, reading only the
// experts and rows its tokens were routed to:
//   dX: dx[e] = dy[e] @ W[e]^T on rows r < min(counts[e], cap); rows past
//       the count are written as zeros;
//   dW: dw[e] = xe[e]^T @ dy[e] summed over rows r < min(counts[e], cap)
//       only; an expert with count 0 gets dw = 0.
//
// Stands in for XLA's autodiff of einsum("ecd,edf->ecf") in the JAX
// package's _expert_ffn (repro/models/moe.py:43-57), as
// flash_attention_bwd.cu stands in for the autodiff of chunked_attention.
// xe (E, cap, K), W (E, K, N), dy (E, cap, N), dx (E, cap, K), dw (E, K,
// N): contiguous bf16; counts (E,) int32 on the device.
//
// Contract:
// - deterministic: each output element is one chain of k16 wgmma steps in
//   fp32, in increasing order of the reduced index (N for dX, rows for
//   dW), inside one block, then one rounding to bf16. No atomics, no
//   split of the reduction over blocks: the same inputs give the same bits
//   in every launch;
// - dW masks the rows at or past the count itself: the last, partial row
//   tile's rows past the count are zeroed in shared memory (both
//   operands) before its wgmma, so whatever the caller left there (NaN
//   included) never reaches dw;
// - only live data is read: dX walks the live 64-row tiles of each expert
//   (the other tiles' blocks store zeros and read nothing), dW reads
//   ceil(count / 64) row tiles of xe and dy an expert, and an expert with
//   count 0 reads no weight and no row. The counts are read on the device.
//
// Design. One block a 128-column output tile of one expert: dX (row tile
// of 64 rows up to cap 64, else 128) x (128 columns of K), dW (128 rows of
// K) x (128 columns of N); grid (column tiles, row tiles, E). A producer
// warp's one thread keeps TMA loads (3-D maps, boxes of 64 contiguous
// elements, 128-byte swizzle; rows past cap and columns past the end read
// as zeros) in flight through a ring of `stages` stages of 64 reduced
// elements on full/empty mbarriers; one or two consumer warpgroups of 64
// output rows run m64n128k16 wgmma on them. The operands' layouts:
//   dX: A = dy rows, K-major (reduced N contiguous), as the forward's A;
//       B = W^T: W's rows hold the reduced N contiguous, so B is K-major
//       too: a box of 128 W rows x 64 N, read with the transpose bit off;
//   dW: A = xe^T: xe's rows hold the output's M (= K) contiguous, so A is
//       MN-major, read as the forward reads its B (64-column chunks of 64
//       rows, the transpose bit on); B = dy rows, N-major, as the forward's
//       B.
// Every value that steers the wgmma path comes from a shuffle of lane 0
// (warpgroup-uniform to the compiler), every wgmma wait runs on every
// consumer, busy or not, and the epilogue reads the accumulators outside
// any branch: otherwise ptxas serializes every wgmma (its C7518 note).
//
// Bound on the H100: at mixtral's training shape (8 experts, cap 1280,
// 6144 x 16384) each product is 2 (kept rows) K N operations at the bf16
// peak (about 0.2 ms for the 1.6 GB of weights and 2 x 10^12 operations of
// one of them), above the bytes' time; at llama4's (128 experts, cap 40,
// 5120 x 8192) the weights' and dW's 10.7 GB each bound it. The design is
// the simple one: one tile a block, no persistent walk, no 4-D maps; the
// ring hides the loads' latency.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kRows = 64;            // output rows a consumer warpgroup (wgmma's M)
constexpr int kBN = 128;             // output columns a block
constexpr int kBK = 64;              // reduced elements a ring stage
constexpr int kBox = 64 * 128;       // bytes of a 64 x 64 bf16 box
constexpr int kMaxSmem = 232448;

// Dynamic shared bytes: 1024 for the ring's alignment, then each stage's
// WGS A boxes and its B tile (kBN x 64, 16 KB), a full and an empty
// barrier a stage.
inline long long smem_bytes(int wgs, int stages) {
  return 1024LL + (long long)stages * (wgs * kBox + kBN * 128 + 16);
}

// Zeros over rows [r0, r1) x columns [c0, c1) of a row-major bf16 matrix
// with `ld` columns (c0, c1 and ld multiples of 8), 16 bytes a store.
__device__ __forceinline__ void zero_tile(__nv_bfloat16* out, int ld, int r0, int r1, int c0,
                                          int c1, int t, int nt) {
  const int chunks = (c1 - c0) / 8;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = t; i < (r1 - r0) * chunks; i += nt)
    *reinterpret_cast<uint4*>(out + (size_t)(r0 + i / chunks) * ld + c0 + (i % chunks) * 8) =
        zero;
}

// DW false: dX, out (E, cap, M) with M = K, rows of the block's tile from
// cap; the reduced dimension `red` = N. DW true: dW, out (E, M, N) with M
// = K; the reduced dimension is the expert's rows.
template <int WGS, bool DW>
__global__ void __launch_bounds__(128 * (WGS + 1), 1)
expert_bwd_kernel(const __grid_constant__ CUtensorMap a_map,
                  const __grid_constant__ CUtensorMap b_map, __nv_bfloat16* __restrict__ out,
                  const int* __restrict__ counts, int cap, int M, int N, int red,
                  int stages) {
  constexpr int BM = kRows * WGS, kAcc = kBN / 2;
  extern __shared__ __align__(128) unsigned char raw[];
  unsigned char* ring = raw + ((1024 - (tma::smem_u32(raw) & 1023)) & 1023);
  const int b_off = WGS * kBox, stage = b_off + kBN * 128;
  uint64_t* full = (uint64_t*)(ring + (size_t)stages * stage);
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x, wg = __shfl_sync(~0u, tid / 128, 0);
  const int e = blockIdx.z;
  // Warpgroup-uniform to the compiler: each expert's kept rows from lane 0.
  const int live = __shfl_sync(~0u, min(max(counts[e], 0), cap), 0);
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  // The block's output: dX rows [m0, m0 + BM) of cap x columns [n0, n0 +
  // kBN) of M; dW rows [m0, m0 + BM) of M x columns [n0, n0 + kBN) of N.
  const int rows_out = DW ? M : cap, cols_out = DW ? N : M;
  __nv_bfloat16* oe = out + (size_t)e * rows_out * cols_out;
  // A tile with nothing to sum: dX's rows all past the count, dW's expert
  // without rows. Zeros, and no byte read.
  if (DW ? live == 0 : m0 >= live) {
    zero_tile(oe, cols_out, m0, min(m0 + BM, rows_out), n0, min(n0 + kBN, cols_out), tid,
              blockDim.x);
    return;
  }
  const int nk = __shfl_sync(~0u, ((DW ? live : red) + kBK - 1) / kBK, 0);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      tma::bar_init(&full[s], 1);
      tma::bar_init(&empty[s], WGS);
    }
    tma::fence_init();
  }
  __syncthreads();

  if (wg == WGS) {
    // The producer: one thread issues every load.
    if (tid == WGS * 128) {
      const int busy = DW ? WGS : min(WGS, (live - m0 + kRows - 1) / kRows);
      int s = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < nk; ++kt) {
        tma::bar_wait(&empty[s], phase ^ 1);
        tma::bar_expect(&full[s], busy * kBox + kBN * 128);
        unsigned char* st = ring + (size_t)s * stage;
        for (int w = 0; w < busy; ++w) {
          if constexpr (DW)   // xe: 64 rows of the stage x 64 columns of M
            tma::load(st + w * kBox, &a_map, m0 + w * kRows, kt * kBK, e, &full[s]);
          else                // dy: 64 rows of the tile x 64 reduced columns
            tma::load(st + w * kBox, &a_map, kt * kBK, m0 + w * kRows, e, &full[s]);
        }
        if constexpr (DW) {   // dy: 64 rows of the stage x 64 columns, twice
          for (int c = 0; c < kBN / 64; ++c)
            tma::load(st + b_off + c * kBox, &b_map, n0 + c * 64, kt * kBK, e, &full[s]);
        } else {              // W: 128 rows (columns of dx) x 64 reduced columns
          tma::load(st + b_off, &b_map, kt * kBK, n0, e, &full[s]);
        }
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // The consumers.
  const int ct = tid % 128, warp = ct / 32, lane = tid % 32;
  const bool busy = DW || m0 + wg * kRows < live;
  // dW: rows of the last stage at or past the count (0 when it is full).
  const int tail = DW ? nk * kBK - live : 0;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  int s = 0, held = -1;
  uint32_t phase = 0;
  for (int kt = 0; kt < nk; ++kt) {
    tma::bar_wait(&full[s], phase);
    unsigned char* st = ring + (size_t)s * stage;
    if (DW && kt == nk - 1 && tail > 0) {
      // Rows [kBK - tail, kBK) of every box of the stage (each row 128
      // bytes; the swizzle permutes 16-byte chunks within a row) zeroed by
      // the consumers together, made visible to wgmma's async proxy, then
      // a barrier of the consumers before any of them reads the stage.
      const int per_box = tail * 8, n = (WGS + kBN / 64) * per_box;
      for (int i = tid; i < n; i += WGS * 128) {
        const int box = i / per_box, j = i % per_box;
        *reinterpret_cast<uint4*>(st + box * kBox + (kBK - tail + j / 8) * 128 + (j % 8) * 16) =
            make_uint4(0, 0, 0, 0);
      }
      tma::fence_async();
      asm volatile("bar.sync 1, %0;\n" ::"r"(WGS * 128) : "memory");
    }
    if (busy) {
      wgmma::fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {   // k16 steps in increasing order
        if constexpr (DW)
          wgmma::mma<kBN, 1, 1>(acc, wgmma::desc_b(st + wg * kBox, ks, kBox),
                                wgmma::desc_b(st + b_off, ks, kBox));
        else
          wgmma::mma<kBN, 0, 0>(acc, wgmma::desc_a(st + wg * kBox, ks),
                                wgmma::desc_a(st + b_off, ks));
      }
      wgmma::commit();
    }
    wgmma::wait<1>();                  // the previous stage's group is done
    if (held >= 0 && ct == 0) tma::bar_arrive(&empty[held]);
    held = s;
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
  wgmma::wait<0>();
#pragma unroll
  for (int i = 0; i < kAcc; ++i) wgmma::pin(acc[i]);
  if (ct == 0) tma::bar_arrive(&empty[held]);
  // The sums rounded to bf16, every register on every thread, then stored:
  // dX's rows below the count (zeros from it on, below cap), dW's rows
  // below M; columns below the output's width.
  uint32_t res[kAcc / 2];
#pragma unroll
  for (int i = 0; i < kAcc / 2; ++i) {
    __nv_bfloat162 v = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
    res[i] = *reinterpret_cast<const uint32_t*>(&v);
  }
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wg * kRows + warp * 16 + g + 8 * h;
      if (col >= cols_out || row >= rows_out) continue;
      *reinterpret_cast<uint32_t*>(oe + (size_t)row * cols_out + col) =
          DW || row < live ? res[2 * j + h] : 0u;
    }
  }
}

template <int WGS, bool DW>
cudaError_t launch(const CUtensorMap& a_map, const CUtensorMap& b_map, void* out,
                   const int* counts, int E, int cap, int M, int N, int red, int stages,
                   dim3 grid, cudaStream_t st) {
  const int bytes = (int)smem_bytes(WGS, stages);
  auto kern = expert_bwd_kernel<WGS, DW>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();   // reported here; leave no error for the next launch
    return err;
  }
  kern<<<grid, 128 * (WGS + 1), bytes, st>>>(a_map, b_map, (__nv_bfloat16*)out, counts, cap,
                                             M, N, red, stages);
  return cudaGetLastError();
}

bool map(CUtensorMap* m, const void* p, int E, int rows, int cols, int box_rows) {
  return tma::tensor_map(m, p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, E, rows, cols, 64, box_rows,
                         CU_TENSOR_MAP_SWIZZLE_128B);
}

bool bad_shape(int E, int cap, int K, int N, int stages, int wgs) {
  return E <= 0 || E > 65535 || cap <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8 ||
         stages < 2 || smem_bytes(wgs, stages) > kMaxSmem;
}

}  // namespace

// dx (E, cap, K) = dy (E, cap, N) @ w (E, K, N)^T on each expert's rows
// below min(counts[e], cap), zeros past them. `bm` rows a block: 64 (one
// consumer warpgroup) or 128 (two); `stages` ring stages
// (kernels/expert_matmul.py::schedule_dx). Returns the CUDA error code of
// the launch.
extern "C" int expert_matmul_bwd_dx(const void* dy, const void* w, void* dx, const void* counts,
                                    int E, int cap, int K, int N, int bm, int stages,
                                    void* stream) {
  if ((bm != 64 && bm != 128) || bad_shape(E, cap, K, N, stages, bm / kRows))
    return (int)cudaErrorInvalidValue;
  CUtensorMap a_map, b_map;
  if (!map(&a_map, dy, E, cap, N, kRows) || !map(&b_map, w, E, K, N, kBN))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((K + kBN - 1) / kBN, (cap + bm - 1) / bm, E);
  cudaStream_t st = (cudaStream_t)stream;
  const int* c = (const int*)counts;
  if (bm == 64) return (int)launch<1, false>(a_map, b_map, dx, c, E, cap, K, N, N, stages, grid, st);
  return (int)launch<2, false>(a_map, b_map, dx, c, E, cap, K, N, N, stages, grid, st);
}

// dw (E, K, N) = xe (E, cap, K)^T @ dy (E, cap, N) over each expert's rows
// below min(counts[e], cap); zeros for an expert without rows. 128 x 128
// output tiles, two consumer warpgroups; `stages` ring stages
// (kernels/expert_matmul.py::schedule_dw). Returns the CUDA error code of
// the launch.
extern "C" int expert_matmul_bwd_dw(const void* xe, const void* dy, void* dw, const void* counts,
                                    int E, int cap, int K, int N, int stages, void* stream) {
  if (bad_shape(E, cap, K, N, stages, 2)) return (int)cudaErrorInvalidValue;
  CUtensorMap a_map, b_map;
  if (!map(&a_map, xe, E, cap, K, kBK) || !map(&b_map, dy, E, cap, N, kBK))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (K + 2 * kRows - 1) / (2 * kRows), E);
  return (int)launch<2, true>(a_map, b_map, dw, (const int*)counts, E, cap, K, N, cap, stages,
                              grid, (cudaStream_t)stream);
}
