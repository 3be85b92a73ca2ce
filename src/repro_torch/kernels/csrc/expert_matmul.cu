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
// - row r < min(counts[e], cap) of expert e is bitwise dense_matmul of that
//   one row against W[e]: each block runs dense_tile.cuh's block_product with
//   the slice plan of (K, N) (kernels/dense_matmul.py::plan), so a row's bits
//   never follow cap, E or the other experts' rows;
// - rows at or past the count are written as zeros;
// - a block whose rows all lie past its expert's count reads no weight byte:
//   it writes its zeros and returns. A decode step that routes 4 rows to 4 of
//   llama4's 128 experts reads 4 experts' weights, not 128;
// - the counts are read on the device: no host sync a layer.
//
// Grid: (N / BN, cap / BM, E). Tile plans: strips (64 x 32, K in 128-wide
// tiles) up to cap = 64, wide tiles (128 x 128) above; both walk every K
// slice in one block (kernels/expert_matmul.py::launch_plan). No split-K scratch:
// the skipped experts' blocks would each need a partial of their own.
//
// Bound on the H100: at decode it must read the touched experts' weights
// once, 2 K N bytes each (llama4's 5120 x 8192: 84 MB an expert, 25 us at
// 3.35 TB/s); at prefill (mixtral, cap 400 of 8 experts) 2 E cap K N
// operations at the bf16 peak.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_tile.cuh"

namespace {

using namespace dense;

template <typename T, int MODE>
__global__ void __launch_bounds__(T::kThreads)
expert_kernel(const __nv_bfloat16* __restrict__ xe, const __nv_bfloat16* __restrict__ w,
              __nv_bfloat16* __restrict__ y, const int* __restrict__ counts, int cap, int K,
              int N, int slice_k) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int e = blockIdx.z;
  const int m = min(max(counts[e], 0), cap);
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  __nv_bfloat16* ye = y + (size_t)e * cap * N;
  if (m0 < m)
    block_product<T, MODE, __nv_bfloat16>(smem, xe + (size_t)e * cap * K,
                                          w + (size_t)e * K * N, ye, nullptr, m, K, N,
                                          slice_k, blockIdx.x, blockIdx.y, 0);
  // Rows [max(m0, m), min(m0 + BM, cap)) of this tile's columns: zeros, 16
  // bytes (8 columns, N a multiple of 8) a store.
  constexpr int kChunks = T::BN / 8;
  const int r0 = max(m0, m), r1 = min(m0 + T::BM, cap);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < (r1 - r0) * kChunks; i += T::kThreads) {
    const int row = r0 + i / kChunks, col = n0 + (i % kChunks) * 8;
    if (col < N) *reinterpret_cast<uint4*>(ye + (size_t)row * N + col) = zero;
  }
}

template <typename T, int MODE>
cudaError_t launch(const void* xe, const void* w, void* y, const int* counts, int E, int cap,
                   int K, int N, int slice_k, cudaStream_t st) {
  const dim3 grid((N + T::BN - 1) / T::BN, (cap + T::BM - 1) / T::BM, E);
  constexpr int bytes = (int)sizeof(Smem<T, MODE>);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        expert_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  expert_kernel<T, MODE><<<grid, T::kThreads, bytes, st>>>(
      (const __nv_bfloat16*)xe, (const __nv_bfloat16*)w, (__nv_bfloat16*)y, counts, cap, K,
      N, slice_k);
  return cudaGetLastError();
}

}  // namespace

// xe (E, cap, K), w (E, K, N), y (E, cap, N): contiguous bfloat16; counts (E,)
// int32 on the device. K and N multiples of 8. The plan
// (kernels/expert_matmul.py): `slices` K slices of `slice_k` (a multiple of
// 128) each, dense_matmul's for (K, N); `bm` rows per block: 64 (strips) or
// 128 (wide tiles). Returns the CUDA error code of the launch.
extern "C" int expert_matmul(const void* xe, const void* w, void* y, const void* counts,
                             int E, int cap, int K, int N, int slices, int slice_k, int bm,
                             void* stream) {
  if (E <= 0 || cap <= 0 || N <= 0) return (int)cudaGetLastError();
  if (K <= 0 || K % 8 || N % 8 || E > 65535 || slices < 1 || slice_k <= 0 ||
      slice_k % kSliceTile || (long long)slice_k * slices < K ||
      (long long)slice_k * (slices - 1) >= K || (bm != Strip::BM && bm != Wide::BM))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* c = (const int*)counts;
  const bool one = slices == 1;
  if (bm == Wide::BM)
    return (int)(one ? launch<Wide, kOne>(xe, w, y, c, E, cap, K, N, slice_k, st)
                     : launch<WideSplit, kWalkSmem>(xe, w, y, c, E, cap, K, N, slice_k, st));
  return (int)(one ? launch<Strip, kOne>(xe, w, y, c, E, cap, K, N, slice_k, st)
                   : launch<Strip, kWalkRegs>(xe, w, y, c, E, cap, K, N, slice_k, st));
}
