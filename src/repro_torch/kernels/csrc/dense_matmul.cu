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

#include "dense_tile.cuh"

namespace {

using namespace dense;

template <typename T, int MODE, typename OT>
__global__ void __launch_bounds__(T::kThreads)
dense_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
             OT* __restrict__ y, float* __restrict__ part, int M, int K, int N,
             int slice_k) {
  extern __shared__ __align__(128) unsigned char smem[];
  block_product<T, MODE, OT>(smem, x, w, y, part, M, K, N, slice_k, blockIdx.x,
                             blockIdx.y, blockIdx.z);
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
