// mbarriers, TMA tensor copies and their tensor maps, shared by the RG-LRU
// kernels (rglru.cu, rglru_bwd.cu: a (B, T, W) tensor streamed in boxes of
// (channels, positions) of one row) and expert_matmul.cu (an expert's
// (cap, K) rows and (K, N) weights, boxes of one expert, 128-byte swizzle;
// 4-D maps that cut the contiguous dimension in 64-wide chunks).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// One arrival for the whole warp, after every lane's shared-memory accesses
// before it.
__device__ __forceinline__ void warp_arrive(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) bar_arrive(bar);
}
// Wait until the phase of parity `parity` has completed. A wait that
// outlasts any run (2^30 polls, each suspending the thread for a while)
// is a fault: trap, so the launch fails instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 30)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}
// Arrive, and expect `bytes` of tensor copies before the phase completes.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}
// Order this thread's shared-memory accesses before the tensor copies that
// follow (the async proxy).
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// The box of `map` at (c, t, b) into shared memory, counted on `bar`.
// Positions outside the tensor (t < 0 or past T, channels past W) read
// as zeros.
__device__ __forceinline__ void load(void* dst, const CUtensorMap* map, int c, int t, int b,
                                     uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)), "l"(map), "r"(c), "r"(t),
      "r"(b), "r"(smem_u32(bar))
      : "memory");
}
// The box of the 4-D `map` at (c0, c1, c2, c3) into shared memory, counted
// on `bar`.
__device__ __forceinline__ void load4(void* dst, const CUtensorMap* map, int c0, int c1,
                                      int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)), "l"(map), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}
// Shared memory to the box of `map` at (c, t, b) (rows past the tensor's
// end are dropped), in the current bulk group.
__device__ __forceinline__ void store(const CUtensorMap* map, const void* src, int c, int t,
                                      int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n"
      ::"l"(map), "r"(c), "r"(t), "r"(b), "r"(smem_u32(src))
      : "memory");
}
// Close the bulk group and wait until its copies have read shared memory.
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// cuTensorMapEncodeTiled of libcuda, fetched through the CUDA runtime (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A (B, T, W) tensor of `es`-byte elements, boxes of C channels x `rows`
// positions of one row, laid out in shared memory by `swizzle`.
inline bool tensor_map(CUtensorMap* map, const void* p, CUtensorMapDataType type, int es, int B,
                       int T, int W, int C, int rows,
                       CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  const EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * es, (cuuint64_t)T * W * es};
  const cuuint32_t box[3] = {(cuuint32_t)C, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return enc(map, type, 3, const_cast<void*>(p), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 4-D map of bf16 elements: dims[0] contiguous, strides (bytes) of
// dims 1-3, boxes of box[0..3], 128-byte swizzle; e.g. a (B, T, W) tensor
// seen as (B, W / 64, T, 64), so that one box holds several 64-wide
// column chunks of the same rows, chunk after chunk.
inline bool tensor_map_4d(CUtensorMap* map, const void* p, const uint64_t (&dims)[4],
                          const uint64_t (&strides)[3], const uint32_t (&box)[4]) {
  const EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t d[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t st[3] = {strides[0], strides[1], strides[2]};
  const cuuint32_t bx[4] = {box[0], box[1], box[2], box[3]};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), d, st, bx, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tma
