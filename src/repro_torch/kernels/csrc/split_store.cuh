// The store of the int8 tensor-core matmuls (fused_matmul.cu and the
// dequant entry of bitplane_matmul.cu): where an int32 accumulator tile
// goes, and how a K split is summed before it goes there.
//
// Out mode 0 stores the int32 accumulator (M, N). Modes 1 and 2 store the
// dequantized product
//     y = out_dtype((float(acc) * xs[m]) * (wscale[n] * wmul))
// as float32 / bfloat16: two float32 products in that order, then one
// rounding (repro/core/quantized_linear.py::_serve_matmul and
// repro/kernels/ops.py::mixed_group_matmul). y has row stride ldy and
// may point at a column offset of a wider output, so the two filter
// groups of a Table III leaf write [y8, yl] with no concatenation.
//
// A float cannot be dequantized before the K slices are summed, so with
// a K split the slices write int32 partial tiles to scratch (slice, M, N)
// (store_part8), which are summed in slice order and then stored: at
// decode (up to kLastBlockRows rows) by the last block of each output
// tile to arrive (last_block_store: a counter per tile, which that block
// resets, so the counters need no fill), above that by fold_kernel, a
// second launch over all SMs (faster once the last block's serial tail
// grows with the rows). Integer addition is exact, so a row's bits never
// depend on the split or on the other rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace splitk {

// Up to this many rows the last block of a tile sums a K split; above it
// a fold launch does.
constexpr int kLastBlockRows = 8;

// Where the result goes. mode 0: the int32 accumulator (M, N); 1 / 2: y
// as float32 / bfloat16, row stride ldy. vec: rows allow 16-byte stores
// of 8 columns.
struct Out {
  int mode;
  int32_t* acc;
  void* y;
  int ldy;
  const float* wscale;
  float wmul;
  int vec;
};

__device__ __forceinline__ float dequant(int v, float xs, const Out& o, int col) {
  return __fmul_rn(__fmul_rn(__int2float_rn(v), xs), __fmul_rn(o.wscale[col], o.wmul));
}

// Element (row, col), xs the row's scale.
__device__ __forceinline__ void store1(const Out& o, int N, int row, int col, int v, float xs) {
  if (o.mode == 0) {
    o.acc[(size_t)row * N + col] = v;
    return;
  }
  const float f = dequant(v, xs, o, col);
  const size_t at = (size_t)row * o.ldy + col;
  if (o.mode == 1) static_cast<float*>(o.y)[at] = f;
  else static_cast<__nv_bfloat16*>(o.y)[at] = __float2bfloat16_rn(f);
}

// Columns c0 .. c0 + 7 of one row (c0 a multiple of 8).
__device__ __forceinline__ void store8(const Out& o, int N, int row, int c0, const int* v,
                                       float xs) {
  if (!o.vec || c0 + 8 > N) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (c0 + e < N) store1(o, N, row, c0 + e, v[e], xs);
    return;
  }
  if (o.mode == 0) {
    int4* dst = reinterpret_cast<int4*>(o.acc + (size_t)row * N + c0);
    dst[0] = make_int4(v[0], v[1], v[2], v[3]);
    dst[1] = make_int4(v[4], v[5], v[6], v[7]);
    return;
  }
  float f[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = dequant(v[e], xs, o, c0 + e);
  const size_t at = (size_t)row * o.ldy + c0;
  if (o.mode == 1) {
    float4* dst = reinterpret_cast<float4*>(static_cast<float*>(o.y) + at);
    dst[0] = make_float4(f[0], f[1], f[2], f[3]);
    dst[1] = make_float4(f[4], f[5], f[6], f[7]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
      w[e] = *reinterpret_cast<uint32_t*>(&p);
    }
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(o.y) + at) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Columns c0 .. c0 + 7 of one row of K slice `slice`'s partial tile.
__device__ __forceinline__ void store_part8(int32_t* __restrict__ part, int slice, int M,
                                            int N, int row, int c0, const int* v) {
  int32_t* dst = part + ((size_t)slice * M + row) * N + c0;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (c0 + e < N) dst[e] = v[e];
}

// After every thread of the block wrote its partial tile: the last block
// of this output tile (grid: x N tiles, y K slices, z M tiles) to arrive
// sums the slices' partial tiles in slice order and stores rows m0 ..
// m0 + rows - 1, columns n0 .. n0 + BN - 1 (clipped to N), then resets
// the tile's counter for the next launch. xs(r): the scale of row m0 + r;
// last: an int of the block's dynamic shared memory (a static one would
// push a kernel with exactly 48 KB of dynamic shared memory past the
// default limit). Every thread of the block must call it.
template <int BN, int THREADS, typename RowScale>
__device__ __forceinline__ void last_block_store(const Out& o, const int32_t* __restrict__ part,
                                                 int* __restrict__ counters, int* last, int M,
                                                 int N, int m0, int rows, int n0,
                                                 RowScale xs) {
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) *last = atomicAdd(&counters[tile], 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  const int ncols = min(BN, N - n0);
  for (int i = threadIdx.x; i < rows * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    if (c >= ncols) continue;
    const int row = m0 + r, col = n0 + c;
    int sum = 0;
    for (int sl = 0; sl < (int)gridDim.y; ++sl)
      sum += __ldcg(part + ((size_t)sl * M + row) * N + col);
    store1(o, N, row, col, sum, xs(r));
  }
  if (threadIdx.x == 0) counters[tile] = 0;
}

// K split above kLastBlockRows rows: element (row, col) = the S slices'
// partial sums in slice order, then stored as the matmul stores.
__global__ void fold_kernel(const int32_t* __restrict__ part, int S, int M, int N, Out out,
                            const float* __restrict__ scales) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  int sum = 0;
  for (int s = 0; s < S; ++s) sum += part[(size_t)s * M * N + i];
  store1(out, N, i / N, i % N, sum, scales[i / N]);
}

inline void launch_fold(const int32_t* part, int S, int M, int N, const Out& out,
                        const float* scales, cudaStream_t st) {
  fold_kernel<<<(M * N + 255) / 256, 256, 0, st>>>(part, S, M, N, out, scales);
}

}  // namespace splitk
