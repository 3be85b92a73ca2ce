// Paged flash-decode attention for Hopper.
//
// Replaces repro/kernels/paged_attention.py::paged_attention
// (_paged_kernel): one query token per batch row attends the paged KV
// pool through the row's block table and decode position q_pos, with the
// G query heads of a KV head in one tile, an online fp32 softmax, tanh
// softcap, and in-kernel dequantization of an int8 pool (scores on codes
// times the per-key scale, probabilities times the per-value scale).
// Rows whose table is all -1 output zeros.
//
// Bound on the H100: decode reads every live K/V byte of every row once
// and does 4 flops per byte-pair, so it is bound by the pool bytes it
// streams. The TPU grid (B, NKV/bh, max_blocks) ran the block axis in
// order with the softmax state in VMEM scratch; here one thread block per
// (row, KV head) walks the row's table in a loop with the state in shared
// memory, so nothing carries between blocks. Dead table entries and
// blocks past q_pos are never loaded: a row's traffic is its live blocks.

#include "paged_common.cuh"

namespace {

template <typename QT, typename KT, bool QUANT>
__global__ void __launch_bounds__(paged::kThreads)
paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ pool_k,
                    const KT* __restrict__ pool_v, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ table,
                    const int* __restrict__ q_pos, QT* __restrict__ out, int NKV,
                    int G, int H, int bs, int maxb, float scale, float softcap) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, n = blockIdx.y;
  const long base = ((long)b * NKV + n) * G * H;
  paged::attend_rows<QT, KT, QUANT>(
      q + base, out + base, /*ii_stride=*/0, /*nI=*/1, G, H,
      /*pos0=*/q_pos[b], /*pos_step=*/0, /*n_valid=*/1, pool_k, pool_v,
      k_scale, v_scale, table + (long)b * maxb, maxb, bs, NKV, n, scale,
      softcap, smem);
}

template <typename QT, typename KT, bool QUANT>
int launch(const void* q, const void* pk, const void* pv, const float* ks,
           const float* vs, const int* table, const int* q_pos, void* out,
           int B, int NQ, int NKV, int H, int bs, int maxb, float scale,
           float softcap, cudaStream_t st) {
  const int G = NQ / NKV;
  const size_t smem = paged::attend_smem_floats(G, H, bs) * sizeof(float);
  auto kern = paged_decode_kernel<QT, KT, QUANT>;
  cudaError_t e = paged::allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(B, NKV), paged::kThreads, smem, st>>>(
      (const QT*)q, (const KT*)pk, (const KT*)pv, ks, vs, table, q_pos,
      (QT*)out, NKV, G, H, bs, maxb, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// q/out (B, 1, NQ, H); pools (num_blocks, bs, NKV, H); scales
// (num_blocks, bs, NKV, 1) float32 for an int8 pool (quant = 1), else
// null; table (B, maxb) int32; q_pos (B,) int32. dtype: 0 = float32,
// 1 = bfloat16 (q, out, and an unquantized pool).
extern "C" int paged_attention(const void* q, const void* pool_k, const void* pool_v,
                               const float* k_scale, const float* v_scale,
                               const int* table, const int* q_pos, void* out, int B,
                               int NQ, int NKV, int H, int bs, int maxb, int dtype,
                               int quant, float scale, float softcap, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0) return (int)cudaGetLastError();
  if (dtype == 1) {
    if (quant)
      return launch<__nv_bfloat16, int8_t, true>(q, pool_k, pool_v, k_scale, v_scale,
                                                 table, q_pos, out, B, NQ, NKV, H, bs,
                                                 maxb, scale, softcap, st);
    return launch<__nv_bfloat16, __nv_bfloat16, false>(q, pool_k, pool_v, k_scale,
                                                       v_scale, table, q_pos, out, B,
                                                       NQ, NKV, H, bs, maxb, scale,
                                                       softcap, st);
  }
  if (quant)
    return launch<float, int8_t, true>(q, pool_k, pool_v, k_scale, v_scale, table,
                                       q_pos, out, B, NQ, NKV, H, bs, maxb, scale,
                                       softcap, st);
  return launch<float, float, false>(q, pool_k, pool_v, k_scale, v_scale, table,
                                     q_pos, out, B, NQ, NKV, H, bs, maxb, scale,
                                     softcap, st);
}
