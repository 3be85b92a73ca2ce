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
// (row, KV head) walks the row's keys in 32-key tiles (attend_tile.cuh,
// gathered from the blocks each tile spans) with the state in registers,
// so nothing carries between blocks. Wholly unallocated tiles and tiles
// past q_pos are never loaded: a row's traffic is its live blocks.
//
// contig_attention runs the same code over one layer of the contiguous
// cache (the static engine's and the contiguous scheduler's decode), each
// row's slots standing in for its blocks, so static decode and paged
// decode sum in one order.

#include "paged_common.cuh"

namespace {

template <typename QT, typename KT, bool QUANT>
__global__ void __launch_bounds__(paged::kThreads)
paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ pool_k,
                    const KT* __restrict__ pool_v, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ table,
                    const int* __restrict__ q_pos, QT* __restrict__ out, int NKV,
                    int G, int H, int bs, int maxb, float scale, float softcap) {
  const int b = blockIdx.x, n = blockIdx.y;
  const long base = ((long)b * NKV + n) * G * H;
  paged::attend_rows<QT, KT, QUANT>(
      q + base, out + base, /*ii_stride=*/0, /*nI=*/1, G, H,
      /*pos0=*/q_pos[b], /*pos_step=*/0, /*n_valid=*/1, pool_k, pool_v,
      k_scale, v_scale, paged::PagedSrc{table + (long)b * maxb, maxb, bs}, NKV, n,
      scale, softcap);
}

// The same decode over a full contiguous cache (B, S, NKV, H): row b's
// keys are its own slots, slot == position (the identity table).
template <typename QT, typename KT, bool QUANT>
__global__ void __launch_bounds__(paged::kThreads)
contig_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k_cache,
                     const KT* __restrict__ v_cache, const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale, const int* __restrict__ slot_pos,
                     const int* __restrict__ q_pos, QT* __restrict__ out, int NKV,
                     int G, int H, int S, float scale, float softcap) {
  const int b = blockIdx.x, n = blockIdx.y;
  const long base = ((long)b * NKV + n) * G * H;
  paged::attend_rows<QT, KT, QUANT>(
      q + base, out + base, /*ii_stride=*/0, /*nI=*/1, G, H,
      /*pos0=*/q_pos[b], /*pos_step=*/0, /*n_valid=*/1, k_cache, v_cache,
      k_scale, v_scale, paged::ContigSrc{slot_pos + (long)b * S, S, (long)b * S}, NKV,
      n, scale, softcap);
}

template <typename QT, typename KT, bool QUANT>
int launch(const void* q, const void* pk, const void* pv, const float* ks,
           const float* vs, const int* table, const int* q_pos, void* out,
           int B, int NQ, int NKV, int H, int bs, int maxb, int contig, float scale,
           float softcap, cudaStream_t st) {
  const int G = NQ / NKV;
  if (contig)
    contig_decode_kernel<QT, KT, QUANT><<<dim3(B, NKV), paged::kThreads, 0, st>>>(
        (const QT*)q, (const KT*)pk, (const KT*)pv, ks, vs, table, q_pos, (QT*)out,
        NKV, G, H, maxb, scale, softcap);
  else
    paged_decode_kernel<QT, KT, QUANT><<<dim3(B, NKV), paged::kThreads, 0, st>>>(
        (const QT*)q, (const KT*)pk, (const KT*)pv, ks, vs, table, q_pos, (QT*)out,
        NKV, G, H, bs, maxb, scale, softcap);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, const float* ks,
             const float* vs, const int* table, const int* q_pos, void* out, int B,
             int NQ, int NKV, int H, int bs, int maxb, int contig, int dtype,
             int quant, float scale, float softcap, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0) return (int)cudaGetLastError();
  if (H <= 0 || H > attn::kHMax || NKV <= 0 || NQ % NKV || NQ / NKV > paged::kRowsMax)
    return (int)cudaErrorInvalidValue;
  if (!contig && (bs <= 0 || (bs % paged::kBK && paged::kBK % bs))) return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  if (dtype == 1) {
    if (quant)
      return launch<bf, int8_t, true>(q, k, v, ks, vs, table, q_pos, out, B, NQ, NKV,
                                      H, bs, maxb, contig, scale, softcap, st);
    return launch<bf, bf, false>(q, k, v, ks, vs, table, q_pos, out, B, NQ, NKV, H,
                                 bs, maxb, contig, scale, softcap, st);
  }
  if (quant)
    return launch<float, int8_t, true>(q, k, v, ks, vs, table, q_pos, out, B, NQ, NKV,
                                       H, bs, maxb, contig, scale, softcap, st);
  return launch<float, float, false>(q, k, v, ks, vs, table, q_pos, out, B, NQ, NKV, H,
                                     bs, maxb, contig, scale, softcap, st);
}

}  // namespace

// q/out (B, 1, NQ, H); pools (num_blocks, bs, NKV, H) with bs dividing
// or a multiple of the 32-key tile; scales (num_blocks, bs, NKV, 1)
// float32 for an int8 pool (quant = 1), else null; table (B, maxb) int32;
// q_pos (B,) int32. dtype: 0 = float32, 1 = bfloat16 (q, out, and an
// unquantized pool).
extern "C" int paged_attention(const void* q, const void* pool_k, const void* pool_v,
                               const float* k_scale, const float* v_scale,
                               const int* table, const int* q_pos, void* out, int B,
                               int NQ, int NKV, int H, int bs, int maxb, int dtype,
                               int quant, float scale, float softcap, void* stream) {
  return dispatch(q, pool_k, pool_v, k_scale, v_scale, table, q_pos, out, B, NQ, NKV,
                  H, bs, maxb, /*contig=*/0, dtype, quant, scale, softcap, stream);
}

// Decode over one layer of the full contiguous cache: q/out (B, 1, NQ,
// H); k/v_cache (B, S, NKV, H); scales (B, S, NKV, 1) float32 for an int8
// cache (quant = 1), else null; slot_pos (B, S) int32 (-1 = empty, else
// the slot's own position); q_pos (B,) int32.
extern "C" int contig_attention(const void* q, const void* k_cache, const void* v_cache,
                                const float* k_scale, const float* v_scale,
                                const int* slot_pos, const int* q_pos, void* out, int B,
                                int NQ, int NKV, int H, int S, int dtype, int quant,
                                float scale, float softcap, void* stream) {
  return dispatch(q, k_cache, v_cache, k_scale, v_scale, slot_pos, q_pos, out, B, NQ,
                  NKV, H, /*bs=*/1, /*maxb=*/S, /*contig=*/1, dtype, quant, scale,
                  softcap, stream);
}
