// Paged flash-decode attention for Hopper, split over the context.
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
// order with the softmax state in VMEM scratch. Here (bf16 q) the grid is
// (B, NKV, splits): one warp per (row, KV head, split of attn::kSplit
// keys) holds the G <= 16 query heads as one 16-row mma tile (unused rows
// masked), stages the split's 32-key tiles through a cp.async ring and
// writes the split's (m, l, O) to scratch the wrapper allocates; a second
// launch on the same stream folds each row's splits in increasing order
// and normalises (attn::fold_splits_kernel), with the fold that flash and
// prefill run inside their blocks, so decode stays bitwise their rows. At
// the timed shape (B = 4, 16 KV heads, up to 512 keys) that is 512 blocks
// where one per (row, KV head) gave 64. Wholly unallocated tiles and keys
// past q_pos are never loaded: a row's traffic is its live blocks.
// float32 q runs the scalar tile in one block per (row, KV head), its
// splits folded in the block (attend_f32.cuh).
//
// contig_attention runs the same code over one layer of the contiguous
// cache (the static engine's and the contiguous scheduler's decode), each
// row's slots standing in for its blocks, so static decode and paged
// decode sum in one order.

#include "paged_common.cuh"

namespace {

using bf = __nv_bfloat16;

// table: the (B, maxb) block table, or for CONTIG the (B, S) slot
// positions with maxb = S.
template <bool CONTIG, typename F>
__device__ __forceinline__ void with_src(const int* table, int b, int bs, int maxb, F&& f) {
  if constexpr (CONTIG)
    f(paged::ContigSrc{table + (long)b * maxb, maxb, (long)b * maxb});
  else
    f(paged::PagedSrc{table + (long)b * maxb, maxb, bs});
}

template <int H, typename KT, bool QUANT, bool CONTIG>
__global__ void __launch_bounds__(32)
decode_split_kernel(const bf* __restrict__ q, const KT* __restrict__ pk,
                    const KT* __restrict__ pv, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ table,
                    const int* __restrict__ q_pos, float* __restrict__ part_o,
                    float* __restrict__ part_ml, int NKV, int G, int bs, int maxb, int ns,
                    float scale, float softcap) {
  const int b = blockIdx.x, n = blockIdx.y, sp = blockIdx.z;
  const int qp = q_pos[b];
  if (qp < 0 || sp > qp / attn::kSplit) return;   // the fold never reads it
  const long bn = (long)b * NKV + n, ps = bn * ns + sp;
  const paged::Rows rows{0, G, G, H, qp, 0, 1};
  with_src<CONTIG>(table, b, bs, maxb, [&](const auto& src) {
    attn::attend_mma<H, 1, QUANT, false>(q + bn * G * H, (bf*)nullptr, rows, pk, pv, ks,
                                         vs, src, NKV, n, scale, softcap, sp,
                                         part_o + ps * 16 * H, part_ml + ps * 32);
  });
}

template <int H, typename KT, bool QUANT, bool CONTIG>
__global__ void __launch_bounds__(attn::kF32Threads)
decode_f32_kernel(const float* __restrict__ q, const KT* __restrict__ pk,
                  const KT* __restrict__ pv, const float* __restrict__ ks,
                  const float* __restrict__ vs, const int* __restrict__ table,
                  const int* __restrict__ q_pos, float* __restrict__ out, int NKV, int G,
                  int bs, int maxb, float scale, float softcap) {
  const int b = blockIdx.x, n = blockIdx.y;
  const long base = ((long)b * NKV + n) * G * H;
  const paged::Rows rows{0, G, G, H, q_pos[b], 0, 1};
  with_src<CONTIG>(table, b, bs, maxb, [&](const auto& src) {
    attn::attend_f32<H, QUANT>(q + base, out + base, rows, pk, pv, ks, vs, src, NKV, n,
                               scale, softcap);
  });
}

template <int H, typename KT, bool QUANT, bool CONTIG>
int launch_bf16(const void* q, const void* pk, const void* pv, const float* ks,
                const float* vs, const int* table, const int* q_pos, void* out,
                float* part_o, float* part_ml, int B, int NKV, int G, int bs, int maxb,
                int ns, float scale, float softcap, cudaStream_t st) {
  using SM = attn::MmaSmem<H, 1, QUANT, false>;
  auto kern = decode_split_kernel<H, KT, QUANT, CONTIG>;
  int e = attn::allow_smem(kern, SM::bytes);
  if (e) return e;
  kern<<<dim3(B, NKV, ns), 32, SM::bytes, st>>>(
      (const bf*)q, (const KT*)pk, (const KT*)pv, ks, vs, table, q_pos, part_o, part_ml,
      NKV, G, bs, maxb, ns, scale, softcap);
  e = (int)cudaGetLastError();
  if (e) return e;
  attn::fold_splits_kernel<H><<<dim3(B, NKV), 256, 0, st>>>(part_o, part_ml, q_pos,
                                                            (bf*)out, NKV, G, ns);
  return (int)cudaGetLastError();
}

template <int H, typename KT, bool QUANT, bool CONTIG>
int launch_f32(const void* q, const void* pk, const void* pv, const float* ks,
               const float* vs, const int* table, const int* q_pos, void* out, int B,
               int NKV, int G, int bs, int maxb, float scale, float softcap,
               cudaStream_t st) {
  using SM = attn::F32Smem<H>;
  auto kern = decode_f32_kernel<H, KT, QUANT, CONTIG>;
  int e = attn::allow_smem(kern, SM::bytes);
  if (e) return e;
  kern<<<dim3(B, NKV), attn::kF32Threads, SM::bytes, st>>>(
      (const float*)q, (const KT*)pk, (const KT*)pv, ks, vs, table, q_pos, (float*)out,
      NKV, G, bs, maxb, scale, softcap);
  return (int)cudaGetLastError();
}

template <bool CONTIG>
int dispatch(const void* q, const void* k, const void* v, const float* ks,
             const float* vs, const int* table, const int* q_pos, void* out,
             float* part_o, float* part_ml, int B, int NQ, int NKV, int H, int bs,
             int maxb, int ns, int dtype, int quant, float scale, float softcap,
             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0) return (int)cudaGetLastError();
  if (!attn::head_dim_ok(H) || NKV <= 0 || NQ % NKV || NQ / NKV > paged::kGMax)
    return (int)cudaErrorInvalidValue;
  if (!CONTIG && (bs <= 0 || (bs % paged::kBK && paged::kBK % bs)))
    return (int)cudaErrorInvalidValue;
  const int G = NQ / NKV;
  const long cap = CONTIG ? (long)maxb : (long)maxb * bs;   // keys a row may hold
  return attn::with_head_dim(H, [&](auto hd) -> int {
    constexpr int HH = decltype(hd)::value;
    if (dtype == 1) {
      if (ns <= 0 || (long)ns * attn::kSplit < cap || !part_o || !part_ml)
        return (int)cudaErrorInvalidValue;
      if (quant)
        return launch_bf16<HH, int8_t, true, CONTIG>(q, k, v, ks, vs, table, q_pos, out,
                                                     part_o, part_ml, B, NKV, G, bs, maxb,
                                                     ns, scale, softcap, st);
      return launch_bf16<HH, bf, false, CONTIG>(q, k, v, ks, vs, table, q_pos, out, part_o,
                                                part_ml, B, NKV, G, bs, maxb, ns, scale,
                                                softcap, st);
    }
    if (quant)
      return launch_f32<HH, int8_t, true, CONTIG>(q, k, v, ks, vs, table, q_pos, out, B,
                                                  NKV, G, bs, maxb, scale, softcap, st);
    return launch_f32<HH, float, false, CONTIG>(q, k, v, ks, vs, table, q_pos, out, B, NKV,
                                                G, bs, maxb, scale, softcap, st);
  });
}

}  // namespace

// q/out (B, 1, NQ, H); pools (num_blocks, bs, NKV, H) with bs dividing
// or a multiple of the 32-key tile; scales (num_blocks, bs, NKV, 1)
// float32 for an int8 pool (quant = 1), else null; table (B, maxb) int32;
// q_pos (B,) int32. dtype: 0 = float32, 1 = bfloat16 (q, out, and an
// unquantized pool). For bfloat16, part_o (B, NKV, ns, 16, H) and part_ml
// (B, NKV, ns, 16, 2) float32 scratch with ns * 64 >= maxb * bs (null
// for float32). H in {16, 64, 80, 128, 160, 192, 256}, NQ / NKV <= 16.
extern "C" int paged_attention(const void* q, const void* pool_k, const void* pool_v,
                               const float* k_scale, const float* v_scale,
                               const int* table, const int* q_pos, void* out,
                               float* part_o, float* part_ml, int B, int NQ, int NKV,
                               int H, int bs, int maxb, int ns, int dtype, int quant,
                               float scale, float softcap, void* stream) {
  return dispatch<false>(q, pool_k, pool_v, k_scale, v_scale, table, q_pos, out, part_o,
                         part_ml, B, NQ, NKV, H, bs, maxb, ns, dtype, quant, scale,
                         softcap, stream);
}

// Decode over one layer of the full contiguous cache: q/out (B, 1, NQ,
// H); k/v_cache (B, S, NKV, H); scales (B, S, NKV, 1) float32 for an int8
// cache (quant = 1), else null; slot_pos (B, S) int32 (-1 = empty, else
// the slot's own position); q_pos (B,) int32; scratch as paged_attention
// with ns * 64 >= S.
extern "C" int contig_attention(const void* q, const void* k_cache, const void* v_cache,
                                const float* k_scale, const float* v_scale,
                                const int* slot_pos, const int* q_pos, void* out,
                                float* part_o, float* part_ml, int B, int NQ, int NKV,
                                int H, int S, int ns, int dtype, int quant, float scale,
                                float softcap, void* stream) {
  return dispatch<true>(q, k_cache, v_cache, k_scale, v_scale, slot_pos, q_pos, out,
                        part_o, part_ml, B, NQ, NKV, H, /*bs=*/1, /*maxb=*/S, ns, dtype,
                        quant, scale, softcap, stream);
}
