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
// decode sum in one order. ring_attention runs it over a ring cache (a
// sliding window; Griffin's local attention, which the JAX package
// computes outside any Pallas kernel, repro/models/common.py
// decode_attention): the row sees positions max(0, q_pos - window + 1) ..
// q_pos, position p in slot p % S iff slot_pos[p % S] == p, in the same
// tiles and splits at absolute positions, so a ring row's bits are those
// of flash's windowed row on the same keys. Its grid holds the splits of
// one window (33 for 2048 keys) and block z runs split first / 64 + z.
// Bound on the H100 at Griffin's decode (B = 4, one KV head of 256, a
// full 2048-slot ring): the K and V bytes, 8.4 MB a layer, 2.5 us.

#include "paged_common.cuh"

namespace {

using bf = __nv_bfloat16;

enum Source { kPaged, kContig, kRing };

// table: the (B, maxb) block table, or for kContig / kRing the (B, S)
// slot positions with maxb = S.
template <int SRC, typename F>
__device__ __forceinline__ void with_src(const int* table, int b, int bs, int maxb, F&& f) {
  if constexpr (SRC == kContig)
    f(paged::ContigSrc{table + (long)b * maxb, maxb, (long)b * maxb});
  else if constexpr (SRC == kRing)
    f(paged::RingSrc{table + (long)b * maxb, maxb, (long)b * maxb});
  else
    f(paged::PagedSrc{table + (long)b * maxb, maxb, bs});
}

// The decode row of batch row b at q_pos qp: its G query heads, keys from
// `first` (0 without a window) to qp.
__device__ __forceinline__ paged::DecodeRows decode_rows(int G, int H, int qp, int window) {
  return paged::DecodeRows{{0, G, G, H, qp, 0, 1}, window > 0 ? max(0, qp - window + 1) : 0};
}

template <int H, typename KT, bool QUANT, int SRC>
__global__ void __launch_bounds__(32)
decode_split_kernel(const bf* __restrict__ q, const KT* __restrict__ pk,
                    const KT* __restrict__ pv, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ table,
                    const int* __restrict__ q_pos, float* __restrict__ part_o,
                    float* __restrict__ part_ml, int NKV, int G, int bs, int maxb, int ns,
                    int window, float scale, float softcap) {
  const int b = blockIdx.x, n = blockIdx.y;
  const int qp = q_pos[b];
  const paged::DecodeRows rows = decode_rows(G, H, qp, window);
  const int sp = blockIdx.z + rows.first / attn::kSplit;   // absolute split
  if (qp < 0 || sp > qp / attn::kSplit) return;   // the fold never reads it
  const long bn = (long)b * NKV + n, ps = bn * ns + blockIdx.z;
  with_src<SRC>(table, b, bs, maxb, [&](const auto& src) {
    attn::attend_mma<H, 1, QUANT, false>(q + bn * G * H, (bf*)nullptr, rows, pk, pv, ks,
                                         vs, src, NKV, n, scale, softcap, sp,
                                         part_o + ps * 16 * H, part_ml + ps * 32);
  });
}

template <int H, typename KT, bool QUANT, int SRC>
__global__ void __launch_bounds__(attn::kF32Threads)
decode_f32_kernel(const float* __restrict__ q, const KT* __restrict__ pk,
                  const KT* __restrict__ pv, const float* __restrict__ ks,
                  const float* __restrict__ vs, const int* __restrict__ table,
                  const int* __restrict__ q_pos, float* __restrict__ out, int NKV, int G,
                  int bs, int maxb, int window, float scale, float softcap) {
  const int b = blockIdx.x, n = blockIdx.y;
  const long base = ((long)b * NKV + n) * G * H;
  const paged::DecodeRows rows = decode_rows(G, H, q_pos[b], window);
  with_src<SRC>(table, b, bs, maxb, [&](const auto& src) {
    attn::attend_f32<H, QUANT>(q + base, out + base, rows, pk, pv, ks, vs, src, NKV, n,
                               scale, softcap);
  });
}

template <int H, typename KT, bool QUANT, int SRC>
int launch_bf16(const void* q, const void* pk, const void* pv, const float* ks,
                const float* vs, const int* table, const int* q_pos, void* out,
                float* part_o, float* part_ml, int B, int NKV, int G, int bs, int maxb,
                int ns, int window, float scale, float softcap, cudaStream_t st) {
  using SM = attn::MmaSmem<H, 1, QUANT, false>;
  auto kern = decode_split_kernel<H, KT, QUANT, SRC>;
  int e = attn::allow_smem(kern, SM::bytes);
  if (e) return e;
  kern<<<dim3(B, NKV, ns), 32, SM::bytes, st>>>(
      (const bf*)q, (const KT*)pk, (const KT*)pv, ks, vs, table, q_pos, part_o, part_ml,
      NKV, G, bs, maxb, ns, window, scale, softcap);
  e = (int)cudaGetLastError();
  if (e) return e;
  attn::fold_splits_kernel<H><<<dim3(B, NKV, (G * H + 255) / 256), 256, 0, st>>>(
      part_o, part_ml, q_pos, (bf*)out, NKV, G, ns, window);
  return (int)cudaGetLastError();
}

template <int H, typename KT, bool QUANT, int SRC>
int launch_f32(const void* q, const void* pk, const void* pv, const float* ks,
               const float* vs, const int* table, const int* q_pos, void* out, int B,
               int NKV, int G, int bs, int maxb, int window, float scale, float softcap,
               cudaStream_t st) {
  using SM = attn::F32Smem<H>;
  auto kern = decode_f32_kernel<H, KT, QUANT, SRC>;
  int e = attn::allow_smem(kern, SM::bytes);
  if (e) return e;
  kern<<<dim3(B, NKV), attn::kF32Threads, SM::bytes, st>>>(
      (const float*)q, (const KT*)pk, (const KT*)pv, ks, vs, table, q_pos, (float*)out,
      NKV, G, bs, maxb, window, scale, softcap);
  return (int)cudaGetLastError();
}

// Splits a row's keys may span: those of the whole cache, or of one
// window of `window` positions starting anywhere (cdiv(window - 1, 64) + 1).
inline long splits_needed(int SRC, int bs, int maxb, int window) {
  if (SRC == kRing) return (window - 1 + attn::kSplit - 1) / attn::kSplit + 1;
  const long cap = SRC == kContig ? (long)maxb : (long)maxb * bs;   // keys a row may hold
  return (cap + attn::kSplit - 1) / attn::kSplit;
}

template <int SRC>
int dispatch(const void* q, const void* k, const void* v, const float* ks,
             const float* vs, const int* table, const int* q_pos, void* out,
             float* part_o, float* part_ml, int B, int NQ, int NKV, int H, int bs,
             int maxb, int ns, int window, int dtype, int quant, float scale,
             float softcap, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0) return (int)cudaGetLastError();
  if (!attn::head_dim_ok(H) || NKV <= 0 || NQ % NKV || NQ / NKV > paged::kGMax)
    return (int)cudaErrorInvalidValue;
  if (SRC == kPaged && (bs <= 0 || (bs % paged::kBK && paged::kBK % bs)))
    return (int)cudaErrorInvalidValue;
  if ((SRC == kRing) != (window > 0) || (SRC == kRing && maxb <= 0))
    return (int)cudaErrorInvalidValue;
  const int G = NQ / NKV;
  return attn::with_head_dim(H, [&](auto hd) -> int {
    constexpr int HH = decltype(hd)::value;
    if (dtype == 1) {
      if (ns <= 0 || ns < splits_needed(SRC, bs, maxb, window) || !part_o || !part_ml)
        return (int)cudaErrorInvalidValue;
      if (quant)
        return launch_bf16<HH, int8_t, true, SRC>(q, k, v, ks, vs, table, q_pos, out,
                                                  part_o, part_ml, B, NKV, G, bs, maxb, ns,
                                                  window, scale, softcap, st);
      return launch_bf16<HH, bf, false, SRC>(q, k, v, ks, vs, table, q_pos, out, part_o,
                                             part_ml, B, NKV, G, bs, maxb, ns, window, scale,
                                             softcap, st);
    }
    if (quant)
      return launch_f32<HH, int8_t, true, SRC>(q, k, v, ks, vs, table, q_pos, out, B, NKV,
                                               G, bs, maxb, window, scale, softcap, st);
    return launch_f32<HH, float, false, SRC>(q, k, v, ks, vs, table, q_pos, out, B, NKV, G,
                                             bs, maxb, window, scale, softcap, st);
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
  return dispatch<kPaged>(q, pool_k, pool_v, k_scale, v_scale, table, q_pos, out, part_o,
                          part_ml, B, NQ, NKV, H, bs, maxb, ns, /*window=*/0, dtype, quant,
                          scale, softcap, stream);
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
  return dispatch<kContig>(q, k_cache, v_cache, k_scale, v_scale, slot_pos, q_pos, out,
                           part_o, part_ml, B, NQ, NKV, H, /*bs=*/1, /*maxb=*/S, ns,
                           /*window=*/0, dtype, quant, scale, softcap, stream);
}

// Decode over one layer of a ring cache under a sliding window (window >
// 0): the operands of contig_attention, slot_pos (B, S) with position p in
// slot p % S iff slot_pos[p % S] == p (-1 = empty), the window, and
// scratch with ns >= cdiv(window - 1, 64) + 1 splits.
extern "C" int ring_attention(const void* q, const void* k_cache, const void* v_cache,
                              const float* k_scale, const float* v_scale,
                              const int* slot_pos, const int* q_pos, void* out,
                              float* part_o, float* part_ml, int B, int NQ, int NKV, int H,
                              int S, int window, int ns, int dtype, int quant, float scale,
                              float softcap, void* stream) {
  return dispatch<kRing>(q, k_cache, v_cache, k_scale, v_scale, slot_pos, q_pos, out, part_o,
                         part_ml, B, NQ, NKV, H, /*bs=*/1, /*maxb=*/S, ns, window, dtype,
                         quant, scale, softcap, stream);
}
