// Paged chunked-prefill attention for Hopper.
//
// Replaces repro/kernels/paged_prefill.py::paged_prefill_attention
// (_chunk_kernel): one row's chunk of Lc queries attends causally over
// [pool-resident prefix ++ the chunk], and the chunk's K/V lands in its
// destination pool blocks in place. An int8 pool is quantized on write
// with kv_cache.quantize_kv's math (_quantize_tile): per (token, head)
// scale = absmax * (1/127), codes = clamp(rint(x * (1/scale))), so the
// pool bytes and scale planes match the plain version bitwise. Slots
// outside [start, start + length) are never written, nor are blocks that
// are not destinations; padded queries (i >= length) output zeros.
//
// store = 0 is the read-only form: nothing is written and the chunk
// attends the K/V already resident at its positions. A prefix-cache hit
// on a whole prompt runs its last token so: the blocks are shared, hold
// exactly what a store would write, and must never be written.
//
// The read/write race: a destination block is both attended and
// rewritten. The TPU grid (NKV/bh, max_blocks) ran in order, merging the
// chunk into each destination tile before attending it. Thread blocks on
// the card run in no order, so the C entry writes the chunk first (one
// warp per (token, KV head)) and attends after, in a second launch on
// the same stream. The attention then reads the chunk's keys through the
// pool's own representation — dequantize(quantize(k)) for an int8 pool —
// exactly what the TPU kernel's merged tile held.
//
// Bound on the H100: at Lc = 32 the chunk reads the resident prefix once
// per KV head and does 4*Lc flops per K/V element pair; for prompts of a
// few hundred tokens it is bound by the pool bytes it streams. For bf16
// one thread block per (KV head, 64 (query, head) rows: 4 warps of 16)
// walks the rows' keys in the tiles and splits of whole-prompt flash
// attention on the tensor cores (attend_tile.cuh), folding the splits in
// the block, so a chunk's rows get the bits whole-prompt prefill gives
// them; float32 runs the scalar tile, 16 rows a block.

#include <type_traits>

#include "paged_common.cuh"

namespace {

using bf = __nv_bfloat16;
constexpr int kMmaWarps = 4;    // 16 query rows each: 64 (query, head) rows a block

template <typename QT, typename KT, bool QUANT>
__global__ void chunk_write_kernel(const QT* __restrict__ k_new,
                                   const QT* __restrict__ v_new, KT* __restrict__ pool_k,
                                   KT* __restrict__ pool_v, float* __restrict__ k_scale,
                                   float* __restrict__ v_scale,
                                   const int* __restrict__ blocks, int mb, int NKV,
                                   int H, int bs, int start, int length) {
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (pair >= length * NKV) return;
  const int i = pair / NKV, n = pair % NKV;
  const int pos = start + i;
  const int jb = pos / bs;
  if (jb >= mb) return;
  const int blk = blocks[jb];
  if (blk < 0) return;
  const long src = ((long)i * NKV + n) * H;
  const long slot = (long)(blk * bs + pos % bs) * NKV + n;
  const long dst = slot * H;
  for (int which = 0; which < 2; ++which) {
    const QT* x = which ? v_new : k_new;
    KT* pool = which ? pool_v : pool_k;
    if constexpr (QUANT) {
      float mx = 0.f;
      for (int h = lane; h < H; h += 32) mx = fmaxf(mx, fabsf(attn::to_f(x[src + h])));
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float s = __fmul_rn(mx, 1.0f / 127.0f);
      const float inv = s > 0.f ? __fdiv_rn(1.0f, s) : 0.f;
      for (int h = lane; h < H; h += 32) {
        const float t = rintf(__fmul_rn(attn::to_f(x[src + h]), inv));
        pool[dst + h] = (int8_t)(int)fminf(fmaxf(t, -128.f), 127.f);
      }
      if (lane == 0) (which ? v_scale : k_scale)[slot] = s;
    } else {
      for (int h = lane; h < H; h += 32) pool[dst + h] = (KT)x[src + h];
    }
  }
}

template <int H, typename KT, bool QUANT>
__global__ void __launch_bounds__(kMmaWarps * 32)
chunk_attend_mma_kernel(const bf* __restrict__ q, const KT* __restrict__ pool_k,
                        const KT* __restrict__ pool_v, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, const int* __restrict__ blocks,
                        bf* __restrict__ out, int Lc, int NKV, int G, int bs, int mb,
                        int rows_tok, int start, int length, float scale, float softcap) {
  const int n = blockIdx.x;
  const int i0 = blockIdx.y * rows_tok;
  const long ii_stride = (long)NKV * G * H;
  const long base = (long)i0 * ii_stride + (long)n * G * H;
  const paged::Rows rows{ii_stride, min(rows_tok, Lc - i0) * G, G, H, start + i0, 1,
                         length - i0};
  attn::attend_mma<H, kMmaWarps, QUANT, true>(
      q + base, out + base, rows, pool_k, pool_v, k_scale, v_scale,
      paged::PagedSrc{blocks, mb, bs}, NKV, n, scale, softcap, -1, nullptr, nullptr);
}

template <int H, typename KT, bool QUANT>
__global__ void __launch_bounds__(attn::kF32Threads)
chunk_attend_f32_kernel(const float* __restrict__ q, const KT* __restrict__ pool_k,
                        const KT* __restrict__ pool_v, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, const int* __restrict__ blocks,
                        float* __restrict__ out, int Lc, int NKV, int G, int bs, int mb,
                        int rows_tok, int start, int length, float scale, float softcap) {
  const int n = blockIdx.x;
  const int i0 = blockIdx.y * rows_tok;
  const long ii_stride = (long)NKV * G * H;
  const long base = (long)i0 * ii_stride + (long)n * G * H;
  const paged::Rows rows{ii_stride, min(rows_tok, Lc - i0) * G, G, H, start + i0, 1,
                         length - i0};
  attn::attend_f32<H, QUANT>(q + base, out + base, rows, pool_k, pool_v, k_scale, v_scale,
                             paged::PagedSrc{blocks, mb, bs}, NKV, n, scale, softcap);
}

template <int H, typename QT, typename KT, bool QUANT>
int launch(const void* q, const void* kn, const void* vn, void* pk, void* pv,
           float* ks, float* vs, const int* blocks, void* out, int Lc, int NQ,
           int NKV, int bs, int mb, int start, int length, bool store, float scale,
           float softcap, cudaStream_t st) {
  const int G = NQ / NKV;
  if (store && length > 0) {
    const int warps = 4;
    const int pairs = length * NKV;
    chunk_write_kernel<QT, KT, QUANT><<<(pairs + warps - 1) / warps, 32 * warps, 0, st>>>(
        (const QT*)kn, (const QT*)vn, (KT*)pk, (KT*)pv, ks, vs, blocks, mb, NKV, H,
        bs, start, length);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if constexpr (std::is_same<QT, bf>::value) {
    using SM = attn::MmaSmem<H, kMmaWarps, QUANT, true>;
    const int rows_tok = kMmaWarps * 16 / G;
    auto kern = chunk_attend_mma_kernel<H, KT, QUANT>;
    int e = attn::allow_smem(kern, SM::bytes);
    if (e) return e;
    kern<<<dim3(NKV, (Lc + rows_tok - 1) / rows_tok), kMmaWarps * 32, SM::bytes, st>>>(
        (const bf*)q, (const KT*)pk, (const KT*)pv, ks, vs, blocks, (bf*)out, Lc, NKV, G,
        bs, mb, rows_tok, start, length, scale, softcap);
  } else {
    using SM = attn::F32Smem<H>;
    const int rows_tok = attn::kF32Rows / G;
    auto kern = chunk_attend_f32_kernel<H, KT, QUANT>;
    int e = attn::allow_smem(kern, SM::bytes);
    if (e) return e;
    kern<<<dim3(NKV, (Lc + rows_tok - 1) / rows_tok), attn::kF32Threads, SM::bytes, st>>>(
        (const float*)q, (const KT*)pk, (const KT*)pv, ks, vs, blocks, (float*)out, Lc,
        NKV, G, bs, mb, rows_tok, start, length, scale, softcap);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q/out (1, Lc, NQ, H); k_new/v_new (1, Lc, NKV, H) in q's dtype; pools
// (num_blocks, bs, NKV, H), written in place; scales (num_blocks, bs,
// NKV, 1) float32 for an int8 pool (quant = 1), else null; blocks (mb,)
// int32. dtype: 0 = float32, 1 = bfloat16. store: 1 writes the chunk's
// K/V, 0 reads the pool as it is. H in {16, 64, 80, 128, 160, 192, 256},
// NQ / NKV <= 16.
extern "C" int paged_prefill(const void* q, const void* k_new, const void* v_new,
                             void* pool_k, void* pool_v, float* k_scale, float* v_scale,
                             const int* blocks, void* out, int Lc, int NQ, int NKV, int H,
                             int bs, int mb, int start, int length, int dtype, int quant,
                             int store, float scale, float softcap, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Lc <= 0) return (int)cudaGetLastError();
  if (!attn::head_dim_ok(H) || NKV <= 0 || NQ % NKV || NQ / NKV > paged::kGMax ||
      bs <= 0 || (bs % paged::kBK && paged::kBK % bs))
    return (int)cudaErrorInvalidValue;
  return attn::with_head_dim(H, [&](auto hd) -> int {
    constexpr int HH = decltype(hd)::value;
    if (dtype == 1) {
      if (quant)
        return launch<HH, bf, int8_t, true>(q, k_new, v_new, pool_k, pool_v, k_scale,
                                            v_scale, blocks, out, Lc, NQ, NKV, bs, mb,
                                            start, length, store != 0, scale, softcap, st);
      return launch<HH, bf, bf, false>(q, k_new, v_new, pool_k, pool_v, k_scale, v_scale,
                                       blocks, out, Lc, NQ, NKV, bs, mb, start, length,
                                       store != 0, scale, softcap, st);
    }
    if (quant)
      return launch<HH, float, int8_t, true>(q, k_new, v_new, pool_k, pool_v, k_scale,
                                             v_scale, blocks, out, Lc, NQ, NKV, bs, mb,
                                             start, length, store != 0, scale, softcap, st);
    return launch<HH, float, float, false>(q, k_new, v_new, pool_k, pool_v, k_scale,
                                           v_scale, blocks, out, Lc, NQ, NKV, bs, mb,
                                           start, length, store != 0, scale, softcap, st);
  });
}
