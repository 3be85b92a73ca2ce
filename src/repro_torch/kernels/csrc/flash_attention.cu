// Flash-attention forward for Hopper: whole-prompt prefill attention.
//
// Replaces repro/kernels/flash_attention.py::flash_attention (_flash_kernel)
// with the GQA dispatch of repro/kernels/ops.py::flash_attention folded in:
// q (B, Tq, NQ, H) attends k/v (B, Tk, NKV, H), query head h reading KV
// head h / (NQ / NKV) (no repeated K/V in device memory). Key j is
// visible to query position p = q_offset + i iff j < Tk, j <= p or
// j < prefix_len (causal; prefix-LM, the rule JAX computes in XLA,
// repro/models/common.py::_mask_block) and j > p - window (window > 0):
// one contiguous range (p - window, max(p, prefix_len - 1)] a row, so
// the tile skip below covers every mask. Scores q.k * H^-0.5 and an
// online softmax in float32, masked keys excluded, a row that sees no key
// outputs zeros; the output has q's dtype. K/V may be float32 while q is
// bf16 (an int8 cache's prefill reads dequantized K/V): they are read in
// their own type, never rounded to bf16.
//
// Bound on the H100: at the prefill shapes (B*NQ = 64 heads of 128, 320
// tokens, bf16) it must read q, k, v and write out once, ~21 MB (6 us at
// 3.35 TB/s), against ~1.7 GFLOP of causal products (2 us at the bf16
// peak), so the bytes bound it. For bf16 a block owns (batch*head, 64
// query rows): 4 warps of 16 rows share each 32-key K/V tile, staged as
// bf16 by cp.async into a 2-stage ring, and run the tensor-core tile step
// and the split fold of attend_tile.cuh, the order the paged kernels
// share, so chunked prefill and decode sum in exactly this order. float32
// (either operand) runs the scalar tile, 16 rows a block. Tiles wholly
// outside the block's causal/window range are never loaded.
//
// Tiles are fixed (32 keys at absolute positions, splits of 64), not
// sized from T: a row's result depends only on its own query and the keys
// it sees, never on the length its batch was padded to or on the block
// it shares, so bucketed prefill is bitwise exact-length prefill on the
// card.

#include <type_traits>

#include "attend_tile.cuh"
#include "flash_rows.cuh"

namespace {

using bf = __nv_bfloat16;
constexpr int kMmaWarps = 4;
constexpr int kMmaRows = kMmaWarps * 16;   // query rows a bf16 block

// Keys of batch row b: position pos < Tk lives in slot b * Tk + pos.
struct FlashSrc {
  long base;   // b * Tk
  int Tk;
  __device__ long slot(int pos) const { return pos < Tk ? base + pos : -1; }
  __device__ bool tile_live(int kt) const { return kt * attn::kBK < Tk; }
};

// Query rows t0 + r (r < nrows) of (batch b, head h): key j is visible to
// query position p = q_offset + t0 + r iff j < Tk, j <= max(p,
// prefix_len - 1) (causal) and j > p - window (window > 0), the range of
// flash_rows.cuh, which the backward walks too. A prefix row
// (p < prefix_len - 1) sees keys past its own position, up to the
// prefix's last: in a block of rows that straddles the prefix, the tile
// range reaches past the diagonal and each row masks its own keys.
struct FlashRows {
  long base;   // (b * Tq + t0) * NQ + h
  int nrows, NQ, H, qpos0, Tk, causal, window, prefix_len;
  __device__ bool exists(int r) const { return r < nrows; }
  __device__ int lo(int r) const { return flash::row_lo(qpos0 + r, window); }
  __device__ int hi(int r) const { return flash::row_hi(qpos0 + r, Tk, causal, prefix_len); }
  __device__ long q_off(int r) const { return (base + (long)r * NQ) * H; }
};

template <int ROWS>
__device__ __forceinline__ void flash_coords(int Tq, int Tk, int NQ, int NKV, int H,
                                             int causal, int window, int q_offset,
                                             int prefix_len, FlashRows& rows,
                                             FlashSrc& src, int& kvh) {
  const int b = blockIdx.y / NQ, h = blockIdx.y % NQ;
  const int t0 = blockIdx.x * ROWS;
  kvh = h / (NQ / NKV);
  rows = FlashRows{((long)b * Tq + t0) * NQ + h, min(ROWS, Tq - t0), NQ, H,
                   q_offset + t0, Tk, causal, window, prefix_len};
  src = FlashSrc{(long)b * Tk, Tk};
}

template <int H>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_mma_kernel(const bf* __restrict__ q, const bf* __restrict__ k, const bf* __restrict__ v,
                 bf* __restrict__ out, int Tq, int Tk, int NQ, int NKV, int causal,
                 int window, int q_offset, int prefix_len, float scale) {
  FlashRows rows;
  FlashSrc src;
  int kvh;
  flash_coords<kMmaRows>(Tq, Tk, NQ, NKV, H, causal, window, q_offset, prefix_len, rows,
                         src, kvh);
  attn::attend_mma<H, kMmaWarps, false, true>(q, out, rows, k, v, nullptr, nullptr, src,
                                              NKV, kvh, scale, 0.f, -1, nullptr, nullptr);
}

template <int H, typename QT, typename KT>
__global__ void __launch_bounds__(attn::kF32Threads)
flash_f32_kernel(const QT* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
                 QT* __restrict__ out, int Tq, int Tk, int NQ, int NKV, int causal,
                 int window, int q_offset, int prefix_len, float scale) {
  FlashRows rows;
  FlashSrc src;
  int kvh;
  flash_coords<attn::kF32Rows>(Tq, Tk, NQ, NKV, H, causal, window, q_offset, prefix_len,
                               rows, src, kvh);
  attn::attend_f32<H, false>(q, out, rows, k, v, nullptr, nullptr, src, NKV, kvh, scale,
                             0.f);
}

template <int H, typename QT, typename KT>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Tq, int Tk,
           int NQ, int NKV, int causal, int window, int q_offset, int prefix_len,
           float scale, cudaStream_t st) {
  if constexpr (std::is_same<QT, bf>::value && std::is_same<KT, bf>::value) {
    using SM = attn::MmaSmem<H, kMmaWarps, false, true>;
    auto kern = flash_mma_kernel<H>;
    int e = attn::allow_smem(kern, SM::bytes);
    if (e) return e;
    kern<<<dim3((Tq + kMmaRows - 1) / kMmaRows, B * NQ), kMmaWarps * 32, SM::bytes, st>>>(
        (const bf*)q, (const bf*)k, (const bf*)v, (bf*)out, Tq, Tk, NQ, NKV, causal, window,
        q_offset, prefix_len, scale);
  } else {
    using SM = attn::F32Smem<H>;
    auto kern = flash_f32_kernel<H, QT, KT>;
    int e = attn::allow_smem(kern, SM::bytes);
    if (e) return e;
    kern<<<dim3((Tq + attn::kF32Rows - 1) / attn::kF32Rows, B * NQ), attn::kF32Threads,
           SM::bytes, st>>>((const QT*)q, (const KT*)k, (const KT*)v, (QT*)out, Tq, Tk, NQ,
                            NKV, causal, window, q_offset, prefix_len, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q/out (B, Tq, NQ, H), k/v (B, Tk, NKV, H), all contiguous; q_dtype and
// kv_dtype are 0 = float32, 1 = bfloat16; H in {16, 64, 80, 128, 160,
// 192, 256}, NQ % NKV == 0; prefix_len >= 0 (0: plain causal). Returns
// the CUDA error code of the launch (0 = launched).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Tq, int Tk, int NQ, int NKV,
                               int H, int q_dtype, int kv_dtype, int causal,
                               int window, int q_offset, int prefix_len, float scale,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || Tq <= 0) return (int)cudaGetLastError();
  if (!attn::head_dim_ok(H) || NKV <= 0 || NQ % NKV) return (int)cudaErrorInvalidValue;
  const int sel = 2 * q_dtype + kv_dtype;
  return attn::with_head_dim(H, [&](auto hd) -> int {
    constexpr int HH = decltype(hd)::value;
    if (sel == 0) return launch<HH, float, float>(q, k, v, out, B, Tq, Tk, NQ, NKV, causal, window, q_offset, prefix_len, scale, st);
    if (sel == 1) return launch<HH, float, bf>(q, k, v, out, B, Tq, Tk, NQ, NKV, causal, window, q_offset, prefix_len, scale, st);
    if (sel == 2) return launch<HH, bf, float>(q, k, v, out, B, Tq, Tk, NQ, NKV, causal, window, q_offset, prefix_len, scale, st);
    if (sel == 3) return launch<HH, bf, bf>(q, k, v, out, B, Tq, Tk, NQ, NKV, causal, window, q_offset, prefix_len, scale, st);
    return (int)cudaErrorInvalidValue;
  });
}
