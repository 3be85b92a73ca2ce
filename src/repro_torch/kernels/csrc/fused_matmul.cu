// Fused activation-quantize -> packed-weight integer matmul for Hopper's
// int8 tensor cores, with the dequant in its store.
//
// Replaces repro/kernels/fused_matmul.py::fused_quantize_matmul
// (_fused_kernel): (M, K) float activations times (K, N) weight codes
// give an exact (M, N) int32 accumulator and (M,) float32 per-row
// scales. A second output form, the serving path's, stores
//     y = out_dtype((float(acc) * xs[m]) * (scale[n] * 4^plane_lo))
// instead of acc (repro/core/quantized_linear.py::_serve_matmul's two
// float32 products, in that order, then one rounding), straight into a
// strided output at a column offset, so a leaf of two filter groups
// writes [y8, yl] with no concatenation.
//
// Quantization is the JAX kernel's prologue: scale = absmax * (1/qhi)
// (the strength-reduced form jitted XLA computes), inv = 1/scale with a
// correctly rounded division, codes = clamp(rint(x * inv)) with the
// product kept out of any FMA (__fmul_rn) and rint rounding half to even
// like jnp.round. A first launch reduces each row's absmax; at decode (M
// <= 8) each matmul block reduces its few rows itself instead, and no
// row pass runs; with the rows' scales handed in (the second group of a
// leaf) neither does. The matmul blocks read the float activations (float32, or
// bfloat16 as they are: bf16 -> f32 is exact) through a cp.async ring,
// quantize each (rows x 64) tile into the int8 shared tile that ldmatrix
// reads, and contract it on `mma.sync.m16n8k32` (s8 x s8, or u8 x s8 for
// unsigned codes up to 255) against the packed weights, unpacked in
// registers exactly as in bitplane_matmul.cu: a warp's four n8 tiles
// interleave their columns, so one 32-bit word per packed row gives a
// lane its B fragments after a sign-extending field extraction (the
// w_plane_lo shift folded in) and a 4 x 4 byte transpose. No activation
// code reaches device memory.
//
// Bound on the H100: at decode (M = 4) the K N bits/8 packed weight bytes
// bound it; at a static prefill (M = 1280) the 2 M K N int8 operations
// do (1 979 TOP/s). Every N tile reads its float rows again (from L2) and
// quantizes them again: 256-column tiles halve both at prefill, and
// bfloat16 input halves the traffic. The tile, the grid and the K split come
// from the caller's plan (kernels/fused_matmul.py::plan): one K slice
// stores from registers; a split writes int32 partial tiles to a scratch
// buffer, which at decode (M <= 8) the last block of a tile to arrive
// sums and stores (a counter per tile, reset by that block, so it needs
// no fill), and above that a fold launch sums over all SMs (measured
// faster at M = 32, where the last block's serial tail dominated). That
// store is split_store.cuh, shared with bitplane_matmul.cu's dequant
// entry. Integer addition is exact, so any plan gives the same bits, and
// a row never depends on M, on the split or on the other rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "split_store.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps: 2 along M x 4 along N
constexpr int kBN = 128;        // output columns per 32-column group of each of 4 warps
constexpr int kKT = 64;         // K codes per tile
// Up to this M (decode) the matmul blocks reduce the row scales and sum
// a K split themselves; above it a row pass and a fold launch do.
constexpr int kFuseRows = splitk::kLastBlockRows;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// Four consecutive activations from shared memory as float32.
__device__ __forceinline__ void load4(const float* p, float* e) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  e[0] = q.x; e[1] = q.y; e[2] = q.z; e[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* e) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  e[0] = __uint_as_float(q.x << 16);
  e[1] = __uint_as_float(q.x & 0xffff0000u);
  e[2] = __uint_as_float(q.y << 16);
  e[3] = __uint_as_float(q.y & 0xffff0000u);
}

// A block is 32 MI rows by 128 NG columns: 8 warps, 2 along M x 4 along
// N, a warp owning NG groups of 32 columns (group wn + 4 g).
template <int MI, int NG, int BITS, typename XT>
struct Smem {
  static constexpr int S = 3;                 // stages of the cp.async ring
  XT x[S][32 * MI][kKT];                      // activations, rows x K
  int8_t b[S][kKT * BITS / 8][kBN * NG];      // packed weight bytes, K rows x N
  int8_t a[32 * MI][kKT];                     // the tile's activation codes
  float scl[32 * MI];                         // row scale
  float inv[32 * MI];                         // 1 / row scale
  int last;                                   // this block sums the split
};

// Activation codes: rows of 4 16-byte chunks, chunk c of row r at
// c ^ ((r >> 1) & 3), so ldmatrix's 8 rows hit 8 bank groups. Packed
// weight rows as in bitplane_matmul.cu: chunk c of packed row p at
// c ^ (2 ((p / RPQ) & 3)) (inside its 128 bytes).
template <int MI, int NG, int BITS, typename XT>
__device__ __forceinline__ int8_t* a_at(Smem<MI, NG, BITS, XT>& s, int r, int c) {
  return &s.a[r][(c ^ ((r >> 1) & 3)) << 4];
}
template <int MI, int NG, int BITS, typename XT>
__device__ __forceinline__ int8_t* b_at(Smem<MI, NG, BITS, XT>& s, int st, int p, int c) {
  constexpr int RPQ = BITS / 2;
  return &s.b[st][p][(c ^ (((p / RPQ) & 3) << 1)) << 4];
}

// 4 bytes of sign-extended codes of width b held in the low b bits of each
// byte of x (bitplane_matmul.cu).
__device__ __forceinline__ uint32_t sext4(uint32_t x, uint32_t sign, uint32_t mult) {
  return x | ((x & sign) * mult);
}

using splitk::Out;

template <typename XT>
__global__ void row_scale_kernel(const XT* __restrict__ x, int K, float rq,
                                 float* __restrict__ scales) {
  const XT* row = x + (size_t)blockIdx.x * K;
  float mx = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) mx = fmaxf(mx, fabsf(to_f(row[k])));
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  __shared__ float red[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  if (warp == 0) {
    mx = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) scales[blockIdx.x] = __fmul_rn(mx, rq);
  }
}

// vec bit 0: activation rows allow 16-byte copies; bit 1: packed rows do.
template <int MI, int NG, int BITS, bool SIGNED, typename XT>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const XT* __restrict__ x, const int8_t* __restrict__ wp,
             float* __restrict__ scales, int M, int K, int N, int kb, int qlo, int qhi,
             float rq, int fuse, int fold, int shift, int vec, Out out,
             int32_t* __restrict__ part,
             int* __restrict__ counters) {
  using Sm = Smem<MI, NG, BITS, XT>;
  constexpr int BN = kBN * NG;
  constexpr int S = Sm::S;
  constexpr int BM = 32 * MI;
  constexpr int RPQ = BITS / 2;    // packed rows per quad of K codes
  constexpr int EPB = 8 / BITS;    // codes per byte
  constexpr int PR = kKT * BITS / 8;
  constexpr int EPC = 16 / (int)sizeof(XT);   // activations per 16-byte chunk
  constexpr int CPR = kKT / EPC;              // chunks per activation row
  extern __shared__ __align__(128) unsigned char smem[];
  Sm& s = *reinterpret_cast<Sm*>(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.z * BM;
  const int ks0 = blockIdx.y * kb, ks1 = min(K, ks0 + kb);
  const int nk = (ks1 - ks0 + kKT - 1) / kKT;
  const int kp_rows = K * BITS / 8;
  const int rows = min(BM, M - m0);   // rows of the block inside M
  const bool vx = (vec & 1) != 0, vw = (vec & 2) != 0;

  // Row scales: from the row pass, or (fuse: a few rows, as at decode)
  // each block reduces its rows' absmax itself, a warp a row, and the
  // blocks of the first column and slice store them.
  if (fuse) {
    for (int r = warp; r < rows; r += kThreads / 32) {
      const XT* row = x + (size_t)(m0 + r) * K;
      float mx = 0.f;
#pragma unroll 8
      for (int k = lane; k < K; k += 32) mx = fmaxf(mx, fabsf(to_f(row[k])));
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane == 0) {
        s.scl[r] = __fmul_rn(mx, rq);
        if (blockIdx.x == 0 && blockIdx.y == 0) scales[m0 + r] = s.scl[r];
      }
    }
    __syncthreads();
  }
  for (int r = tid; r < BM; r += kThreads) {
    const float sc = r < rows ? (fuse ? s.scl[r] : scales[m0 + r]) : 0.f;
    s.scl[r] = sc;
    s.inv[r] = sc > 0.f ? __fdiv_rn(1.0f, sc) : 0.f;
  }

  // Rows past M are neither loaded nor quantized: their codes reach only
  // their own mma rows, which are never stored.
  auto load = [&](int st, int kt) {
    const int k0 = ks0 + kt * kKT;
    for (int idx = tid; idx < rows * CPR; idx += kThreads) {
      const int r = idx / CPR, c = idx % CPR, gk = k0 + c * EPC;
      const XT* src = x + (size_t)(m0 + r) * K + gk;
      XT* dst = &s.x[st][r][c * EPC];
      const int n = max(0, min(EPC, K - gk));
      if (vx) {
        mma::cp16(dst, n > 0 ? src : nullptr, n > 0);
      } else {
#pragma unroll
        for (int j = 0; j < EPC; ++j) dst[j] = j < n ? src[j] : zero<XT>();
      }
    }
    for (int idx = tid; idx < PR * (BN / 16); idx += kThreads) {
      const int p = idx / (BN / 16), c = idx % (BN / 16);
      const int gp = k0 * BITS / 8 + p, gn = n0 + 16 * c;
      const int n = gp < kp_rows ? max(0, min(16, N - gn)) : 0;
      int8_t* dst = b_at(s, st, p, c);
      const int8_t* src = wp + (size_t)gp * N + gn;
      if (vw) {
        mma::cp16(dst, n > 0 ? src : nullptr, n > 0);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) dst[j] = j < n ? src[j] : (int8_t)0;
      }
    }
  };

  // The landed activation tile of stage st -> int8 codes in s.a: a
  // thread quantizes 4 consecutive K of one row, 16 lanes a row.
  auto quantize = [&](int st) {
    for (int idx = tid; idx < rows * (kKT / 4); idx += kThreads) {
      const int r = idx >> 4, f = idx & 15;
      float e[4];
      load4(&s.x[st][r][4 * f], e);
      const float inv = s.inv[r];
      int c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)   // rint (half to even), then the clamp: exact in int
        c[j] = min(max(__float2int_rn(__fmul_rn(e[j], inv)), qlo), qhi);
      const uint32_t word = __byte_perm(__byte_perm(c[0], c[1], 0x0040),
                                        __byte_perm(c[2], c[3], 0x0040), 0x5410);
      *reinterpret_cast<uint32_t*>(a_at(s, r, f >> 2) + 4 * (f & 3)) = word;
    }
  };

  int d[MI][4 * NG][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[i][j][e] = 0;

  const int b = BITS - shift;     // the planes kept
  const uint32_t fmask = ((1u << b) - 1u) * 0x01010101u;
  const uint32_t fsign = (1u << (b - 1)) * 0x01010101u;
  const uint32_t fmult = (1u << (9 - b)) - 2u;
  const bool active = m0 + wm * 16 * MI < M;   // warp-uniform

#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < nk) load(st, st);
    mma::cp_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 2));
    __syncthreads();   // tile kt landed; s.a and the stage refilled below are free
    const int nxt = kt + S - 1;
    if (nxt < nk) load(nxt % S, nxt);
    mma::cp_commit();
    const int st = kt % S;
    quantize(st);
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int ks = 0; ks < kKT / 32; ++ks) {     // k32 steps
#pragma unroll
    for (int gq = 0; gq < NG; ++gq) {           // the warp's 32-column groups
      const int grp = wn + 4 * gq;
      uint32_t bf[4][2];                        // [n8 tile][k half]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = ks * 8 + 4 * h + t;       // K quad of this lane's fragment
        uint32_t W[RPQ];
#pragma unroll
        for (int r = 0; r < RPQ; ++r)
          W[r] = *reinterpret_cast<const uint32_t*>(
              b_at(s, st, q * RPQ + r, grp * 2 + (g >> 2)) + 4 * (g & 3));
        uint32_t F[4];                          // byte c: code (k = 4q + kk, column c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          F[kk] = sext4((W[kk / EPB] >> ((kk % EPB) * BITS + shift)) & fmask, fsign, fmult);
        const uint32_t lo01 = __byte_perm(F[0], F[1], 0x5140);
        const uint32_t hi01 = __byte_perm(F[0], F[1], 0x7362);
        const uint32_t lo23 = __byte_perm(F[2], F[3], 0x5140);
        const uint32_t hi23 = __byte_perm(F[2], F[3], 0x7362);
        bf[0][h] = __byte_perm(lo01, lo23, 0x5410);
        bf[1][h] = __byte_perm(lo01, lo23, 0x7632);
        bf[2][h] = __byte_perm(hi01, hi23, 0x5410);
        bf[3][h] = __byte_perm(hi01, hi23, 0x7632);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        uint32_t a[4];
        mma::ldm_x4(a, a_at(s, wm * 16 * MI + i * 16 + (lane & 15), ks * 2 + (lane >> 4)));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma::mma16832<SIGNED>(d[i][4 * gq + j], a, bf[j][0], bf[j][1]);
      }
    }
    }
  }

  // Lane (g, t) holds, for each m16 tile, rows g and g + 8 at the 8
  // consecutive columns 8 t .. 8 t + 7 of the warp's 32: tile j's C column
  // 2t (+1) is column 8 t + j (+4).
  const bool split = gridDim.y > 1;
  if (active) {
#pragma unroll
    for (int gq = 0; gq < NG; ++gq)
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 16 * MI + i * 16 + g + 8 * h;
        const int c0 = n0 + (wn + 4 * gq) * 32 + 8 * t;
        if (row >= M) continue;
        int o[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          o[j] = d[i][4 * gq + j][2 * h];
          o[4 + j] = d[i][4 * gq + j][2 * h + 1];
        }
        if (!split) splitk::store8(out, N, row, c0, o, s.scl[row - m0]);
        else splitk::store_part8(part, blockIdx.y, M, N, row, c0, o);
      }
  }
  if (!split || fold) return;

  // K split at decode: the last block of this output tile to arrive sums
  // the slices and stores (split_store.cuh).
  splitk::last_block_store<BN, kThreads>(out, part, counters, &s.last, M, N, m0, rows, n0,
                                         [&](int r) { return s.scl[r]; });
}

template <int MI, int NG, int BITS, bool SIGNED, typename XT>
cudaError_t launch_tile(dim3 grid, cudaStream_t st, const XT* x, const int8_t* wp,
                        float* scales, int M, int K, int N, int kb, int qlo, int qhi,
                        float rq, int fuse, int fold, int shift, int vec, const Out& out,
                        int32_t* part, int* counters) {
  constexpr int bytes = (int)sizeof(Smem<MI, NG, BITS, XT>);
  auto kern = fused_kernel<MI, NG, BITS, SIGNED, XT>;
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, kThreads, bytes, st>>>(x, wp, scales, M, K, N, kb, qlo, qhi, rq, fuse, fold,
                                      shift, vec, out, part, counters);
  return cudaSuccess;
}

struct Args {
  int M, K, N, kb, qlo, qhi, fuse, fold, shift, vec;
  float rq;
  dim3 grid;
  int32_t* part;
  int* counters;
};

// Tiles: 32 x 128, 64 x 128 and 64 x 256 (bm x bn).
template <int BITS, bool SIGNED, typename XT>
cudaError_t by_rows(int bm, int bn, cudaStream_t st, const XT* x, const int8_t* wp,
                    float* scales, const Args& a, const Out& out) {
#define FUSED_LAUNCH(MI, NG)                                                             \
  launch_tile<MI, NG, BITS, SIGNED, XT>(a.grid, st, x, wp, scales, a.M, a.K, a.N, a.kb, \
                                        a.qlo, a.qhi, a.rq, a.fuse, a.fold, a.shift,     \
                                        a.vec, out,                                      \
                                        a.part, a.counters)
  if (bm == 32) return FUSED_LAUNCH(1, 1);
  return bn == 256 ? FUSED_LAUNCH(2, 2) : FUSED_LAUNCH(2, 1);
#undef FUSED_LAUNCH
}

template <typename XT>
cudaError_t by_bits(int bits, bool sgn, int bm, int bn, cudaStream_t st, const XT* x,
                    const int8_t* wp, float* scales, const Args& a, const Out& out) {
  if (bits == 8)
    return sgn ? by_rows<8, true>(bm, bn, st, x, wp, scales, a, out)
               : by_rows<8, false>(bm, bn, st, x, wp, scales, a, out);
  if (bits == 4)
    return sgn ? by_rows<4, true>(bm, bn, st, x, wp, scales, a, out)
               : by_rows<4, false>(bm, bn, st, x, wp, scales, a, out);
  return sgn ? by_rows<2, true>(bm, bn, st, x, wp, scales, a, out)
             : by_rows<2, false>(bm, bn, st, x, wp, scales, a, out);
}

template <typename XT>
int run(const XT* x, const int8_t* wp, int M, int K, int N, int bits, int a_bits,
        int act_signed, int w_plane_lo, int bm, int bn, int kb, int ksplit, float* scales,
        int scales_ready, Out out, int32_t* part, int* counters, cudaStream_t st) {
  const int shift = 2 * w_plane_lo;
  if ((bits != 2 && bits != 4 && bits != 8) || a_bits < 2 || a_bits > 8 || shift < 0 ||
      shift >= bits || (bm != 32 && bm != 64) || (bn != 128 && bn != 256) ||
      (bn == 256 && bm != 64) || ksplit < 1 || kb < 1 ||
      kb % kKT || (long long)kb * ksplit < K || (long long)kb * (ksplit - 1) >= K ||
      (ksplit > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  const bool sgn = act_signed != 0;
  Args a;
  a.M = M; a.K = K; a.N = N; a.kb = kb; a.shift = shift;
  a.qhi = sgn ? (1 << (a_bits - 1)) - 1 : (1 << a_bits) - 1;
  a.qlo = sgn ? -(1 << (a_bits - 1)) : 0;
  a.part = part;
  a.counters = counters;
  a.grid = dim3((N + bn - 1) / bn, ksplit, (M + bm - 1) / bm);
  const int xbytes = (int)sizeof(XT);
  a.vec = (((long long)K * xbytes) % 16 == 0 && (uintptr_t)x % 16 == 0 ? 1 : 0) |
          (N % 16 == 0 && (uintptr_t)wp % 16 == 0 ? 2 : 0);
  a.rq = 1.0f / (float)a.qhi;
  a.fuse = !scales_ready && M <= kFuseRows;
  a.fold = ksplit > 1 && M > kFuseRows;
  if (!scales_ready && !a.fuse) row_scale_kernel<XT><<<M, 256, 0, st>>>(x, K, a.rq, scales);
  const cudaError_t e = by_bits<XT>(bits, sgn, bm, bn, st, x, wp, scales, a, out);
  if (e != cudaSuccess) return (int)e;
  if (a.fold) splitk::launch_fold(part, ksplit, M, N, out, scales, st);
  return (int)cudaGetLastError();
}

template <typename... A>
int run_x(const void* x, int x_dtype, A... rest) {
  if (x_dtype == 0) return run<float>(static_cast<const float*>(x), rest...);
  if (x_dtype == 1) return run<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), rest...);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (M, K) float32 (x_dtype 0) or bfloat16 (1); wp (K*bits/8, N) int8
// packed codes; scales (M,) float32 out; acc (M, N) int32 out. The plan
// (kernels/fused_matmul.py::plan): bm x bn tiles (32 x 128, 64 x 128 or
// 64 x 256), kb K codes per slice (a multiple of 64), ksplit slices; with
// ksplit > 1, part is (ksplit, M, N) int32 scratch and counters holds one
// zeroed int per output tile ((N / bn) (M / bm), rounded up), left zeroed.
// Returns the CUDA error code of the launches (0 = launched).
extern "C" int fused_quantize_matmul(const void* x, int x_dtype, const int8_t* wp, int M,
                                     int K, int N, int bits, int a_bits, int act_signed,
                                     int w_plane_lo, int bm, int bn, int kb, int ksplit,
                                     float* scales, int32_t* acc, int32_t* part,
                                     int* counters, void* stream) {
  Out out{};
  out.mode = 0;
  out.acc = acc;
  out.vec = (N % 4 == 0 && (uintptr_t)acc % 16 == 0) ? 1 : 0;
  return run_x(x, x_dtype, wp, M, K, N, bits, a_bits, act_signed, w_plane_lo, bm, bn, kb,
               ksplit, scales, 0, out, part, counters, (cudaStream_t)stream);
}

// The dequant form: y (row stride ldy, float32 for y_dtype 0, bfloat16
// for 1) gets (float(acc) * scales[m]) * (wscale[n] * 4^w_plane_lo) at
// columns 0 .. N-1. With scales_ready the rows' scales are read from
// `scales` (a previous call on the same x and activation precision),
// else computed into it. Other arguments as above.
extern "C" int fused_dequant_matmul(const void* x, int x_dtype, const int8_t* wp, int M,
                                    int K, int N, int bits, int a_bits, int act_signed,
                                    int w_plane_lo, int bm, int bn, int kb, int ksplit,
                                    float* scales,
                                    int scales_ready, const float* wscale, void* y,
                                    int y_dtype, int ldy, int32_t* part, int* counters,
                                    void* stream) {
  if ((y_dtype != 0 && y_dtype != 1) || ldy < N || w_plane_lo < 0 || w_plane_lo > 3)
    return (int)cudaErrorInvalidValue;
  Out out{};
  out.mode = 1 + y_dtype;
  out.y = y;
  out.ldy = ldy;
  out.wscale = wscale;
  out.wmul = (float)(1 << (2 * w_plane_lo));
  const int align = y_dtype == 0 ? 4 : 8;
  out.vec = (ldy % align == 0 && (uintptr_t)y % 16 == 0) ? 1 : 0;
  return run_x(x, x_dtype, wp, M, K, N, bits, a_bits, act_signed, w_plane_lo, bm, bn, kb,
               ksplit, scales, scales_ready, out, part, counters, (cudaStream_t)stream);
}
