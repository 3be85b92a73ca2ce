// Exact integer matmul of int8 activation codes by packed weight codes,
// for Hopper's int8 tensor cores.
//
// Replaces repro/kernels/bitplane_matmul.py::bitplane_matmul
// (_bitplane_matmul_kernel): (M, K) activation codes times (K, N) weight
// codes give the exact (M, N) int32 product. The TPU kernel splits the
// activations into 2-bit offset-binary planes, runs one MXU pass per
// plane and subtracts offset * colsum(W); the sum it builds is x @ W, and
// the int8 mma computes that product directly, so no plane, offset or
// colsum exists here: odd a_bits need no partial top plane, and zero
// padding (codes past M, K or N) contributes exact zeros. The weights
// arrive as PackedWeight bytes (2/4/8 bits, little-endian along K; w_bits
// = 8 is the (K, N) codes themselves) and are unpacked in registers on
// their way into the mma's B fragments, so the low-bit group of a Table
// III layer is never unpacked in device memory. w_plane_lo is an
// arithmetic shift of each unpacked weight code before it enters the
// product, the TPU kernel's "shift before the colsum correction".
// Unsigned activation codes may arrive wrapped (an 8-bit 255 is stored as
// int8 -1): their A fragments are masked to a_bits and read as u8.
//
// Bound on the H100: at prefill (M = 1280) the 2 M K N operations bound it
// (1 979 TOP/s int8); at decode the K N bits/8 packed weight bytes do.
// Design: `mma.sync.m16n8k32` s8/u8 x s8 -> s32 on 128-column blocks of
// 32, 64 or 128 rows (8 warps, 2 along M x 4 along N; a warp owns a
// 16*MI x 32 tile), K walked in 128-code tiles through a 3-stage cp.async
// ring. The activation tile feeds ldmatrix; the packed tile stays packed
// in shared memory. A warp's four n8 tiles interleave their columns
// (tile j, column g is column 4 g + j of the warp's 32), so a lane's B
// fragments for all four tiles come from one 32-bit word (4 columns) per
// packed row: bits/2 loads per 4 K codes, then a sign-extending field
// extraction and a 4 x 4 byte transpose (__byte_perm). The grid and the
// K split come from the caller's plan (kernels/bitplane_matmul.py::plan).
//
// Two output forms share that mainloop. The int32 entry (the JAX
// signature) stores the accumulator: one K slice stores every element, a
// split adds slices with integer atomics into a zeroed output. The
// dequant entry, the Table III path's, stores
//     y = out_dtype((float(acc) * xs[m]) * ws[n])
// into a strided output at a column offset, so a leaf's two filter
// groups write [y8, yl] with no concatenation, cast or product around
// them (split_store.cuh, shared with fused_matmul.cu): a split writes
// int32 partial tiles, summed in slice order before the dequant by the
// last block of a tile to arrive (M <= 8) or by a fold launch. Integer
// addition is exact and associative, so any plan gives the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "split_store.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps: 2 along M x 4 along N
constexpr int kBN = 128;        // output columns per block
constexpr int kKT = 128;        // K codes per shared tile (one 128-byte row of x)
constexpr int kStages = 3;

template <int MI, int BITS>
struct Smem {
  int8_t a[kStages][32 * MI][kKT];             // activation codes, rows x K
  int8_t b[kStages][kKT * BITS / 8][kBN];      // packed weight bytes, K rows x N
};

// XOR swizzles by 16-byte chunk. x rows are 8 chunks: chunk c of row r at
// c ^ (r & 7), so ldmatrix's 8 rows hit 8 bank groups. Packed rows are 8
// chunks: chunk c of packed row p at c ^ (2 ((p / RPQ) & 3)), so the four
// K quads a warp's lanes read at once (p / RPQ = t mod 4) sit in
// different bank groups.
template <int MI, int BITS>
__device__ __forceinline__ int8_t* a_at(Smem<MI, BITS>& s, int st, int r, int c) {
  return &s.a[st][r][(c ^ (r & 7)) << 4];
}
template <int MI, int BITS>
__device__ __forceinline__ int8_t* b_at(Smem<MI, BITS>& s, int st, int p, int c) {
  constexpr int RPQ = BITS / 2;
  return &s.b[st][p][(c ^ (((p / RPQ) & 3) << 1)) << 4];
}

// One 16-byte chunk from global memory into shared memory: cp.async when
// the operands are 16-byte aligned (`vec`), else byte loads, `n` valid
// bytes (0..16) and zeros after them.
__device__ __forceinline__ void load16(int8_t* dst, const int8_t* src, int n, bool vec) {
  if (vec) {
    mma::cp16(dst, n > 0 ? src : nullptr, n > 0);
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) dst[j] = j < n ? src[j] : (int8_t)0;
  }
}

// 4 bytes of sign-extended codes of width b held in the low b bits of each
// byte of x (the bits above masked off): byte | (sign bit * (2^(9-b) - 2)),
// which fills bits b..7 without a carry across bytes (mult = 0 for b = 8).
__device__ __forceinline__ uint32_t sext4(uint32_t x, uint32_t sign, uint32_t mult) {
  return x | ((x & sign) * mult);
}

// The dequant entry's store (split_store.cuh): y from the int32 tile and
// the rows' scales xs; a K split's partial tiles in part, its tiles'
// counters, and fold: a fold launch sums the split (above kLastBlockRows
// rows), else the last block of each tile does.
struct Deq {
  splitk::Out out;
  const float* xs;
  int32_t* part;
  int* counters;
  int fold;
};

// The int32 entry (DEQ false) and the dequant entry (DEQ true) share the
// mainloop; only the store differs.
template <int MI, int BITS, bool SIGNED, bool DEQ>
__device__ __forceinline__ void imma_body(const int8_t* __restrict__ x,
                                          const int8_t* __restrict__ wp, int M, int K, int N,
                                          int kb, uint32_t amask4, int shift, int vec,
                                          int32_t* __restrict__ acc, const Deq& dq) {
  constexpr int BM = 32 * MI;
  constexpr int RPQ = BITS / 2;    // packed rows per quad of K codes
  constexpr int EPB = 8 / BITS;    // codes per byte
  constexpr int PR = kKT * BITS / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  Smem<MI, BITS>& s = *reinterpret_cast<Smem<MI, BITS>*>(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.z * BM;
  const int ks0 = blockIdx.y * kb, ks1 = min(K, ks0 + kb);
  const int nk = (ks1 - ks0 + kKT - 1) / kKT;
  const int kp_rows = K * BITS / 8;
  const bool v = vec != 0;

  auto load = [&](int st, int kt) {
    const int k0 = ks0 + kt * kKT;
#pragma unroll
    for (int i = 0; i < BM * (kKT / 16) / kThreads; ++i) {
      const int idx = tid + i * kThreads, r = idx >> 3, c = idx & 7;
      const int gm = m0 + r, gk = k0 + 16 * c;
      const int n = gm < M ? max(0, min(16, K - gk)) : 0;
      load16(a_at(s, st, r, c), x + (size_t)gm * K + gk, n, v);
    }
#pragma unroll
    for (int i = 0; i < PR * (kBN / 16) / kThreads; ++i) {
      const int idx = tid + i * kThreads, p = idx >> 3, c = idx & 7;
      const int gp = k0 * BITS / 8 + p, gn = n0 + 16 * c;
      const int n = gp < kp_rows ? max(0, min(16, N - gn)) : 0;
      load16(b_at(s, st, p, c), wp + (size_t)gp * N + gn, n, v);
    }
  };

  int d[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[i][j][e] = 0;

  // Field extraction: width b = BITS - shift (the planes kept).
  const int b = BITS - shift;
  const uint32_t fmask = ((1u << b) - 1u) * 0x01010101u;
  const uint32_t fsign = (1u << (b - 1)) * 0x01010101u;
  const uint32_t fmult = (1u << (9 - b)) - 2u;
  const bool active = m0 + wm * 16 * MI < M;   // warp-uniform: rows past M skip the mma

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load(st, st);
    mma::cp_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();   // tile kt has landed; the stage refilled below is free
    const int nxt = kt + kStages - 1;
    if (nxt < nk) load(nxt % kStages, nxt);
    mma::cp_commit();
    if (!active) continue;
    const int st = kt % kStages;
#pragma unroll
    for (int ks = 0; ks < kKT / 32; ++ks) {     // k32 steps
      uint32_t bf[4][2];                        // [n8 tile][k half]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = ks * 8 + 4 * h + t;       // K quad of this lane's fragment
        uint32_t W[RPQ];
#pragma unroll
        for (int r = 0; r < RPQ; ++r)
          W[r] = *reinterpret_cast<const uint32_t*>(
              b_at(s, st, q * RPQ + r, wn * 2 + (g >> 2)) + 4 * (g & 3));
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
        mma::ldm_x4(a, a_at(s, st, wm * 16 * MI + i * 16 + (lane & 15), ks * 2 + (lane >> 4)));
        if (!SIGNED) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] &= amask4;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) mma::mma16832<SIGNED>(d[i][j], a, bf[j][0], bf[j][1]);
      }
    }
  }
  // Lane (g, t) holds, for each m16 tile, rows g and g + 8 at the 8
  // consecutive columns 8 t .. 8 t + 7 of the warp's 32: tile j's C column
  // 2t (+1) is column 8 t + j (+4).
  const bool split = gridDim.y > 1;
  const int c0 = n0 + wn * 32 + 8 * t;
  if constexpr (DEQ) {
    if (active) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm * 16 * MI + i * 16 + g + 8 * h;
          if (row >= M) continue;
          int o[8];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            o[j] = d[i][j][2 * h];
            o[4 + j] = d[i][j][2 * h + 1];
          }
          if (!split) splitk::store8(dq.out, N, row, c0, o, dq.xs[row]);
          else splitk::store_part8(dq.part, blockIdx.y, M, N, row, c0, o);
        }
    }
    if (!split || dq.fold) return;
    // The ring is free once every thread is past the mainloop (the first
    // barrier in last_block_store): its first int holds the flag.
    const float* xs = dq.xs + m0;
    splitk::last_block_store<kBN, kThreads>(dq.out, dq.part, dq.counters,
                                            reinterpret_cast<int*>(smem), M, N, m0,
                                            min(BM, M - m0), n0,
                                            [&](int r) { return xs[r]; });
    return;
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 16 * MI + i * 16 + g + 8 * h;
      if (row >= M) continue;
      int o[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[j] = d[i][j][2 * h];
        o[4 + j] = d[i][j][2 * h + 1];
      }
      int32_t* dst = acc + (size_t)row * N + c0;
      if (!split && v && c0 + 8 <= N) {
        reinterpret_cast<int4*>(dst)[0] = make_int4(o[0], o[1], o[2], o[3]);
        reinterpret_cast<int4*>(dst)[1] = make_int4(o[4], o[5], o[6], o[7]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (c0 + e < N) {
            if (split) atomicAdd(dst + e, o[e]);
            else dst[e] = o[e];
          }
      }
    }
}

template <int MI, int BITS, bool SIGNED>
__global__ void __launch_bounds__(kThreads)
imma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wp, int M, int K,
            int N, int kb, uint32_t amask4, int shift, int vec, int32_t* __restrict__ acc) {
  imma_body<MI, BITS, SIGNED, false>(x, wp, M, K, N, kb, amask4, shift, vec, acc, Deq{});
}

// Signed activation codes and every weight plane only.
template <int MI, int BITS>
__global__ void __launch_bounds__(kThreads)
imma_dequant_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wp, int M,
                    int K, int N, int kb, int vec, Deq dq) {
  imma_body<MI, BITS, true, true>(x, wp, M, K, N, kb, 0u, 0, vec, nullptr, dq);
}

// The launch arguments both entries share.
struct Args {
  const int8_t* x;
  const int8_t* wp;
  int M, K, N, kb, shift, vec;
  uint32_t amask4;
  dim3 grid;
};

// Shared memory above 48 KB must be asked for, kernel by kernel.
template <typename F>
cudaError_t allow_smem(F kern, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int MI, int BITS, bool SIGNED, bool DEQ>
cudaError_t launch_imma(const Args& a, cudaStream_t st, int32_t* acc, const Deq& dq) {
  constexpr int bytes = (int)sizeof(Smem<MI, BITS>);
  cudaError_t e;
  if constexpr (DEQ) {
    static_assert(SIGNED, "the dequant entry takes signed codes");
    auto kern = imma_dequant_kernel<MI, BITS>;
    if ((e = allow_smem(kern, bytes)) != cudaSuccess) return e;
    kern<<<a.grid, kThreads, bytes, st>>>(a.x, a.wp, a.M, a.K, a.N, a.kb, a.vec, dq);
  } else {
    auto kern = imma_kernel<MI, BITS, SIGNED>;
    if ((e = allow_smem(kern, bytes)) != cudaSuccess) return e;
    kern<<<a.grid, kThreads, bytes, st>>>(a.x, a.wp, a.M, a.K, a.N, a.kb, a.amask4, a.shift,
                                          a.vec, acc);
  }
  return cudaSuccess;
}

template <int BITS, bool SIGNED, bool DEQ>
cudaError_t imma_mi(int bm, const Args& a, cudaStream_t st, int32_t* acc, const Deq& dq) {
  if (bm == 32) return launch_imma<1, BITS, SIGNED, DEQ>(a, st, acc, dq);
  if (bm == 64) return launch_imma<2, BITS, SIGNED, DEQ>(a, st, acc, dq);
  return launch_imma<4, BITS, SIGNED, DEQ>(a, st, acc, dq);
}

template <bool SIGNED, bool DEQ>
cudaError_t imma_bits(int bits, int bm, const Args& a, cudaStream_t st, int32_t* acc,
                      const Deq& dq) {
  if (bits == 8) return imma_mi<8, SIGNED, DEQ>(bm, a, st, acc, dq);
  if (bits == 4) return imma_mi<4, SIGNED, DEQ>(bm, a, st, acc, dq);
  return imma_mi<2, SIGNED, DEQ>(bm, a, st, acc, dq);
}

// The plan's and the precision's checks (both entries), and the launch
// arguments; vec from the operands' alignment.
bool make_args(const int8_t* x, const int8_t* wp, int M, int K, int N, int bits, int a_bits,
               int shift, int bm, int kb, int ksplit, Args& a) {
  if ((bits != 2 && bits != 4 && bits != 8) || a_bits < 2 || a_bits > 8 || shift < 0 ||
      shift >= bits || (bm != 32 && bm != 64 && bm != 128) || ksplit < 1 || kb < 1 ||
      kb % kKT || (long long)kb * ksplit < K || (long long)kb * (ksplit - 1) >= K)
    return false;
  a.x = x;
  a.wp = wp;
  a.M = M; a.K = K; a.N = N; a.kb = kb; a.shift = shift;
  a.grid = dim3((N + kBN - 1) / kBN, ksplit, (M + bm - 1) / bm);
  a.vec = (K % 16 == 0 && N % 16 == 0 && (uintptr_t)x % 16 == 0 &&
           (uintptr_t)wp % 16 == 0) ? 1 : 0;
  a.amask4 = (uint32_t)((1 << a_bits) - 1) * 0x01010101u;
  return true;
}

}  // namespace

// x (M, K) int8 activation codes; wp (K*bits/8, N) int8 packed weight
// codes; acc (M, N) int32, zero-filled by the caller when ksplit > 1.
// The plan (kernels/bitplane_matmul.py::plan): bm rows per block (32, 64
// or 128), kb K codes per slice (a multiple of 128), ksplit slices.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int bitplane_matmul(const int8_t* x, const int8_t* wp, int M, int K, int N,
                               int bits, int a_bits, int act_signed, int w_plane_lo,
                               int bm, int kb, int ksplit, int32_t* acc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  Args a;
  if (!make_args(x, wp, M, K, N, bits, a_bits, 2 * w_plane_lo, bm, kb, ksplit, a))
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)acc % 16) a.vec = 0;
  const cudaError_t e = act_signed ? imma_bits<true, false>(bits, bm, a, st, acc, Deq{})
                                   : imma_bits<false, false>(bits, bm, a, st, acc, Deq{});
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The dequant form: y (row stride ldy, float32 for y_dtype 0, bfloat16
// for 1) gets (float(acc) * xs[m]) * wscale[n] at columns 0 .. N-1, acc
// the exact product above of signed activation codes (all weight
// planes), xs (M,) the rows' scales (quantize_rows), wscale (N,) the
// columns'. With ksplit > 1, part is (ksplit, M, N) int32 scratch and
// counters holds one zeroed int per output tile (ceil(N / 128) ceil(M /
// bm)), left zeroed. Returns the CUDA error code of the launches (0 =
// launched).
extern "C" int bitplane_dequant_matmul(const int8_t* x, const int8_t* wp, int M, int K, int N,
                                       int bits, int a_bits, int bm, int kb,
                                       int ksplit, const float* xs, const float* wscale,
                                       void* y, int y_dtype, int ldy, int32_t* part,
                                       int* counters, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Args a;
  if (!make_args(x, wp, M, K, N, bits, a_bits, 0, bm, kb, ksplit, a) ||
      (y_dtype != 0 && y_dtype != 1) || ldy < N || xs == nullptr || wscale == nullptr ||
      y == nullptr || (ksplit > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  Deq dq{};
  dq.out.mode = 1 + y_dtype;
  dq.out.y = y;
  dq.out.ldy = ldy;
  dq.out.wscale = wscale;
  dq.out.wmul = 1.0f;
  dq.out.vec = (ldy % (y_dtype == 0 ? 4 : 8) == 0 && (uintptr_t)y % 16 == 0) ? 1 : 0;
  dq.xs = xs;
  dq.part = part;
  dq.counters = counters;
  dq.fold = ksplit > 1 && M > splitk::kLastBlockRows;
  const cudaError_t e = imma_bits<true, true>(bits, bm, a, st, nullptr, dq);
  if (e != cudaSuccess) return (int)e;
  if (dq.fold) splitk::launch_fold(part, ksplit, M, N, dq.out, xs, st);
  return (int)cudaGetLastError();
}
