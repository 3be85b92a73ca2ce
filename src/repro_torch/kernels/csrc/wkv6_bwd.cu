// The gradient of the RWKV-6 chunked recurrence (csrc/wkv6.cu) for Hopper.
//
// Replaces no Pallas kernel: the JAX package differentiates its chunked
// jnp form (repro/models/rwkv6.py::wkv6_chunked) with XLA's autodiff, and
// the Pallas wkv6 kernel has no VJP. Per chunk c of a head, with lw =
// log(max(w, 1e-12)), Lsh_t the sum of lw before t in the chunk, L_last its
// total, the gate e^(Lsh_t - L_s) of s < t, A[t,s] = dout_t . v_s and G the
// gradient of the state after the chunk (S_c+1):
//   dr_t  = e^Lsh_t (S_c dout_t) + sum_s<t A[t,s] k_s gate + A[t,t] u k_t
//   dk_s  = sum_t>s A[t,s] r_t gate + e^(L_last - L_s) (G v_s) + A[s,s] u r_s
//   dv_s  = sum_t>s P[t,s] dout_t + P[s,s] dout_s + (k_s e^(L_last - L_s)) G
//   du   += sum_t A[t,t] r_t k_t
//   dS_c  = e^L_last G + sum_t (r_t e^Lsh_t) dout_t^T
// (P the forward's intra-chunk matrix). d(lw)_j sums only the terms whose
// exponent spans position j: G . (e^L_last S_c) rowwise, k_s (the state part
// of dk_s) for s < j, r_t (the two gated parts of dr_t) for t > j, minus k_s
// (the gated part of dk_s) for s >= j. dw = d(lw) / w where w > 1e-12, else
// 0 (JAX's clamp); a pad gets nothing.
//
// Four launches, in a fixed order (no atomics: two calls give the same
// bits, and a row's gradients never depend on its batch):
//   wkv6_bwd_state_kernel, a block per (head, chunk, row): W_c = sum_t (r_t
//     e^Lsh_t) dout_t^T and D_c = e^L_last into scratch;
//   wkv6_bwd_pass_kernel, a thread per (row, head, state element): G from
//     dstate_out (or 0), then for c from the last chunk down, G_c+1 stored in
//     place of W_c and G = D_c G + W_c; the last G is dstate_in. The chunks
//     are walked in reverse from the chunk-start states the forward already
//     stored (wkv6_pass_kernel's S_c), so nothing of the forward runs again;
//   wkv6_bwd_chunk_kernel, a block per (head, chunk, row): dr, dk, dv, dw
//     and the chunk's du partial from S_c and G_c+1;
//   wkv6_bwd_du_kernel, a thread per (head, k): du summed over rows, then
//     chunks.
//
// The chunk kernel factors the gates as the forward does, through
// sub-chunk boundaries. A chunk is 64 rows (pads past its length: zeros,
// lw = 0) in eight 8-row sub-chunks J; a thread owns (J, k) and keeps its
// rows of r, k and lw in registers. For t in Jt and s in an earlier Js,
// gate(t, s) = e^(p_t) F(Js, Jt) e^(q_s): p_t the sum of lw before t
// inside Jt, q_s after s inside Js, F the totals of the sub-chunks between
// them. So with R̂ = r e^p and K̂ = k e^q (one exp a row), dr's sum over
// earlier sub-chunks is e^(p_t) (A_off K̂) and dk's over later ones e^(q_s)
// (A_offᵀ R̂), each a plain product a thread runs over its rows with F
// chained Horner-wise from one sub-chunk to the next (one exp a
// sub-chunk); P's off-diagonal blocks are R̂ F K̂ᵀ and dv's P part Pᵀ dout.
// Only the 8 x 8 diagonal blocks walk s from t - 1 down with the exponent
// summed over s < j < t: one exp per (t, s, k) feeds dk's, dr's and P's
// terms (28 a thread, ~14 k a block, against ~258 k for an exp per gate
// in a row walk and a column walk over the whole chunk). P's diagonal
// block: each lane holds a row's 8 products and a reduce-scatter over the
// warp's 32 k (9 shuffles a row, a fixed tree) sums them; the two warps of
// a sub-chunk add their halves when P is assembled. Every exponent is a
// sum of lw <= 0 and none is the difference of two long prefixes (at a
// decay of 1e-6 a chunk's prefix reaches -884, where float32's spacing is
// 6e-5). The d(lw) prefix and suffix sums run per (J, k) over the thread's
// rows, then across the sub-chunks' totals: every warp takes part.
// Products are float32 FMAs (no tensor cores): dw and du are held to 1e-4
// of max |g| even where r, k, v are bf16.
//
// Why 8 rows: a thread's rows of r, k and lw stay in registers from the
// first phase to the last, beside two or three row-wide sums. At 16 rows
// (the forward's sub-chunk, 256 threads, two blocks an SM) that did not fit
// in 128 registers: ptxas spilled ~1.4 KB a thread, and the chunk kernel
// took 1.39-1.55 ms at the training shape below on an H100. At 8 rows a
// block is 512 threads, one an SM (16 warps), with room for every
// phase's sums.
//
// Bound on the H100 at rwkv6-3b's training shape (B = 8, T = 512, H = 40,
// K = V = 64, chunk 64, bf16 r/k/v): it reads r, k, v, w, dout and the
// chunk-start states once and writes dr, dk, dv, dw and dstate_in, ~0.40 GB
// (0.12 ms at 3.35 TB/s), against ~10 G float32 operations of the products
// above (0.15 ms at 67 TFLOP/s): operations. The chunk block stages six 64
// x 68 float32 tiles, reused across its phases (dout^T, v^T then R̂, S_c
// then K̂, G_c+1, A, A^T then Pᵀ); both gated sums run in one phase, so
// every thread walks 56 rows of the other sub-chunks whatever its J.
//
// Shared memory: tiles at a row stride of 68 floats. A warp reads a row
// segment as broadcast float4s, or one float (or float4) a lane from
// consecutive rows (k, or v), never with lanes strided by a multiple of 8
// rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "wkv6_common.cuh"

namespace {

using namespace wkv6_common;

constexpr int kThreads = 512;
constexpr int kMaxDim = 64;              // K, V and the chunk length the kernel takes
constexpr int kSub = 8;                  // sub-chunk rows
constexpr int kSeg = kMaxDim / kSub;     // sub-chunks of a chunk
constexpr int kPairs = kSeg * (kSeg - 1) / 2;   // (Js < Jt) sub-chunk pairs
constexpr int kStr = kMaxDim + 4;        // row stride (floats) of a staged tile
constexpr int kTile = kMaxDim * kStr;
constexpr int kPassThreads = 256;
constexpr int kInFlight = 8;             // the pass kernel's chunks loaded together

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
// kSub consecutive floats of a shared row (a broadcast when the warp reads one row).
__device__ __forceinline__ void ld8(const float* p, float* x) {
#pragma unroll
  for (int q = 0; q < kSub / 4; ++q) {
    const float4 v = ld4(p + 4 * q);
    x[4 * q] = v.x; x[4 * q + 1] = v.y; x[4 * q + 2] = v.z; x[4 * q + 3] = v.w;
  }
}



// A chunk's 64 rows of a (B, T, H, D) tensor, transposed into dst[j][t]
// (rows past n zero): a lane reads 4 consecutive elements of row t, lanes
// on consecutive t, so the four stores hit consecutive banks.
template <typename T>
__device__ void stage_t(const T* __restrict__ src, const Dims& d, int D, int b, int h, int c0,
                        int n, float* dst) {
  for (int i = threadIdx.x; i < kMaxDim * (D / 4); i += kThreads) {
    const int t = i % kMaxDim, j = 4 * (i / kMaxDim);
    float e[4] = {0.f, 0.f, 0.f, 0.f};
    if (t < n) ldg4(src + tok(d, b, c0 + t, h) * D + j, e);
#pragma unroll
    for (int m = 0; m < 4; ++m) dst[(j + m) * kStr + t] = e[m];
  }
}

// A (K x V) state block (row-major, contiguous) into a kStr-strided tile.
__device__ void stage_state(const float* __restrict__ src, int K, int V, float* dst) {
  const int nv = V / 4;
  for (int i = threadIdx.x; i < K * nv; i += kThreads) {
    const int kk = i / nv, v = 4 * (i % nv);
    *reinterpret_cast<float4*>(dst + kk * kStr + v) =
        __ldg(reinterpret_cast<const float4*>(src + kk * V + v));
  }
}

// A thread's kSub rows of r (if R), k (if Kp) and lw = log(max(w, 1e-12))
// at channel kk; pad rows and channels past K: 0, lw 0.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ r, const T* __restrict__ k,
                                          const float* __restrict__ w, const Dims& d, int b,
                                          int h, int c0, int n, int j0, int kk, float* R,
                                          float* Kp, float* lw) {
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const bool ok = kk < d.K && j0 + i < n;
    const long at = tok(d, b, c0 + j0 + i, h) * d.K + kk;
    if (R) R[i] = ok ? to_f(r[at]) : 0.f;
    if (Kp) Kp[i] = ok ? to_f(k[at]) : 0.f;
    lw[i] = ok ? logf(fmaxf(w[at], 1e-12f)) : 0.f;
  }
}

// W_c = sum_t (r_t e^Lsh_t) dout_t^T (K x V) and D_c = e^L_last (K). A
// thread per (sub-chunk, k) scales its rows (e^Lsh = e^(p_t + the totals
// before its sub-chunk)); then a 4 x 4 (k, v) register tile per thread
// over one half of the rows, the second half's tile added to the first's
// (a fixed order). Three blocks an SM, so one's loads overlap another's
// products.
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
wkv6_bwd_state_kernel(const T* __restrict__ r, const float* __restrict__ dout,
                      const float* __restrict__ w, Dims d, float* __restrict__ Wc,
                      float* __restrict__ Dc) {
  extern __shared__ float sm[];
  float* RF = sm;                 // r e^Lsh, [t][k]
  float* O = RF + kTile;          // dout, [t][v]
  float* tot = O + kTile;         // [J][k]
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int J = tid / kMaxDim, kk = tid % kMaxDim, j0 = J * kSub;
  const int c0 = c * d.C, n = min(d.C, d.Tn - c0);
  const long bhc = ((long)b * d.H + h) * d.nc + c;
  float rv[kSub], lw[kSub];
  load_rows<T>(r, nullptr, w, d, b, h, c0, n, j0, kk, rv, nullptr, lw);
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < kSub; ++i) run = __fadd_rn(run, lw[i]);
  tot[J * kMaxDim + kk] = run;
  const int nv = d.V / 4;
  for (int i = tid; i < kMaxDim * nv; i += kThreads) {
    const int t = i / nv, v = 4 * (i % nv);
    *reinterpret_cast<float4*>(O + t * kStr + v) =
        t < n ? __ldg(reinterpret_cast<const float4*>(dout + tok(d, b, c0 + t, h) * d.V + v))
              : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  run = 0.f;
  for (int q = 0; q < J; ++q) run = __fadd_rn(run, tot[q * kMaxDim + kk]);
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    RF[(j0 + i) * kStr + kk] = __fmul_rn(rv[i], e0(run));
    run = __fadd_rn(run, lw[i]);
  }
  if (J == kSeg - 1 && kk < d.K) Dc[bhc * d.K + kk] = e0(run);
  __syncthreads();
  const int half = tid / 256, k0 = 4 * ((tid % 256) / 16), v0 = 4 * (tid % 16);
  const bool ok = k0 < d.K && v0 < d.V;
  float acc[4][4] = {};
  for (int t = half * kMaxDim / 2; t < min(n, (half + 1) * kMaxDim / 2); ++t) {
    const float4 a = ld4(RF + t * kStr + k0), x = ld4(O + t * kStr + v0);
    const float av[4] = {a.x, a.y, a.z, a.w}, xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
  }
  __syncthreads();                             // RF read: the second half's tiles take it
  if (half == 1)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(RF + (k0 + i) * kStr + v0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  if (half == 1 || !ok) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 y = ld4(RF + (k0 + i) * kStr + v0);
    *reinterpret_cast<float4*>(Wc + (bhc * d.K + k0 + i) * d.V + v0) =
        make_float4(__fadd_rn(acc[i][0], y.x), __fadd_rn(acc[i][1], y.y),
                    __fadd_rn(acc[i][2], y.z), __fadd_rn(acc[i][3], y.w));
  }
}

// The reverse pass over the chunks: G_c+1 replaces W_c in place, the last
// G is dstate_in. Its order is the row's own chunks and nothing else; the
// loads of kInFlight chunks are in flight together.
__global__ void __launch_bounds__(kPassThreads)
wkv6_bwd_pass_kernel(const float* __restrict__ dstate_out, const float* __restrict__ Dc,
                     float* __restrict__ WGc, Dims d, float* __restrict__ dstate_in) {
  const long bh = blockIdx.x;
  const int KV = d.K * d.V, i = blockIdx.y * kPassThreads + threadIdx.x, kk = i / d.V;
  if (i >= KV) return;
  float g = dstate_out ? dstate_out[bh * KV + i] : 0.f;
  for (int c1 = d.nc; c1 > 0; c1 -= kInFlight) {
    float wc[kInFlight], dc[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int c = c1 - 1 - j;
      wc[j] = c >= 0 ? WGc[(bh * d.nc + c) * KV + i] : 0.f;
      dc[j] = c >= 0 ? Dc[(bh * d.nc + c) * d.K + kk] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int c = c1 - 1 - j;
      if (c < 0) break;
      WGc[(bh * d.nc + c) * KV + i] = g;
      g = __fadd_rn(__fmul_rn(dc[j], g), wc[j]);
    }
  }
  dstate_in[bh * KV + i] = g;
}

// The sum over a warp's 32 lanes of each of 8 values, by a reduce-scatter
// (9 shuffles, a fixed tree): lane l ends with the sum of value (l >> 2) & 7.
__device__ __forceinline__ float reduce_scatter8(const float* p) {
  const int lane = threadIdx.x & 31;
  float v4[4], v2[2];
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float send = h16 ? p[m] : p[m + 4], keep = h16 ? p[m + 4] : p[m];
    v4[m] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 16));
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const float send = h8 ? v4[m] : v4[m + 2], keep = h8 ? v4[m + 2] : v4[m];
    v2[m] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 8));
  }
  float v1 = __fadd_rn(h4 ? v2[1] : v2[0], __shfl_xor_sync(0xffffffffu, h4 ? v2[0] : v2[1], 4));
  v1 = __fadd_rn(v1, __shfl_xor_sync(0xffffffffu, v1, 2));
  return __fadd_rn(v1, __shfl_xor_sync(0xffffffffu, v1, 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
wkv6_bwd_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ w, const float* __restrict__ u,
                      const float* __restrict__ Sc, const float* __restrict__ Gc,
                      const float* __restrict__ dout, Dims d, T* __restrict__ dr,
                      T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dw,
                      float* __restrict__ du_part) {
  extern __shared__ float sm[];
  float* OT = sm;                 // dout^T [v][t]
  float* VT = OT + kTile;         // v^T [v][s], then R̂ = r e^p [t][k]
  float* S = VT + kTile;          // S_c [k][v], then K̂ = k e^q [s][k]
  float* G = S + kTile;           // G_c+1 [k][v]
  float* A = G + kTile;           // A [t][s]
  float* AT = A + kTile;          // A^T [s][t], then P^T [s][t]
  float* tot = AT + kTile;        // [J][k]: each sub-chunk's sum of lw
  float* tkst = tot + kSeg * kMaxDim;    // [J][k]: sums of k (state part of dk)
  float* ty = tkst + kSeg * kMaxDim;     // [J][k]: sums of r gated - k gated
  float* duj = ty + kSeg * kMaxDim;      // [J][k]: du partials
  float* Hs = duj + kSeg * kMaxDim;      // [J][k]: e^(totals after J)
  float* Ft = Hs + kSeg * kMaxDim;       // [pair][k]: F(Js, Jt), pair Jt (Jt - 1) / 2 + Js
  float* Pd = Ft + kPairs * kMaxDim;     // [J][warp half][t][s]: P's diagonal partials
  float* us = Pd + kSeg * 2 * kSub * kSub;   // u of this head
  float* c0s = us + kMaxDim;             // G . (e^L_last S_c) per k
  float* RH = VT;
  float* KH = S;
  float* PT = AT;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int J = warp >> 1, kk = (warp & 1) * 32 + lane, j0 = J * kSub;
  const int c0 = c * d.C, n = min(d.C, d.Tn - c0);
  const int K = d.K, V = d.V;
  const long bhc = ((long)b * d.H + h) * d.nc + c;
  const bool active = kk < K;
  const long row0 = tok(d, b, c0 + j0, h) * K + kk, rstep = (long)d.H * K;
  const int nrows = active ? max(0, min(kSub, n - j0)) : 0;

  // -- stage: a thread's rows in registers, dout^T, v^T, S_c, G_c+1 in tiles.
  float rv[kSub], kv[kSub], lw[kSub];
  load_rows<T>(r, k, w, d, b, h, c0, n, j0, kk, rv, kv, lw);
  {
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < kSub; ++i) run = __fadd_rn(run, lw[i]);
    tot[J * kMaxDim + kk] = run;
  }
  stage_t<float>(dout, d, V, b, h, c0, n, OT);
  stage_t<T>(v, d, V, b, h, c0, n, VT);
  stage_state(Sc + bhc * K * V, K, V, S);
  stage_state(Gc + bhc * K * V, K, V, G);
  if (tid < kMaxDim) us[tid] = tid < K ? u[h * K + tid] : 0.f;
  __syncthreads();

  // -- A = dout v^T (a 2 x 4 (t, s) tile a thread; a warp covers 4 t-tiles
  //    x 8 s-tiles) into A and A^T; the exponent tables.
  {
    const int t0 = 2 * ((warp >> 1) * 4 + (lane >> 3)), s0 = 4 * ((warp & 1) * 8 + (lane & 7));
    float acc[2][4] = {};
    for (int vv = 0; vv < V; ++vv) {
      const float2 a = ld2(OT + vv * kStr + t0);
      const float4 x = ld4(VT + vv * kStr + s0);
      const float av[2] = {a.x, a.y}, xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float4*>(A + (t0 + i) * kStr + s0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float2*>(AT + (s0 + j) * kStr + t0) = make_float2(acc[0][j], acc[1][j]);
  }
  float off = 0.f, suf = 0.f, last = 0.f;     // the totals before J, after J, all
  for (int q = 0; q < kSeg; ++q) {
    const float x = tot[q * kMaxDim + kk];
    if (q < J) off = __fadd_rn(off, x);
    if (q > J) suf = __fadd_rn(suf, x);
    last = __fadd_rn(last, x);
  }
  Hs[J * kMaxDim + kk] = e0(suf);
  for (int Js = 0; Js < J; ++Js) {            // F(Js, J): the totals strictly between
    float x = 0.f;
    for (int q = Js + 1; q < J; ++q) x = __fadd_rn(x, tot[q * kMaxDim + kk]);
    Ft[(J * (J - 1) / 2 + Js) * kMaxDim + kk] = e0(x);
  }
  if (J == 0) {
    float s = 0.f;
    if (active)
      for (int vv = 0; vv < V; vv += 4) {
        const float4 g = ld4(G + kk * kStr + vv), x = ld4(S + kk * kStr + vv);
        s = fmaf(g.x, x.x, s); s = fmaf(g.y, x.y, s);
        s = fmaf(g.z, x.z, s); s = fmaf(g.w, x.w, s);
      }
    c0s[kk] = __fmul_rn(e0(last), s);
  }
  __syncthreads();

  // -- The state parts: dks_s = e^(q_s + totals after J) (G v_s) and
  //    dr1_t = e^(p_t + totals before J) (S_c dout_t); du.
  float dks[kSub], drg[kSub];
  {
#pragma unroll
    for (int i = 0; i < kSub; ++i) dks[i] = drg[i] = 0.f;
    if (active)
      for (int vv = 0; vv < V; vv += 4) {
        const float4 g4 = ld4(G + kk * kStr + vv), s4 = ld4(S + kk * kStr + vv);
        const float gv[4] = {g4.x, g4.y, g4.z, g4.w}, sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          float x[kSub], o[kSub];
          ld8(VT + (vv + m) * kStr + j0, x);
          ld8(OT + (vv + m) * kStr + j0, o);
#pragma unroll
          for (int i = 0; i < kSub; ++i) {
            dks[i] = fmaf(x[i], gv[m], dks[i]);
            drg[i] = fmaf(o[i], sv[m], drg[i]);
          }
        }
      }
    float q = suf, p = off, kst = 0.f, dus = 0.f;
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int ir = kSub - 1 - i;
      dks[ir] = __fmul_rn(dks[ir], e0(q));
      q = __fadd_rn(q, lw[ir]);
      drg[i] = __fmul_rn(drg[i], e0(p));
      p = __fadd_rn(p, lw[i]);
    }
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      kst = fmaf(kv[i], dks[i], kst);
      dus = fmaf(__fmul_rn(A[(j0 + i) * kStr + j0 + i], rv[i]), kv[i], dus);
    }
    tkst[J * kMaxDim + kk] = kst;
    duj[J * kMaxDim + kk] = dus;
  }
  __syncthreads();                             // v^T and S_c read: R̂ and K̂ take them
  {
    float p = 0.f, q = 0.f;
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int ir = kSub - 1 - i;
      RH[(j0 + i) * kStr + kk] = __fmul_rn(rv[i], e0(p));
      p = __fadd_rn(p, lw[i]);
      KH[(j0 + ir) * kStr + kk] = __fmul_rn(kv[ir], e0(q));
      q = __fadd_rn(q, lw[ir]);
    }
  }
  __syncthreads();

  // -- The gated sums. dk from later sub-chunks, chained from the last
  //    down (acc = acc e^(tot_Jt) + sum_t in Jt A[t, s] R̂_t, then e^(q_s)
  //    acc); dr from earlier ones, chained from the first up (acc = acc
  //    e^(tot_Js) + sum_s in Js A[t, s] K̂_s, then e^(p_t) acc): 56 rows a
  //    thread between the two, whatever J.
  float dki[kSub];
  {
    float acc[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) dki[i] = acc[i] = 0.f;
    for (int Jt = kSeg - 1; Jt > J; --Jt) {
      const float f = e0(tot[Jt * kMaxDim + kk]);
#pragma unroll
      for (int i = 0; i < kSub; ++i) dki[i] = __fmul_rn(dki[i], f);
      for (int t = Jt * kSub; t < (Jt + 1) * kSub; ++t) {
        float a[kSub];
        ld8(A + t * kStr + j0, a);
        const float rh = RH[t * kStr + kk];
#pragma unroll
        for (int i = 0; i < kSub; ++i) dki[i] = fmaf(a[i], rh, dki[i]);
      }
    }
    for (int Js = 0; Js < J; ++Js) {
      const float f = e0(tot[Js * kMaxDim + kk]);
#pragma unroll
      for (int i = 0; i < kSub; ++i) acc[i] = __fmul_rn(acc[i], f);
      for (int s = Js * kSub; s < (Js + 1) * kSub; ++s) {
        float a[kSub];
        ld8(AT + s * kStr + j0, a);
        const float kh = KH[s * kStr + kk];
#pragma unroll
        for (int i = 0; i < kSub; ++i) acc[i] = fmaf(a[i], kh, acc[i]);
      }
    }
    float p = 0.f, q = 0.f;
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int ir = kSub - 1 - i;
      dki[ir] = __fmul_rn(dki[ir], e0(q));
      q = __fadd_rn(q, lw[ir]);
      drg[i] = fmaf(e0(p), acc[i], drg[i]);
      p = __fadd_rn(p, lw[i]);
    }
  }
  {
    // The diagonal block: row t, s from t - 1 down, the exponent summed
    // over s < j < t as it goes; dk's and dr's terms and P's from the same
    // gate. Row t's products over the warp's k are reduce-scattered (P[t][t]
    // = r u k).
    float* pd = Pd + ((J * 2 + (warp & 1)) * kSub) * kSub;
    const float uk = us[kk];
#pragma unroll
    for (int it = 0; it < kSub; ++it) {
      float a[kSub], pv[kSub];
      ld8(A + (j0 + it) * kStr + j0, a);
      float e = 0.f, dri = 0.f;
#pragma unroll
      for (int is = 0; is < kSub; ++is) pv[is] = 0.f;
#pragma unroll
      for (int is = it - 1; is >= 0; --is) {
        const float g = e0(e);
        dki[is] = fmaf(__fmul_rn(a[is], rv[it]), g, dki[is]);
        dri = fmaf(__fmul_rn(a[is], kv[is]), g, dri);
        pv[is] = __fmul_rn(__fmul_rn(rv[it], kv[is]), g);
        e = __fadd_rn(e, lw[is]);
      }
      pv[it] = __fmul_rn(__fmul_rn(rv[it], uk), kv[it]);
      drg[it] = __fadd_rn(drg[it], dri);
      const float sum = reduce_scatter8(pv);
      if (!(lane & 3)) pd[it * kSub + ((lane >> 2) & 7)] = sum;
    }
    // dk and dr out. d(lw) of row j: minus k dk_gated at j and after it,
    // plus r dr_gated after it, plus k dks before it (the other sub-chunks'
    // sums and G . (e^L_last S_c) come after the barrier).
    float sk = 0.f, sr = 0.f, pre = 0.f;
#pragma unroll
    for (int i = kSub - 1; i >= 0; --i) {
      const float ad = A[(j0 + i) * kStr + j0 + i];
      if (i < nrows) {
        put(dk + row0 + i * rstep, fmaf(__fmul_rn(ad, uk), rv[i], __fadd_rn(dki[i], dks[i])));
        put(dr + row0 + i * rstep, fmaf(__fmul_rn(ad, uk), kv[i], drg[i]));
      }
      const float kin = __fmul_rn(kv[i], dki[i]);
      dki[i] = __fsub_rn(__fsub_rn(sr, sk), kin);     // dki: d(lw) from here on
      sk = __fadd_rn(sk, kin);
      sr = fmaf(rv[i], drg[i], sr);
    }
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      dki[i] = __fadd_rn(dki[i], pre);
      pre = fmaf(kv[i], dks[i], pre);
    }
    ty[J * kMaxDim + kk] = __fsub_rn(sr, sk);
  }
  __syncthreads();

  // -- d(lw) and dw: the sums of the other sub-chunks and G . (e^L_last S_c).
  {
    float base = c0s[kk];
    for (int q = 0; q < J; ++q) base = __fadd_rn(base, tkst[q * kMaxDim + kk]);
    for (int q = J + 1; q < kSeg; ++q) base = __fadd_rn(base, ty[q * kMaxDim + kk]);
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      if (i >= nrows) continue;
      const float wj = w[row0 + i * rstep];
      dw[row0 + i * rstep] = wj > 1e-12f ? __fdiv_rn(__fadd_rn(dki[i], base), wj) : 0.f;
    }
    if (J == 0 && active) {
      float s = 0.f;
      for (int q = 0; q < kSeg; ++q) s = __fadd_rn(s, duj[q * kMaxDim + kk]);
      du_part[bhc * K + kk] = s;
    }
  }

  // -- P^T [s][t] over A^T's tile: off-diagonal blocks R̂ F K̂^T (a 2 x 4
  //    (t, s) tile a thread over k, 8 a block pair), diagonal blocks the
  //    two warps' halves (0 above the diagonal).
  if (tid < kPairs * 8) {
    const int pair = tid / 8, e = tid % 8;
    int Jt = 1;
    while ((Jt + 1) * Jt / 2 <= pair) ++Jt;
    const int Js = pair - Jt * (Jt - 1) / 2;
    const int t0 = Jt * kSub + 2 * (e / 2), s0 = Js * kSub + 4 * (e % 2);
    const float* F = Ft + pair * kMaxDim;
    float acc[2][4] = {};
    for (int q = 0; q < K; q += 4) {
      const float4 f = ld4(F + q);
      float a[2][4], x[4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float4 y = ld4(RH + (t0 + i) * kStr + q);
        a[i][0] = __fmul_rn(y.x, f.x); a[i][1] = __fmul_rn(y.y, f.y);
        a[i][2] = __fmul_rn(y.z, f.z); a[i][3] = __fmul_rn(y.w, f.w);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 y = ld4(KH + (s0 + j) * kStr + q);
        x[j][0] = y.x; x[j][1] = y.y; x[j][2] = y.z; x[j][3] = y.w;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int m = 0; m < 4; ++m) acc[i][j] = fmaf(a[i][m], x[j][m], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float2*>(PT + (s0 + j) * kStr + t0) = make_float2(acc[0][j], acc[1][j]);
  } else {
    for (int e = tid - kPairs * 8; e < kSeg * kSub * kSub; e += kThreads - kPairs * 8) {
      const int Jd = e / (kSub * kSub), ts = e % (kSub * kSub), it = ts / kSub, is = ts % kSub;
      const float* pd = Pd + (Jd * 2 * kSub) * kSub;
      PT[(Jd * kSub + is) * kStr + Jd * kSub + it] =
          it >= is ? __fadd_rn(pd[it * kSub + is], pd[(kSub + it) * kSub + is]) : 0.f;
    }
  }
  __syncthreads();

  // -- dv_s = sum_t>=s P[t, s] dout_t + (K̂_s e^(totals after J(s))) G: a
  //    (2 s, 4 v) tile a thread, the v rows 16 apart (consecutive lanes on
  //    consecutive rows); the half-warps take s-tiles i and 31 - i.
  {
    const int st = (lane < 16) ? warp : 31 - warp, vt = lane & 15, s0 = 2 * st;
    float acc[2][4] = {};
    for (int t = s0 & ~3; t < kMaxDim; t += 4) {
      float p[2][4], o[4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float4 y = ld4(PT + (s0 + i) * kStr + t);
        p[i][0] = y.x; p[i][1] = y.y; p[i][2] = y.z; p[i][3] = y.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 y = ld4(OT + (vt + 16 * j) * kStr + t);
        o[j][0] = y.x; o[j][1] = y.y; o[j][2] = y.z; o[j][3] = y.w;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int m = 0; m < 4; ++m) acc[i][j] = fmaf(p[i][m], o[j][m], acc[i][j]);
    }
    const float* H4 = Hs + (s0 / kSub) * kMaxDim;
    for (int q = 0; q < K; q += 4) {
      const float4 hq = ld4(H4 + q);
      const float hv[4] = {hq.x, hq.y, hq.z, hq.w};
      float x[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float4 y = ld4(KH + (s0 + i) * kStr + q);
        x[i][0] = __fmul_rn(y.x, hv[0]); x[i][1] = __fmul_rn(y.y, hv[1]);
        x[i][2] = __fmul_rn(y.z, hv[2]); x[i][3] = __fmul_rn(y.w, hv[3]);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        float g[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) g[j] = G[(q + m) * kStr + vt + 16 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i][m], g[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int vv = vt + 16 * j;
        if (vv < V && s0 + i < n) put(dv + tok(d, b, c0 + s0 + i, h) * V + vv, acc[i][j]);
      }
  }
}

// du = sum over rows, then chunks, of the chunk kernel's partials.
__global__ void wkv6_bwd_du_kernel(const float* __restrict__ du_part, Dims d,
                                   float* __restrict__ du) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= d.H * d.K) return;
  const int h = i / d.K, kk = i % d.K;
  float s = 0.f;
  for (int b = 0; b < d.B; ++b)
    for (int c = 0; c < d.nc; ++c)
      s = __fadd_rn(s, du_part[(((long)b * d.H + h) * d.nc + c) * d.K + kk]);
  du[i] = s;
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w, const float* u,
           const float* states, const float* dout, const float* dso, void* dr, void* dk,
           void* dv, float* dw, float* du, float* dsi, float* scratch, int B, int Tn, int H,
           int K, int V, int C, cudaStream_t st) {
  Dims d{B, Tn, H, K, V, C, (Tn + C - 1) / C};
  float* WGc = scratch;                                  // B H nc K V
  float* Dc = WGc + (size_t)B * H * d.nc * K * V;        // B H nc K
  float* du_part = Dc + (size_t)B * H * d.nc * K;        // B H nc K
  const size_t smem_state = sizeof(float) * (2 * kTile + kSeg * kMaxDim);
  const size_t smem_chunk = sizeof(float) * (6 * kTile + 5 * kSeg * kMaxDim +
                                             kPairs * kMaxDim + 2 * kSeg * kSub * kSub +
                                             2 * kMaxDim);
  auto ks = wkv6_bwd_state_kernel<T>;
  auto kc = wkv6_bwd_chunk_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(ks, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_state);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_chunk);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  const dim3 grid(H, d.nc, B);    // neighbouring blocks: neighbouring heads of one row's tokens
  ks<<<grid, kThreads, smem_state, st>>>(static_cast<const T*>(r), dout, w, d, WGc, Dc);
  wkv6_bwd_pass_kernel<<<dim3(B * H, (K * V + kPassThreads - 1) / kPassThreads), kPassThreads,
                         0, st>>>(dso, Dc, WGc, d, dsi);
  kc<<<grid, kThreads, smem_chunk, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, u,
      states, WGc, dout, d, static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv), dw,
      du_part);
  wkv6_bwd_du_kernel<<<(H * K + 127) / 128, 128, 0, st>>>(du_part, d, du);
  return (int)cudaGetLastError();
}

}  // namespace

// r/k (B, T, H, K) and v (B, T, H, V) in `dtype` (0 = float32, 1 =
// bfloat16), as are the outputs dr, dk, dv; w (B, T, H, K), u (H, K),
// states (B, H, nc, K, V) (the state entering each chunk, nc = ceil(T /
// chunk)), dout (B, T, H, V) and dstate_out (B, H, K, V, or null: zero)
// float32; outputs dw (B, T, H, K), du (H, K) and dstate_in (B, H, K, V)
// float32; all contiguous, states, dout and dstate_out 16-byte aligned. K
// and V are multiples of 4 in 4..64, chunk in 1..64, T >= 1. scratch: B H
// nc (K V + 2 K) float32, 16-byte aligned. Returns the CUDA error code of
// the launches.
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v, const float* w,
                        const float* u, const float* states, const float* dout,
                        const float* dstate_out, void* dr, void* dk, void* dv, float* dw,
                        float* du, float* dstate_in, float* scratch, int B, int T, int H,
                        int K, int V, int chunk, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (K < 4 || K > kMaxDim || K % 4 || V < 4 || V > kMaxDim || V % 4 || chunk < 1 ||
      chunk > kMaxDim || B < 1 || T < 1 || H < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, states, dout, dstate_out, dr, dk, dv, dw, du,
                                 dstate_in, scratch, B, T, H, K, V, chunk, st);
  return launch<float>(r, k, v, w, u, states, dout, dstate_out, dr, dk, dv, dw, du, dstate_in,
                       scratch, B, T, H, K, V, chunk, st);
}
