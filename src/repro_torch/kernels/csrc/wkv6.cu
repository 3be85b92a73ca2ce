// RWKV-6 (Finch) chunked recurrence for Hopper, spread over chunks.
//
// Replaces repro/kernels/wkv6.py::wkv6 (_wkv6_kernel), with the state
// carried in and out as repro/models/rwkv6.py::wkv6_chunked carries it:
// per head, S (K x V) and, for each token t,
//     o_t = r_t (S + diag(u) k_t v_t^T),   S <- diag(w_t) S + k_t v_t^T,
// computed chunk by chunk (chunk boundaries at absolute positions 0, C,
// 2C, ...). Per chunk, with lw = log(max(w, 1e-12)), L its inclusive
// prefix over the chunk and Lsh = L - lw:
//     o      = (r e^Lsh) S_c + P v,
//     P[t,s] = sum_k r[t,k] k[s,k] e^(Lsh[t,k] - L[s,k])  (s < t),
//     P[t,t] = sum_k r[t,k] u[k] k[t,k],
//     S_c+1  = e^L_last S_c + U_c,   U_c = (k e^(L_last - L))^T v.
//
// Three launches for a prompt (T > 1):
//   wkv6_state_kernel, a block per (chunk, head, row): each chunk's decay
//     D_c = e^L_last and increment U_c, into a scratch buffer;
//   wkv6_pass_kernel, a thread per (row, head, state element): S_0 = the
//     carried state, S_c+1 = D_c S_c + U_c in chunk order (5 steps at T =
//     320), each S_c stored in place of U_c and the last as the new
//     state. Its order is the row's own chunks and nothing else;
//   wkv6_out_kernel, a block per (chunk, head, row): the chunk's outputs
//     from S_c, which it loads while it stages the chunk.
// The chunks of a prompt run in parallel in the first and the last.
// A decode step (T = 1) is one launch of wkv6_step_kernel: one block per
// (row, head, 16 state columns), the carried state read and written once.
//
// Inside a chunk, log-decays are summed per 16-token sub-chunk J: a
// forward sum gives each row's exclusive prefix inside J (Lsh_t - L_b,
// b = 16 J - 1 the row before J) and J's total, a backward sum each row's
// suffix inside J (L_b' - L_s, b' = J's last row), and the totals give
// the offsets of the sub-chunks (L_b) and the sums after them. No
// exponent is the difference of two long prefixes (at a decay of 1e-6 a
// chunk's prefix reaches -884, where float32's spacing is 6e-5), and
// every exponent is <= 0, so nothing overflows. For s in a sub-chunk
// before t's, e^(Lsh_t - L_s) = e^(Lsh_t - L_b) e^(L_b - L_s): the r rows
// are scaled once per token, the k rows once per boundary (chained from
// one boundary to the next in place), and those P blocks are plain dot
// products. Only the 16 x 16 diagonal blocks keep one exp per (t, s, k),
// with the exponent summed from t down to s.
//
// Shared memory holds (rows x 64) tiles at a row stride of 68 floats: a
// warp reads them along k (lanes on consecutive k) or as float4 along a
// row with lanes on consecutive rows, 8 lanes of a quarter-warp on 8
// distinct bank groups, never with lanes strided by K. Outputs and the
// state increment are 4 x 4 register tiles of f32 FMAs (no TF32).
//
// Pad tokens (k = 0, w = 1: lw = 0) add exact zeros to every sum, rows
// past T are staged as pad tokens, and every loop bound is the chunk
// length, never T: a prompt's outputs and final state are bitwise those
// of the same prompt padded to any longer length. A row never reads
// another row.
//
// Bound on the H100: at the prefill shape (B = 4, T = 320, H = 40, K = V
// = 64, bf16 r/k/v, f32 w) it reads r, k, v, w and the state once and
// writes out and the state once, ~38 MB (11 us at 3.35 TB/s), against
// ~1.1 G float32 operations of the recurrence (16 us at 67 TFLOP/s
// outside the tensor cores); the chunked form's pairwise products add
// about as much again. A decode step moves the state twice, ~5.2 MB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "wkv6_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDim = 64;           // K, V and the chunk length the kernel takes
constexpr int kSub = 16;              // sub-chunk length
constexpr int kSeg = kMaxDim / kSub;  // sub-chunks of a chunk
constexpr int kStr = kMaxDim + 4;     // row stride (floats) of a staged tile
constexpr int kTile = kMaxDim * kStr; // floats of a staged tile

using namespace wkv6_common;

// Rows [0, C4) of chunk c: r (if R), k, v and lw; rows past T are pad
// tokens (zeros, lw = 0). A thread issues all its loads (4 elements
// each) before it stores any, so they are in flight together.
template <typename T>
__device__ void stage(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ w, const Dims& d,
                      int b, int h, int c0, int n, int C4, float* R, float* Kb, float* Vb,
                      float* Lw) {
  constexpr int kIt = kMaxDim * kMaxDim / 4 / kThreads;
  const int nk4 = d.K / 4, nv4 = d.V / 4;
  float rv[kIt][4], kv[kIt][4], wv[kIt][4], vv[kIt][4];
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int i = threadIdx.x + it * kThreads, t = i / nk4, kk = 4 * (i % nk4);
    const int tv = i / nv4, v0 = 4 * (i % nv4);
#pragma unroll
    for (int e = 0; e < 4; ++e) rv[it][e] = kv[it][e] = vv[it][e] = 0.f, wv[it][e] = 1.f;
    if (i < C4 * nk4 && t < n) {
      const long off = tok(d, b, c0 + t, h) * d.K + kk;
      if (R) ldg4(r + off, rv[it]);
      ldg4(k + off, kv[it]);
      ldg4(w + off, wv[it]);
    }
    if (i < C4 * nv4 && tv < n) ldg4(v + tok(d, b, c0 + tv, h) * d.V + v0, vv[it]);
  }
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int i = threadIdx.x + it * kThreads, t = i / nk4, kk = 4 * (i % nk4);
    const int tv = i / nv4, v0 = 4 * (i % nv4);
    if (i < C4 * nk4) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (R) R[t * kStr + kk + e] = rv[it][e];
        Kb[t * kStr + kk + e] = kv[it][e];
        Lw[t * kStr + kk + e] = logf(fmaxf(wv[it][e], 1e-12f));
      }
    }
    if (i < C4 * nv4) {
#pragma unroll
      for (int e = 0; e < 4; ++e) Vb[tv * kStr + v0 + e] = vv[it][e];
    }
  }
}

// One thread per (k, sub-chunk J), over J's rows: tot[J][k] = the sum of
// lw in token order; R (if given) *= e^(exclusive prefix inside J); then
// Lw := the sum of lw after each row inside J (backward). Then the
// threads k < K sum the totals: off[J] before J (off[kSeg] = L_last) and
// suf[J] after J. Sub-chunks past C4 have total 0.
__device__ void prefixes(float* Lw, float* R, float* tot, float* off, float* suf, int K,
                         int C4) {
  for (int i = threadIdx.x; i < kSeg * kMaxDim; i += kThreads) {
    const int kk = i % kMaxDim, J = i / kMaxDim;
    if (kk >= K) continue;
    const int t0 = J * kSub, t1 = min(t0 + kSub, C4);
    float run = 0.f;
    for (int t = t0; t < t1; ++t) {
      const float x = Lw[t * kStr + kk];
      if (R) R[t * kStr + kk] = __fmul_rn(R[t * kStr + kk], e0(run));
      run = __fadd_rn(run, x);
    }
    tot[J * kMaxDim + kk] = run;
    run = 0.f;
    for (int t = t1 - 1; t >= t0; --t) {
      const float x = Lw[t * kStr + kk];
      Lw[t * kStr + kk] = run;
      run = __fadd_rn(run, x);
    }
  }
  __syncthreads();
  if (threadIdx.x < K) {
    const int kk = threadIdx.x;
    float o = 0.f;
    for (int J = 0; J < kSeg; ++J) {
      off[J * kMaxDim + kk] = o;
      o = __fadd_rn(o, tot[J * kMaxDim + kk]);
    }
    off[kSeg * kMaxDim + kk] = o;
    float s = 0.f;
    for (int J = kSeg - 1; J >= 0; --J) {
      suf[J * kMaxDim + kk] = s;
      s = __fadd_rn(s, tot[J * kMaxDim + kk]);
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ w, Dims d, float* __restrict__ Dc,
                  float* __restrict__ Uc) {
  extern __shared__ float sm[];
  float* Kb = sm;
  float* Vb = Kb + kTile;
  float* Lw = Vb + kTile;
  float* tot = Lw + kTile;               // kSeg x 64
  float* off = tot + kSeg * kMaxDim;     // (kSeg + 1) x 64
  float* suf = off + (kSeg + 1) * kMaxDim;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int c0 = c * d.C, n = min(d.C, d.Tn - c0), C4 = (d.C + 3) & ~3;
  const long bhc = ((long)b * d.H + h) * d.nc + c;

  stage<T>(nullptr, k, v, w, d, b, h, c0, n, C4, nullptr, Kb, Vb, Lw);
  __syncthreads();
  prefixes(Lw, nullptr, tot, off, suf, d.K, C4);
  if (tid < d.K) Dc[bhc * d.K + tid] = expf(off[kSeg * kMaxDim + tid]);
  // k e^(L_last - L_s) = k e^(suffix inside J(s)) e^(sum after J(s)).
  for (int i = tid; i < C4 * d.K; i += kThreads) {
    const int t = i / d.K, kk = i % d.K;
    Kb[t * kStr + kk] = __fmul_rn(__fmul_rn(Kb[t * kStr + kk], e0(Lw[t * kStr + kk])),
                                  e0(suf[(t / kSub) * kMaxDim + kk]));
  }
  __syncthreads();

  // U = khat^T v, a 4 x 4 tile of (k, v) per thread.
  const int nvb = d.V / 4;
  for (int tile = tid; tile < (d.K / 4) * nvb; tile += kThreads) {
    const int k0 = 4 * (tile / nvb), v0 = 4 * (tile % nvb);
    float acc[4][4] = {};
    for (int s = 0; s < C4; ++s) {
      const float4 a = *reinterpret_cast<const float4*>(Kb + s * kStr + k0);
      const float4 x = *reinterpret_cast<const float4*>(Vb + s * kStr + v0);
      const float av[4] = {a.x, a.y, a.z, a.w}, xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(Uc + (bhc * d.K + k0 + i) * d.V + v0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_out_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ w, const float* __restrict__ u,
                const float* __restrict__ Sc, Dims d, float* __restrict__ out) {
  extern __shared__ float sm[];
  float* R = sm;                         // r, then r e^(Lsh - L_b), then r e^Lsh
  float* Kb = R + kTile;                 // k, then k e^(L_b - L); then S_c
  float* Vb = Kb + kTile;
  float* Lw = Vb + kTile;                // lw, then the suffix sums inside a sub-chunk
  float* P = Lw + kTile;                 // P[t][s]
  float* tot = P + kTile;
  float* off = tot + kSeg * kMaxDim;
  float* suf = off + (kSeg + 1) * kMaxDim;
  float* us = suf + kSeg * kMaxDim;
  float* S = Kb;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = c * d.C, n = min(d.C, d.Tn - c0), C4 = (d.C + 3) & ~3;
  const int K = d.K, V = d.V;
  const long bh = (long)b * d.H + h;

  // The state entering this chunk (wkv6_pass_kernel), loaded while the
  // chunk is staged and stored once the k tile is free.
  constexpr int kEl = kMaxDim * kMaxDim / kThreads;
  float sv[kEl];
#pragma unroll
  for (int m = 0; m < kEl; ++m) {
    const int i = tid + m * kThreads;
    sv[m] = i < K * V ? Sc[(bh * d.nc + c) * K * V + i] : 0.f;
  }
  stage<T>(r, k, v, w, d, b, h, c0, n, C4, R, Kb, Vb, Lw);
  for (int i = tid; i < K; i += kThreads) us[i] = u[h * K + i];
  __syncthreads();

  // Diagonal blocks: a half-warp per row t (rows t and t + 1 share a
  // warp), a lane per 4 consecutive k, the exponent summed from t - 1
  // down to s; P[t][s] = 0 for s > t inside the sub-chunk.
  const int hl = lane & 15, k4 = 4 * hl;
  for (int t2 = warp; 2 * t2 < C4; t2 += kThreads / 32) {
    const int t = 2 * t2 + (lane >> 4), j0 = t - t % kSub, j1 = min(j0 + kSub, C4);
    float rt[4] = {}, uk[4] = {}, acc[4] = {};
    if (k4 < K) {
#pragma unroll
      for (int e = 0; e < 4; ++e) rt[e] = R[t * kStr + k4 + e], uk[e] = us[k4 + e];
    }
    for (int dd = 0; dd <= 2 * t2 + 1 - j0; ++dd) {   // warp-uniform: the odd row's count
      const int s = t - dd;
      float p = 0.f;
      if (s >= j0 && k4 < K) {
        const float4 kq = *reinterpret_cast<const float4*>(Kb + s * kStr + k4);
        const float ks[4] = {kq.x, kq.y, kq.z, kq.w};
        if (dd == 0) {
#pragma unroll
          for (int e = 0; e < 4; ++e) p = fmaf(__fmul_rn(rt[e], uk[e]), ks[e], p);
        } else {
          const float4 lq = *reinterpret_cast<const float4*>(Lw + s * kStr + k4);
          const float ls[4] = {lq.x, lq.y, lq.z, lq.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p = fmaf(__fmul_rn(rt[e], ks[e]), e0(acc[e]), p);
            acc[e] = __fadd_rn(acc[e], ls[e]);
          }
        }
      }
      for (int o = 8; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
      if (hl == 0 && s >= j0) P[t * kStr + s] = p;
    }
    for (int s = t + 1 + hl; s < j1; s += 16) P[t * kStr + s] = 0.f;
  }
  __syncthreads();

  prefixes(Lw, R, tot, off, suf, K, C4);   // R := r e^(Lsh - L_b), Lw := suffixes

  // Earlier sub-chunks: for t in J, s < 16 J, P[t][s] = R[t] . k_s e^(L_b - L_s),
  // b = 16 J - 1; the k rows are rescaled from one boundary to the next.
  for (int J = 1; J * kSub < C4; ++J) {
    const int prev = (J - 1) * kSub, j0 = J * kSub, j1 = min(j0 + kSub, C4);
    for (int i = tid; i < j0 * K; i += kThreads) {
      const int s = i / K, kk = i % K;
      const float f = s >= prev ? e0(Lw[s * kStr + kk]) : e0(tot[(J - 1) * kMaxDim + kk]);
      Kb[s * kStr + kk] = __fmul_rn(Kb[s * kStr + kk], f);
    }
    __syncthreads();
    for (int i = tid; i < (j1 - j0) * j0; i += kThreads) {
      const int t = j0 + i / j0, s = i % j0;
      float p[4] = {};                          // four independent chains
      for (int kk = 0; kk < K; kk += 4) {
        const float4 a = *reinterpret_cast<const float4*>(R + t * kStr + kk);
        const float4 x = *reinterpret_cast<const float4*>(Kb + s * kStr + kk);
        p[0] = fmaf(a.x, x.x, p[0]);
        p[1] = fmaf(a.y, x.y, p[1]);
        p[2] = fmaf(a.z, x.z, p[2]);
        p[3] = fmaf(a.w, x.w, p[3]);
      }
      P[t * kStr + s] = (p[0] + p[1]) + (p[2] + p[3]);
    }
    __syncthreads();
  }

  // r e^Lsh = (r e^(Lsh - L_b)) e^(L_b) for rows past the first sub-chunk.
  for (int i = tid; i < C4 * K; i += kThreads) {
    const int t = i / K, kk = i % K;
    if (t >= kSub)
      R[t * kStr + kk] = __fmul_rn(R[t * kStr + kk], e0(off[(t / kSub) * kMaxDim + kk]));
  }
#pragma unroll
  for (int m = 0; m < kEl; ++m) {
    const int i = tid + m * kThreads;
    if (i < K * V) S[(i / V) * kStr + i % V] = sv[m];
  }
  __syncthreads();

  // o = (r e^Lsh) S + P v, a 4 x 4 tile of (t, v) per thread; P v runs
  // over s up to the tile's last row (P is 0 above the diagonal).
  const int nvb = V / 4;
  for (int tile = tid; tile < (C4 / 4) * nvb; tile += kThreads) {
    const int t0 = 4 * (tile / nvb), v0 = 4 * (tile % nvb);
    float acc[4][4] = {};
    for (int kk = 0; kk < K; kk += 4) {
      float a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 q = *reinterpret_cast<const float4*>(R + (t0 + i) * kStr + kk);
        a[i][0] = q.x; a[i][1] = q.y; a[i][2] = q.z; a[i][3] = q.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(S + (kk + j) * kStr + v0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(a[i][j], x.x, acc[i][0]);
          acc[i][1] = fmaf(a[i][j], x.y, acc[i][1]);
          acc[i][2] = fmaf(a[i][j], x.z, acc[i][2]);
          acc[i][3] = fmaf(a[i][j], x.w, acc[i][3]);
        }
      }
    }
    for (int s0 = 0; s0 < t0 + 4; s0 += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 q = *reinterpret_cast<const float4*>(P + (t0 + i) * kStr + s0);
        p[i][0] = q.x; p[i][1] = q.y; p[i][2] = q.z; p[i][3] = q.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(Vb + (s0 + j) * kStr + v0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(p[i][j], x.x, acc[i][0]);
          acc[i][1] = fmaf(p[i][j], x.y, acc[i][1]);
          acc[i][2] = fmaf(p[i][j], x.z, acc[i][2]);
          acc[i][3] = fmaf(p[i][j], x.w, acc[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (t0 + i < n)
        *reinterpret_cast<float4*>(out + tok(d, b, c0 + t0 + i, h) * V + v0) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// The state pass: per (row, head), S_0 = the carried state and S_c+1 =
// D_c S_c + U_c in chunk order, a thread per state element. S_c replaces
// U_c in place (the state entering chunk c, which wkv6_out_kernel reads);
// the last is the new state.
__global__ void __launch_bounds__(kThreads)
wkv6_pass_kernel(const float* __restrict__ state_in, const float* __restrict__ Dc,
                 float* __restrict__ USc, Dims d, float* __restrict__ state_out) {
  const long bh = blockIdx.x;
  const int KV = d.K * d.V, i = blockIdx.y * kThreads + threadIdx.x, kk = i / d.V;
  if (i >= KV) return;
  float s = state_in[bh * KV + i];
  for (int c0 = 0; c0 < d.nc; c0 += 4) {       // 4 chunks' loads in flight
    float uc[4], dc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long bhc = bh * d.nc + c0 + j;
      uc[j] = c0 + j < d.nc ? USc[bhc * KV + i] : 0.f;
      dc[j] = c0 + j < d.nc ? Dc[bhc * d.K + kk] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c0 + j >= d.nc) break;
      USc[(bh * d.nc + c0 + j) * KV + i] = s;
      s = fmaf(dc[j], s, uc[j]);
    }
  }
  state_out[bh * KV + i] = s;
}

// One token with the carried state: o = r (S + diag(u) k v^T), S <- diag(w) S + k v^T.
// A block per (row, head, 16 state columns); a thread owns one column and
// every 16th k, loads its state elements together, and the 16 partial
// outputs of a column are summed in a fixed order. The row's r, k, w, u
// and v are staged once per block.
constexpr int kStepV = 16;                    // state columns per block
template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_step_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ w, const float* __restrict__ u,
                 const float* __restrict__ state_in, int H, int K, int V,
                 float* __restrict__ out, float* __restrict__ state_out) {
  constexpr int kG = kThreads / kStepV;         // k groups
  constexpr int kPer = kMaxDim / kG;            // k values per thread
  __shared__ float rs[kMaxDim], ks[kMaxDim], ws[kMaxDim], us[kMaxDim];
  __shared__ float part[kG][kStepV];
  const int bh = blockIdx.x, h = bh % H, tid = threadIdx.x;
  const int vv = blockIdx.y * kStepV + tid % kStepV, g = tid / kStepV;
  float sv[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int kk = g + kG * m;
    sv[m] = (vv < V && kk < K) ? state_in[((long)bh * K + kk) * V + vv] : 0.f;
  }
  if (tid < K) {
    rs[tid] = to_f(r[(long)bh * K + tid]);
    ks[tid] = to_f(k[(long)bh * K + tid]);
    ws[tid] = w[(long)bh * K + tid];
    us[tid] = u[h * K + tid];
  }
  const float vt = vv < V ? to_f(v[(long)bh * V + vv]) : 0.f;
  __syncthreads();
  float o = 0.f;
  if (vv < V) {
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int kk = g + kG * m;
      if (kk >= K) continue;
      const float kv = __fmul_rn(ks[kk], vt);
      o = fmaf(rs[kk], fmaf(us[kk], kv, sv[m]), o);
      state_out[((long)bh * K + kk) * V + vv] = fmaf(ws[kk], sv[m], kv);
    }
  }
  part[g][tid % kStepV] = o;
  __syncthreads();
  if (g == 0 && vv < V) {
    float acc = part[0][tid];
    for (int j = 1; j < kG; ++j) acc += part[j][tid];
    out[(long)bh * V + vv] = acc;
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w, const float* u,
           const float* state_in, float* out, float* state_out, float* scratch, int B,
           int Tn, int H, int K, int V, int C, cudaStream_t st) {
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  if (Tn == 1) {
    const dim3 grid(B * H, (V + kStepV - 1) / kStepV);
    wkv6_step_kernel<T><<<grid, kThreads, 0, st>>>(rt, kt, vt, w, u, state_in, H, K, V, out,
                                                   state_out);
    return (int)cudaGetLastError();
  }
  Dims d{B, Tn, H, K, V, C, (Tn + C - 1) / C};
  float* Dc = scratch;
  float* Uc = scratch + (size_t)B * H * d.nc * K;
  const size_t small = sizeof(float) * kMaxDim * (3 * kSeg + 1);
  const size_t smem_state = sizeof(float) * 3 * kTile + small;
  const size_t smem_out = sizeof(float) * 5 * kTile + small + sizeof(float) * kMaxDim;
  auto ks = wkv6_state_kernel<T>;
  auto ko = wkv6_out_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(ks, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_state);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ko, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_out);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(d.nc, H, B);
  ks<<<grid, kThreads, smem_state, st>>>(kt, vt, w, d, Dc, Uc);
  wkv6_pass_kernel<<<dim3(B * H, (K * V + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      state_in, Dc, Uc, d, state_out);
  ko<<<grid, kThreads, smem_out, st>>>(rt, kt, vt, w, u, Uc, d, out);
  return (int)cudaGetLastError();
}

}  // namespace

// r/k (B, T, H, K) and v (B, T, H, V) in `dtype` (0 = float32, 1 =
// bfloat16); w (B, T, H, K), u (H, K), state_in/state_out (B, H, K, V)
// and out (B, T, H, V) float32; all contiguous. K and V are multiples of
// 4 in 4..64, chunk in 1..64. scratch: B H ceil(T / chunk) (K + K V)
// float32 (unused at T = 1). Returns the CUDA error code of the launches.
extern "C" int wkv6(const void* r, const void* k, const void* v, const float* w,
                    const float* u, const float* state_in, float* out, float* state_out,
                    float* scratch, int B, int T, int H, int K, int V, int chunk, int dtype,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (K < 4 || K > kMaxDim || K % 4 || V < 4 || V > kMaxDim || V % 4 || chunk < 1 ||
      chunk > kMaxDim || B < 0 || T < 0 || H < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  if (T == 0)
    return (int)cudaMemcpyAsync(state_out, state_in, sizeof(float) * B * H * K * V,
                                cudaMemcpyDeviceToDevice, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, state_in, out, state_out, scratch, B, T, H,
                                 K, V, chunk, st);
  return launch<float>(r, k, v, w, u, state_in, out, state_out, scratch, B, T, H, K, V,
                       chunk, st);
}
