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
// Four launches:
//   wkv6_bwd_state_kernel, a block per (chunk, head, row): W_c = sum_t (r_t
//     e^Lsh_t) dout_t^T and D_c = e^L_last into scratch;
//   wkv6_bwd_pass_kernel, a thread per (row, head, state element): G from
//     dstate_out (or 0), then for c from the last chunk down, G_c+1 stored in
//     place of W_c and G = D_c G + W_c; the last G is dstate_in. The chunks
//     are walked in reverse from the chunk-start states the forward already
//     stored (wkv6_pass_kernel's S_c), so nothing of the forward runs again;
//   wkv6_bwd_chunk_kernel, a block per (chunk, head, row): dr, dk, dv, dw
//     and the chunk's du partial from S_c and G_c+1;
//   wkv6_bwd_du_kernel, a thread per (head, k): du summed over rows, then
//     chunks, in that fixed order (no atomics: two calls give the same bits).
//
// Exponents: the gates are never the difference of two long prefixes (at a
// decay of 1e-6 a chunk's prefix reaches -884, where float32's spacing is
// 6e-5). In the chunk kernel a warp owns a row t (lanes on k) and walks s
// from t - 1 down, summing lw over s < j < t as it goes; another pass owns a
// column s and walks t up from s + 1. Every exponent is a sum of lw <= 0.
// One exp per (t, s, k) in each walk: a simple first design (the forward
// factors the off-diagonal blocks through sub-chunk boundaries instead).
//
// Bound on the H100 at rwkv6-3b's training shape (B = 8, T = 512, H = 40,
// K = V = 64, chunk 64, bf16 r/k/v): it reads r, k, v, w, dout and the
// chunk-start states once and writes dr, dk, dv, dw and dstate_in, ~0.40 GB
// (0.12 ms at 3.35 TB/s), against ~12 G float32 operations (two walks of
// C^2/2 K gates, six C^2 K products a chunk, 0.18 ms at 67 TFLOP/s).
//
// Shared memory: (rows x 64) tiles at a row stride of 68 floats (float4 rows,
// lanes on consecutive columns), S_c and G at a stride of 65 (read along k or
// along v with lanes on consecutive elements, no bank conflict).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDim = 64;              // K, V and the chunk length the kernel takes
constexpr int kStr = kMaxDim + 4;        // row stride (floats) of a staged tile
constexpr int kTile = kMaxDim * kStr;
constexpr int kSStr = kMaxDim + 1;       // row stride of S_c and G
constexpr int kSTile = kMaxDim * kSStr;
constexpr int kPassThreads = 256;

struct Dims {
  int B, Tn, H, K, V, C, nc;
};

__device__ __forceinline__ long tok(const Dims& d, int b, int t, int h) {
  return ((long)b * d.Tn + t) * d.H + h;
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Rows [0, C4) of chunk c0 / C of a (B, T, H, D) tensor into a tile; rows
// past n (past T, and a chunk's rounding to 4) are zero.
template <typename T>
__device__ void stage(const T* __restrict__ src, const Dims& d, int D, int b, int h, int c0,
                      int n, int C4, float* dst) {
  for (int i = threadIdx.x; i < C4 * D; i += kThreads) {
    const int t = i / D, j = i % D;
    dst[t * kStr + j] = t < n ? to_f(src[tok(d, b, c0 + t, h) * D + j]) : 0.f;
  }
}

// lw = log(max(w, 1e-12)); pad rows have w = 1, lw = 0.
__device__ void stage_lw(const float* __restrict__ w, const Dims& d, int b, int h, int c0, int n,
                         int C4, float* dst) {
  for (int i = threadIdx.x; i < C4 * d.K; i += kThreads) {
    const int t = i / d.K, j = i % d.K;
    dst[t * kStr + j] = t < n ? logf(fmaxf(w[tok(d, b, c0 + t, h) * d.K + j], 1e-12f)) : 0.f;
  }
}

// A (K x V) state block (row-major, contiguous) into a kSStr-strided tile.
__device__ void stage_state(const float* __restrict__ src, int K, int V, float* dst) {
  for (int i = threadIdx.x; i < K * V; i += kThreads) dst[(i / V) * kSStr + i % V] = src[i];
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// W_c = sum_t (r_t e^Lsh_t) dout_t^T (K x V) and D_c = e^L_last (K).
template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_bwd_state_kernel(const T* __restrict__ r, const float* __restrict__ dout,
                      const float* __restrict__ w, Dims d, float* __restrict__ Wc,
                      float* __restrict__ Dc) {
  extern __shared__ float sm[];
  float* R = sm;
  float* O = R + kTile;
  float* Lw = O + kTile;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int c0 = c * d.C, n = min(d.C, d.Tn - c0), C4 = (d.C + 3) & ~3;
  const long bhc = ((long)b * d.H + h) * d.nc + c;
  stage<T>(r, d, d.K, b, h, c0, n, C4, R);
  stage<float>(dout, d, d.V, b, h, c0, n, C4, O);
  stage_lw(w, d, b, h, c0, n, C4, Lw);
  __syncthreads();
  if (tid < d.K) {
    float run = 0.f;
    for (int t = 0; t < C4; ++t) {
      R[t * kStr + tid] = __fmul_rn(R[t * kStr + tid], expf(run));
      run = __fadd_rn(run, Lw[t * kStr + tid]);
    }
    Dc[bhc * d.K + tid] = expf(run);
  }
  __syncthreads();
  const int nvb = d.V / 4;
  for (int tile = tid; tile < (d.K / 4) * nvb; tile += kThreads) {
    const int k0 = 4 * (tile / nvb), v0 = 4 * (tile % nvb);
    float acc[4][4] = {};
    for (int t = 0; t < C4; ++t) {
      const float4 a = *reinterpret_cast<const float4*>(R + t * kStr + k0);
      const float4 x = *reinterpret_cast<const float4*>(O + t * kStr + v0);
      const float av[4] = {a.x, a.y, a.z, a.w}, xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(Wc + (bhc * d.K + k0 + i) * d.V + v0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// The reverse pass over the chunks: G_c+1 replaces W_c in place, the last
// G is dstate_in. Its order is the row's own chunks and nothing else.
__global__ void __launch_bounds__(kPassThreads)
wkv6_bwd_pass_kernel(const float* __restrict__ dstate_out, const float* __restrict__ Dc,
                     float* __restrict__ WGc, Dims d, float* __restrict__ dstate_in) {
  const long bh = blockIdx.x;
  const int KV = d.K * d.V, i = blockIdx.y * kPassThreads + threadIdx.x, kk = i / d.V;
  if (i >= KV) return;
  float g = dstate_out ? dstate_out[bh * KV + i] : 0.f;
  for (int c = d.nc - 1; c >= 0; --c) {
    const long at = (bh * d.nc + c) * KV + i;
    const float wc = WGc[at];
    WGc[at] = g;
    g = __fadd_rn(__fmul_rn(Dc[(bh * d.nc + c) * d.K + kk], g), wc);
  }
  dstate_in[bh * KV + i] = g;
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
  float* R = sm;                  // r
  float* Kt = R + kTile;          // k
  float* Vt = Kt + kTile;         // v
  float* O = Vt + kTile;          // dout
  float* Lw = O + kTile;          // lw
  float* A = Lw + kTile;          // A[t][s] = dout_t . v_s
  float* RY = A + kTile;          // r (gated parts of dr), then the sums after each row
  float* KIN = RY + kTile;        // k (gated part of dk)
  float* KST = KIN + kTile;       // k (state part of dk)
  float* S = KST + kTile;         // S_c (K x V, stride kSStr)
  float* G = S + kSTile;          // G_c+1
  float* us = G + kSTile;         // u of this head
  float* c0s = us + kMaxDim;      // G . (e^L_last S_c) per k
  float* khat = c0s + kMaxDim;    // per warp: k_s e^(L_last - L_s)
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = c * d.C, n = min(d.C, d.Tn - c0), C4 = (d.C + 3) & ~3;
  const int K = d.K, V = d.V;
  const long bhc = ((long)b * d.H + h) * d.nc + c;

  stage<T>(r, d, K, b, h, c0, n, C4, R);
  stage<T>(k, d, K, b, h, c0, n, C4, Kt);
  stage<T>(v, d, V, b, h, c0, n, C4, Vt);
  stage<float>(dout, d, V, b, h, c0, n, C4, O);
  stage_lw(w, d, b, h, c0, n, C4, Lw);
  stage_state(Sc + bhc * K * V, K, V, S);
  stage_state(Gc + bhc * K * V, K, V, G);
  for (int i = tid; i < K; i += kThreads) us[i] = u[h * K + i];
  __syncthreads();

  // A = dout v^T, a 4 x 4 tile of (t, s) per thread.
  const int nb = C4 / 4;
  for (int tile = tid; tile < nb * nb; tile += kThreads) {
    const int t0 = 4 * (tile / nb), s0 = 4 * (tile % nb);
    float acc[4][4] = {};
    for (int vv = 0; vv < V; vv += 4) {
      float4 a[4], x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(O + (t0 + i) * kStr + vv);
        x[i] = *reinterpret_cast<const float4*>(Vt + (s0 + i) * kStr + vv);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(a[i].x, x[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, x[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, x[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, x[j].w, acc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) A[(t0 + i) * kStr + s0 + j] = acc[i][j];
  }
  // G . (e^L_last S_c), rowwise (L_last summed in token order).
  if (tid < K) {
    float run = 0.f;
    for (int t = 0; t < C4; ++t) run = __fadd_rn(run, Lw[t * kStr + tid]);
    float s = 0.f;
    for (int vv = 0; vv < V; ++vv) s = fmaf(G[tid * kSStr + vv], S[tid * kSStr + vv], s);
    c0s[tid] = __fmul_rn(expf(run), s);
  }
  __syncthreads();

  // Rows: a warp per row t, lane on k and k + 32; s from t - 1 down, the
  // exponent summed over s < j < t as it goes (it ends as Lsh_t).
  for (int t = warp; t < C4; t += kWarps) {
    float acc[2] = {0.f, 0.f}, dri[2] = {0.f, 0.f};
    const int kk[2] = {lane, lane + 32};
    for (int s = t - 1; s >= 0; --s) {
      const float a = A[t * kStr + s];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (kk[e] >= K) continue;
        dri[e] = fmaf(__fmul_rn(a, Kt[s * kStr + kk[e]]), expf(acc[e]), dri[e]);
        acc[e] = __fadd_rn(acc[e], Lw[s * kStr + kk[e]]);
      }
    }
    const float att = A[t * kStr + t];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (kk[e] >= K) continue;
      float s1 = 0.f;
      for (int vv = 0; vv < V; ++vv) s1 = fmaf(O[t * kStr + vv], S[kk[e] * kSStr + vv], s1);
      const float dr1 = __fmul_rn(expf(acc[e]), s1);
      const float gated = __fadd_rn(dr1, dri[e]);
      const float g = __fadd_rn(gated, __fmul_rn(__fmul_rn(att, us[kk[e]]), Kt[t * kStr + kk[e]]));
      if (t < n) put(dr + tok(d, b, c0 + t, h) * K + kk[e], g);
      RY[t * kStr + kk[e]] = __fmul_rn(R[t * kStr + kk[e]], gated);
    }
  }

  // Columns: a warp per column s, lane on k and k + 32 (and on v and v +
  // 32 for dv); t from s + 1 up, the exponent summed over s < j < t as it
  // goes (it ends as L_last - L_s). P[t][s] is the lanes' sum over k.
  for (int s = warp; s < C4; s += kWarps) {
    const int kk[2] = {lane, lane + 32};
    float acc[2] = {0.f, 0.f}, dki[2] = {0.f, 0.f}, dvv[2] = {0.f, 0.f}, ks[2], rs[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      ks[e] = kk[e] < K ? Kt[s * kStr + kk[e]] : 0.f;
      rs[e] = kk[e] < K ? R[s * kStr + kk[e]] : 0.f;
    }
    for (int t = s + 1; t < C4; ++t) {
      const float a = A[t * kStr + s];
      float p = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (kk[e] >= K) continue;
        const float rt = R[t * kStr + kk[e]], g = expf(acc[e]);
        dki[e] = fmaf(__fmul_rn(a, rt), g, dki[e]);
        p = fmaf(__fmul_rn(rt, ks[e]), g, p);
        acc[e] = __fadd_rn(acc[e], Lw[t * kStr + kk[e]]);
      }
      const float P = warp_sum(p);
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (kk[e] < V) dvv[e] = fmaf(P, O[t * kStr + kk[e]], dvv[e]);
    }
    float pd = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (kk[e] < K) pd = fmaf(__fmul_rn(rs[e], us[kk[e]]), ks[e], pd);
    pd = warp_sum(pd);
    const float ass = A[s * kStr + s];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (kk[e] < V) dvv[e] = fmaf(pd, O[s * kStr + kk[e]], dvv[e]);
      if (kk[e] >= K) continue;
      float gv = 0.f;
      for (int vv = 0; vv < V; ++vv) gv = fmaf(Vt[s * kStr + vv], G[kk[e] * kSStr + vv], gv);
      const float ex = expf(acc[e]);
      const float dks = __fmul_rn(ex, gv);
      const float g = __fadd_rn(__fadd_rn(dki[e], dks), __fmul_rn(__fmul_rn(ass, us[kk[e]]), rs[e]));
      if (s < n) put(dk + tok(d, b, c0 + s, h) * K + kk[e], g);
      KIN[s * kStr + kk[e]] = __fmul_rn(ks[e], dki[e]);
      KST[s * kStr + kk[e]] = __fmul_rn(ks[e], dks);
      khat[warp * kMaxDim + kk[e]] = __fmul_rn(ks[e], ex);
    }
    __syncwarp();
    // The state part of dv: (k_s e^(L_last - L_s)) G.
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (kk[e] >= V) continue;
      float x = dvv[e];
      for (int q = 0; q < K; ++q) x = fmaf(khat[warp * kMaxDim + q], G[q * kSStr + kk[e]], x);
      if (s < n) put(dv + tok(d, b, c0 + s, h) * V + kk[e], x);
    }
    __syncwarp();
  }
  __syncthreads();

  // d(lw) and du, a thread per k: the sums after each row (backward), then
  // the state parts before it (forward).
  if (tid < K) {
    float suf = 0.f;
    for (int j = C4 - 1; j >= 0; --j) {
      const float y = __fsub_rn(RY[j * kStr + tid], KIN[j * kStr + tid]);
      RY[j * kStr + tid] = suf;
      suf = __fadd_rn(suf, y);
    }
    float pre = 0.f, dus = 0.f;
    const float cst = c0s[tid];
    for (int j = 0; j < C4; ++j) {
      const float dl = __fsub_rn(__fadd_rn(__fadd_rn(cst, pre), RY[j * kStr + tid]),
                                 KIN[j * kStr + tid]);
      pre = __fadd_rn(pre, KST[j * kStr + tid]);
      dus = fmaf(__fmul_rn(A[j * kStr + j], R[j * kStr + tid]), Kt[j * kStr + tid], dus);
      if (j < n) {
        const long at = tok(d, b, c0 + j, h) * K + tid;
        const float wj = w[at];
        dw[at] = wj > 1e-12f ? __fdiv_rn(dl, wj) : 0.f;
      }
    }
    du_part[bhc * K + tid] = dus;
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
  const size_t smem_state = sizeof(float) * 3 * kTile;
  const size_t smem_chunk =
      sizeof(float) * (9 * kTile + 2 * kSTile + 2 * kMaxDim + kWarps * kMaxDim);
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
  const dim3 grid(d.nc, H, B);
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
// float32; all contiguous. K and V are multiples of 4 in 4..64, chunk in
// 1..64, T >= 1. scratch: B H nc (K V + 2 K) float32. Returns the CUDA error
// code of the launches.
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
