// Shared pieces of the paged-attention kernels: element conversions and
// the block-level flash-attention loop over one row's block table.
//
// A thread block attends R query rows that share one KV head to the
// paged pool (num_blocks, block_size, NKV, H), walking the row's block
// table in order and folding each live pool block into an online fp32
// softmax. The math is the TPU kernels' (repro/kernels/paged_attention.py
// _paged_kernel, repro/kernels/paged_prefill.py _chunk_kernel): scores on
// the pool's values (int8 codes times the per-key scale for an int8
// pool), times H^-0.5, optional tanh softcap, masked keys set to the
// float32 minimum (not -inf) with a `safe_m` guard, probabilities times
// the per-value scale for an int8 pool, and rows that see no key output
// zeros. Blocks past the last query position and unallocated (-1) table
// entries are never loaded.
#pragma once

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Shared memory (floats) the attend loop needs for R rows.
__host__ __device__ inline size_t attend_smem_floats(int R, int H, int bs) {
  return (size_t)2 * R * H + 2 * (size_t)bs * H + 2 * bs + (size_t)R * bs + 3 * R;
}

// Rows: row r = ii * G + g reads q at q_base + ii * ii_stride + g * H and
// sits at absolute position qpos(ii) = ii < n_valid ? pos0 + ii * pos_step
// : -1 (no key visible). out has q's layout.
template <typename QT, typename KT, bool QUANT>
__device__ void attend_rows(const QT* __restrict__ q_base, QT* __restrict__ out_base,
                            long ii_stride, int nI, int G, int H,
                            int pos0, int pos_step, int n_valid,
                            const KT* __restrict__ pool_k, const KT* __restrict__ pool_v,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale,
                            const int* __restrict__ tbl, int ntbl, int bs, int NKV,
                            int head, float scale, float softcap, float* smem) {
  const int R = nI * G;
  float* q_s = smem;                  // R * H
  float* acc_s = q_s + R * H;         // R * H
  float* k_s = acc_s + R * H;         // bs * H
  float* v_s = k_s + bs * H;          // bs * H
  float* ks_s = v_s + bs * H;         // bs
  float* vs_s = ks_s + bs;            // bs
  float* s_s = vs_s + bs;             // R * bs
  float* m_s = s_s + R * bs;          // R
  float* l_s = m_s + R;               // R
  float* al_s = l_s + R;              // R
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < R * H; i += kThreads) {
    const int r = i / H, h = i % H;
    q_s[i] = to_f(q_base[(long)(r / G) * ii_stride + (r % G) * H + h]);
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  const int n_live = min(nI, n_valid);
  const int last = n_live > 0 ? pos0 + (n_live - 1) * pos_step : -1;
  const int nblk = last < 0 ? 0 : min(ntbl, last / bs + 1);
  __syncthreads();

  for (int j = 0; j < nblk; ++j) {
    const int blk = tbl[j];
    if (blk < 0) continue;          // unallocated: never loaded
    for (int i = tid; i < bs * H; i += kThreads) {
      const int t = i / H, h = i % H;
      const long off = ((long)(blk * bs + t) * NKV + head) * H + h;
      k_s[i] = to_f(pool_k[off]);
      v_s[i] = to_f(pool_v[off]);
    }
    if (QUANT) {
      for (int t = tid; t < bs; t += kThreads) {
        const long off = (long)(blk * bs + t) * NKV + head;
        ks_s[t] = k_scale[off];
        vs_s[t] = v_scale[off];
      }
    }
    __syncthreads();

    for (int i = warp; i < R * bs; i += kWarps) {
      const int r = i / bs, t = i % bs;
      float d = 0.f;
      for (int h = lane; h < H; h += 32) d += q_s[r * H + h] * k_s[t * H + h];
      for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      if (lane == 0) {
        float s = d;
        if (QUANT) s = s * ks_s[t];
        s = s * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        const int ii = r / G;
        const int qpos = ii < n_valid ? pos0 + ii * pos_step : -1;
        s_s[i] = (j * bs + t <= qpos) ? s : -FLT_MAX;
      }
    }
    __syncthreads();

    for (int r = tid; r < R; r += kThreads) {
      const int ii = r / G;
      const int qpos = ii < n_valid ? pos0 + ii * pos_step : -1;
      const float m_prev = m_s[r];
      float bmax = -INFINITY;
      for (int t = 0; t < bs; ++t) bmax = fmaxf(bmax, s_s[r * bs + t]);
      const float m_new = fmaxf(m_prev, bmax);
      const float safe_m = isfinite(m_new) ? m_new : 0.f;
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        float p = (j * bs + t <= qpos) ? expf(s_s[r * bs + t] - safe_m) : 0.f;
        sum += p;
        if (QUANT) p = p * vs_s[t];
        s_s[r * bs + t] = p;
      }
      const float alpha = isfinite(m_prev) ? expf(m_prev - safe_m) : 0.f;
      l_s[r] = l_s[r] * alpha + sum;
      al_s[r] = alpha;
      m_s[r] = m_new;
    }
    __syncthreads();

    for (int i = tid; i < R * H; i += kThreads) {
      const int r = i / H, h = i % H;
      float pv = 0.f;
      for (int t = 0; t < bs; ++t) pv += s_s[r * bs + t] * v_s[t * H + h];
      acc_s[i] = acc_s[i] * al_s[r] + pv;
    }
    __syncthreads();
  }

  for (int i = tid; i < R * H; i += kThreads) {
    const int r = i / H, h = i % H;
    const float l = fmaxf(l_s[r], 1e-30f);
    out_base[(long)(r / G) * ii_stride + (r % G) * H + h] = from_f<QT>(acc_s[i] / l);
  }
}

// Opt a kernel into more than 48 KB of dynamic shared memory once.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace paged
