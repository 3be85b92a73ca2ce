// The bf16 attention driver of attend_tile.cuh: NW warps of 16 query rows
// share each staged K/V tile; every warp runs the tensor-core tile step
// (step 3 of the order) on its rows, and the split fold (step 4) either
// inside the block (FOLD: flash, prefill) or into scratch for a second
// launch (decode, one split per block). Included by attend_tile.cuh.
#pragma once

namespace attn {

// Dynamic shared memory of attend_mma, in bytes from the base (every
// offset a multiple of 16). K/V rows are H + 8 bf16 long: an odd number
// of 16-byte chunks, so the 8 rows an ldmatrix reads hit 8 distinct bank
// groups.
template <int H, int NW, bool QUANT, bool FOLD>
struct MmaSmem {
  static constexpr int LD = H + 8;
  static constexpr int NKB = QUANT ? 1 : 2;          // bf16 K/V buffers
  static constexpr size_t q = 0;                    // [NW * 16][LD] bf16
  static constexpr size_t kv = q + (size_t)NW * 16 * LD * 2;    // [NKB][k, v][32][LD]
  static constexpr size_t raw = kv + (size_t)NKB * 2 * kBK * LD * 2;  // int8 [2][k, v][32][H]
  static constexpr size_t meta = raw + (QUANT ? (size_t)2 * 2 * kBK * H : 0);  // [2][ks, vs, live][32]
  static constexpr size_t otot = meta + (size_t)2 * 3 * kBK * 4;  // [NW][H / 2][32] f32
  static constexpr size_t bytes = otot + (FOLD ? (size_t)NW * (H / 2) * 32 * 4 : 0);
};

// Attend rows [0, NW * 16) of `rows` (see row_span) over the keys of
// `src` (slot(pos): the key's slot, -1 if none; tile_live(kt)): K/V of
// slot s at (s * NKV + head) * H in pk / pv, int8 codes with per-slot
// scales ksc / vsc when QUANT. split < 0: every split of the rows' range,
// folded in the block, output written to out (FOLD). split >= 0 (NW = 1,
// !FOLD): only that split's tiles; its (m, l, O) go to part_ml [16][2]
// and part_o [16][H].
template <int H, int NW, bool QUANT, bool FOLD, typename KT, typename Rows, typename Src>
__device__ void attend_mma(const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
                           const Rows& rows, const KT* __restrict__ pk,
                           const KT* __restrict__ pv, const float* __restrict__ ksc,
                           const float* __restrict__ vsc, const Src& src, int NKV, int head,
                           float scale, float softcap, int split,
                           float* __restrict__ part_o, float* __restrict__ part_ml) {
  using SM = MmaSmem<H, NW, QUANT, FOLD>;
  constexpr int LD = SM::LD, NT = H / 16, NTH = NW * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = (__nv_bfloat16*)(smem + SM::q);
  __nv_bfloat16* kv_s = (__nv_bfloat16*)(smem + SM::kv);
  int8_t* raw_s = (int8_t*)(smem + SM::raw);
  float* meta = (float*)(smem + SM::meta);
  float* otot = (float*)(smem + SM::otot);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  int kt0, kt1, last;
  row_span(rows, NW * 16, kt0, kt1, last);
  if (split >= 0) {
    kt0 = max(kt0, split * kTPS);
    kt1 = min(kt1, split * kTPS + kTPS);
  }

  for (int i = tid; i < NW * 16 * (H / 8); i += NTH) {
    const int r = i / (H / 8), c = i % (H / 8);
    const bool ok = rows.exists(r);
    cp16(q_s + r * LD + c * 8, ok ? q + rows.q_off(r) + c * 8 : q, ok);
  }

  // Stage tile kt into ring buffer buf: keys past `last`, in no slot, or
  // past the source's end are zeros.
  auto stage = [&](int buf, int kt) {
    const int k_lo = kt * kBK;
    float* ks = meta + buf * 3 * kBK;
    float* vs = ks + kBK;
    int* live = (int*)(vs + kBK);
    for (int j = tid; j < kBK; j += NTH) {
      const int pos = k_lo + j;
      const long sl = pos <= last ? src.slot(pos) : -1;
      live[j] = sl >= 0;
      if (QUANT) {
        ks[j] = sl >= 0 ? ksc[sl * NKV + head] : 0.f;
        vs[j] = sl >= 0 ? vsc[sl * NKV + head] : 0.f;
      }
    }
    constexpr int CPR = H * (int)sizeof(KT) / 16;     // 16-byte chunks a key row
    constexpr int EPC = 16 / (int)sizeof(KT);         // elements a chunk
    for (int i = tid; i < kBK * CPR; i += NTH) {
      const int j = i / CPR, c = i % CPR, pos = k_lo + j;
      const long sl = pos <= last ? src.slot(pos) : -1;
      const long off = (sl * NKV + head) * H + c * EPC;
      void *dk, *dv;
      if (QUANT) {
        dk = raw_s + ((buf * 2 + 0) * kBK + j) * H + c * 16;
        dv = raw_s + ((buf * 2 + 1) * kBK + j) * H + c * 16;
      } else {
        dk = kv_s + ((buf * 2 + 0) * kBK + j) * LD + c * 8;
        dv = kv_s + ((buf * 2 + 1) * kBK + j) * LD + c * 8;
      }
      cp16(dk, sl >= 0 ? (const void*)(pk + off) : (const void*)pk, sl >= 0);
      cp16(dv, sl >= 0 ? (const void*)(pv + off) : (const void*)pv, sl >= 0);
    }
  };

  // This thread's two rows (g and g + 8 of its warp) and their state.
  int lo_h[2], hi_h[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    const bool ok = rows.exists(r);
    lo_h[h] = ok ? rows.lo(r) : 1;
    hi_h[h] = ok ? rows.hi(r) : -1;
  }
  float o[H / 8][4], m[2], l[2], M[2], L[2];
#pragma unroll
  for (int n = 0; n < H / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = M[h] = -INFINITY;
    l[h] = L[h] = 0.f;
  }
  float* my_otot = otot + (size_t)warp * (H / 2) * 32 + lane;   // element i at [i * 32]
  if (FOLD)
    for (int i = 0; i < H / 2; ++i) my_otot[i * 32] = 0.f;

  int cur = (kt0 < kt1 && src.tile_live(kt0)) ? kt0 : next_live(src, kt0, kt1);
  if (cur < kt1) stage(0, cur);
  cp_commit();
  for (int it = 0; cur < kt1; ++it) {
    const int nxt = next_live(src, cur, kt1);
    cp_wait_all();
    __syncthreads();       // tile `cur` landed; everyone is done with the other buffer
    if (nxt < kt1) stage((it + 1) & 1, nxt);
    cp_commit();
    const int buf = it & 1;
    const __nv_bfloat16 *kb, *vb;
    if (QUANT) {           // widen this tile's int8 codes exactly to bf16
      for (int i = tid; i < 2 * kBK * (H / 8); i += NTH) {
        const int kvsel = i / (kBK * (H / 8)), rem = i % (kBK * (H / 8));
        const int j = rem / (H / 8), c = rem % (H / 8);
        const int8_t* s8 = raw_s + ((buf * 2 + kvsel) * kBK + j) * H + c * 8;
        const int2 codes = *reinterpret_cast<const int2*>(s8);
        const int8_t* cb = reinterpret_cast<const int8_t*>(&codes);
        uint4 w;
        w.x = pack_bf16((float)cb[0], (float)cb[1]);
        w.y = pack_bf16((float)cb[2], (float)cb[3]);
        w.z = pack_bf16((float)cb[4], (float)cb[5]);
        w.w = pack_bf16((float)cb[6], (float)cb[7]);
        *reinterpret_cast<uint4*>(kv_s + (kvsel * kBK + j) * LD + c * 8) = w;
      }
      __syncthreads();
      kb = kv_s;
      vb = kv_s + kBK * LD;
    } else {
      kb = kv_s + (buf * 2) * kBK * LD;
      vb = kb + kBK * LD;
    }
    const float* ks = meta + buf * 3 * kBK;
    const float* vs = ks + kBK;
    const int* live = (const int*)(vs + kBK);
    const int k_lo = cur * kBK;

    // S = Q K^T: H/16 k-steps in order.
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
    const __nv_bfloat16* qw = q_s + warp * 16 * LD;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t a[4];
      ldm_x4(a, qw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t b[4];
        ldm_x4(b, kb + (jp * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * LD + kk * 16 +
                      ((lane >> 3) & 1) * 8);
        mma16816(s[2 * jp], a, b[0], b[1]);
        mma16816(s[2 * jp + 1], a, b[2], b[3]);
      }
    }
    // Scale, softcap, mask; the row max.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jt = 0; jt < 4; ++jt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * jt + 2 * t + e, pos = k_lo + j;
          float v = s[jt][2 * h + e];
          if (QUANT) v = __fmul_rn(v, ks[j]);
          v = __fmul_rn(v, scale);
          if (softcap > 0.f) v = __fmul_rn(softcap, tanhf(__fdiv_rn(v, softcap)));
          v = (live[j] && pos >= lo_h[h] && pos <= hi_h[h]) ? v : -INFINITY;
          s[jt][2 * h + e] = v;
          mx[h] = fmaxf(mx[h], v);
        }
    float alpha[2], mu[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h]);
      mu[h] = mn == -INFINITY ? 0.f : mn;
      alpha[h] = expf(__fsub_rn(m[h], mu[h]));
      m[h] = mn;
    }
    // p = exp(s - m); the row sum; P in bf16 (times the value scale).
    float sum[2] = {0.f, 0.f};
    uint32_t pa[4][2];
#pragma unroll
    for (int jt = 0; jt < 4; ++jt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p0 = expf(__fsub_rn(s[jt][2 * h], mu[h]));
        float p1 = expf(__fsub_rn(s[jt][2 * h + 1], mu[h]));
        sum[h] = __fadd_rn(__fadd_rn(sum[h], p0), p1);
        if (QUANT) {
          p0 = __fmul_rn(p0, vs[8 * jt + 2 * t]);
          p1 = __fmul_rn(p1, vs[8 * jt + 2 * t + 1]);
        }
        pa[jt][h] = pack_bf16(p0, p1);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] = __fadd_rn(sum[h], __shfl_xor_sync(0xffffffffu, sum[h], 1));
      sum[h] = __fadd_rn(sum[h], __shfl_xor_sync(0xffffffffu, sum[h], 2));
      l[h] = __fmaf_rn(l[h], alpha[h], sum[h]);
    }
#pragma unroll
    for (int n = 0; n < H / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[n][c] = __fmul_rn(o[n][c], alpha[c >> 1]);
    // O += P V: two k16 steps over the tile's keys, in order.
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint32_t a[4] = {pa[2 * kk][0], pa[2 * kk][1], pa[2 * kk + 1][0],
                             pa[2 * kk + 1][1]};
#pragma unroll
      for (int dn = 0; dn < NT; ++dn) {
        uint32_t b[4];
        ldm_x4_t(b, vb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dn * 16 +
                        (lane >> 4) * 8);
        mma16816(o[2 * dn], a, b[0], b[1]);
        mma16816(o[2 * dn + 1], a, b[2], b[3]);
      }
    }

    if (FOLD && (nxt >= kt1 || nxt / kTPS != cur / kTPS)) {   // the split ends
      float fa[2], fb[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        fold_ml(M[h], L[h], m[h], l[h], fa[h], fb[h]);
        m[h] = -INFINITY;
        l[h] = 0.f;
      }
#pragma unroll
      for (int n = 0; n < H / 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float* p = my_otot + (n * 4 + c) * 32;
          *p = fold_o(*p, o[n][c], fa[c >> 1], fb[c >> 1]);
          o[n][c] = 0.f;
        }
    }
    cur = nxt;
  }
  cp_wait_all();

  if (FOLD) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g + 8 * h;
      if (!rows.exists(r)) continue;
      __nv_bfloat16* orow = out + rows.q_off(r);
#pragma unroll
      for (int n = 0; n < H / 8; ++n) {
        const float v0 = finish(my_otot[(n * 4 + 2 * h) * 32], L[h]);
        const float v1 = finish(my_otot[(n * 4 + 2 * h + 1) * 32], L[h]);
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < H / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        part_o[(g + 8 * (c >> 1)) * H + n * 8 + 2 * t + (c & 1)] = o[n][c];
    if (t == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        part_ml[(g + 8 * h) * 2] = m[h];
        part_ml[(g + 8 * h) * 2 + 1] = l[h];
      }
  }
}

// Fold the splits of decode (written by attend_mma with split >= 0) in
// increasing order, and normalise: one thread per (query row, dim) of one
// (row b, KV head n), blocks (b, n, z) sharing a (b, n)'s G * H elements
// (z along them), so a few KV heads (MQA: one) still fill the card. part_o [B][NKV][ns][16][H], part_ml [..][16][2];
// out (B, NKV * G, H) in q's layout. Slot z of a row's scratch holds
// split first / kSplit + z, first = max(0, q_pos - window + 1) under a
// sliding window (window > 0), else 0: the splits before it hold no key
// the row sees, and folding such a split leaves the total as it was.
template <int H>
__global__ void fold_splits_kernel(const float* __restrict__ part_o,
                                   const float* __restrict__ part_ml,
                                   const int* __restrict__ q_pos,
                                   __nv_bfloat16* __restrict__ out, int NKV, int G, int ns,
                                   int window) {
  const int b = blockIdx.x, n = blockIdx.y;
  const int qp = q_pos[b];
  const int sp0 = window > 0 ? max(0, qp - window + 1) / kSplit : 0;
  const int nsb = qp < 0 ? 0 : min(ns, qp / kSplit + 1 - sp0);
  const long bn = (long)b * NKV + n;
  for (int e = blockIdx.z * blockDim.x + threadIdx.x; e < G * H;
       e += gridDim.z * blockDim.x) {
    const int r = e / H, d = e % H;
    float M = -INFINITY, L = 0.f, O = 0.f;
    for (int sp = 0; sp < nsb; ++sp) {
      const long ps = bn * ns + sp;
      float a, bb;
      fold_ml(M, L, part_ml[(ps * 16 + r) * 2], part_ml[(ps * 16 + r) * 2 + 1], a, bb);
      O = fold_o(O, part_o[(ps * 16 + r) * H + d], a, bb);
    }
    out[(bn * G + r) * H + d] = __float2bfloat16_rn(finish(O, L));
  }
}

}  // namespace attn
