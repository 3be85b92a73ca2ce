// The float32 attention driver of attend_tile.cuh: 4 warps of 4 query
// rows (16 a block) over 32-key float32 tiles, the scalar tile step of the
// order (lane j scores key j) inside the same splits and fold as the
// tensor-core driver, the fold inside the block. Included by
// attend_tile.cuh.
#pragma once

namespace attn {

constexpr int kF32Threads = 128;
constexpr int kF32Rows = 16;                         // query rows a block
constexpr int kF32RPW = kF32Rows / (kF32Threads / 32);

// Dynamic shared memory of attend_f32, in bytes: the block's queries
// [16][H], K [32][H + 1] (padded so lanes reading different keys hit
// different banks), V [32][H], and the tile's ks, vs, live [32].
template <int H>
struct F32Smem {
  static constexpr size_t q = 0;
  static constexpr size_t k = q + (size_t)kF32Rows * H * 4;
  static constexpr size_t v = k + (size_t)kBK * (H + 1) * 4;
  static constexpr size_t meta = v + (size_t)kBK * H * 4;
  static constexpr size_t bytes = meta + 3 * kBK * 4;
};

// The state of one query row, held by one warp: lane owns acc[i] for
// output dim lane + 32 i.
template <int H>
struct RowF32 {
  static constexpr int DPL = (H + 31) / 32;
  float m, l, acc[DPL];
  __device__ void init() {
    m = -INFINITY;
    l = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  }
};

// Fold the tile into one row (the whole warp). vis: whether this lane's
// key is visible to the row; every visible key lies in [jlo, jhi]. QUANT:
// scores on int8 codes times ks, probabilities times vs.
template <int H, bool QUANT>
__device__ __forceinline__ void tile_f32(RowF32<H>& st, const float* __restrict__ q,
                                         const float* __restrict__ tk,
                                         const float* __restrict__ tv,
                                         const float* __restrict__ ks,
                                         const float* __restrict__ vs, bool vis, int jlo,
                                         int jhi, float scale, float softcap, int lane) {
  if (!__any_sync(0xffffffffu, vis)) return;     // the row sees no key here
  float s = -INFINITY;
  if (vis) {
    float dot = 0.f;
    for (int d = 0; d < H; ++d) dot = __fmaf_rn(q[d], tk[lane * (H + 1) + d], dot);
    if (QUANT) dot = __fmul_rn(dot, ks[lane]);
    s = __fmul_rn(dot, scale);
    if (softcap > 0.f) s = __fmul_rn(softcap, tanhf(__fdiv_rn(s, softcap)));
  }
  float mx = s;
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  const float m_new = fmaxf(st.m, mx);
  float p = vis ? expf(__fsub_rn(s, m_new)) : 0.f;
  const float alpha = st.m == -INFINITY ? 0.f : expf(__fsub_rn(st.m, m_new));
  float sum = p;
  for (int o = 16; o > 0; o >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
  st.l = __fmaf_rn(st.l, alpha, sum);
  if (QUANT) p = __fmul_rn(p, vs[lane]);
#pragma unroll
  for (int i = 0; i < RowF32<H>::DPL; ++i) st.acc[i] = __fmul_rn(st.acc[i], alpha);
  for (int j = jlo; j <= jhi; ++j) {
    const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
    for (int i = 0; i < RowF32<H>::DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < H) st.acc[i] = __fmaf_rn(pj, tv[j * H + d], st.acc[i]);
    }
  }
  st.m = m_new;
}

// Attend rows [0, 16) of `rows` over the keys of `src` (as attend_mma,
// every split folded in the block) and write their outputs.
template <int H, bool QUANT, typename QT, typename KT, typename Rows, typename Src>
__device__ void attend_f32(const QT* __restrict__ q, QT* __restrict__ out, const Rows& rows,
                           const KT* __restrict__ pk, const KT* __restrict__ pv,
                           const float* __restrict__ ksc, const float* __restrict__ vsc,
                           const Src& src, int NKV, int head, float scale, float softcap) {
  using SM = F32Smem<H>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = (float*)(smem + SM::q);
  float* tk = (float*)(smem + SM::k);
  float* tv = (float*)(smem + SM::v);
  float* ks = (float*)(smem + SM::meta);
  float* vs = ks + kBK;
  int* live = (int*)(vs + kBK);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  int kt0, kt1, last;
  row_span(rows, kF32Rows, kt0, kt1, last);
  for (int i = tid; i < kF32Rows * H; i += kF32Threads) {
    const int r = i / H, d = i % H;
    q_s[i] = rows.exists(r) ? to_f(q[rows.q_off(r) + d]) : 0.f;
  }
  RowF32<H> sp[kF32RPW], tot[kF32RPW];
#pragma unroll
  for (int rr = 0; rr < kF32RPW; ++rr) {
    sp[rr].init();
    tot[rr].init();
  }

  int cur = (kt0 < kt1 && src.tile_live(kt0)) ? kt0 : next_live(src, kt0, kt1);
  while (cur < kt1) {
    const int nxt = next_live(src, cur, kt1);
    const int k_lo = cur * kBK;
    __syncthreads();              // the previous tile's readers are done
    for (int i = tid; i < kBK * H; i += kF32Threads) {
      const int j = i / H, d = i % H, pos = k_lo + j;
      const long sl = pos <= last ? src.slot(pos) : -1;
      const long off = (sl * NKV + head) * H + d;
      tk[j * (H + 1) + d] = sl >= 0 ? to_f(pk[off]) : 0.f;
      tv[j * H + d] = sl >= 0 ? to_f(pv[off]) : 0.f;
    }
    for (int j = tid; j < kBK; j += kF32Threads) {
      const int pos = k_lo + j;
      const long sl = pos <= last ? src.slot(pos) : -1;
      live[j] = sl >= 0;
      if (QUANT) {
        ks[j] = sl >= 0 ? ksc[sl * NKV + head] : 0.f;
        vs[j] = sl >= 0 ? vsc[sl * NKV + head] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kF32RPW; ++rr) {
      const int r = warp * kF32RPW + rr;
      if (!rows.exists(r)) continue;                 // warp-uniform
      const int jlo = max(0, rows.lo(r) - k_lo), jhi = min(kBK - 1, rows.hi(r) - k_lo);
      tile_f32<H, QUANT>(sp[rr], q_s + r * H, tk, tv, ks, vs,
                         lane >= jlo && lane <= jhi && live[lane], jlo, jhi, scale,
                         softcap, lane);
    }
    if (nxt >= kt1 || nxt / kTPS != cur / kTPS) {    // the split ends
#pragma unroll
      for (int rr = 0; rr < kF32RPW; ++rr) {
        float a, b;
        fold_ml(tot[rr].m, tot[rr].l, sp[rr].m, sp[rr].l, a, b);
#pragma unroll
        for (int i = 0; i < RowF32<H>::DPL; ++i)
          tot[rr].acc[i] = fold_o(tot[rr].acc[i], sp[rr].acc[i], a, b);
        sp[rr].init();
      }
    }
    cur = nxt;
  }

#pragma unroll
  for (int rr = 0; rr < kF32RPW; ++rr) {
    const int r = warp * kF32RPW + rr;
    if (!rows.exists(r)) continue;
    QT* orow = out + rows.q_off(r);
#pragma unroll
    for (int i = 0; i < RowF32<H>::DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < H) orow[d] = from_f<QT>(finish(tot[rr].acc[i], tot[rr].l));
    }
  }
}

}  // namespace attn
