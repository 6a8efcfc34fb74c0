// The fast tiers' shared device functions: the factorized CIE94 score and
// the top-m candidate list of the pruned CIEDE2000 tier, used by the
// port's three kernels (`quantize_assign.cu`, `quantize_meld.cu`,
// `lloyd_accumulate.cu`).
//
// Replaces `kmeans_tpu/ops/kernels.py::_screen_factor_planes` (`:558`),
// `_screen_k_fn` (`:580`) and `_prune_screen` (`:624`). The plain PyTorch
// twins are `kmeans_tpu_torch/ops/kernels.py::screen_factors`,
// `screen_score` and `_prune_screen`.
//
// The squared CIE94 distance splits into a term of the pixel alone plus a
// dot product of six pixel factors with seven per-centroid features. The
// features come in as the `[kp, 7]` table `factor_g_table` builds outside
// the kernel (rows `[L2, L2^2, C2, C2 * C2, a2, b2, a2^2 + b2^2]`); each
// kernel stages it in shared memory beside the centroids. The pixel-only
// term cannot change an argmin, so the score drops it: six multiplies and
// six adds per centroid, summed left to right, each one IEEE float32
// operation spelled with an _rn intrinsic so that none is fused (the
// twin's eager PyTorch rounds each product before its add). A fused form
// would be faster and give other bits.
//
// The reference's TPU gather tables (`prune_c_table`, `prune_pal_table`,
// `_table_gather`) have no counterpart: a thread reads `cent[3 * idx]`.

#pragma once

#include <cuda_runtime.h>

#include "delta_e.cuh"

namespace kmeans {

// The tiers by the code the launchers take (`KERNEL_TIERS` in
// kmeans_tpu_torch/ops/kernels.py).
constexpr int kTierExact = 0;
constexpr int kTierFactor = 1;     // factorized CIE94 score
constexpr int kTierAlgebraic = 2;  // accumulator only: divide-free CIE94 distance
constexpr int kTierPrune = 3;      // factorized screen, exact CIEDE2000 on m survivors

constexpr int kGCols = 7;
// Below any masked screening score: a slot not below it was never filled.
constexpr float kBigHalf = 1.7e38f;

struct ScreenFactors {
  float rsh2, q, f0, f2, f4, f5;
};

// Pixel side: rsh2 = 1 / (sh sh), q = 1 / (sc sc) - rsh2, f0 = -2 L,
// f2 = -2 c1 q, f4 = -2 a rsh2, f5 = -2 b rsh2, with true divisions.
__device__ __forceinline__ ScreenFactors screen_factors(float l, float a, float b,
                                                        float c1) {
  const float sc = __fadd_rn(1.0f, __fmul_rn(F32(0.045), c1));
  const float sh = __fadd_rn(1.0f, __fmul_rn(F32(0.015), c1));
  ScreenFactors f;
  f.rsh2 = __fdiv_rn(1.0f, __fmul_rn(sh, sh));
  f.q = __fsub_rn(__fdiv_rn(1.0f, __fmul_rn(sc, sc)), f.rsh2);
  f.f0 = __fmul_rn(-2.0f, l);
  f.f2 = __fmul_rn(__fmul_rn(-2.0f, c1), f.q);
  f.f4 = __fmul_rn(__fmul_rn(-2.0f, a), f.rsh2);
  f.f5 = __fmul_rn(__fmul_rn(-2.0f, b), f.rsh2);
  return f;
}

// f0 g0 + g1 + f2 g2 + q g3 + f4 g4 + f5 g5 + rsh2 g6, left to right.
__device__ __forceinline__ float screen_score(const ScreenFactors& f,
                                              const float* __restrict__ g) {
  float s = __fmul_rn(f.f0, g[0]);
  s = __fadd_rn(s, g[1]);
  s = __fadd_rn(s, __fmul_rn(f.f2, g[2]));
  s = __fadd_rn(s, __fmul_rn(f.q, g[3]));
  s = __fadd_rn(s, __fmul_rn(f.f4, g[4]));
  s = __fadd_rn(s, __fmul_rn(f.f5, g[5]));
  return __fadd_rn(s, __fmul_rn(f.rsh2, g[6]));
}

// The accumulator's divide-free CIE94 distance on the same reciprocals:
// dl^2 + (da^2 + db^2) rsh2 + dcab^2 q, no clamp
// (kmeans_tpu/ops/kernels.py:1379-1385).
__device__ __forceinline__ float cie94_algebraic_sq(float l1, float a1, float b1,
                                                    float c1, float rsh2, float q,
                                                    float l2, float a2, float b2,
                                                    float c2) {
  const float dl = __fsub_rn(l1, l2);
  const float da = __fsub_rn(a1, a2);
  const float db = __fsub_rn(b1, b2);
  const float dcab = __fsub_rn(c1, c2);
  const float ab = __fmul_rn(__fadd_rn(__fmul_rn(da, da), __fmul_rn(db, db)), rsh2);
  return __fadd_rn(__fadd_rn(__fmul_rn(dl, dl), ab),
                   __fmul_rn(__fmul_rn(dcab, dcab), q));
}

// The m best (score, index) pairs of one pixel in rank order. M is a
// template parameter and every loop over it unrolls, so the 2 M values
// stay in registers. A new pair walks the list once: at each slot a
// strictly smaller score takes the slot and pushes the holder on, so equal
// scores keep the lower index first. The list is sorted, so a score not
// below the last slot's changes nothing and skips the walk.
template <int M>
struct TopM {
  float d[M];
  int i[M];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      d[j] = kBig;
      i[j] = 0;
    }
  }

  __device__ __forceinline__ void insert(float sd, int si) {
    if (!(sd < d[M - 1])) return;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const bool take = sd < d[j];
      const float hd = d[j];
      const int hi = i[j];
      d[j] = take ? sd : hd;
      i[j] = take ? si : hi;
      sd = take ? hd : sd;
      si = take ? hi : si;
    }
  }

  // Takes the best pair off the front and moves the rest up, so a runtime
  // loop can visit the list in rank order without indexing registers.
  __device__ __forceinline__ void pop(float* sd, int* si) {
    *sd = d[0];
    *si = i[0];
#pragma unroll
    for (int j = 0; j + 1 < M; ++j) {
      d[j] = d[j + 1];
      i[j] = i[j + 1];
    }
    d[M - 1] = kBig;
    i[M - 1] = 0;
  }
};

// Pass 1 of the pruned tier: the M best of the first k_active centroids by
// the factorized score against the staged table `gtab` [kp * 7].
template <int M>
__device__ __forceinline__ void prune_screen(const ScreenFactors& f,
                                             const float* __restrict__ gtab,
                                             int k_active, TopM<M>* top) {
  top->init();
  for (int k = 0; k < k_active; ++k) {
    top->insert(screen_score(f, gtab + kGCols * k), k);
  }
}

// The closest so far, carried with strict `<`: the first minimum wins.
struct Closest {
  float d = kBig;
  int k = 0;

  __device__ __forceinline__ void update(float nd, int nk) {
    if (nd < d) {
      d = nd;
      k = nk;
    }
  }
};

// One pixel's pass over the first k_active centroids under (Metric, Tier):
// `carry->update(d, k)` sees each visited centroid once. `c1` is the
// pixel's chroma; `cent` [kp * 3], `chroma` [kp] and `gtab` [kp * 7] are
// the staged tables. d is the squared distance under the exact, algebraic
// and pruned tiers and the factorized score (a rank, no distance) under
// kTierFactor. The exact, factorized and algebraic tiers visit every
// centroid in index order. Under kTierPrune only the M survivors of the
// screen are visited, in screening-rank order, so a carry with strict `<`
// gives a tie between exact distances to the better rank, not the lower
// index; slots never filled (fewer than M active centroids) end the visit
// (kmeans_tpu/ops/kernels.py:903-936, 1010-1018).
template <int Metric, int Tier, int M, typename Carry>
__device__ __forceinline__ void scan_centroids(float l, float a, float b, float c1,
                                               const float* __restrict__ cent,
                                               const float* __restrict__ chroma,
                                               const float* __restrict__ gtab,
                                               int k_active, Carry* carry) {
  // Pixel-side terms, hoisted out of the centroid loop
  // (kmeans_tpu/ops/kernels.py:823-826, 863, 1356).
  if constexpr (Tier == kTierPrune) {
    const ScreenFactors f = screen_factors(l, a, b, c1);
    TopM<M> top;
    prune_screen<M>(f, gtab, k_active, &top);
#pragma unroll 1
    for (int j = 0; j < M; ++j) {
      float sd;
      int idx;
      top.pop(&sd, &idx);
      if (!(sd < kBigHalf)) break;
      carry->update(cie2000_sq(l, a, b, c1, cent[3 * idx + 0], cent[3 * idx + 1],
                               cent[3 * idx + 2], chroma[idx]),
                    idx);
    }
  } else if constexpr (Tier == kTierFactor) {
    const ScreenFactors f = screen_factors(l, a, b, c1);
    for (int k = 0; k < k_active; ++k) carry->update(screen_score(f, gtab + kGCols * k), k);
  } else if constexpr (Tier == kTierAlgebraic) {
    const ScreenFactors f = screen_factors(l, a, b, c1);
    for (int k = 0; k < k_active; ++k) {
      carry->update(cie94_algebraic_sq(l, a, b, c1, f.rsh2, f.q, cent[3 * k + 0],
                                       cent[3 * k + 1], cent[3 * k + 2], chroma[k]),
                    k);
    }
  } else {
    float sc, sh2;
    cie94_weights(c1, &sc, &sh2);
    for (int k = 0; k < k_active; ++k) {
      carry->update(pixel_distance<Metric>(l, a, b, c1, sc, sh2, cent[3 * k + 0],
                                           cent[3 * k + 1], cent[3 * k + 2], chroma[k]),
                    k);
    }
  }
}

// Nearest of the first k_active centroids to one pixel: `scan_centroids`
// with the `Closest` carry.
template <int Metric, int Tier, int M>
__device__ __forceinline__ void nearest_centroid(float l, float a, float b,
                                                 const float* __restrict__ cent,
                                                 const float* __restrict__ chroma,
                                                 const float* __restrict__ gtab,
                                                 int k_active, int* best_k_out,
                                                 float* best_d_out) {
  Closest best;
  scan_centroids<Metric, Tier, M>(l, a, b, kmeans::chroma(a, b), cent, chroma, gtab,
                                  k_active, &best);
  *best_k_out = best.k;
  *best_d_out = best.d;
}

// Under exact CIE94, a pixel of a tile whose quotients `div_by_recip` might
// not give exactly is scanned again here, by `cie94_sq` and its IEEE
// divides: the loop the kernels ran before the tiled form. It is rare (a
// centroid or pixel out of `Cie94Pixel`'s range, or a dividend below
// 2^-64 and not zero), so it is kept out of line.
static __device__ __noinline__ void rescan_cie94(Cie94Pixel p, const float4* cent, int count,
                                                 int base, float* best_d, int* best_k) {
  for (int k = 0; k < count; ++k) {
    const float4 c = cent[k];
    const float d = cie94_sq(p.l, p.a, p.b, p.c1, p.sc, p.sh2, c.x, c.y, c.z, c.w);
    if (d < *best_d) {
      *best_d = d;
      *best_k = base + k;
    }
  }
}

// The exact tiers' register tile: P pixels of one thread against `count`
// staged centroids `cent` [count] (L, a, b, chroma), numbered from `base`.
// The centroid loop is outermost: one 16-byte shared load a centroid
// serves all P pixels, whose P independent distances hide each other's
// latency. Each pixel still visits the centroids in index order with
// strict `<`, so the first minimum wins and `best_k` is the one loop's.
// `best_d` / `best_k` carry in and out (a chunked palette calls this once
// a chunk). Under CIE94 the divides take the pixel's hoisted reciprocals;
// `cents_ok` says whether every staged centroid is in range
// (`cie94_centroid_ok`). A pixel out of range, or every pixel of the tile
// when the centroids are not or a dividend fell below 2^-64, is rescanned
// from its state at entry by `rescan_cie94`.
template <int Metric, int P>
__device__ __forceinline__ void scan_exact_tile(const Cie94Pixel (&px)[P], float (&best_d)[P],
                                                int (&best_k)[P],
                                                const float4* __restrict__ cent, int count,
                                                int base, bool cents_ok) {
  float d0[P];
  int k0[P];
#pragma unroll
  for (int s = 0; s < P; ++s) {
    d0[s] = best_d[s];
    k0[s] = best_k[s];
  }
  unsigned tiny = ~0u;
#pragma unroll 1
  for (int k = 0; k < count; ++k) {
    const float4 c = cent[k];
#pragma unroll
    for (int s = 0; s < P; ++s) {
      float d;
      if constexpr (Metric == kMetricCie2000) {
        d = cie2000_sq(px[s].l, px[s].a, px[s].b, px[s].c1, c.x, c.y, c.z, c.w);
      } else {
        d = cie94_sq_recip(px[s], c, &tiny);
      }
      if (d < best_d[s]) {
        best_d[s] = d;
        best_k[s] = base + k;
      }
    }
  }
  if constexpr (Metric == kMetricCie94) {
    const bool all = !cents_ok || tiny < kTinyDividend;
#pragma unroll
    for (int s = 0; s < P; ++s) {
      if (all || !px[s].ok) {
        best_d[s] = d0[s];
        best_k[s] = k0[s];
        rescan_cie94(px[s], cent, count, base, &best_d[s], &best_k[s]);
      }
    }
  }
}

// Copies centroids [start, start + len) of `centroids` [kp * 3] into
// shared memory as (L, a, b, chroma), the exact tiers' table, and returns
// whether the ones this thread copied are in `cie94_centroid_ok`'s range.
__device__ __forceinline__ bool stage_cent4(const float* __restrict__ centroids, int start,
                                            int len, float4* cent4) {
  bool ok = true;
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const int k = start + i;
    const float ca = centroids[3 * k + 1];
    const float cb = centroids[3 * k + 2];
    cent4[i] = make_float4(centroids[3 * k + 0], ca, cb, kmeans::chroma(ca, cb));
    ok = ok && cie94_centroid_ok(ca, cb);
  }
  return ok;
}

// Copies the `[kp, 7]` table into shared memory (no-op for a null table).
__device__ __forceinline__ void stage_g_table(const float* __restrict__ gtab_in,
                                              float* gtab, int kp) {
  if (gtab_in == nullptr) return;
  for (int i = threadIdx.x; i < kGCols * kp; i += blockDim.x) gtab[i] = gtab_in[i];
}

// Whether (metric, tier, prune_m) names an instance a launcher has.
inline bool tier_args_valid(int metric, int tier, const void* gtab, int prune_m,
                            bool algebraic_ok) {
  if (metric != kMetricCie94 && metric != kMetricCie2000) return false;
  if (tier == kTierExact) return true;
  if (tier == kTierFactor) return metric == kMetricCie94 && gtab != nullptr;
  if (tier == kTierAlgebraic) return algebraic_ok && metric == kMetricCie94;
  if (tier == kTierPrune) {
    return metric == kMetricCie2000 && gtab != nullptr && (prune_m == 8 || prune_m == 16);
  }
  return false;
}

}  // namespace kmeans
