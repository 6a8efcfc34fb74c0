// The fast tiers' shared device functions: the factorized CIE94 score and
// the top-m candidate list of the pruned CIEDE2000 tier, and the register
// tiles and carries of the port's three kernels (`quantize_assign.cu`,
// `quantize_meld.cu`, `lloyd_accumulate.cu`).
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
// kernel stages it in shared memory padded to 8 columns, so a row is two
// 16-byte loads. The pixel-only term cannot change an argmin, so the score
// drops it: six multiplies and six adds per centroid, summed left to
// right, each one IEEE float32 operation spelled with an _rn intrinsic so
// that none is fused (the twin's eager PyTorch rounds each product before
// its add). A fused form would be faster and give other bits.
//
// The pruned tier's candidate list is built without a walk of the list per
// centroid (`prune_screen`): packed 32-bit keys sorted by a network and
// merged, and the scores themselves only where keys could rank otherwise.
//
// The reference's TPU gather tables (`prune_c_table`, `prune_pal_table`,
// `_table_gather`) have no counterpart: a thread reads `cent[idx]`.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// `screen_score` of a row held as two 16-byte values: (g0, g1) =
// (g[0..3], g[4..6] and a pad).
__device__ __forceinline__ float screen_score4(const ScreenFactors& f, float4 g0, float4 g1) {
  float s = __fmul_rn(f.f0, g0.x);
  s = __fadd_rn(s, g0.y);
  s = __fadd_rn(s, __fmul_rn(f.f2, g0.z));
  s = __fadd_rn(s, __fmul_rn(f.q, g0.w));
  s = __fadd_rn(s, __fmul_rn(f.f4, g1.x));
  s = __fadd_rn(s, __fmul_rn(f.f5, g1.y));
  return __fadd_rn(s, __fmul_rn(f.rsh2, g1.z));
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

// The score of centroid k from the staged `[kp, 7]` feature table padded
// to 8 columns: row k is g[2 k] (columns 0-3) and g[2 k + 1] (4-6, then
// 0), two 16-byte loads.
__device__ __forceinline__ float row_score(const ScreenFactors& f, const float4* __restrict__ g,
                                           int k) {
  return screen_score4(f, g[2 * k], g[2 * k + 1]);
}

// The m best (score, index) pairs of one pixel in rank order. M is a
// template parameter and every loop over it unrolls, so the 2 M values
// stay in registers. A new pair walks the list once: at each slot a
// strictly smaller score takes the slot and pushes the holder on. The list
// is sorted by score, so a score not below the last slot's changes
// nothing and skips the walk. Equal scores are not kept in index order: a
// pushed holder passes the slots of its own score, so a smaller arrival
// moves the first of a run of equal scores to the run's end, and off the
// list when the run ends it. Which of equal scores stay, and in what
// order, depends on the arrivals; the scores themselves are the M least
// in ascending order, and the list depends only on the arrivals whose
// score is at most the M-th least (a larger one never passes the gate
// before them or moves them).
template <int M>
struct TopM {
  float d[M];  // the scores; `prune_screen` may leave 0 for one below kBigHalf
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

// Batcher's odd-even merge sorts of 8 and 16 values: 19 and 63
// compare-exchanges X(a, b), each putting the lesser of a and b first
// (`tests/test_torch_screen.py` holds them to Batcher's loops).
#define KM_BATCHER8(X) \
  X(0, 1) X(2, 3) X(4, 5) X(6, 7) X(0, 2) X(1, 3) X(4, 6) X(5, 7) X(1, 2) X(5, 6) X(0, 4) \
  X(1, 5) X(2, 6) X(3, 7) X(2, 4) X(3, 5) X(1, 2) X(3, 4) X(5, 6)
#define KM_BATCHER16(X) \
  X(0, 1) X(2, 3) X(4, 5) X(6, 7) X(8, 9) X(10, 11) X(12, 13) X(14, 15) X(0, 2) X(1, 3) \
  X(4, 6) X(5, 7) X(8, 10) X(9, 11) X(12, 14) X(13, 15) X(1, 2) X(5, 6) X(9, 10) \
  X(13, 14) X(0, 4) X(1, 5) X(2, 6) X(3, 7) X(8, 12) X(9, 13) X(10, 14) X(11, 15) X(2, 4) \
  X(3, 5) X(10, 12) X(11, 13) X(1, 2) X(3, 4) X(5, 6) X(9, 10) X(11, 12) X(13, 14) \
  X(0, 8) X(1, 9) X(2, 10) X(3, 11) X(4, 12) X(5, 13) X(6, 14) X(7, 15) X(4, 8) X(5, 9) \
  X(6, 10) X(7, 11) X(2, 4) X(3, 5) X(6, 8) X(7, 9) X(10, 12) X(11, 13) X(1, 2) X(3, 4) \
  X(5, 6) X(7, 8) X(9, 10) X(11, 12) X(13, 14)

// Sorts N = 8 or 16 values in registers by its network: `cx(a, b)` names
// two of them by constant indices and puts the lesser first.
template <int N, typename Cx>
__device__ __forceinline__ void sort_network(Cx cx) {
  static_assert(N == 8 || N == 16, "networks of 8 and 16 values");
#define KM_CX(a, b) cx(a, b);
  if constexpr (N == 8) {
    KM_BATCHER8(KM_CX)
  } else {
    KM_BATCHER16(KM_CX)
  }
#undef KM_CX
}

// The pruned tier's screening key of centroid k with score s: the score's
// bits in an order that unsigned comparison keeps (-0 taken as +0), their
// `low` bits replaced by k; ~0u for a score not below kBig (NaN and +inf
// included), which never enters the list. A key's top bits, key >> kbits
// (its bucket), order the scores: a lower bucket is a strictly lower
// score. Within a bucket the index orders the keys, so keys rank the
// centroids as the scores do except between scores of one bucket.
__device__ __forceinline__ uint32_t screen_key(float s, int k, uint32_t low) {
  const uint32_t b = __float_as_uint(__fadd_rn(s, 0.0f));
  const uint32_t u = b ^ (static_cast<uint32_t>(static_cast<int32_t>(b) >> 31) | 0x80000000u);
  return s < kBig ? (u & ~low) | static_cast<uint32_t>(k) : ~0u;
}

// The largest score whose key can fall below `key` (the last score of its
// bucket), +inf while `key` is ~0u (a slot not filled).
__device__ __forceinline__ float bucket_top(uint32_t key, uint32_t low) {
  const uint32_t u = key | low;
  const uint32_t b = (u & 0x80000000u) ? u ^ 0x80000000u : ~u;
  return key == ~0u ? INFINITY : __uint_as_float(b);
}

// Pass 1 of the pruned tier: exactly the list `TopM::insert` builds from
// the first k_active centroids k = 0, 1, ... by the factorized score
// `row_score(f, g, k)`, with keys (`screen_key`) in place of its walk of
// floats and indices:
// - The first M keys are sorted by `sort_network`. Each later score is
//   compared with the largest score of the M-th key's bucket (one float
//   compare, as the walk's gate); only one not above it takes its key,
//   which is inserted, two unsigned min/max a slot and no chain from slot
//   to slot, if it is below the M-th. A step no lane of the warp needs is
//   skipped by the whole warp, so a pixel whose list has settled costs a
//   score and a compare a centroid. `out` keeps the least key that left
//   or never entered of those past the gate: a score the gate stops lies
//   in a higher bucket than the final M-th key.
// - If the M-th key and `out` share a bucket, a score of that bucket may
//   belong in place of one kept; else every score kept is below every
//   score that left. Where two kept keys share a bucket (the keys order
//   them by index), the scores are computed again and the M pairs sorted
//   by score.
// - Where a score left shares the M-th key's bucket, or two kept scores
//   are equal (the walk's order of equal scores depends on the arrivals),
//   the list is built by `TopM::insert` from the scores of bucket <= the
//   M-th key's alone: every score up to the M-th least, so the same list.
//   Else the kept scores are distinct and below all others, and the walk
//   would have left them in ascending order: the list.
// - The exact pass reads only the list's order and whether each score is
//   below kBigHalf. So where no two kept keys share a bucket and none lies
//   in kBigHalf's bucket or above, the scores are not computed again: each
//   filled slot holds 0.
// Every lane of the warp that is still running calls this together (the
// steps' votes).
template <int M>
__device__ __forceinline__ void prune_screen(const ScreenFactors& f, const float4* __restrict__ g,
                                             int k_active, TopM<M>* top) {
  const int kbits = 32 - __clz(k_active - 1);  // the bits of the largest index
  const uint32_t low = (1u << kbits) - 1u;
  uint32_t keep[M];
#pragma unroll
  for (int j = 0; j < M; ++j) keep[j] = ~0u;
  uint32_t out = ~0u;
  // The first M keys: sorted by the network.
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const float s = row_score(f, g, min(j, k_active - 1));
    keep[j] = j < k_active ? screen_key(s, j, low) : ~0u;
  }
  sort_network<M>([&](int a, int b) {
    const uint32_t lo = min(keep[a], keep[b]);
    keep[b] = max(keep[a], keep[b]);
    keep[a] = lo;
  });
  // The rest, two scores computed together (their loads and sums overlap)
  // and taken in turn: a score above `gate`, the largest of the M-th key's
  // bucket, has a key above the M-th, so it cannot belong, nor share that
  // bucket with the final M-th key. Any other takes its key, which is
  // inserted if it is below the M-th. Each step is taken by the warp only
  // where one of its lanes needs it, so that pixels whose lists have
  // settled cost a score and a compare a centroid.
  const unsigned lanes = __activemask();
  float gate = bucket_top(keep[M - 1], low);
  auto step = [&](float s, int k) {
    const bool past = s <= gate;
    if (!__any_sync(lanes, past)) return;
    const uint32_t key = screen_key(s, k, low);
    if (past) out = min(out, max(key, keep[M - 1]));
    const bool enters = past && key < keep[M - 1];
    if (!__any_sync(lanes, enters)) return;
    if (enters) {
      // Keys are distinct and `keep` ascending, so slot i becomes the
      // greater of the old slot i - 1 and min(old slot i, key).
#pragma unroll
      for (int i = M - 1; i >= 1; --i) keep[i] = max(keep[i - 1], min(keep[i], key));
      keep[0] = min(keep[0], key);
      gate = bucket_top(keep[M - 1], low);
    }
  };
#pragma unroll 1
  for (int k = M; k < k_active; k += 2) {
    const float s0 = row_score(f, g, k);
    const float s1 = row_score(f, g, min(k + 1, k_active - 1));
    step(s0, k);
    if (k + 1 < k_active) step(s1, k + 1);
  }
  const uint32_t bucket = keep[M - 1] >> kbits;
  bool walk = keep[M - 1] != ~0u && (out >> kbits) == bucket;
  if (!walk) {
    // Keys from the bucket of kBigHalf up may hold a score at or above it.
    const uint32_t high = (__float_as_uint(kBigHalf) | 0x80000000u) & ~low;
    bool shared = false, rescore = false;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const bool filled = keep[j] != ~0u;
      top->i[j] = filled ? static_cast<int>(keep[j] & low) : 0;
      top->d[j] = filled ? 0.0f : kBig;
      if (j > 0) shared = shared || (filled && (keep[j] >> kbits) == (keep[j - 1] >> kbits));
      rescore = rescore || (filled && keep[j] >= high);
    }
    if (shared || rescore) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        if (top->d[j] == 0.0f) top->d[j] = row_score(f, g, top->i[j]);
      }
      sort_network<M>([&](int a, int b) {
        const bool swap = top->d[b] < top->d[a];
        const float da = top->d[a];
        const int ia = top->i[a];
        top->d[a] = swap ? top->d[b] : da;
        top->i[a] = swap ? top->i[b] : ia;
        top->d[b] = swap ? da : top->d[b];
        top->i[b] = swap ? ia : top->i[b];
      });
#pragma unroll
      for (int j = 1; j < M; ++j) walk = walk || (top->d[j] < kBig && top->d[j] == top->d[j - 1]);
    }
  }
  if (walk) {
    top->init();
#pragma unroll 1
    for (int k = 0; k < k_active; ++k) {
      const float s = row_score(f, g, k);
      if (s < kBig && (screen_key(s, k, low) >> kbits) <= bucket) top->insert(s, k);
    }
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

// The two closest so far, carried with strict `<`: a new minimum displaces
// the closest into second place, else a distance below the second's
// replaces it, which orders ties as `lax.top_k` does (the first index
// wins; kmeans_tpu/ops/kernels.py:994-1007).
struct TwoClosest {
  float d1 = kBig, d2 = kBig;
  int k1 = 0, k2 = 0;

  __device__ __forceinline__ void update(float d, int k) {
    const bool first = d < d1, second = d < d2;
    d2 = first ? d1 : second ? d : d2;
    k2 = first ? k1 : second ? k : k2;
    d1 = first ? d : d1;
    k1 = first ? k : k1;
  }
};

// One pixel's pass under the pruned tier: `carry->update(d, k)` sees the
// M survivors of the screen (`prune_screen` over the first k_active rows
// of the padded feature table `g`, `row_score`) in screening-rank order,
// d their exact squared CIEDE2000 distance to the staged centroids `cent`
// [kp] (L, a, b, chroma); `c1` is the pixel's chroma. A carry with strict
// `<` gives a tie between exact distances to the better rank, not the
// lower index; slots never filled (fewer than M active centroids) end the
// visit (kmeans_tpu/ops/kernels.py:903-936, 1010-1018). The other tiers
// scan register tiles (`scan_exact_tile`, `scan_factor_tile`,
// `scan_algebraic_tile`).
template <int Metric, int Tier, int M, typename Carry>
__device__ __forceinline__ void scan_centroids(float l, float a, float b, float c1,
                                               const float4* __restrict__ cent,
                                               const float4* __restrict__ g, int k_active,
                                               Carry* carry) {
  static_assert(Tier == kTierPrune, "the other tiers scan register tiles");
  // Pixel-side terms, hoisted out of the centroid loop
  // (kmeans_tpu/ops/kernels.py:823-826, 863, 1356).
  const ScreenFactors f = screen_factors(l, a, b, c1);
  TopM<M> top;
  prune_screen<M>(f, g, k_active, &top);
#pragma unroll 1
  for (int j = 0; j < M; ++j) {
    float sd;
    int idx;
    top.pop(&sd, &idx);
    if (!(sd < kBigHalf)) break;
    const float4 c = cent[idx];
    carry->update(cie2000_sq(l, a, b, c1, c.x, c.y, c.z, c.w), idx);
  }
}

// Under exact CIE94, a pixel of a tile whose quotients `div_by_recip` might
// not give exactly is scanned again here, by `cie94_sq` and its IEEE
// divides: the loop the kernels ran before the tiled form. It is rare (a
// centroid or pixel out of `Cie94Pixel`'s range, or a dividend below
// 2^-64 and not zero), so it is kept out of line.
template <typename Carry>
static __device__ __noinline__ void rescan_cie94(Cie94Pixel p, const float4* cent, int count,
                                                 int base, Carry* carry) {
  for (int k = 0; k < count; ++k) {
    const float4 c = cent[k];
    carry->update(cie94_sq(p.l, p.a, p.b, p.c1, p.sc, p.sh2, c.x, c.y, c.z, c.w), base + k);
  }
}

// The exact tiers' register tile: P pixels of one thread against `count`
// staged centroids `cent` [count] (L, a, b, chroma), numbered from `base`.
// The centroid loop is outermost: one 16-byte shared load a centroid
// serves all P pixels, whose P independent distances hide each other's
// latency. Each pixel still visits the centroids in index order, so its
// carry (`Closest`, `TwoClosest`) ends as the one loop's. The carries come
// in and go out (a chunked palette calls this once a chunk). Under CIE94
// the divides take the pixel's hoisted reciprocals; `cents_ok` says
// whether every staged centroid is in range (`cie94_centroid_ok`). A pixel
// out of range, or every pixel of the tile when the centroids are not or a
// dividend fell below 2^-64, is rescanned from its carry at entry by
// `rescan_cie94`.
template <int Metric, int P, typename Carry>
__device__ __forceinline__ void scan_exact_tile(const Cie94Pixel (&px)[P], Carry (&carry)[P],
                                                const float4* __restrict__ cent, int count,
                                                int base, bool cents_ok) {
  Carry entry[P];
#pragma unroll
  for (int s = 0; s < P; ++s) entry[s] = carry[s];
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
      carry[s].update(d, base + k);
    }
  }
  if constexpr (Metric == kMetricCie94) {
    const bool all = !cents_ok || tiny < kTinyDividend;
#pragma unroll
    for (int s = 0; s < P; ++s) {
      if (all || !px[s].ok) {
        carry[s] = entry[s];
        rescan_cie94(px[s], cent, count, base, &carry[s]);
      }
    }
  }
}

// The factorized tier's register tile: P pixels' factors `f` against the
// first k_active rows of the padded feature table `g`, the centroid loop
// outermost (two 16-byte shared loads a centroid serve the P pixels), each
// pixel's carry updated in index order with its score.
template <int P, typename Carry>
__device__ __forceinline__ void scan_factor_tile(const ScreenFactors (&f)[P], Carry (&carry)[P],
                                                 const float4* __restrict__ g, int k_active) {
#pragma unroll 1
  for (int k = 0; k < k_active; ++k) {
    const float4 g0 = g[2 * k], g1 = g[2 * k + 1];
#pragma unroll
    for (int s = 0; s < P; ++s) carry[s].update(screen_score4(f[s], g0, g1), k);
  }
}

// A pixel of the accumulator's algebraic tier: (L, a, b), its chroma `c1`
// and `screen_factors`' rsh2 and q, the weights of `cie94_algebraic_sq`.
struct AlgebraicPixel {
  float l, a, b, c1, rsh2, q;
};

__device__ __forceinline__ AlgebraicPixel algebraic_pixel(float l, float a, float b) {
  const float c1 = kmeans::chroma(a, b);
  const ScreenFactors f = screen_factors(l, a, b, c1);
  return AlgebraicPixel{l, a, b, c1, f.rsh2, f.q};
}

// The algebraic tier's register tile: P pixels against the first k_active
// staged centroids `cent` [kp] (L, a, b, chroma), the centroid loop
// outermost (one 16-byte shared load a centroid serves the P pixels), each
// pixel's carry updated in index order with `cie94_algebraic_sq`, a true
// squared distance (the accumulator's inertia column).
template <int P, typename Carry>
__device__ __forceinline__ void scan_algebraic_tile(const AlgebraicPixel (&px)[P],
                                                    Carry (&carry)[P],
                                                    const float4* __restrict__ cent,
                                                    int k_active) {
#pragma unroll 1
  for (int k = 0; k < k_active; ++k) {
    const float4 c = cent[k];
#pragma unroll
    for (int s = 0; s < P; ++s) {
      carry[s].update(cie94_algebraic_sq(px[s].l, px[s].a, px[s].b, px[s].c1, px[s].rsh2,
                                         px[s].q, c.x, c.y, c.z, c.w),
                      k);
    }
  }
}

// One register tile of P pixels under (Metric, Tier) against the staged
// centroids `cent` [count] numbered from `base` (0 under the fast tiers)
// and, for the fast tiers, the padded feature table `g`: the exact tile,
// the factorized tile, or under the pruned tier each pixel's screen and
// exact pass in turn (the list and the CIEDE2000 calls leave no registers
// for more). A pixel is a `Cie94Pixel` (L, a, b, chroma and CIE94's
// hoisted weights) or, under the factorized tier alone, its
// `ScreenFactors`. Each carry ends as the one loop's over the same
// centroids.
template <int Metric, int Tier, int M, int P, typename Pixel, typename Carry>
__device__ __forceinline__ void scan_tile(const Pixel (&px)[P], Carry (&carry)[P],
                                          const float4* __restrict__ cent,
                                          const float4* __restrict__ g, int count, int base,
                                          bool cents_ok) {
  if constexpr (Tier == kTierExact) {
    scan_exact_tile<Metric, P>(px, carry, cent, count, base, cents_ok);
  } else if constexpr (Tier == kTierFactor && std::is_same_v<Pixel, ScreenFactors>) {
    scan_factor_tile<P>(px, carry, g, count);
  } else if constexpr (Tier == kTierFactor) {
    ScreenFactors f[P];
#pragma unroll
    for (int s = 0; s < P; ++s) f[s] = screen_factors(px[s].l, px[s].a, px[s].b, px[s].c1);
    scan_factor_tile<P>(f, carry, g, count);
  } else {
#pragma unroll
    for (int s = 0; s < P; ++s) {
      scan_centroids<Metric, Tier, M>(px[s].l, px[s].a, px[s].b, px[s].c1, cent, g, count,
                                      &carry[s]);
    }
  }
}

// Centroid k of `centroids` [kp * 3] as (L, a, b, chroma).
__device__ __forceinline__ float4 centroid4(const float* __restrict__ centroids, int k) {
  const float* c = centroids + 3 * k;
  return make_float4(c[0], c[1], c[2], kmeans::chroma(c[1], c[2]));
}

// Copies centroids [start, start + len) of `centroids` [kp * 3] into
// shared memory as (L, a, b, chroma), the exact tiers' table, and returns
// whether the ones this thread copied are in `cie94_centroid_ok`'s range.
__device__ __forceinline__ bool stage_cent4(const float* __restrict__ centroids, int start,
                                            int len, float4* cent4) {
  bool ok = true;
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    cent4[i] = centroid4(centroids, start + i);
    ok = ok && cie94_centroid_ok(cent4[i].y, cent4[i].z);
  }
  return ok;
}

// Copies the `[kp, 7]` feature table into shared memory padded to 8
// columns (`row_score`); a no-op for a null table.
__device__ __forceinline__ void stage_feature_rows(const float* __restrict__ gtab_in,
                                                   float4* g, int kp) {
  if (gtab_in == nullptr) return;
  for (int k = threadIdx.x; k < kp; k += blockDim.x) {
    const float* r = gtab_in + kGCols * k;
    g[2 * k] = make_float4(r[0], r[1], r[2], r[3]);
    g[2 * k + 1] = make_float4(r[4], r[5], r[6], 0.0f);
  }
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
