// Dither threshold of B palettes in one launch, for Hopper (sm_90a): the
// reference's greedy approximation of the largest pairwise centroid
// distance, divided by sqrt(k_active).
//
// Replaces the reference's one `fori_loop` inside its executable
// (`kmeans_tpu/ops/quantize.py:112-147`, vmapped over frames at
// `kmeans_tpu/api.py:3255`). Port-only: the reference has no Pallas kernel
// for it; the port's plain twins (`dither_threshold_reference`,
// `dither_thresholds_reference` in `kmeans_tpu_torch/ops/quantize.py`) run
// ~10 small launches per centroid, ~1.7 s at k = 2048.
//
// The serial walk: a = p[0], b = p[min(1, kp - 1)], d_ab = dist(a, b);
// then for each i in [2, min(kp, k_active)): d_a = dist(p[i], a),
// d_b = dist(p[i], b) (the candidate first: CIE94 is asymmetric); if
// d_a > d_b and d_a > d_ab, p[i] replaces b; else if d_b > d_ab, it
// replaces a; d_ab follows. The result is d_ab / sqrt(k_active).
//
// Design: one block per palette, a first-trigger scan. The walk is
// sequential only at its updates: a step that triggers neither test leaves
// (a, b, d_ab) as they were, so every step between two updates reads the
// same state (a random palette updates about ten times at any k). Each
// round, each of `n` warps scores 32 candidates, lane l of warp w candidate
// s + 32 w + l, against the round's state, with the same `distance` calls
// in the same orientation as the serial walk, and votes `first || d_b >
// d_ab` (`__ballot_sync`). The round's first triggering candidate (the
// lowest voting lane of the lowest voting warp) is applied by every thread
// exactly as the serial walk applies it, and the next round starts just
// after it; a round with no vote moves s past its window. The steps before
// the first trigger are no-ops in the serial walk and their distances are
// the same function of the same inputs, so the result has the serial
// walk's bits; NaN compares false in both forms alike.
//
// The window adapts, so that a palette that updates at every step costs
// about what the serial walk does: `n` doubles (up to the block's warps)
// after a round with no vote and halves after one with a vote. While `n`
// is 1, warp 0 runs the rounds alone (`solo_rounds`), with no block
// barrier: after an update it shifts its candidates into place by
// shuffles from the window it holds and the next one, which it loaded a
// round ahead, so a round waits on no load; it hands the state to the
// block (one barrier) at its first round without a vote. Rounds of several
// warps meet at a double-buffered slot per warp in shared memory (hit,
// its two distances and its colour) and one barrier. Each warp loads the
// next round's candidates (for the case of no vote) before it scores the
// current ones, and the palette is prefetched into L2 at the start.
//
// What bounds it on this card: neither bytes (12 B a centroid) nor the
// card's rate (about 2 k distances), but the chain of rounds: about
// (updates + k / (32 warps)) rounds of one distance latency each (CIE94
// ~20 operations with two divides and three square roots, CIEDE2000 ~105
// with its atan2f, sinf, cosf and expf calls), against 2 (k - 2) dependent
// distances for one thread walking the palette.

#include <cuda_runtime.h>
#include <stdint.h>

#include "delta_e.cuh"

namespace {

using namespace kmeans;

// Warps a palette takes at most; the launcher gives a palette one warp per
// kPerWarp entries, so small palettes take fewer. A warp scores one
// window of 32 candidates a round: two ran slower in every case timed.
constexpr int kMaxWarps = 16;
constexpr int kPerWarp = 256;
constexpr int kNoHit = 0x7FFFFFFF;
constexpr unsigned kFull = 0xFFFFFFFFu;

template <int Metric>
__device__ __forceinline__ float distance(const float* x, const float* y) {
  const float c1 = chroma(x[1], x[2]);
  const float c2 = chroma(y[1], y[2]);
  float sc, sh2;
  cie94_weights(c1, &sc, &sh2);
  return __fsqrt_rn(
      pixel_distance<Metric>(x[0], x[1], x[2], c1, sc, sh2, y[0], y[1], y[2], c2));
}

// Candidate i of palette p into c; a candidate at or past `end` reads p[0]
// (a valid address; its vote is masked).
__device__ __forceinline__ void load_candidate(const float* __restrict__ p, int end, int i,
                                               float (&c)[3]) {
  const int q = i < end ? i : 0;
  c[0] = __ldg(p + 3 * q);
  c[1] = __ldg(p + 3 * q + 1);
  c[2] = __ldg(p + 3 * q + 2);
}

// The serial walk's update by candidate c with distances (da, db), applied
// alike by every thread that holds the state.
__device__ __forceinline__ void apply(float da, float db, const float (&c)[3], float (&a)[3],
                                      float (&b)[3], float* dab) {
  if ((da > db) && (da > *dab)) {
    b[0] = c[0], b[1] = c[1], b[2] = c[2];
    *dab = da;
  } else {
    a[0] = c[0], a[1] = c[1], a[2] = c[2];
    *dab = db;
  }
}

// Rounds of one warp while each of them updates the walk. On entry lane l
// holds candidates s + l (cur) and s + 32 + l (nxt, maybe still loading);
// on return s has moved past the first round without a vote (or to the
// end) and cur, nxt hold the windows at the new s and s + 32.
template <int Metric>
__device__ __forceinline__ void solo_rounds(const float* __restrict__ p, int end, int lane,
                                            int* s, float (&a)[3], float (&b)[3], float* dab,
                                            float (&cur)[3], float (&nxt)[3]) {
  while (*s < end) {
    const float da = distance<Metric>(cur, a);
    const float db = distance<Metric>(cur, b);
    const bool first = (da > db) && (da > *dab);
    const unsigned vote = __ballot_sync(kFull, *s + lane < end && (first || db > *dab));
    if (vote == 0u) {
      *s += 32;
      cur[0] = nxt[0], cur[1] = nxt[1], cur[2] = nxt[2];
      load_candidate(p, end, *s + 32 + lane, nxt);
      return;
    }
    const int src = __ffs(vote) - 1;
    const float c[3] = {__shfl_sync(kFull, cur[0], src), __shfl_sync(kFull, cur[1], src),
                        __shfl_sync(kFull, cur[2], src)};
    apply(__shfl_sync(kFull, da, src), __shfl_sync(kFull, db, src), c, a, b, dab);
    // The next round starts at s + src + 1: lane l takes candidate
    // s + from, from lane `from` of this window or the next.
    const int from = lane + src + 1;
    const int from_lane = from & 31;
    float next_cur[3], next_nxt[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float x = __shfl_sync(kFull, cur[k], from_lane);
      const float y = __shfl_sync(kFull, nxt[k], from_lane);
      next_cur[k] = from < 32 ? x : y;
      next_nxt[k] = y;
    }
    if (from >= 32) load_candidate(p, end, *s + 32 + from, next_nxt);
    *s += src + 1;
#pragma unroll
    for (int k = 0; k < 3; ++k) cur[k] = next_cur[k], nxt[k] = next_nxt[k];
  }
}

template <int Metric>
__global__ void __launch_bounds__(32 * kMaxWarps)
    dither_threshold_kernel(const float* __restrict__ palettes, int kp, int k_active,
                            const int32_t* __restrict__ k_actives, float* __restrict__ out) {
  // Per warp and round parity: the warp's first hit, its distances and colour.
  __shared__ int slot_hit[2][kMaxWarps];
  __shared__ float slot_val[2][kMaxWarps][5];
  // The state warp 0 hands over after its solo rounds.
  __shared__ float solo_state[7];
  __shared__ int solo_s;
  const int f = blockIdx.x;
  const int warps = blockDim.x / 32;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* p = palettes + static_cast<int64_t>(f) * kp * 3;
  const int ka = k_actives != nullptr ? k_actives[f] : k_active;
  for (int i = 32 * threadIdx.x; i < 3 * kp; i += 32 * blockDim.x) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p + i));
  }

  float a[3] = {p[0], p[1], p[2]};
  const int j1 = kp > 1 ? 1 : 0;
  float b[3] = {p[3 * j1], p[3 * j1 + 1], p[3 * j1 + 2]};
  float dab = distance<Metric>(a, b);
  const int end = kp < ka ? kp : ka;

  int s = 2;       // the first candidate of this round
  int n = 1;       // warps that score this round
  int parity = 0;  // which half of the slots this round writes
  float cur[3], nxt[3];
  if (w == 0) {
    load_candidate(p, end, s + lane, cur);
    load_candidate(p, end, s + 32 + lane, nxt);
  }
  while (s < end) {
    if (n == 1) {
      if (w == 0) solo_rounds<Metric>(p, end, lane, &s, a, b, &dab, cur, nxt);
      if (warps == 1) continue;
      if (threadIdx.x == 0) {
        solo_s = s;
        solo_state[0] = a[0], solo_state[1] = a[1], solo_state[2] = a[2];
        solo_state[3] = b[0], solo_state[4] = b[1], solo_state[5] = b[2];
        solo_state[6] = dab;
      }
      __syncthreads();
      s = solo_s;
      a[0] = solo_state[0], a[1] = solo_state[1], a[2] = solo_state[2];
      b[0] = solo_state[3], b[1] = solo_state[4], b[2] = solo_state[5];
      dab = solo_state[6];
      n = 2;
      if (w == 1) load_candidate(p, end, s + 32 + lane, cur);
      continue;
    }
    // The next round's candidates if no candidate of this one triggers.
    const int s_next = s + 32 * n;
    const int n_next = min(2 * n, warps);
    if (w < n_next) load_candidate(p, end, s_next + 32 * w + lane, nxt);

    int hit = kNoHit;
    float val[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (w < n) {
      const float da = distance<Metric>(cur, a);
      const float db = distance<Metric>(cur, b);
      const bool first = (da > db) && (da > dab);
      const int i = s + 32 * w + lane;
      const unsigned vote = __ballot_sync(kFull, i < end && (first || db > dab));
      if (vote != 0u) {
        const int src = __ffs(vote) - 1;
        hit = __shfl_sync(kFull, i, src);
        val[0] = __shfl_sync(kFull, da, src);
        val[1] = __shfl_sync(kFull, db, src);
#pragma unroll
        for (int k = 0; k < 3; ++k) val[2 + k] = __shfl_sync(kFull, cur[k], src);
      }
    }
    // The block's first hit: that of its lowest warp with one.
    if (lane == 0) {
      slot_hit[parity][w] = hit;
#pragma unroll
      for (int k = 0; k < 5; ++k) slot_val[parity][w][k] = val[k];
    }
    __syncthreads();
    const unsigned any =
        __ballot_sync(kFull, (lane < warps ? slot_hit[parity][lane] : kNoHit) != kNoHit);
    if (any == 0u) {
      s = s_next;
      n = n_next;
      cur[0] = nxt[0], cur[1] = nxt[1], cur[2] = nxt[2];
    } else {
      const int src = __ffs(any) - 1;
      const float* v = slot_val[parity][src];
      const float c[3] = {v[2], v[3], v[4]};
      apply(v[0], v[1], c, a, b, &dab);
      s = slot_hit[parity][src] + 1;
      n = max(1, n / 2);
      if (n == 1) {
        if (w == 0) load_candidate(p, end, s + 32 + lane, nxt);
      }
      if (w < n) load_candidate(p, end, s + 32 * w + lane, cur);
    }
    parity ^= 1;
  }
  if (threadIdx.x == 0) out[f] = __fdiv_rn(dab, __fsqrt_rn(static_cast<float>(ka)));
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns the launch's cudaError_t (0
// on success). Device pointers: palettes [frames * kp * 3] f32 Lab;
// k_actives [frames] i32, or null for `k_active` in every frame (each in
// [1, kp]); out [frames] f32. metric 0 (CIE94) or 1 (CIEDE2000). One block
// per palette, of one warp per kPerWarp entries (at least 1, at most
// kMaxWarps). It allocates nothing and does not synchronise.
int kmeans_dither_threshold(const void* palettes, int frames, int kp, int k_active,
                            const void* k_actives, int metric, void* out, void* stream) {
  if (frames < 1 || kp < 1 || (metric != kMetricCie94 && metric != kMetricCie2000)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = metric == kMetricCie2000 ? dither_threshold_kernel<kMetricCie2000>
                                         : dither_threshold_kernel<kMetricCie94>;
  const int fit = kp / kPerWarp;
  const int warps = fit < 1 ? 1 : fit > kMaxWarps ? kMaxWarps : fit;
  kernel<<<frames, 32 * warps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(palettes), kp, k_active, static_cast<const int32_t*>(k_actives),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
