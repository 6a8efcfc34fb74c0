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
// Design: one thread per palette. Thread f walks palette f in the twin's
// order: a = p[0], b = p[min(1, kp - 1)], d_ab = dist(a, b); then for each
// i in [2, min(kp, k_active)): d_a = dist(p[i], a), d_b = dist(p[i], b)
// (the candidate first: CIE94 is asymmetric); if d_a > d_b and d_a > d_ab,
// p[i] replaces b; else if d_b > d_ab, it replaces a; d_ab follows. The
// result is d_ab / sqrt(k_active). The walk is sequential by nature, two
// distances per centroid, so one thread does it; B palettes run on B
// threads. Distances are `delta_e.cuh`'s, with a square root on top, each
// float operation one _rn intrinsic in the twin's order, so the thresholds
// equal the twin's bits under both metrics.
//
// What bounds it on this card: neither bytes (12 B a centroid) nor the
// card's rate, but one thread's latency: 2 (k - 2) dependent distance
// evaluations (CIE94 ~20 operations, CIEDE2000 ~105 with its atan2f, sinf,
// cosf and expf calls). At k = 2048 that is microseconds to a few
// milliseconds, where the twin's eager loop takes ~40,000 launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "delta_e.cuh"

namespace {

using namespace kmeans;

template <int Metric>
__device__ __forceinline__ float distance(const float* x, const float* y) {
  const float c1 = chroma(x[1], x[2]);
  const float c2 = chroma(y[1], y[2]);
  float sc, sh2;
  cie94_weights(c1, &sc, &sh2);
  return __fsqrt_rn(
      pixel_distance<Metric>(x[0], x[1], x[2], c1, sc, sh2, y[0], y[1], y[2], c2));
}

template <int Metric>
__global__ void dither_threshold_kernel(const float* __restrict__ palettes, int frames,
                                        int kp, int k_active,
                                        const int32_t* __restrict__ k_actives,
                                        float* __restrict__ out) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= frames) return;
  const float* p = palettes + static_cast<int64_t>(f) * kp * 3;
  const int ka = k_actives != nullptr ? k_actives[f] : k_active;
  float a[3] = {p[0], p[1], p[2]};
  const int j = kp > 1 ? 1 : 0;
  float b[3] = {p[3 * j], p[3 * j + 1], p[3 * j + 2]};
  float dab = distance<Metric>(a, b);
  const int end = kp < ka ? kp : ka;
  for (int i = 2; i < end; ++i) {
    const float ci[3] = {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
    const float da = distance<Metric>(ci, a);
    const float db = distance<Metric>(ci, b);
    const bool first = (da > db) && (da > dab);
    const bool second = !first && (db > dab);
    if (first) {
      b[0] = ci[0], b[1] = ci[1], b[2] = ci[2];
      dab = da;
    } else if (second) {
      a[0] = ci[0], a[1] = ci[1], a[2] = ci[2];
      dab = db;
    }
  }
  out[f] = __fdiv_rn(dab, __fsqrt_rn(static_cast<float>(ka)));
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns the launch's cudaError_t (0
// on success). Device pointers: palettes [frames * kp * 3] f32 Lab;
// k_actives [frames] i32, or null for `k_active` in every frame (each in
// [1, kp]); out [frames] f32. metric 0 (CIE94) or 1 (CIEDE2000). It
// allocates nothing and does not synchronise.
int kmeans_dither_threshold(const void* palettes, int frames, int kp, int k_active,
                            const void* k_actives, int metric, void* out, void* stream) {
  if (frames < 1 || kp < 1 || (metric != kMetricCie94 && metric != kMetricCie2000)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = metric == kMetricCie2000 ? dither_threshold_kernel<kMetricCie2000>
                                         : dither_threshold_kernel<kMetricCie94>;
  const int threads = 128;
  const int blocks = (frames + threads - 1) / threads;
  kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(palettes), frames, kp, k_active,
      static_cast<const int32_t*>(k_actives), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
