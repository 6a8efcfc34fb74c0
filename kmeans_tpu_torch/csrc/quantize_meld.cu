// Fused meld pass for Hopper (sm_90a): u8 sRGB -> Lab -> the two closest
// centroids under CIE94 or CIEDE2000 -> their blend -> Lab -> u8 sRGB ->
// RGB bytes packed into int32 words.
//
// Replaces the Pallas TPU kernel `kmeans_tpu/ops/kernels.py::_quantize_kernel`
// in meld mode with its in-kernel RGB24 pack (`fused_meld_packed`,
// `:994-1077`, and the frames batch `fused_meld_frames_packed`, `:2129`),
// for the exact CIE94 and CIEDE2000 metrics and their fast tiers
// (screen.cuh). The plain PyTorch twins
// `kmeans_tpu_torch/ops/kernels.py::meld_packed_reference` and
// `meld_frames_packed_reference` are the spec of the words it writes.
//
// Per pixel:
// - the two closest of the first k_active centroids, carried with strict
//   `<`: a new minimum displaces the closest into second place, else a
//   distance below the second's replaces it. That orders ties as
//   `lax.top_k` does (the first index wins), as the reference's carry does
//   (`:994-1007`).
// - factor = sqrt(d2) / sqrt(d(closest, second)), with d2 the carried
//   squared distance from the pixel to the second (`:1028-1041`); the blend
//   factor * closest + (1 - factor) * second. With one active centroid the
//   output is centroid 0 (`:1043-1049`). Two centroids of one colour make
//   den == 0 and the blend NaN; it is written as 0, as the reference's
//   float-to-integer conversion writes it (colorspace.cuh).
// - Lab -> sRGB -> u8 with rintf, round half to even like torch.round;
//   the sRGB encode's byte is found by an 8-step search of its 255 step
//   points (colorspace.cuh::linear_to_srgb8), which equals the `powf`
//   form on every float32 input (checked on the card by
//   `kmeans_tpu_torch/tools/srgb_steps.py`).
// - Factorized CIE94 tier: the loop carries the factorized score, which
//   ranks the centroids but is no distance, so the numerator is recomputed
//   as the exact CIE94 distance from the pixel to the second (`:1033-1034`).
// - Pruned CIEDE2000 tier: the screen keeps the m best by the factorized
//   score (screen.cuh::prune_screen); the same carry then runs over those
//   survivors in rank order on their exact distances (`:1010-1018`), so d2
//   is exact.
//
// Design: a thread owns a group of 4 pixels, the pixels at rows r, blk + r,
// 2 blk + r and 3 blk + r of a tile (blk = tile_rows / 4) in one lane, so
// the thread writes its 3 output words itself and no packing crosses
// threads. Word row j (< 3) of the group holds, low byte first:
// j = 0: R0 G0 B0 R1; j = 1: G1 B1 R2 G2; j = 2: B2 R3 G3 B3 (`:1055-1077`).
// It scans them P at a time (`tile_pixels`: 1 under exact CIE94 and
// CIEDE2000, 4 under the factorized score) through screen.cuh::scan_tile
// with the `TwoClosest` carry: the centroid loop outermost, one 16-byte
// shared load of (L, a, b, chroma) or two of the padded feature row a
// centroid, CIE94's divides through the pixel's hoisted reciprocals (a
// pixel out of their range is rescanned with IEEE divides). d(closest,
// second), a function of the two centroids alone, comes from a [kp, kp]
// table each block fills once when kp <= kDenTableMaxK (16: the card
// measured it slower at 32), else it is computed per pixel as before.
// Frames: frame f = frame_base + blockIdx.y; its blocks read the image at
// pixel offset f * frame_stride (0: one image for every frame), stage frame
// f's palette and k_active and write frame f's words, the single-image
// layout. The launcher issues at most 65,535 frames (the grid's y limit) a
// launch, each group with its first frame as `frame_base`.
// The gamma table, the sRGB step points and the centroids (with their
// chroma) live in shared memory; the centroid loop is a runtime loop. A
// palette larger than `chunk` centroids (the `Chunked` instances, exact
// tier only) is staged `chunk` centroids at a time, the four pixels held
// in registers with their two closest across chunks (the 4-pixel tile
// under CIE94), so the result is the one loop's; the blend then reads its
// two centroids from global memory. Any k is one launch (the reference has
// no meld kernel above k = 1024).
//
// Float rounding as in quantize_assign.cu: one IEEE float32 operation per
// step in the twin's order, _rn intrinsics, no fast math.
//
// What bounds it on this card: it reads 3 B/px and writes 3 B/px, so at
// k = 8 the per-pixel conversions (three `powf` into Lab, the divides of
// Lab -> sRGB, the step searches), the per-centroid distances and, under
// CIEDE2000, their atan2f, sinf, cosf and expf calls set the pace, not
// memory bandwidth. The tiled CIE94 loop costs about 35 instructions a
// pixel-centroid pair (SASS), against about 50 before.

#include <cuda_runtime.h>
#include <stdint.h>

#include "colorspace.cuh"
#include "delta_e.cuh"
#include "screen.cuh"

namespace {

using namespace kmeans;

constexpr int kLanes = 128;
constexpr int kThreads = 256;
// The largest grid y extent: frames beyond it go in another launch.
constexpr int64_t kMaxGridY = 65535;
// Palettes of at most this many centroids take d(closest, second) from a
// [kp, kp] table each block fills once (`den_table`).
constexpr int kDenTableMaxK = 16;

// Pixels a thread scans together (a divisor of its 4) under (metric,
// tier), and the blocks of kThreads an SM must hold (`__launch_bounds__`):
// the pairs measured fastest without spills. The chunked instances hold
// all 4 pixels across the chunks.
__host__ __device__ constexpr int tile_pixels(int metric, int tier, bool chunked) {
  if (chunked) return metric == kMetricCie94 ? 4 : 1;
  return tier == kTierFactor ? 4 : 1;
}
__host__ __device__ constexpr int min_blocks(int tier, bool chunked) {
  if (chunked || tier == kTierPrune) return 2;
  return tier == kTierFactor ? 3 : 4;
}

// d(closest, second) under Metric, the closest first with its own hoisted
// weights (kmeans_tpu/ops/kernels.py:1038-1041).
template <int Metric>
__device__ __forceinline__ float centroid_distance(float4 c1, float4 c2) {
  float sc1, sh21;
  cie94_weights(c1.w, &sc1, &sh21);
  return pixel_distance<Metric>(c1.x, c1.y, c1.z, c1.w, sc1, sh21, c2.x, c2.y, c2.z, c2.w);
}

// The blend of one pixel `px` between its closest centroid c1 and its
// second c2, with d2 the squared distance to the second and den_sq
// d(c1, c2), as u8 RGB (kmeans_tpu/ops/kernels.py:1028-1054).
__device__ __forceinline__ void blend_rgb(float d2, float den_sq, float4 c1, float4 c2,
                                          const int* steps, uint32_t* rgb) {
  const float factor = __fdiv_rn(__fsqrt_rn(d2), __fsqrt_rn(den_sq));
  const float rest = __fsub_rn(1.0f, factor);
  int r8, g8, b8;
  lab_to_srgb8(__fadd_rn(__fmul_rn(factor, c1.x), __fmul_rn(rest, c2.x)),
               __fadd_rn(__fmul_rn(factor, c1.y), __fmul_rn(rest, c2.y)),
               __fadd_rn(__fmul_rn(factor, c1.z), __fmul_rn(rest, c2.z)), steps, &r8, &g8, &b8);
  rgb[0] = static_cast<uint32_t>(r8);
  rgb[1] = static_cast<uint32_t>(g8);
  rgb[2] = static_cast<uint32_t>(b8);
}

// The u8 RGB of one pixel alone: its one centroid `c`.
__device__ __forceinline__ void centroid_rgb(float4 c, const int* steps, uint32_t* rgb) {
  int r8, g8, b8;
  lab_to_srgb8(c.x, c.y, c.z, steps, &r8, &g8, &b8);
  rgb[0] = static_cast<uint32_t>(r8);
  rgb[1] = static_cast<uint32_t>(g8);
  rgb[2] = static_cast<uint32_t>(b8);
}

// Writes the 4 pixels' u8 RGB (bytes[12]) as the group's 3 words: word
// row j of the group holds bytes 4j .. 4j + 3 of R0 G0 B0 R1 G1 ...
__device__ __forceinline__ void store_group(const uint32_t (&bytes)[12],
                                            int32_t* __restrict__ out, int64_t tile, int64_t r,
                                            int lane, int blk) {
  const int64_t base = (tile * 3 * blk + r) * kLanes + lane;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const uint32_t word = bytes[4 * j] | (bytes[4 * j + 1] << 8) |
                          (bytes[4 * j + 2] << 16) | (bytes[4 * j + 3] << 24);
    out[base + static_cast<int64_t>(j) * blk * kLanes] = static_cast<int32_t>(word);
  }
}

template <int Metric, int Tier, int M, bool Chunked>
__global__ void __launch_bounds__(kThreads, min_blocks(Tier, Chunked)) meld_kernel(
    const uint8_t* __restrict__ rgb, int64_t n, int64_t frame_stride,
    const float* __restrict__ centroids, int kp, int chunk, int k_active,
    const int32_t* __restrict__ k_actives,
    const float* __restrict__ gtab_in, const float* __restrict__ gamma_lut,
    int tile_rows,
    int32_t* __restrict__ out, int64_t n_groups, int64_t frame_base) {
  constexpr int SP = tile_pixels(Metric, Tier, Chunked);  // pixels a scan takes
  constexpr int P = Chunked ? 4 : SP;                      // pixels held at a time
  constexpr bool kFast = Tier != kTierExact;
  extern __shared__ float4 smem4[];
  const int len = Chunked ? chunk : kp;  // centroids staged at a time
  float* lut = reinterpret_cast<float*>(smem4);       // [256]
  int* steps = reinterpret_cast<int*>(smem4 + 64);    // [256]
  float4* cent = smem4 + 128;                         // [len] (L, a, b, chroma)
  float4* g = cent + len;                             // [2 len], fast tiers only
  float* den = reinterpret_cast<float*>(g + (kFast ? 2 * len : 0));  // [kp * kp]
  const bool use_den = !Chunked && kp <= kDenTableMaxK;

  // The frame's operands.
  const int64_t f = frame_base + blockIdx.y;
  rgb += f * frame_stride * 3;
  centroids += f * kp * 3;
  if (kFast) gtab_in += f * kp * kGCols;
  if (k_actives != nullptr) k_active = k_actives[f];
  out += f * 3 * n_groups;

  for (int i = threadIdx.x; i < 256; i += kThreads) {
    lut[i] = gamma_lut[i];
    steps[i] = kSrgb8Steps[i];
  }
  bool staged_ok = true;
  if (!Chunked) {
    staged_ok = stage_cent4(centroids, 0, kp, cent);
    if (kFast) stage_feature_rows(gtab_in, g, kp);
  }
  const bool cents_ok = __syncthreads_and(staged_ok);
  if (use_den) {
    // From the launch operand, as `stage_cent4` stages it: the shared
    // table's loads stay the tile loop's alone.
    for (int i = threadIdx.x; i < kp * kp; i += kThreads) {
      den[i] = centroid_distance<Metric>(centroid4(centroids, i / kp),
                                         centroid4(centroids, i % kp));
    }
    __syncthreads();
  }

  const int64_t gi = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int blk = tile_rows / 4;
  const int64_t row = gi / kLanes;
  const int lane = static_cast<int>(gi % kLanes);
  const int64_t tile = row / blk;
  const int64_t r = row % blk;
  const bool active = gi < n_groups;
  auto pixel = [&](int s) {
    float l, a, b;
    pixel_lab(rgb, n, ((tile * tile_rows) + s * blk + r) * kLanes + lane, lut, &l, &a, &b);
    return cie94_pixel(l, a, b, kmeans::chroma(a, b));
  };
  uint32_t bytes[12];

  if constexpr (Chunked) {
    // Exact tier: the four pixels' two closest carry across the chunks,
    // SP pixels a scan.
    Cie94Pixel px[P];
    TwoClosest two[P];
    if (active) {
#pragma unroll
      for (int s = 0; s < P; ++s) px[s] = pixel(s);
    }
    for (int start = 0; start < k_active; start += chunk) {
      const int staged = min(chunk, kp - start);
      __syncthreads();  // the previous chunk's readers are done
      const bool chunk_ok = __syncthreads_and(stage_cent4(centroids, start, staged, cent));
      if (!active) continue;
#pragma unroll
      for (int s = 0; s < P; s += SP) {
        scan_exact_tile<Metric, SP>(reinterpret_cast<const Cie94Pixel(&)[SP]>(px[s]),
                                    reinterpret_cast<TwoClosest(&)[SP]>(two[s]), cent,
                                    min(staged, k_active - start), start, chunk_ok);
      }
    }
    if (!active) return;
#pragma unroll
    for (int s = 0; s < P; ++s) {
      if (k_active > 1) {
        const float4 c1 = centroid4(centroids, two[s].k1);
        const float4 c2 = centroid4(centroids, two[s].k2);
        blend_rgb(two[s].d2, centroid_distance<Metric>(c1, c2), c1, c2, steps, bytes + 3 * s);
      } else {
        centroid_rgb(make_float4(centroids[0], centroids[1], centroids[2], 0.0f), steps,
                     bytes + 3 * s);
      }
    }
  } else {
    if (!active) return;
#pragma unroll 1
    for (int s0 = 0; s0 < 4; s0 += P) {
      Cie94Pixel px[P];
      TwoClosest two[P];
#pragma unroll
      for (int s = 0; s < P; ++s) px[s] = pixel(s0 + s);
      if (k_active > 1) {
        scan_tile<Metric, Tier, M, P>(px, two, cent, g, k_active, 0, cents_ok);
      }
#pragma unroll
      for (int s = 0; s < P; ++s) {
        uint32_t* out_rgb = bytes + 3 * (s0 + s);
        if (k_active > 1) {
          const float4 c1 = cent[two[s].k1], c2 = cent[two[s].k2];
          float d2 = two[s].d2;
          if constexpr (Tier == kTierFactor) {
            // The carried score only ranks: the exact distance to the second.
            d2 = pixel_distance<Metric>(px[s].l, px[s].a, px[s].b, px[s].c1, px[s].sc,
                                        px[s].sh2, c2.x, c2.y, c2.z, c2.w);
          }
          const float den_sq = use_den ? den[two[s].k1 * kp + two[s].k2]
                                       : centroid_distance<Metric>(c1, c2);
          blend_rgb(d2, den_sq, c1, c2, steps, out_rgb);
        } else {
          centroid_rgb(cent[0], steps, out_rgb);
        }
      }
    }
  }
  store_group(bytes, out, tile, r, lane, blk);
}

}  // namespace

extern "C" {

// Launches the kernel over `frames` frames on `stream` and returns the
// launch's cudaError_t (0 on success). All pointers are device pointers:
// rgb the [n * 3] u8 pixels of frame 0, frame f's at pixel f * frame_stride
// (0: one image for every frame); centroids [frames * kp * 3] f32;
// k_actives [frames] i32, or null for `k_active` in every frame; metric 0
// (CIE94) or 1 (CIEDE2000), tier 0 (exact), 1 (factorized, CIE94 only) or 3
// (pruned, CIEDE2000 only, with prune_m 8 or 16); gtab [frames * kp * 7] f32
// for the fast tiers (else ignored); gamma_lut [256] f32; out
// [frames * 3 * n_groups] i32 with n_groups = n_pad / 4, n_pad a multiple
// of tile_rows * 128. A palette of more than `chunk` centroids is staged
// in chunks (exact tier only). Any number of frames: one launch per
// kMaxGridY of them. It allocates nothing and does not synchronise.
int kmeans_meld(const void* rgb, int64_t n, int64_t frame_stride, int frames,
                const void* centroids, int kp, int k_active, const void* k_actives,
                int chunk, int metric, int tier, const void* gtab, int prune_m,
                const void* gamma_lut, int tile_rows, void* out, int64_t n_groups,
                void* stream) {
  if (tile_rows % 4 != 0 || n_groups % (static_cast<int64_t>(tile_rows / 4) * kLanes) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using namespace kmeans;
  if (!tier_args_valid(metric, tier, gtab, prune_m, /*algebraic_ok=*/false)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool chunked = kp > chunk;
  if (frames < 1 || chunk < 1 || (chunked && tier != kTierExact)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = meld_kernel<kMetricCie94, kTierExact, 0, false>;
  if (chunked) {
    kernel = metric == kMetricCie2000 ? meld_kernel<kMetricCie2000, kTierExact, 0, true>
                                      : meld_kernel<kMetricCie94, kTierExact, 0, true>;
  } else if (tier == kTierFactor) {
    kernel = meld_kernel<kMetricCie94, kTierFactor, 0, false>;
  } else if (tier == kTierPrune) {
    kernel = prune_m == 8 ? meld_kernel<kMetricCie2000, kTierPrune, 8, false>
                          : meld_kernel<kMetricCie2000, kTierPrune, 16, false>;
  } else if (metric == kMetricCie2000) {
    kernel = meld_kernel<kMetricCie2000, kTierExact, 0, false>;
  }
  if (tier == kTierExact) gtab = nullptr;
  const int64_t blocks = (n_groups + kThreads - 1) / kThreads;
  const size_t len = static_cast<size_t>(chunked ? chunk : kp);
  const size_t den = !chunked && kp <= kDenTableMaxK ? static_cast<size_t>(kp) * kp : 0;
  const size_t smem = sizeof(float4) * (128 + len * (gtab ? 3 : 1)) + sizeof(float) * den;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  for (int64_t base = 0; base < frames; base += kMaxGridY) {
    const int64_t left = static_cast<int64_t>(frames) - base;
    const int64_t group = left < kMaxGridY ? left : kMaxGridY;
    kernel<<<dim3(static_cast<unsigned int>(blocks), static_cast<unsigned int>(group)),
             kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(rgb), n, frame_stride,
        static_cast<const float*>(centroids), kp, chunk, k_active,
        static_cast<const int32_t*>(k_actives), static_cast<const float*>(gtab),
        static_cast<const float*>(gamma_lut), tile_rows, static_cast<int32_t*>(out),
        n_groups, base);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
