// Fused assign pass for Hopper (sm_90a): u8 sRGB -> Lab -> (Bayer dither)
// -> CIE94 or CIEDE2000 argmin over a palette -> one of three outputs:
// bit-packed palette indices, the palette colour as an RGBA word, or the
// palette index as one byte.
//
// Replaces the Pallas TPU kernel `kmeans_tpu/ops/kernels.py::_quantize_kernel`
// in its replace/dither modes: packed-index mode (`fused_assign_packed`),
// colour-out mode (`fused_quantize`, the packed RGBA words of
// `_packed_palette`), u8-index mode (`fused_assign`), and the frames batch
// (`_run_quantize_kernel_frames`: `fused_assign_frames_packed`,
// `fused_quantize_frames`), with the exact CIE94 and CIEDE2000 metrics and
// their fast tiers: the factorized CIE94 score (`:845-847`, `:885-886`) and
// the pruned CIEDE2000 tier (`:892-936`), whose device functions live in
// screen.cuh. Under exact CIE94 the words it writes equal the reference's
// word for word, pad bits included: the plain PyTorch twins in
// `kmeans_tpu_torch/ops/kernels.py` (`assign_packed_reference`,
// `quantize_rgba_reference`, `assign_u8_reference` and the frames twins)
// are the spec of every mode and tier.
//
// Design (for the GPU, not a block-by-block copy of the TPU kernel):
// - Word (tile t, row r < blk, lane l), with blk = tile_rows / ppw and
//   ppw = 32 / bits, holds the pixels
//   p_j = ((t * tile_rows) + j * blk + r) * 128 + l for j < ppw, index j at
//   bit bits * j. A word is written by one thread, so no packing crosses
//   threads. The RGBA and u8 outputs take bits = 32: word g is pixel g.
// - Every tier and output mode is one kernel (`assign_kernel`) that keeps P
//   pixels of a thread in registers (`tile_pixels`: 2 under CIE94, exact
//   or factorized, 1 under CIEDE2000, exact or pruned: the fastest the
//   card measured) and runs the centroid loop
//   outermost (screen.cuh::scan_tile): one 16-byte shared load of a
//   centroid's (L, a, b, chroma), or two of its padded feature row, serve
//   the P pixels, and their independent distances fill the pipeline. A
//   word of ppw > P pixels is computed P at a time; with ppw < P a thread
//   owns P / ppw words, strided by the block's width so that stores stay
//   coalesced. Under exact CIE94 the two divides of a distance take the
//   pixel's hoisted reciprocals (recip.cuh::div_by_recip, exact by
//   Markstein's theorem in the range `Cie94Pixel` and `cie94_centroid_ok`
//   hold the operands to); a tile whose small dividends leave that range
//   is rescanned with IEEE divides (screen.cuh::rescan_cie94), so every
//   word is the twin's. The pruned tier builds each pixel's candidate list
//   from packed 32-bit keys, a sorting network and then a gated insertion
//   (screen.cuh::prune_screen): the list `TopM::insert` builds, without
//   its walk of floats and indices.
// - Pixels p >= n are the reference's zero padding: RGB (0, 0, 0), with
//   their own argmin and dither coordinates like any pixel.
// - Input is the [H, W, 3] u8 RGB image as uploaded (3 B/px); alpha is
//   ignored everywhere in the pipeline.
// - Frames: frame f = frame_base + blockIdx.y. Its blocks read the image at pixel
//   offset f * frame_stride (a stride of 0 puts one image through every
//   frame's palette), stage frame f's palette, k_active and threshold
//   (and, under the fast tiers, its feature-table rows) and write frame f's
//   n_words outputs. Each frame pads to whole tiles and its dither phase
//   starts at its own row 0, so frame f's slice of the output has exactly
//   the single-image layout (kmeans_tpu/ops/kernels.py:1940-1946). A single
//   image is one frame. The grid's y extent stops at 65,535, so the
//   launcher issues the frames in groups of at most that many, each group
//   with its first frame as `frame_base`: every offset is taken from the
//   frame's own number, so a group's frame sees its own layout and phase.
// - The 256-entry gamma table, the centroids, each centroid's chroma and,
//   for the RGBA output, the packed palette words live in shared memory;
//   every pixel visits the centroids k < k_active in index order with
//   strict `<`, so the first minimum wins. A palette larger than `chunk`
//   centroids (the `Chunked` instances, exact tier only, RGBA and u8
//   output) is staged `chunk` centroids at a time: each pixel's closest
//   carries across chunks with the same strict `<`, so the result is the
//   one loop's, and the RGBA word of a new winner is taken from the chunk
//   that holds it. Any k is one launch.
// - The metric, the tier and the pruned tier's candidate count m are
//   template parameters; the launcher picks the instance from its runtime
//   arguments. The fast tiers stage the `[kp, 7]` feature table padded to
//   8 columns (32 B a centroid, 16 KB at kp = 512) in shared memory next
//   to the centroids.
// - Under the pruned tier a thread keeps one pixel's candidate keys live
//   at a time: 2 m registers (m = 8 or 16, the list and a batch), filled
//   by the screening loop and emptied by the exact pass before the
//   thread's next pixel.
//
// Float rounding: every operation is one IEEE float32 operation in the
// reference's order, written with the _rn intrinsics so that none is fused
// into an FMA, and the library is built with --fmad=false as well. Plain
// PyTorch runs one operation per launch, so it never contracts either; a
// contraction here would make near-tie pixels pick another centroid.
// Divisions are the IEEE ones (no --use_fast_math), or under exact CIE94
// the hoisted-reciprocal quotient that equals them bit for bit; square
// roots are the IEEE ones. `powf` is the CUDA math library's, the same
// function PyTorch's CUDA `pow` calls.
//
// What bounds it on this card: at k = 8 it reads 3 B/px and writes at most
// 0.5 B/px (4 B/px for RGBA), so instructions, not memory, bound it. Before
// the tiled form, an exact CIE94 pixel-centroid pair cost 50 instructions
// (two IEEE divide subroutines, each a reciprocal, its refinement, a range
// check and a branch); the tiled loop costs about 30 and runs at the
// card's full instruction rate. At small k the per-pixel Lab conversion
// (three `powf`, the white point's divides through constant reciprocals)
// weighs as much as the loop. Under CIEDE2000 the per-centroid atan2f,
// sinf, cosf and expf calls set the pace and leave no registers for a
// tile. The fast tiers take the divides out of the centroid loop: 12
// operations and a compare per centroid, 18 instructions a pair in the
// factorized tile (the score's order leaves no fusing); under prune, a
// vote and a branch, the list's insertion where a lane needs it, plus m
// exact distances.

#include <cuda_runtime.h>
#include <stdint.h>

#include "colorspace.cuh"
#include "delta_e.cuh"
#include "screen.cuh"

namespace {

using namespace kmeans;

constexpr int kLanes = 128;
constexpr int kThreads = 256;
// The output forms (`ASSIGN_OUTPUTS` in kmeans_tpu_torch/ops/kernels.py).
constexpr int kOutPacked = 0;  // bit-packed indices, ppw per int32 word
constexpr int kOutRgba = 1;    // the palette's RGBA word, one int32 a pixel
constexpr int kOutU8 = 2;      // the palette index, one byte a pixel
// The largest grid y extent: frames beyond it go in another launch.
constexpr int64_t kMaxGridY = 65535;

// (M4[y % 4][x % 4] / 16) - 0.5 in closed form
// (kmeans_tpu/ops/kernels.py::_bayer_value).
__device__ __forceinline__ float bayer_value(int64_t x, int64_t y) {
  const int lo = (2 * static_cast<int>(x & 1) + 3 * static_cast<int>(y & 1)) & 3;
  const int hi =
      (2 * static_cast<int>((x >> 1) & 1) + 3 * static_cast<int>((y >> 1) & 1)) & 3;
  const float m = static_cast<float>(4 * lo + hi);
  return __fsub_rn(__fdiv_rn(m, 16.0f), 0.5f);
}

// Lab of pixel p, moved by the dither adjustment when `dither` is set.
__device__ __forceinline__ void pixel_lab_dithered(const uint8_t* __restrict__ rgb,
                                                   int64_t n, int64_t p, const float* lut,
                                                   int dither, float thr, int64_t width,
                                                   int64_t row_offset, float* l, float* a,
                                                   float* b) {
  // sRGB -> Lab (kmeans_tpu/ops/kernels.py::_lab_from_linear_planes).
  pixel_lab(rgb, n, p, lut, l, a, b);
  if (dither) {
    int64_t px, py;
    if (((p | width) >> 31) == 0) {  // a 32-bit division where it suffices
      px = static_cast<uint32_t>(p) % static_cast<uint32_t>(width);
      py = static_cast<uint32_t>(p) / static_cast<uint32_t>(width) + row_offset;
    } else {
      px = p % width;
      py = p / width + row_offset;
    }
    const float adjust = __fmul_rn(thr, bayer_value(px, py));
    *l = __fadd_rn(*l, adjust);
    *a = __fadd_rn(*a, adjust);
    *b = __fadd_rn(*b, adjust);
  }
}

// Pixels a thread keeps in registers under (metric, tier), and the blocks
// of kThreads an SM must hold (`__launch_bounds__`): the pairs measured
// fastest without spills.
__host__ __device__ constexpr int tile_pixels(int metric, int tier) {
  return metric == kMetricCie94 ? 2 : 1;  // exact or factorized CIE94; CIEDE2000
}
__host__ __device__ constexpr int min_blocks(int tier, int m) {
  return tier == kTierPrune ? (m == 8 ? 4 : 3) : 4;
}

// The assign kernel, every tier and output mode. A thread owns P pixels
// (`tile_pixels`): words of ppw >= P pixels are computed P at a time, and
// with ppw < P a thread owns P / ppw words, strided by the block's width
// so that the stores stay coalesced. The P pixels go through
// `screen.cuh::scan_tile` together. A palette larger than `chunk`
// centroids (`Chunked`, exact tier, RGBA and u8 output only) is staged
// `chunk` centroids at a time: each pixel's closest carries across chunks
// with the same strict `<`, so the result is the one loop's, and the RGBA
// word of a new winner is taken from the chunk that holds it.
template <int Metric, int Tier, int M, bool Chunked>
__global__ void __launch_bounds__(kThreads, min_blocks(Tier, M)) assign_kernel(
    const uint8_t* __restrict__ rgb, int64_t n, int64_t width, int64_t frame_stride,
    const float* __restrict__ centroids, int kp, int chunk, int k_active,
    const int32_t* __restrict__ k_actives, const float* __restrict__ gtab_in,
    const int32_t* __restrict__ palette_in, const float* __restrict__ gamma_lut,
    const float* __restrict__ thresholds, int dither, int64_t row_offset, int out_mode,
    int bits, int tile_rows, void* __restrict__ out, int64_t n_words, int64_t frame_base) {
  constexpr int P = tile_pixels(Metric, Tier);
  constexpr bool kFast = Tier != kTierExact;
  extern __shared__ float4 smem4[];
  const int len = Chunked ? chunk : kp;  // centroids staged at a time
  float* lut = reinterpret_cast<float*>(smem4);  // [256]
  float4* cent = smem4 + 64;                     // [len] (L, a, b, chroma)
  float4* g = cent + len;                        // [2 len], fast tiers only
  int32_t* pal = out_mode == kOutRgba ? reinterpret_cast<int32_t*>(g + (kFast ? 2 * len : 0))
                                      : nullptr;  // [len], RGBA output only

  // The frame's operands.
  const int64_t f = frame_base + blockIdx.y;
  rgb += f * frame_stride * 3;
  centroids += f * kp * 3;
  if (kFast) gtab_in += f * kp * kGCols;
  if (palette_in != nullptr) palette_in += f * kp;
  if (k_actives != nullptr) k_active = k_actives[f];
  const float thr = dither ? thresholds[f] : 0.0f;

  for (int i = threadIdx.x; i < 256; i += kThreads) lut[i] = gamma_lut[i];
  bool staged_ok = true;
  if (!Chunked) {
    staged_ok = stage_cent4(centroids, 0, kp, cent);
    if (kFast) stage_feature_rows(gtab_in, g, kp);
    if (pal != nullptr) {
      for (int i = threadIdx.x; i < kp; i += kThreads) pal[i] = palette_in[i];
    }
  }
  const bool cents_ok = __syncthreads_and(staged_ok);

  // Word layout: ppw pixels a word, spw of them in each of `passes`
  // tiles, P / spw words a thread. ppw, spw and blk = tile_rows / ppw are
  // powers of two (the launcher checks), so the index math shifts.
  const int ppw = 32 / bits;
  const int spw = ppw < P ? ppw : P;
  const int log_spw = __ffs(spw) - 1;
  const int passes = ppw >> log_spw;
  const int blk = tile_rows / ppw;
  const int log_blk = __ffs(blk) - 1;
  const int64_t g0 =
      static_cast<int64_t>(blockIdx.x) * (kThreads * (P >> log_spw)) + threadIdx.x;

  // Under the factorized tier a pixel is its screening factors alone.
  using Pixel = std::conditional_t<Tier == kTierFactor, ScreenFactors, Cie94Pixel>;
  Pixel px[P];
  Closest best[P];
  auto load_tile = [&](int pass) {
#pragma unroll
    for (int s = 0; s < P; ++s) {
      const int64_t gw = g0 + static_cast<int64_t>(s >> log_spw) * kThreads;
      const int j = pass * spw + (s & (spw - 1));
      const int64_t row = gw / kLanes;
      const int64_t p = (((row >> log_blk) * tile_rows + j * blk + (row & (blk - 1))) * kLanes) +
                        gw % kLanes;
      float l, a, b;
      pixel_lab_dithered(rgb, n, p, lut, dither, thr, width, row_offset, &l, &a, &b);
      if constexpr (Tier == kTierFactor) {
        px[s] = screen_factors(l, a, b, kmeans::chroma(a, b));
      } else {
        px[s] = cie94_pixel(l, a, b, kmeans::chroma(a, b));
      }
      best[s] = Closest{};
    }
  };

  if constexpr (Chunked) {
    // One pixel a word (RGBA or u8 output): P words a thread.
    int32_t rgba[P];
    load_tile(0);
    for (int start = 0; start < k_active; start += chunk) {
      const int staged = min(chunk, kp - start);
      __syncthreads();  // the previous chunk's readers are done
      const bool ok = stage_cent4(centroids, start, staged, cent);
      if (pal != nullptr) {
        for (int i = threadIdx.x; i < staged; i += kThreads) pal[i] = palette_in[start + i];
      }
      const bool chunk_ok = __syncthreads_and(ok);
      scan_exact_tile<Metric, P>(px, best, cent, min(staged, k_active - start), start,
                                 chunk_ok);
      if (pal != nullptr) {
#pragma unroll
        for (int s = 0; s < P; ++s) {
          if (best[s].k >= start) rgba[s] = pal[best[s].k - start];
        }
      }
    }
#pragma unroll
    for (int s = 0; s < P; ++s) {
      const int64_t gw = g0 + static_cast<int64_t>(s) * kThreads;
      if (gw >= n_words) continue;
      if (out_mode == kOutU8) {
        static_cast<uint8_t*>(out)[f * n_words + gw] = static_cast<uint8_t>(best[s].k);
      } else {
        static_cast<int32_t*>(out)[f * n_words + gw] = rgba[s];
      }
    }
  } else {
    uint32_t word = 0;
#pragma unroll 1
    for (int pass = 0; pass < passes; ++pass) {
      load_tile(pass);
      scan_tile<Metric, Tier, M, P>(px, best, cent, g, k_active, 0, cents_ok);
#pragma unroll
      for (int s = 0; s < P; ++s) {
        const int j = pass * spw + (s & (spw - 1));
        word |= static_cast<uint32_t>(best[s].k) << (bits * j);
        if (j != ppw - 1) continue;  // the word's last pixel writes it
        const int64_t gw = g0 + static_cast<int64_t>(s >> log_spw) * kThreads;
        if (gw < n_words) {
          if (out_mode == kOutU8) {
            static_cast<uint8_t*>(out)[f * n_words + gw] = static_cast<uint8_t>(best[s].k);
          } else {
            static_cast<int32_t*>(out)[f * n_words + gw] =
                out_mode == kOutRgba ? pal[best[s].k] : static_cast<int32_t>(word);
          }
        }
        word = 0;
      }
    }
  }
}

// Launches `kernel` over `frames` frames in groups of at most kMaxGridY
// (the grid's y extent), each group with its first frame as the kernel's
// last argument, and returns the first launch error (0 on success).
template <typename... Params, typename... Args>
int launch_frames(void (*kernel)(Params...), int64_t blocks, int64_t frames, size_t smem,
                  void* stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  for (int64_t base = 0; base < frames; base += kMaxGridY) {
    const int64_t left = frames - base;
    const int64_t group = left < kMaxGridY ? left : kMaxGridY;
    kernel<<<dim3(static_cast<unsigned int>(blocks), static_cast<unsigned int>(group)),
             kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args..., base);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
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
// for the fast tiers (else ignored); palette [frames * kp] i32 RGBA words
// for out_mode 1 (else ignored); gamma_lut [256] f32; thresholds [frames]
// f32 (read under dither only); out_mode 0 (packed indices, `bits` per
// index), 1 (RGBA words) or 2 (u8 indices), the last two with bits = 32;
// out [frames * n_words] i32 (u8 for out_mode 2) with n_words = n_pad / ppw,
// n_pad a multiple of tile_rows * 128. A palette of more than `chunk`
// centroids is staged in chunks: exact tier, out_mode 1 or 2 only. Any
// number of frames: one launch per kMaxGridY of them. It allocates nothing
// and does not synchronise.
int kmeans_assign(const void* rgb, int64_t n, int64_t width, int64_t frame_stride,
                  int frames, const void* centroids, int kp, int k_active,
                  const void* k_actives, int chunk, int metric, int tier,
                  const void* gtab, int prune_m, const void* palette,
                  const void* gamma_lut, const void* thresholds, int dither,
                  int64_t row_offset, int out_mode, int bits, int tile_rows,
                  void* out, int64_t n_words, void* stream) {
  using namespace kmeans;
  if (!tier_args_valid(metric, tier, gtab, prune_m, /*algebraic_ok=*/false)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool chunked = kp > chunk;
  if (out_mode < kOutPacked || out_mode > kOutU8 || frames < 1 || chunk < 1 ||
      (out_mode != kOutPacked && bits != 32) || (out_mode == kOutRgba && palette == nullptr) ||
      (chunked && (tier != kTierExact || out_mode == kOutPacked))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ppw = 32 / bits;
  const int blk = tile_rows / ppw;
  if ((32 % bits) != 0 || (ppw & (ppw - 1)) != 0 || blk < 1 || blk * ppw != tile_rows ||
      (blk & (blk - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t len = static_cast<size_t>(chunked ? chunk : kp);
  const size_t pal_bytes = out_mode == kOutRgba ? sizeof(int32_t) * len : 0;
  const int64_t n_groups = static_cast<int64_t>(frames);
  auto kernel = assign_kernel<kMetricCie94, kTierExact, 0, false>;
  if (tier == kTierFactor) {
    kernel = assign_kernel<kMetricCie94, kTierFactor, 0, false>;
  } else if (tier == kTierPrune) {
    kernel = prune_m == 8 ? assign_kernel<kMetricCie2000, kTierPrune, 8, false>
                          : assign_kernel<kMetricCie2000, kTierPrune, 16, false>;
  } else if (metric == kMetricCie2000) {
    kernel = chunked ? assign_kernel<kMetricCie2000, kTierExact, 0, true>
                     : assign_kernel<kMetricCie2000, kTierExact, 0, false>;
  } else if (chunked) {
    kernel = assign_kernel<kMetricCie94, kTierExact, 0, true>;
  }
  if (tier == kTierExact) gtab = nullptr;
  // Words a thread owns: P / ppw when a word holds fewer than P pixels.
  const int p = tile_pixels(metric, tier);
  const int64_t per_block = static_cast<int64_t>(kThreads) * (ppw < p ? p / ppw : 1);
  const int64_t blocks = (n_words + per_block - 1) / per_block;
  const size_t smem =
      sizeof(float) * 256 + sizeof(float4) * len * (tier == kTierExact ? 1 : 3) + pal_bytes;
  return launch_frames(kernel, blocks, n_groups, smem, stream, static_cast<const uint8_t*>(rgb),
                       n, width, frame_stride, static_cast<const float*>(centroids), kp, chunk,
                       k_active, static_cast<const int32_t*>(k_actives),
                       static_cast<const float*>(gtab),
                       static_cast<const int32_t*>(out_mode == kOutRgba ? palette : nullptr),
                       static_cast<const float*>(gamma_lut),
                       static_cast<const float*>(thresholds), dither, row_offset, out_mode,
                       bits, tile_rows, out, n_words);
}

const char* kmeans_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
