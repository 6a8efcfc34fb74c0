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
// - One thread per output word. Word (tile t, row r < blk, lane l), with
//   blk = tile_rows / ppw and ppw = 32 / bits, holds the pixels
//   p_j = ((t * tile_rows) + j * blk + r) * 128 + l for j < ppw, index j at
//   bit bits * j. The thread computes its ppw pixels and writes one int32,
//   so no packing crosses threads. The RGBA and u8 outputs take bits = 32:
//   one pixel per thread, word g is pixel g.
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
//   the centroid loop is a runtime loop over k < k_active with strict `<`,
//   so the first minimum wins. A palette larger than `chunk` centroids
//   (the `Chunked` instances, exact tier only, one pixel per thread) is
//   staged `chunk` centroids at a time: the closest carries across chunks
//   with the same strict `<`, so the result is the one loop's, and the
//   RGBA word of a new winner is taken from the chunk that holds it. Any k
//   is one launch.
// - The metric, the tier and the pruned tier's candidate count m are
//   template parameters (screen.cuh::nearest_centroid); the launcher picks
//   one of seven instances from its runtime arguments. The fast tiers stage
//   the `[kp, 7]` feature table (28 B a centroid, 14 KB at kp = 512) in
//   shared memory next to the centroids.
// - Under the pruned tier a thread keeps one pixel's candidate list live at
//   a time: 2 m registers (m = 8 or 16), filled by the screening loop and
//   emptied by the exact pass before the thread's next pixel.
//
// Float rounding: every operation is one IEEE float32 operation in the
// reference's order, written with the _rn intrinsics so that none is fused
// into an FMA, and the library is built with --fmad=false as well. Plain
// PyTorch runs one operation per launch, so it never contracts either; a
// contraction here would make near-tie pixels pick another centroid.
// Divisions and square roots are the IEEE ones (no --use_fast_math).
// `powf` is the CUDA math library's, the same function PyTorch's CUDA
// `pow` calls.
//
// What bounds it on this card: at k = 8 it reads 3 B/px and writes at most
// 0.5 B/px (4 B/px for RGBA), so the per-pixel powf calls and the
// per-pixel, per-centroid divides and square root, not memory bandwidth,
// are the likely bound; under CIEDE2000 the per-centroid atan2f, sinf,
// cosf and expf calls more so. The fast tiers take those out of the
// centroid loop: 12 operations and a compare per centroid (plus the list
// insertion under prune, plus m exact distances). Left for later: a
// fused-multiply-add form of the score and vectorised 16-byte loads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "colorspace.cuh"
#include "delta_e.cuh"
#include "screen.cuh"

namespace {

using namespace kmeans;

constexpr int kLanes = 128;
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
    const int64_t px = p % width;
    const int64_t py = p / width + row_offset;
    const float adjust = __fmul_rn(thr, bayer_value(px, py));
    *l = __fadd_rn(*l, adjust);
    *a = __fadd_rn(*a, adjust);
    *b = __fadd_rn(*b, adjust);
  }
}

// Copies centroids [start, start + len) of the frame's palette into shared
// memory with their chroma, their feature-table rows (fast tiers) and
// their RGBA words (RGBA output): the tables the centroid loop reads.
__device__ __forceinline__ void stage_centroids(const float* __restrict__ centroids,
                                                const float* __restrict__ gtab_in,
                                                const int32_t* __restrict__ palette_in,
                                                int start, int len, float* cent,
                                                float* chroma, float* gtab, int32_t* pal) {
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const int k = start + i;
    const float ca = centroids[3 * k + 1];
    const float cb = centroids[3 * k + 2];
    cent[3 * i + 0] = centroids[3 * k + 0];
    cent[3 * i + 1] = ca;
    cent[3 * i + 2] = cb;
    chroma[i] = kmeans::chroma(ca, cb);
    if (pal != nullptr) pal[i] = palette_in[k];
  }
  stage_g_table(gtab_in == nullptr ? nullptr : gtab_in + kGCols * start, gtab, len);
}

// Adds `base` to every index a carry sees: the scan of a staged chunk
// numbers its centroids from 0.
template <typename Carry>
struct OffsetCarry {
  Carry* carry;
  int base;
  __device__ __forceinline__ void update(float d, int k) { carry->update(d, base + k); }
};

template <int Metric, int Tier, int M, bool Chunked>
__global__ void assign_kernel(
    const uint8_t* __restrict__ rgb, int64_t n, int64_t width, int64_t frame_stride,
    const float* __restrict__ centroids, int kp, int chunk, int k_active,
    const int32_t* __restrict__ k_actives,
    const float* __restrict__ gtab_in, const int32_t* __restrict__ palette_in,
    const float* __restrict__ gamma_lut, const float* __restrict__ thresholds,
    int dither, int64_t row_offset, int out_mode, int bits, int tile_rows,
    void* __restrict__ out, int64_t n_words, int64_t frame_base) {
  extern __shared__ float smem[];
  const int len = Chunked ? chunk : kp;  // centroids staged at a time
  float* lut = smem;                // [256]
  float* cent = smem + 256;         // [len * 3]
  float* chroma = cent + 3 * len;   // [len]
  float* gtab = chroma + len;       // [len * 7], fast tiers only
  int32_t* pal = out_mode == kOutRgba
                     ? reinterpret_cast<int32_t*>(gtab + (gtab_in ? kGCols * len : 0))
                     : nullptr;     // [len], RGBA output only

  // The frame's operands.
  const int64_t f = frame_base + blockIdx.y;
  rgb += f * frame_stride * 3;
  centroids += f * kp * 3;
  if (gtab_in != nullptr) gtab_in += f * kp * kGCols;
  if (palette_in != nullptr) palette_in += f * kp;
  if (k_actives != nullptr) k_active = k_actives[f];
  const float thr = dither ? thresholds[f] : 0.0f;

  for (int i = threadIdx.x; i < 256; i += blockDim.x) lut[i] = gamma_lut[i];
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;

  if constexpr (Chunked) {
    // One pixel per thread (RGBA or u8 output), exact tier.
    const bool active = g < n_words;
    float l = 0.0f, a = 0.0f, b = 0.0f, c1 = 0.0f;
    Closest best;
    int32_t word = 0;
    for (int start = 0; start < k_active; start += chunk) {
      const int staged = min(chunk, kp - start);
      __syncthreads();  // the previous chunk's readers are done
      stage_centroids(centroids, nullptr, palette_in, start, staged, cent, chroma, nullptr,
                      pal);
      __syncthreads();
      if (!active) continue;
      if (start == 0) {
        pixel_lab_dithered(rgb, n, g, lut, dither, thr, width, row_offset, &l, &a, &b);
        c1 = kmeans::chroma(a, b);
      }
      OffsetCarry<Closest> carry{&best, start};
      scan_centroids<Metric, kTierExact, 0>(l, a, b, c1, cent, chroma, nullptr,
                                            min(staged, k_active - start), &carry);
      if (pal != nullptr && best.k >= start) word = pal[best.k - start];
    }
    if (!active) return;
    if (out_mode == kOutU8) {
      static_cast<uint8_t*>(out)[f * n_words + g] = static_cast<uint8_t>(best.k);
    } else {
      static_cast<int32_t*>(out)[f * n_words + g] = word;
    }
  } else {
    stage_centroids(centroids, gtab_in, palette_in, 0, kp, cent, chroma, gtab, pal);
    __syncthreads();
    if (g >= n_words) return;

    const int ppw = 32 / bits;
    const int blk = tile_rows / ppw;
    const int64_t row = g / kLanes;
    const int lane = static_cast<int>(g % kLanes);
    const int64_t tile = row / blk;
    const int64_t r = row % blk;

    uint32_t word = 0;
    int best_k = 0;
    for (int j = 0; j < ppw; ++j) {
      const int64_t p = ((tile * tile_rows) + j * blk + r) * kLanes + lane;
      float l, a, b;
      pixel_lab_dithered(rgb, n, p, lut, dither, thr, width, row_offset, &l, &a, &b);
      float best_d;
      nearest_centroid<Metric, Tier, M>(l, a, b, cent, chroma, gtab, k_active, &best_k,
                                        &best_d);
      word |= static_cast<uint32_t>(best_k) << (bits * j);
    }
    if (out_mode == kOutU8) {
      static_cast<uint8_t*>(out)[f * n_words + g] = static_cast<uint8_t>(best_k);
    } else {
      static_cast<int32_t*>(out)[f * n_words + g] =
          out_mode == kOutRgba ? pal[best_k] : static_cast<int32_t>(word);
    }
  }
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
  auto kernel = assign_kernel<kMetricCie94, kTierExact, 0, false>;
  if (chunked) {
    kernel = metric == kMetricCie2000 ? assign_kernel<kMetricCie2000, kTierExact, 0, true>
                                      : assign_kernel<kMetricCie94, kTierExact, 0, true>;
  } else if (tier == kTierFactor) {
    kernel = assign_kernel<kMetricCie94, kTierFactor, 0, false>;
  } else if (tier == kTierPrune) {
    kernel = prune_m == 8 ? assign_kernel<kMetricCie2000, kTierPrune, 8, false>
                          : assign_kernel<kMetricCie2000, kTierPrune, 16, false>;
  } else if (metric == kMetricCie2000) {
    kernel = assign_kernel<kMetricCie2000, kTierExact, 0, false>;
  }
  if (tier == kTierExact) gtab = nullptr;
  if (out_mode != kOutRgba) palette = nullptr;
  const int threads = 256;
  const int64_t blocks = (n_words + threads - 1) / threads;
  const size_t len = static_cast<size_t>(chunked ? chunk : kp);
  const size_t smem = sizeof(float) * (256 + (4 + (gtab ? kGCols : 0) + (palette ? 1 : 0)) * len);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  for (int64_t base = 0; base < frames; base += kMaxGridY) {
    const int64_t left = static_cast<int64_t>(frames) - base;
    const int64_t group = left < kMaxGridY ? left : kMaxGridY;
    kernel<<<dim3(static_cast<unsigned int>(blocks), static_cast<unsigned int>(group)),
             threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(rgb), n, width, frame_stride,
        static_cast<const float*>(centroids), kp, chunk, k_active,
        static_cast<const int32_t*>(k_actives), static_cast<const float*>(gtab),
        static_cast<const int32_t*>(palette), static_cast<const float*>(gamma_lut),
        static_cast<const float*>(thresholds), dither, row_offset, out_mode, bits,
        tile_rows, out, n_words, base);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kmeans_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
