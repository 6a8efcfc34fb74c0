// Fused assign pass for Hopper (sm_90a): u8 sRGB -> Lab -> (Bayer dither)
// -> CIE94 or CIEDE2000 argmin over a palette -> bit-packed palette indices.
//
// Replaces the Pallas TPU kernel `kmeans_tpu/ops/kernels.py::_quantize_kernel`
// in packed-index mode (`fused_assign_packed`), for replace and dither with
// the exact CIE94 and CIEDE2000 metrics and their fast tiers: the
// factorized CIE94 score (`:845-847`, `:885-886`) and the pruned CIEDE2000
// tier (`:892-936`), whose device functions live in screen.cuh. Under exact
// CIE94 the words it writes equal the reference's word for word, pad bits
// included: the plain PyTorch twin
// `kmeans_tpu_torch/ops/kernels.py::assign_packed_reference` is the spec of
// every tier.
//
// Design (for the GPU, not a block-by-block copy of the TPU kernel):
// - One thread per output word. Word (tile t, row r < blk, lane l), with
//   blk = tile_rows / ppw and ppw = 32 / bits, holds the pixels
//   p_j = ((t * tile_rows) + j * blk + r) * 128 + l for j < ppw, index j at
//   bit bits * j. The thread computes its ppw pixels and writes one int32,
//   so no packing crosses threads.
// - Pixels p >= n are the reference's zero padding: RGB (0, 0, 0), with
//   their own argmin and dither coordinates like any pixel.
// - Input is the [H, W, 3] u8 RGB image as uploaded (3 B/px); alpha is
//   ignored everywhere in the pipeline.
// - The 256-entry gamma table, the centroids and each centroid's chroma
//   live in shared memory; the centroid loop is a runtime loop over
//   k < k_active with strict `<`, so the first minimum wins and no
//   compile-time cap on k exists (k = 1024 uses 16 KB).
// - The metric, the tier and the pruned tier's candidate count m are
//   template parameters (screen.cuh::nearest_centroid); the launcher picks
//   one of five instances from its runtime arguments. The fast tiers stage
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
// 0.5 B/px, so the per-pixel powf calls and the per-pixel, per-centroid
// divides and square root, not memory bandwidth, are the likely bound;
// under CIEDE2000 the per-centroid atan2f, sinf, cosf and expf calls more
// so. The fast tiers take those out of the centroid loop: 12 operations
// and a compare per centroid (plus the list insertion under prune, plus m
// exact distances). Left for later: a fused-multiply-add form of the score,
// vectorised 16-byte loads, and the colour-out mode.

#include <cuda_runtime.h>
#include <stdint.h>

#include "colorspace.cuh"
#include "delta_e.cuh"
#include "screen.cuh"

namespace {

using namespace kmeans;

constexpr int kLanes = 128;

// (M4[y % 4][x % 4] / 16) - 0.5 in closed form
// (kmeans_tpu/ops/kernels.py::_bayer_value).
__device__ __forceinline__ float bayer_value(int64_t x, int64_t y) {
  const int lo = (2 * static_cast<int>(x & 1) + 3 * static_cast<int>(y & 1)) & 3;
  const int hi =
      (2 * static_cast<int>((x >> 1) & 1) + 3 * static_cast<int>((y >> 1) & 1)) & 3;
  const float m = static_cast<float>(4 * lo + hi);
  return __fsub_rn(__fdiv_rn(m, 16.0f), 0.5f);
}

template <int Metric, int Tier, int M>
__global__ void assign_packed_kernel(
    const uint8_t* __restrict__ rgb, int64_t n, int64_t width,
    const float* __restrict__ centroids, int kp, int k_active,
    const float* __restrict__ gtab_in, const float* __restrict__ gamma_lut,
    const float* __restrict__ threshold,
    int dither, int64_t row_offset, int bits, int tile_rows,
    int32_t* __restrict__ out, int64_t n_words) {
  extern __shared__ float smem[];
  float* lut = smem;               // [256]
  float* cent = smem + 256;        // [kp * 3]
  float* chroma = cent + 3 * kp;   // [kp]
  float* gtab = chroma + kp;       // [kp * 7], fast tiers only

  stage_g_table(gtab_in, gtab, kp);
  for (int i = threadIdx.x; i < 256; i += blockDim.x) lut[i] = gamma_lut[i];
  for (int i = threadIdx.x; i < kp; i += blockDim.x) {
    const float ca = centroids[3 * i + 1];
    const float cb = centroids[3 * i + 2];
    cent[3 * i + 0] = centroids[3 * i + 0];
    cent[3 * i + 1] = ca;
    cent[3 * i + 2] = cb;
    chroma[i] = kmeans::chroma(ca, cb);
  }
  __syncthreads();

  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= n_words) return;

  const int ppw = 32 / bits;
  const int blk = tile_rows / ppw;
  const int64_t row = g / kLanes;
  const int lane = static_cast<int>(g % kLanes);
  const int64_t tile = row / blk;
  const int64_t r = row % blk;
  const float thr = dither ? threshold[0] : 0.0f;

  uint32_t word = 0;
  for (int j = 0; j < ppw; ++j) {
    const int64_t p = ((tile * tile_rows) + j * blk + r) * kLanes + lane;
    // sRGB -> Lab (kmeans_tpu/ops/kernels.py::_lab_from_linear_planes).
    float l, a, b;
    pixel_lab(rgb, n, p, lut, &l, &a, &b);

    if (dither) {
      const int64_t px = p % width;
      const int64_t py = p / width + row_offset;
      const float adjust = __fmul_rn(thr, bayer_value(px, py));
      l = __fadd_rn(l, adjust);
      a = __fadd_rn(a, adjust);
      b = __fadd_rn(b, adjust);
    }

    float best_d;
    int best_k;
    nearest_centroid<Metric, Tier, M>(l, a, b, cent, chroma, gtab, k_active, &best_k,
                                      &best_d);
    word |= static_cast<uint32_t>(best_k) << (bits * j);
  }
  out[g] = static_cast<int32_t>(word);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns the launch's cudaError_t
// (0 on success). All pointers are device pointers: rgb [n * 3] u8,
// centroids [kp * 3] f32, metric 0 (CIE94) or 1 (CIEDE2000), tier 0
// (exact), 1 (factorized, CIE94 only) or 3 (pruned, CIEDE2000 only, with
// prune_m 8 or 16), gtab [kp * 7] f32 for the fast tiers (else ignored),
// gamma_lut [256] f32, threshold [1] f32,
// out [n_words] i32 with n_words = n_pad / ppw, n_pad a multiple of
// tile_rows * 128. It allocates nothing and does not synchronise.
int kmeans_assign_packed(const void* rgb, int64_t n, int64_t width,
                         const void* centroids, int kp, int k_active,
                         int metric, int tier, const void* gtab, int prune_m,
                         const void* gamma_lut,
                         const void* threshold, int dither,
                         int64_t row_offset, int bits, int tile_rows,
                         void* out, int64_t n_words, void* stream) {
  using namespace kmeans;
  if (!tier_args_valid(metric, tier, gtab, prune_m, /*algebraic_ok=*/false)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = assign_packed_kernel<kMetricCie94, kTierExact, 0>;
  if (tier == kTierFactor) {
    kernel = assign_packed_kernel<kMetricCie94, kTierFactor, 0>;
  } else if (tier == kTierPrune) {
    kernel = prune_m == 8 ? assign_packed_kernel<kMetricCie2000, kTierPrune, 8>
                          : assign_packed_kernel<kMetricCie2000, kTierPrune, 16>;
  } else if (metric == kMetricCie2000) {
    kernel = assign_packed_kernel<kMetricCie2000, kTierExact, 0>;
  }
  if (tier == kTierExact) gtab = nullptr;
  const int threads = 256;
  const int64_t blocks = (n_words + threads - 1) / threads;
  const size_t smem =
      sizeof(float) * (256 + (gtab ? 4 + kGCols : 4) * static_cast<size_t>(kp));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned int>(blocks), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rgb), n, width,
      static_cast<const float*>(centroids), kp, k_active,
      static_cast<const float*>(gtab), static_cast<const float*>(gamma_lut),
      static_cast<const float*>(threshold), dither, row_offset, bits,
      tile_rows, static_cast<int32_t*>(out), n_words);
  return static_cast<int>(cudaGetLastError());
}

const char* kmeans_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
