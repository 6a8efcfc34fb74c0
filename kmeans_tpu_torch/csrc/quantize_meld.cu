// Fused meld pass for Hopper (sm_90a): u8 sRGB -> Lab -> the two closest
// centroids under CIE94 or CIEDE2000 -> their blend -> Lab -> u8 sRGB ->
// RGB bytes packed into int32 words.
//
// Replaces the Pallas TPU kernel `kmeans_tpu/ops/kernels.py::_quantize_kernel`
// in meld mode with its in-kernel RGB24 pack (`fused_meld_packed`,
// `:994-1077`), for the exact CIE94 and CIEDE2000 metrics and their fast
// tiers (screen.cuh). The plain PyTorch twin
// `kmeans_tpu_torch/ops/kernels.py::meld_packed_reference` is the spec of
// the words it writes.
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
// - Lab -> sRGB -> u8 with rintf, round half to even like torch.round.
// - Factorized CIE94 tier: the loop carries the factorized score, which
//   ranks the centroids but is no distance, so the numerator is recomputed
//   as the exact CIE94 distance from the pixel to the second (`:1033-1034`).
// - Pruned CIEDE2000 tier: the screening loop keeps the m best by the
//   factorized score; the same carry then runs over those survivors in
//   rank order on their exact distances (`:1010-1018`), so d2 is exact.
//
// Design: one thread per group of 4 pixels, the pixels at rows r, blk + r,
// 2 blk + r and 3 blk + r of a tile (blk = tile_rows / 4) in one lane, so
// the thread writes its 3 output words itself and no packing crosses
// threads. Word row j (< 3) of the group holds, low byte first:
// j = 0: R0 G0 B0 R1; j = 1: G1 B1 R2 G2; j = 2: B2 R3 G3 B3 (`:1055-1077`).
// The gamma table, the centroids and their chroma live in shared memory;
// the centroid loop is a runtime loop, so one launch serves any palette
// whose table fits in a block's shared memory (k up to about 14,000; the
// reference has no meld kernel above k = 1024).
//
// Float rounding as in quantize_assign.cu: one IEEE float32 operation per
// step in the twin's order, _rn intrinsics, no fast math.
//
// What bounds it on this card: it reads 3 B/px and writes 3 B/px, so at
// k = 8 the per-pixel powf calls (6: three into Lab, three out of it), the
// per-centroid divides and, under CIEDE2000, the per-centroid atan2f, sinf,
// cosf and expf calls set the pace, not memory bandwidth.

#include <cuda_runtime.h>
#include <stdint.h>

#include "colorspace.cuh"
#include "delta_e.cuh"
#include "screen.cuh"

namespace {

using namespace kmeans;

constexpr int kLanes = 128;

// The two closest so far, carried with strict `<`.
struct TwoClosest {
  float d1 = kBig, d2 = kBig;
  int k1 = 0, k2 = 0;

  __device__ __forceinline__ void update(float d, int k) {
    if (d < d1) {
      d2 = d1;
      k2 = k1;
      d1 = d;
      k1 = k;
    } else if (d < d2) {
      d2 = d;
      k2 = k;
    }
  }
};

template <int Metric, int Tier, int M>
__global__ void meld_packed_kernel(
    const uint8_t* __restrict__ rgb, int64_t n,
    const float* __restrict__ centroids, int kp, int k_active,
    const float* __restrict__ gtab_in, const float* __restrict__ gamma_lut,
    int tile_rows,
    int32_t* __restrict__ out, int64_t n_groups) {
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
  if (g >= n_groups) return;

  const int blk = tile_rows / 4;
  const int64_t row = g / kLanes;
  const int lane = static_cast<int>(g % kLanes);
  const int64_t tile = row / blk;
  const int64_t r = row % blk;

  uint32_t bytes[12];
  for (int s = 0; s < 4; ++s) {
    const int64_t p = ((tile * tile_rows) + s * blk + r) * kLanes + lane;
    float l, a, b;
    pixel_lab(rgb, n, p, lut, &l, &a, &b);

    float ol = cent[0], oa = cent[1], ob = cent[2];
    if (k_active > 1) {
      const float c1 = kmeans::chroma(a, b);
      TwoClosest two;
      scan_centroids<Metric, Tier, M>(l, a, b, c1, cent, chroma, gtab, k_active, &two);
      const int k1 = two.k1, k2 = two.k2;
      // d(closest, second), the closest first: its own hoisted terms.
      const float l1 = cent[3 * k1 + 0], a1 = cent[3 * k1 + 1], b1 = cent[3 * k1 + 2];
      const float l2 = cent[3 * k2 + 0], a2 = cent[3 * k2 + 1], b2 = cent[3 * k2 + 2];
      float d2 = two.d2;
      if constexpr (Tier == kTierFactor) {
        float sc, sh2;
        cie94_weights(c1, &sc, &sh2);
        d2 = pixel_distance<Metric>(l, a, b, c1, sc, sh2, l2, a2, b2, chroma[k2]);
      }
      float sc1, sh21;
      cie94_weights(chroma[k1], &sc1, &sh21);
      const float den_sq = pixel_distance<Metric>(l1, a1, b1, chroma[k1], sc1, sh21,
                                                  l2, a2, b2, chroma[k2]);
      const float factor = __fdiv_rn(__fsqrt_rn(d2), __fsqrt_rn(den_sq));
      const float rest = __fsub_rn(1.0f, factor);
      ol = __fadd_rn(__fmul_rn(factor, l1), __fmul_rn(rest, l2));
      oa = __fadd_rn(__fmul_rn(factor, a1), __fmul_rn(rest, a2));
      ob = __fadd_rn(__fmul_rn(factor, b1), __fmul_rn(rest, b2));
    }
    int r8, g8, b8;
    lab_to_srgb8(ol, oa, ob, &r8, &g8, &b8);
    bytes[3 * s + 0] = static_cast<uint32_t>(r8);
    bytes[3 * s + 1] = static_cast<uint32_t>(g8);
    bytes[3 * s + 2] = static_cast<uint32_t>(b8);
  }

  // Word row j of the group's 3: bytes 4j .. 4j + 3 of R0 G0 B0 R1 G1 ...
  const int64_t base = (tile * 3 * blk + r) * kLanes + lane;
  for (int j = 0; j < 3; ++j) {
    const uint32_t word = bytes[4 * j] | (bytes[4 * j + 1] << 8) |
                          (bytes[4 * j + 2] << 16) | (bytes[4 * j + 3] << 24);
    out[base + static_cast<int64_t>(j) * blk * kLanes] = static_cast<int32_t>(word);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns the launch's cudaError_t
// (0 on success). All pointers are device pointers: rgb [n * 3] u8,
// centroids [kp * 3] f32, metric 0 (CIE94) or 1 (CIEDE2000), tier 0
// (exact), 1 (factorized, CIE94 only) or 3 (pruned, CIEDE2000 only, with
// prune_m 8 or 16), gtab [kp * 7] f32 for the fast tiers (else ignored),
// gamma_lut [256] f32, out [3 * n_groups] i32 with n_groups = n_pad / 4,
// n_pad a multiple of tile_rows * 128. It allocates nothing and does not
// synchronise.
int kmeans_meld_packed(const void* rgb, int64_t n, const void* centroids,
                       int kp, int k_active, int metric, int tier,
                       const void* gtab, int prune_m, const void* gamma_lut,
                       int tile_rows, void* out, int64_t n_groups,
                       void* stream) {
  if (tile_rows % 4 != 0 || n_groups % (static_cast<int64_t>(tile_rows / 4) * kLanes) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using namespace kmeans;
  if (!tier_args_valid(metric, tier, gtab, prune_m, /*algebraic_ok=*/false)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = meld_packed_kernel<kMetricCie94, kTierExact, 0>;
  if (tier == kTierFactor) {
    kernel = meld_packed_kernel<kMetricCie94, kTierFactor, 0>;
  } else if (tier == kTierPrune) {
    kernel = prune_m == 8 ? meld_packed_kernel<kMetricCie2000, kTierPrune, 8>
                          : meld_packed_kernel<kMetricCie2000, kTierPrune, 16>;
  } else if (metric == kMetricCie2000) {
    kernel = meld_packed_kernel<kMetricCie2000, kTierExact, 0>;
  }
  if (tier == kTierExact) gtab = nullptr;
  const int threads = 256;
  const int64_t blocks = (n_groups + threads - 1) / threads;
  const size_t smem =
      sizeof(float) * (256 + (gtab ? 4 + kGCols : 4) * static_cast<size_t>(kp));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned int>(blocks), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rgb), n, static_cast<const float*>(centroids),
      kp, k_active, static_cast<const float*>(gtab),
      static_cast<const float*>(gamma_lut), tile_rows,
      static_cast<int32_t*>(out), n_groups);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
