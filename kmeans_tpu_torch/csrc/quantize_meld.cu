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
// Frames: frame f = frame_base + blockIdx.y; its blocks read the image at
// pixel offset f * frame_stride (0: one image for every frame), stage frame
// f's palette and k_active and write frame f's words, the single-image
// layout. The launcher issues at most 65,535 frames (the grid's y limit) a
// launch, each group with its first frame as `frame_base`.
// The gamma table, the centroids and their chroma live in shared memory;
// the centroid loop is a runtime loop. A palette larger than `chunk`
// centroids (the `Chunked` instances, exact tier only) is staged `chunk`
// centroids at a time, the four pixels' two closest carried across chunks
// with the same strict `<`, so the result is the one loop's; the blend then
// reads its two centroids from global memory. Any k is one launch (the
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
// The largest grid y extent: frames beyond it go in another launch.
constexpr int64_t kMaxGridY = 65535;

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

// Adds `base` to every index the carry sees (a staged chunk numbers its
// centroids from 0).
struct OffsetTwoClosest {
  TwoClosest* two;
  int base;
  __device__ __forceinline__ void update(float d, int k) { two->update(d, base + k); }
};

// The blend of one pixel (l, a, b; chroma c1) between its closest centroid
// (l1, a1, b1; chroma ch1) and its second (l2, a2, b2; chroma ch2), with
// d2 the carried distance to the second.
template <int Metric, int Tier>
__device__ __forceinline__ void blend(float l, float a, float b, float c1, float d2,
                                      float l1, float a1, float b1, float ch1,
                                      float l2, float a2, float b2, float ch2,
                                      float* ol, float* oa, float* ob) {
  if constexpr (Tier == kTierFactor) {
    float sc, sh2;
    cie94_weights(c1, &sc, &sh2);
    d2 = pixel_distance<Metric>(l, a, b, c1, sc, sh2, l2, a2, b2, ch2);
  }
  // d(closest, second), the closest first: its own hoisted terms.
  float sc1, sh21;
  cie94_weights(ch1, &sc1, &sh21);
  const float den_sq = pixel_distance<Metric>(l1, a1, b1, ch1, sc1, sh21, l2, a2, b2, ch2);
  const float factor = __fdiv_rn(__fsqrt_rn(d2), __fsqrt_rn(den_sq));
  const float rest = __fsub_rn(1.0f, factor);
  *ol = __fadd_rn(__fmul_rn(factor, l1), __fmul_rn(rest, l2));
  *oa = __fadd_rn(__fmul_rn(factor, a1), __fmul_rn(rest, a2));
  *ob = __fadd_rn(__fmul_rn(factor, b1), __fmul_rn(rest, b2));
}

// Writes the 4 pixels' u8 RGB (bytes[12]) as the group's 3 words.
__device__ __forceinline__ void store_group(const uint32_t* bytes, int32_t* __restrict__ out,
                                            int64_t tile, int64_t r, int lane, int blk) {
  // Word row j of the group's 3: bytes 4j .. 4j + 3 of R0 G0 B0 R1 G1 ...
  const int64_t base = (tile * 3 * blk + r) * kLanes + lane;
  for (int j = 0; j < 3; ++j) {
    const uint32_t word = bytes[4 * j] | (bytes[4 * j + 1] << 8) |
                          (bytes[4 * j + 2] << 16) | (bytes[4 * j + 3] << 24);
    out[base + static_cast<int64_t>(j) * blk * kLanes] = static_cast<int32_t>(word);
  }
}

__device__ __forceinline__ void put_rgb(float l, float a, float b, uint32_t* bytes) {
  int r8, g8, b8;
  lab_to_srgb8(l, a, b, &r8, &g8, &b8);
  bytes[0] = static_cast<uint32_t>(r8);
  bytes[1] = static_cast<uint32_t>(g8);
  bytes[2] = static_cast<uint32_t>(b8);
}

template <int Metric, int Tier, int M, bool Chunked>
__global__ void meld_kernel(
    const uint8_t* __restrict__ rgb, int64_t n, int64_t frame_stride,
    const float* __restrict__ centroids, int kp, int chunk, int k_active,
    const int32_t* __restrict__ k_actives,
    const float* __restrict__ gtab_in, const float* __restrict__ gamma_lut,
    int tile_rows,
    int32_t* __restrict__ out, int64_t n_groups, int64_t frame_base) {
  extern __shared__ float smem[];
  const int len = Chunked ? chunk : kp;  // centroids staged at a time
  float* lut = smem;               // [256]
  float* cent = smem + 256;        // [len * 3]
  float* chroma = cent + 3 * len;  // [len]
  float* gtab = chroma + len;      // [len * 7], fast tiers only

  // The frame's operands.
  const int64_t f = frame_base + blockIdx.y;
  rgb += f * frame_stride * 3;
  centroids += f * kp * 3;
  if (gtab_in != nullptr) gtab_in += f * kp * kGCols;
  if (k_actives != nullptr) k_active = k_actives[f];
  out += f * 3 * n_groups;

  for (int i = threadIdx.x; i < 256; i += blockDim.x) lut[i] = gamma_lut[i];
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int blk = tile_rows / 4;
  const int64_t row = g / kLanes;
  const int lane = static_cast<int>(g % kLanes);
  const int64_t tile = row / blk;
  const int64_t r = row % blk;
  uint32_t bytes[12];

  if constexpr (Chunked) {
    // Exact tier: the four pixels' two closest carry across the chunks.
    const bool active = g < n_groups;
    float pl[4], pa[4], pb[4], pc[4];
    TwoClosest two[4];
    for (int start = 0; start < k_active; start += chunk) {
      const int staged = min(chunk, kp - start);
      __syncthreads();  // the previous chunk's readers are done
      for (int i = threadIdx.x; i < staged; i += blockDim.x) {
        const float ca = centroids[3 * (start + i) + 1];
        const float cb = centroids[3 * (start + i) + 2];
        cent[3 * i + 0] = centroids[3 * (start + i) + 0];
        cent[3 * i + 1] = ca;
        cent[3 * i + 2] = cb;
        chroma[i] = kmeans::chroma(ca, cb);
      }
      __syncthreads();
      if (!active) continue;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (start == 0) {
          const int64_t p = ((tile * tile_rows) + s * blk + r) * kLanes + lane;
          pixel_lab(rgb, n, p, lut, &pl[s], &pa[s], &pb[s]);
          pc[s] = kmeans::chroma(pa[s], pb[s]);
        }
        OffsetTwoClosest carry{&two[s], start};
        scan_centroids<Metric, kTierExact, 0>(pl[s], pa[s], pb[s], pc[s], cent, chroma,
                                              nullptr, min(staged, k_active - start),
                                              &carry);
      }
    }
    if (!active) return;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float ol = centroids[0], oa = centroids[1], ob = centroids[2];
      if (k_active > 1) {
        const float* c1p = centroids + 3 * two[s].k1;
        const float* c2p = centroids + 3 * two[s].k2;
        blend<Metric, kTierExact>(pl[s], pa[s], pb[s], pc[s], two[s].d2, c1p[0], c1p[1],
                                  c1p[2], kmeans::chroma(c1p[1], c1p[2]), c2p[0], c2p[1],
                                  c2p[2], kmeans::chroma(c2p[1], c2p[2]), &ol, &oa, &ob);
      }
      put_rgb(ol, oa, ob, bytes + 3 * s);
    }
  } else {
    stage_g_table(gtab_in, gtab, kp);
    for (int i = threadIdx.x; i < kp; i += blockDim.x) {
      const float ca = centroids[3 * i + 1];
      const float cb = centroids[3 * i + 2];
      cent[3 * i + 0] = centroids[3 * i + 0];
      cent[3 * i + 1] = ca;
      cent[3 * i + 2] = cb;
      chroma[i] = kmeans::chroma(ca, cb);
    }
    __syncthreads();
    if (g >= n_groups) return;

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
        blend<Metric, Tier>(l, a, b, c1, two.d2, cent[3 * k1 + 0], cent[3 * k1 + 1],
                            cent[3 * k1 + 2], chroma[k1], cent[3 * k2 + 0],
                            cent[3 * k2 + 1], cent[3 * k2 + 2], chroma[k2], &ol, &oa, &ob);
      }
      put_rgb(ol, oa, ob, bytes + 3 * s);
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
  const int threads = 256;
  const int64_t blocks = (n_groups + threads - 1) / threads;
  const size_t len = static_cast<size_t>(chunked ? chunk : kp);
  const size_t smem = sizeof(float) * (256 + (gtab ? 4 + kGCols : 4) * len);
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
