// Lloyd tile accumulator for Hopper (sm_90a): Lab planes -> nearest centroid
// under CIE94 or CIEDE2000 -> per-cluster (sum L, sum a, sum b,
// count[, sum d^2]).
//
// Replaces the Pallas TPU kernel `kmeans_tpu/ops/kernels.py::_lloyd_acc_kernel`
// (launched by `lloyd_accumulate`) in its exact forms, CIE94 and CIEDE2000
// (`:1400-1409`, `:1438-1455`), and its fast forms: the factorized CIE94
// score (`:1357-1368`), the algebraic CIE94 distance that keeps the
// inertia column a true squared distance (`:1369-1385`) and the pruned
// CIEDE2000 tier (`:1411-1437`), one kernel instance per (metric, tier,
// m), picked at launch; the reduction behind the assignment is the same
// for all. Float32 or
// bfloat16 planes, an optional weight plane, an optional inertia column. The
// plain PyTorch twin `kmeans_tpu_torch/ops/kernels.py::lloyd_accumulate_reference`
// is the spec: every pixel's assignment equals the twin's, the counts are
// equal, and the sums agree to float32 rounding (they are added in another
// order).
//
// Design (for the GPU, not a block-by-block copy of the TPU kernel):
// - Input is the padded `[3, M, 128]` plane layout of `pack_lab_planes`;
//   pixel p of channel c lies at c * n_pix + p. Pixels p >= n_valid are
//   padding and drop out by their index, never by their (zero) value.
// - A fixed grid of at most kMaxBlocks blocks walks the tiles (block b
//   takes tiles b, b + grid, ...). Under exact CIE94, the factorized and
//   the algebraic tier a tile is kThreads register tiles of `tile_pixels`
//   pixels, which a thread reads as runs of 4 with one 16-byte load a
//   plane (8 bytes of bfloat16), keeps in registers and adds to the
//   accumulator by one reduction a tile; under exact CIEDE2000 and the
//   pruned tier a tile is kThreads * kPixPerThread pixels, taken one at a
//   time.
// - The exact CIE94 assignment is screen.cuh::scan_exact_tile: the
//   centroid loop outermost over the thread's pixels, one 16-byte shared
//   load of (L, a, b, chroma) a centroid, and the divides through the
//   pixel's hoisted reciprocals (delta_e.cuh::div_by_recip; a tile out of
//   its range is rescanned with IEEE divides), so every assignment is the
//   twin's. Exact CIEDE2000 takes the same loop one pixel at a time (its
//   library calls leave no registers for a tile). The factorized tier is
//   screen.cuh::scan_factor_tile: the centroid loop outermost, two 16-byte
//   loads of a padded feature row serve the tile's pixels. The algebraic
//   tier is screen.cuh::scan_algebraic_tile: the centroid loop outermost,
//   one 16-byte load of (L, a, b, chroma) serves the tile's pixels, each
//   held as (L, a, b, chroma, rsh2, q). The pruned tier takes
//   screen.cuh::scan_centroids one pixel at a time with the keyed screen
//   (screen.cuh::prune_screen); its candidate list and CIEDE2000 calls
//   leave no registers for a tile, and it is bound to 64 registers
//   (kPruneMinBlocks), so that an SM holds all of its share of the grid
//   at kp <= 256.
// - The reduction is deterministic, uses no atomics and costs O(1) a
//   pixel (`warp_group_add`): each warp owns an accumulator [kp, stats] in
//   shared memory; for each pixel slot the lanes with the same cluster
//   (`__match_any_sync`) sum their values by a fixed tree over their ranks
//   in the group, and the group's lowest lane adds the sum to the cluster's
//   row, which no other lane touches in that step. At the end of the block
//   the warps' rows are summed in warp order into the block's [kp, stats]
//   partials; a second kernel sums them over the blocks in block order.
//   The order of every addition depends only on the pixels' clusters and
//   the grid size only on the pixel count, so the totals are equal from
//   run to run and from card to card.
// - Counts are sums of the weight (1.0 without a weight plane): every
//   partial and the total are exact integers below 2^24 pixels.
// - The centroids live in shared memory (16 B each, 8 KB at kp = 512);
//   every pixel visits them in index order with strict `<`, so the first
//   minimum wins (the pruned tier: its survivors in screening-rank order,
//   up to its first unfilled slot). Shared memory at kp = 512 with the
//   inertia column is 88 KB a block (the eight warp accumulators), and
//   104 KB with the fast tiers' feature table (padded to 8 columns).
//
// Float rounding: each float operation is one IEEE float32 operation in the
// twin's order, written with the _rn intrinsics so that none is fused into
// an FMA (the library is also built with --fmad=false), and divisions and
// square roots are the IEEE ones, or under exact CIE94 the hoisted-
// reciprocal quotient that equals them bit for bit. bfloat16 planes widen
// to float32 by a 16-bit shift, which is what `Tensor.float()` does.
//
// What bounds it on this card, per valid pixel and Lloyd step: it reads
// 12 B of float32 planes (6 B of bfloat16, +4 B with a weight plane), and
// does 9 pixel-side operations, 18 per active centroid and 2 per output
// column under CIE94; under CIEDE2000 each centroid costs about 105
// operations, 9 of them library calls (atan2f, sinf, cosf, expf), and 6
// divides. At 4K (8,306,688 padded pixels) the reads take 29.8 us at
// 3.35 TB/s; at k = 8 the 1.35 G operations take 20 us at 67 TFLOP/s of
// float32, so bytes bound it on paper. In instructions, before this form a
// CIE94 pair cost 50 (two IEEE divide subroutines, four scalar shared
// loads) and the reduction rescanned the staged tile once per owned
// cluster; now a pair costs about 29, at the card's full instruction
// rate, and the reduction a few dozen a pixel, which weighs most at small
// k. The fast tiers: the factorized score and compare is 13 operations a
// pair (16 instructions in the 8-pixel tile, the score's order fixed by
// exactness: each product rounded before its add), the algebraic distance
// and compare 14 (about 16.5 instructions in its 8-pixel tile), so what
// the tiles cut is the shared loads a pair, the loop overhead, the global
// loads and the reduction a pixel. The library is built with
// `--fmad=false`, so each operation is one issue slot: the card issues
// about 33.5 T instructions a second (132 SMs x 128 lanes x 1.98 GHz),
// half the 67 TFLOP/s the bound is taken at, which counts an FMA as two,
// and 50% of that bound is these FMA-free tiers' ceiling. The pruned tier's time is in the screen's score a centroid
// and the m exact CIEDE2000 distances of each pixel (library calls, IEEE
// divides and square roots, each with a slow-path branch); at m = 16 its
// registers decide how many of the grid's blocks an SM holds at once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "delta_e.cuh"
#include "screen.cuh"

namespace {

using namespace kmeans;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPixPerThread = 4;  // pixels a thread takes one at a time
constexpr int kTile = kThreads * kPixPerThread;
// Pixels a thread keeps in registers under exact CIE94, the factorized and
// the algebraic tier (a multiple of 4: runs of one 16-byte load). Their
// tiles are kThreads times as many pixels; the grid is sized on kTile, so
// a block may find none.
constexpr int kTilePixels = 8;
// Blocks an SM must hold (`__launch_bounds__`): 2, and under the pruned
// tier 4, which holds its instances to 64 registers: at kp <= 256, where
// shared memory leaves room for 4, an SM then holds its whole share of the
// grid at once and no block waits for another to end.
constexpr int kMinBlocks = 2;
constexpr int kPruneMinBlocks = 4;
constexpr int kMaxBlocks = 528;  // 4 blocks on each of the H100's 132 SMs

// The register tile of (metric, tier), or 0 where pixels go one at a time
// (exact CIEDE2000, whose library calls leave no registers for a tile, and
// the pruned tier, whose screen leaves none either).
__host__ __device__ constexpr int tile_pixels(int metric, int tier) {
  return tier == kTierFactor || tier == kTierAlgebraic ||
                 (tier == kTierExact && metric == kMetricCie94)
             ? kTilePixels
             : 0;
}
__host__ __device__ constexpr int min_blocks(int tier) {
  return tier == kTierPrune ? kPruneMinBlocks : kMinBlocks;
}

// Four consecutive pixels of a plane from element i (a multiple of 4): one
// 16-byte load of float32, one 8-byte load of bfloat16 widened by a 16-bit
// shift, which is what `Tensor.float()` does.
__device__ __forceinline__ float4 load_plane4(const void* planes, int bf16, int64_t i) {
  if (bf16) {
    const uint2 h = *reinterpret_cast<const uint2*>(static_cast<const uint16_t*>(planes) + i);
    return make_float4(__uint_as_float(h.x << 16), __uint_as_float(h.x & 0xffff0000u),
                       __uint_as_float(h.y << 16), __uint_as_float(h.y & 0xffff0000u));
  }
  return *reinterpret_cast<const float4*>(static_cast<const float*>(planes) + i);
}

__device__ __forceinline__ float load_plane(const void* planes, int bf16, int64_t i) {
  if (bf16) {
    const uint32_t bits = static_cast<const uint16_t*>(planes)[i];
    return __uint_as_float(bits << 16);
  }
  return static_cast<const float*>(planes)[i];
}

__device__ __forceinline__ float lane_of(const float4& v, int s) {
  return s == 0 ? v.x : s == 1 ? v.y : s == 2 ? v.z : v.w;
}

// Adds P pixels of every lane to their clusters' rows of the warp's
// accumulator `acc` [kp * stats], deterministically and without atomics.
// For each slot s the lanes with the same cluster `k[s]` form a group
// (`__match_any_sync`); a fixed tree over each lane's rank in its group
// sums the group's values `v[s]`: at step t the lane of rank r (r a
// multiple of 2^(t+1)) adds the partial of rank r + 2^t, whose lane it
// finds by pointer doubling from its successor in the group. The P slots'
// trees run interleaved (they are independent), then each slot's group
// leader, its lowest lane, adds the sum to the cluster's row, which no
// other lane of the warp touches in that step. `k[s]` < 0 (a padding
// pixel) adds nothing. The order of every addition depends only on the
// clusters, so equal inputs give equal bits on every run and every card.
template <int P>
__device__ __forceinline__ void warp_group_add(float* acc, int stats, const int (&k)[P],
                                               float (&v)[P][5]) {
  const int self = static_cast<int>(threadIdx.x % 32);
  const unsigned below = (1u << self) - 1u;
  int rank[P], partner[P];  // partner: the lane of rank + step, or self if none
  unsigned size = 0;
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const unsigned mask = __match_any_sync(0xffffffffu, k[s]);
    rank[s] = __popc(mask & below);
    size = max(size, static_cast<unsigned>(__popc(mask)));
    const unsigned above = mask & ~below & ~(1u << self);
    partner[s] = above ? __ffs(above) - 1 : self;
  }
  size = __reduce_max_sync(0xffffffffu, size);
  for (int step = 1; step < static_cast<int>(size); step <<= 1) {
#pragma unroll
    for (int s = 0; s < P; ++s) {
      float o[5];
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        o[c] = c < 4 || stats == 5 ? __shfl_sync(0xffffffffu, v[s][c], partner[s]) : 0.0f;
      }
      if (partner[s] != self && (rank[s] & (2 * step - 1)) == 0) {
#pragma unroll
        for (int c = 0; c < 5; ++c) v[s][c] = __fadd_rn(v[s][c], o[c]);
      }
      // The partner's partner is rank + 2 step; a partner without one
      // returns itself, and then there is none.
      const int next = __shfl_sync(0xffffffffu, partner[s], partner[s]);
      partner[s] = next == partner[s] ? self : next;
    }
  }
#pragma unroll
  for (int s = 0; s < P; ++s) {
    if (rank[s] == 0 && k[s] >= 0) {
      float* row = acc + k[s] * stats;
      row[0] = __fadd_rn(row[0], v[s][0]);
      row[1] = __fadd_rn(row[1], v[s][1]);
      row[2] = __fadd_rn(row[2], v[s][2]);
      row[3] = __fadd_rn(row[3], v[s][3]);
      if (stats == 5) row[4] = __fadd_rn(row[4], v[s][4]);
    }
    __syncwarp();
  }
}

template <int Metric, int Tier, int M>
__global__ void __launch_bounds__(kThreads, min_blocks(Tier)) lloyd_tile_kernel(
    const void* __restrict__ planes, int bf16, int64_t n_pix, int64_t n_valid,
    const float* __restrict__ centroids, int kp, int k_active,
    const float* __restrict__ gtab_in, const float* __restrict__ weight, int stats,
    float* __restrict__ partials) {
  constexpr int P = tile_pixels(Metric, Tier);
  extern __shared__ float4 smem4[];
  // cent4 [kp] (L, a, b, chroma); the factorized and pruned tiers' padded
  // feature table g [2 kp]; then each warp's accumulator [kp * stats].
  float4* cent4 = smem4;
  float4* g = cent4 + kp;
  float* acc = reinterpret_cast<float*>(g + (gtab_in != nullptr ? 2 * kp : 0));

  const bool staged_ok = stage_cent4(centroids, 0, kp, cent4);
  stage_feature_rows(gtab_in, g, kp);
  for (int i = threadIdx.x; i < kWarps * kp * stats; i += kThreads) acc[i] = 0.0f;
  const bool cents_ok = __syncthreads_and(staged_ok);

  float* warp_acc = acc + (threadIdx.x / 32) * kp * stats;
  if constexpr (P > 0) {
    // The register tile: P pixels a thread, as runs of 4 consecutive
    // pixels (run q at p0 + q * 4 * kThreads), each run one 16-byte load
    // a plane, and one reduction a tile.
    constexpr int kRuns = P / 4;
    const int64_t n_tiles = n_pix / (kThreads * P);
    for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int64_t p0 = tile * kThreads * P + 4 * threadIdx.x;
      float4 l4[kRuns], a4[kRuns], b4[kRuns], w4[kRuns];
#pragma unroll
      for (int q = 0; q < kRuns; ++q) {
        const int64_t p = p0 + q * 4 * kThreads;
        l4[q] = load_plane4(planes, bf16, p);
        a4[q] = load_plane4(planes, bf16, n_pix + p);
        b4[q] = load_plane4(planes, bf16, 2 * n_pix + p);
        w4[q] = weight ? *reinterpret_cast<const float4*>(weight + p)
                       : make_float4(1.0f, 1.0f, 1.0f, 1.0f);
      }
      float l[P], a[P], b[P];
#pragma unroll
      for (int s = 0; s < P; ++s) {
        l[s] = lane_of(l4[s / 4], s % 4);
        a[s] = lane_of(a4[s / 4], s % 4);
        b[s] = lane_of(b4[s / 4], s % 4);
      }
      Closest best[P];
      if constexpr (Tier == kTierExact) {
        Cie94Pixel px[P];
#pragma unroll
        for (int s = 0; s < P; ++s) {
          px[s] = cie94_pixel(l[s], a[s], b[s], kmeans::chroma(a[s], b[s]));
        }
        scan_exact_tile<Metric, P>(px, best, cent4, k_active, 0, cents_ok);
      } else if constexpr (Tier == kTierFactor) {
        ScreenFactors f[P];
#pragma unroll
        for (int s = 0; s < P; ++s) {
          f[s] = screen_factors(l[s], a[s], b[s], kmeans::chroma(a[s], b[s]));
        }
        scan_factor_tile<P>(f, best, g, k_active);
      } else {
        static_assert(Tier == kTierAlgebraic,
                      "the tiled tiers: exact CIE94, factorized, algebraic");
        AlgebraicPixel px[P];
#pragma unroll
        for (int s = 0; s < P; ++s) px[s] = algebraic_pixel(l[s], a[s], b[s]);
        scan_algebraic_tile<P>(px, best, cent4, k_active);
      }
      int best_k[P];
      float v[P][5];
#pragma unroll
      for (int s = 0; s < P; ++s) {
        const float w = lane_of(w4[s / 4], s % 4);
        const int64_t p = p0 + (s / 4) * 4 * kThreads + s % 4;
        best_k[s] = p >= n_valid ? -1 : best[s].k;
        v[s][0] = __fmul_rn(l[s], w);
        v[s][1] = __fmul_rn(a[s], w);
        v[s][2] = __fmul_rn(b[s], w);
        v[s][3] = w;
        v[s][4] = __fmul_rn(best[s].d, w);
      }
      warp_group_add<P>(warp_acc, stats, best_k, v);
    }
  } else {
    // One pixel at a time: exact CIEDE2000 and the pruned tier. Pixel j of
    // a thread lies at threadIdx.x + j * kThreads.
    const int64_t n_tiles = n_pix / kTile;
    for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
#pragma unroll 1
      for (int j = 0; j < kPixPerThread; ++j) {
        const int64_t p = tile * kTile + threadIdx.x + j * kThreads;
        const float l = load_plane(planes, bf16, p);
        const float a = load_plane(planes, bf16, n_pix + p);
        const float b = load_plane(planes, bf16, 2 * n_pix + p);
        const float w = weight ? weight[p] : 1.0f;
        Closest best[1];
        if constexpr (Tier == kTierExact) {
          const Cie94Pixel px[1] = {cie94_pixel(l, a, b, kmeans::chroma(a, b))};
          scan_exact_tile<Metric, 1>(px, best, cent4, k_active, 0, cents_ok);
        } else {
          scan_centroids<Metric, Tier, M>(l, a, b, kmeans::chroma(a, b), cent4, g, k_active,
                                          &best[0]);
        }
        int best_k[1] = {p >= n_valid ? -1 : best[0].k};
        float v[1][5] = {{__fmul_rn(l, w), __fmul_rn(a, w), __fmul_rn(b, w), w,
                          __fmul_rn(best[0].d, w)}};
        warp_group_add<1>(warp_acc, stats, best_k, v);
      }
    }
  }
  __syncthreads();

  // The block's partials: the warps' rows summed in warp order.
  float* out = partials + static_cast<int64_t>(blockIdx.x) * kp * stats;
  for (int i = threadIdx.x; i < kp * stats; i += kThreads) {
    float v = acc[i];
    for (int w = 1; w < kWarps; ++w) v = __fadd_rn(v, acc[w * kp * stats + i]);
    out[i] = v;
  }
}

// out[i] = sum over blocks b, in block order, of partials[b][i].
__global__ void sum_blocks_kernel(const float* __restrict__ partials,
                                  int n_blocks, int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) {
    s = __fadd_rn(s, partials[static_cast<int64_t>(b) * n + i]);
  }
  out[i] = s;
}

}  // namespace

extern "C" {

// Number of blocks (and of partial rows) for `n_pix` padded pixels; the
// caller allocates partials [grid * kp * stats] f32.
int kmeans_lloyd_grid_blocks(int64_t n_pix) {
  const int64_t tiles = n_pix / kTile;
  if (tiles < 1) return 1;
  return static_cast<int>(tiles < kMaxBlocks ? tiles : kMaxBlocks);
}

// Launches both kernels on `stream` and returns the first launch error
// (0 on success). All pointers are device pointers: planes [3 * n_pix]
// f32 (bf16 = 0) or bf16 bits (bf16 = 1), n_pix a multiple of 1024 and of
// kThreads times the tier's register tile (`pack_lab_planes` pads to 16384);
// centroids [kp * 3] f32; metric 0 (CIE94) or 1 (CIEDE2000); tier 0
// (exact), 1 (factorized, CIE94, stats 4 only: its best distance is a
// rank), 2 (algebraic, CIE94) or 3 (pruned, CIEDE2000, prune_m 8 or 16);
// gtab [kp * 7] f32 for tiers 1 and 3 (else ignored); weight
// [n_pix] f32 or null; partials
// [n_blocks * kp * stats] f32 with n_blocks = kmeans_lloyd_grid_blocks;
// out [kp * stats] f32. It allocates nothing and does not synchronise.
int kmeans_lloyd_accumulate(const void* planes, int bf16, int64_t n_pix,
                            int64_t n_valid, const void* centroids, int kp,
                            int k_active, int metric, int tier,
                            const void* gtab, int prune_m, const void* weight,
                            int stats,
                            void* partials, int n_blocks, void* out,
                            void* stream) {
  using namespace kmeans;
  const int tile = tile_pixels(metric, tier);
  if (n_pix % kTile != 0 || (tile > 0 && n_pix % (kThreads * tile) != 0) ||
      (stats != 4 && stats != 5) ||
      n_blocks != kmeans_lloyd_grid_blocks(n_pix) ||
      !tier_args_valid(metric, tier, gtab, prune_m, /*algebraic_ok=*/true) ||
      (tier == kTierFactor && stats != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tier != kTierFactor && tier != kTierPrune) gtab = nullptr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem =
      sizeof(float) * static_cast<size_t>(kp) * (4 + kWarps * stats + (gtab ? 8 : 0));
  auto kernel = lloyd_tile_kernel<kMetricCie94, kTierExact, 0>;
  if (tier == kTierFactor) {
    kernel = lloyd_tile_kernel<kMetricCie94, kTierFactor, 0>;
  } else if (tier == kTierAlgebraic) {
    kernel = lloyd_tile_kernel<kMetricCie94, kTierAlgebraic, 0>;
  } else if (tier == kTierPrune) {
    kernel = prune_m == 8 ? lloyd_tile_kernel<kMetricCie2000, kTierPrune, 8>
                          : lloyd_tile_kernel<kMetricCie2000, kTierPrune, 16>;
  } else if (metric == kMetricCie2000) {
    kernel = lloyd_tile_kernel<kMetricCie2000, kTierExact, 0>;
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<n_blocks, kThreads, smem, s>>>(
      planes, bf16, n_pix, n_valid, static_cast<const float*>(centroids), kp,
      k_active, static_cast<const float*>(gtab), static_cast<const float*>(weight),
      stats, static_cast<float*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = kp * stats;
  sum_blocks_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partials), n_blocks, n,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
