// Lloyd tile accumulator for Hopper (sm_90a): Lab planes -> nearest centroid
// under exact CIE94 -> per-cluster (sum L, sum a, sum b, count[, sum d^2]).
//
// Replaces the Pallas TPU kernel `kmeans_tpu/ops/kernels.py::_lloyd_acc_kernel`
// (launched by `lloyd_accumulate`) in its exact-CIE94 form: float32 or
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
// - A fixed grid of at most kMaxBlocks blocks walks the 1024-pixel tiles
//   (block b takes tiles b, b + grid, ...). Each thread assigns 4 pixels of
//   a tile and stages (L, a, b, weight, d^2, cluster) in shared memory.
// - The reduction is deterministic and uses no atomics: warp w owns the
//   clusters c = w, w + 8, ...; for each owned cluster every lane adds the
//   staged pixels i = lane, lane + 32, ... that belong to it, in that order,
//   a fixed shuffle tree sums the 32 lanes, and lane 0 adds the result to
//   the block's shared accumulator, which no other warp touches. Each
//   block writes its [kp, stats] partials; a second kernel sums them over
//   the blocks in block order. The grid size depends only on the pixel
//   count, so the totals are equal from run to run and from card to card.
// - Counts are sums of the weight (1.0 without a weight plane): every
//   partial and the total are exact integers below 2^24 pixels.
// - The centroids and their chroma live in shared memory (kp <= 512:
//   8 KB); the centroid loop runs to k_active with strict `<`, so the
//   first minimum wins. Shared memory at kp = 512 with the inertia column
//   is 43 KB a block.
//
// Float rounding: each float operation is one IEEE float32 operation in the
// twin's order, written with the _rn intrinsics so that none is fused into
// an FMA (the library is also built with --fmad=false), and divisions and
// square roots are the IEEE ones. bfloat16 planes widen to float32 by a
// 16-bit shift, which is what `Tensor.float()` does.
//
// What bounds it on this card, per valid pixel and Lloyd step: it reads
// 12 B of float32 planes (6 B of bfloat16, +4 B with a weight plane), and
// does 9 pixel-side operations, 18 per active centroid (2 of them IEEE
// divides) and 2 per output column. At 4K (8,306,688 padded pixels) the
// reads take 29.8 us at 3.35 TB/s; at k = 8 the 1.35 G operations take
// 20 us at 67 TFLOP/s of float32, so bytes bound it on paper. The divides
// are multi-instruction sequences, so in practice the centroid loop sets
// the pace, as in the assign kernel. The staging reduction adds about a
// third to the centroid loop's work at any k.
// Left for later: the factorised CIE94 score, CIEDE2000 (ROADMAP B5, B4)
// and a reduction that keeps more warps busy when kp < 8.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPixPerThread = 4;
constexpr int kTile = kThreads * kPixPerThread;
constexpr int kMaxBlocks = 528;  // 4 blocks on each of the H100's 132 SMs
constexpr float kBig = 3.4e38f;

#define F32(x) static_cast<float>(x)

__device__ __forceinline__ float load_plane(const void* planes, int bf16,
                                            int64_t i) {
  if (bf16) {
    const uint32_t bits = static_cast<const uint16_t*>(planes)[i];
    return __uint_as_float(bits << 16);
  }
  return static_cast<const float*>(planes)[i];
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, offset));
  }
  return v;
}

__global__ void __launch_bounds__(kThreads) lloyd_tile_kernel(
    const void* __restrict__ planes, int bf16, int64_t n_pix, int64_t n_valid,
    const float* __restrict__ centroids, int kp, int k_active,
    const float* __restrict__ weight, int stats, float* __restrict__ partials) {
  extern __shared__ float smem[];
  float* cent = smem;                  // [kp * 3]
  float* chroma = cent + 3 * kp;       // [kp]
  float* acc = chroma + kp;            // [kp * stats]
  float* tl = acc + kp * stats;        // staged tile: [kTile] each
  float* ta = tl + kTile;
  float* tb = ta + kTile;
  float* tw = tb + kTile;
  float* td = tw + kTile;
  int* tk = reinterpret_cast<int*>(td + kTile);

  for (int i = threadIdx.x; i < kp; i += kThreads) {
    const float ca = centroids[3 * i + 1];
    const float cb = centroids[3 * i + 2];
    cent[3 * i + 0] = centroids[3 * i + 0];
    cent[3 * i + 1] = ca;
    cent[3 * i + 2] = cb;
    chroma[i] = __fsqrt_rn(__fadd_rn(__fmul_rn(ca, ca), __fmul_rn(cb, cb)));
  }
  for (int i = threadIdx.x; i < kp * stats; i += kThreads) acc[i] = 0.0f;
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t n_tiles = n_pix / kTile;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t base = tile * kTile;
    for (int j = 0; j < kPixPerThread; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int64_t p = base + i;
      if (p >= n_valid) {
        tk[i] = -1;
        continue;
      }
      const float l = load_plane(planes, bf16, p);
      const float a = load_plane(planes, bf16, n_pix + p);
      const float b = load_plane(planes, bf16, 2 * n_pix + p);
      // Pixel-side CIE94 terms, hoisted out of the centroid loop
      // (kmeans_tpu/ops/kernels.py:1356,1387-1389).
      const float c1 = __fsqrt_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)));
      const float sc = __fadd_rn(1.0f, __fmul_rn(F32(0.045), c1));
      const float sh = __fadd_rn(1.0f, __fmul_rn(F32(0.015), c1));
      const float sh2 = __fmul_rn(sh, sh);
      float best_d = kBig;
      int best_k = 0;
      for (int k = 0; k < k_active; ++k) {
        const float dl = __fsub_rn(l, cent[3 * k + 0]);
        const float da = __fsub_rn(a, cent[3 * k + 1]);
        const float db = __fsub_rn(b, cent[3 * k + 2]);
        const float dcab = __fsub_rn(c1, chroma[k]);
        const float hsq = __fsub_rn(
            __fadd_rn(__fmul_rn(da, da), __fmul_rn(db, db)), __fmul_rn(dcab, dcab));
        const float dhab_sq = fmaxf(hsq, 0.0f);
        const float t = __fdiv_rn(dcab, sc);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dl, dl), __fmul_rn(t, t)),
                                  __fdiv_rn(dhab_sq, sh2));
        if (d < best_d) {
          best_d = d;
          best_k = k;
        }
      }
      tl[i] = l;
      ta[i] = a;
      tb[i] = b;
      tw[i] = weight ? weight[p] : 1.0f;
      td[i] = best_d;
      tk[i] = best_k;
    }
    __syncthreads();

    for (int c = warp; c < kp; c += kWarps) {
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f, s4 = 0.0f;
      for (int i = lane; i < kTile; i += 32) {
        if (tk[i] == c) {
          const float w = tw[i];
          s0 = __fadd_rn(s0, __fmul_rn(tl[i], w));
          s1 = __fadd_rn(s1, __fmul_rn(ta[i], w));
          s2 = __fadd_rn(s2, __fmul_rn(tb[i], w));
          s3 = __fadd_rn(s3, w);
          s4 = __fadd_rn(s4, __fmul_rn(td[i], w));
        }
      }
      s0 = warp_sum(s0);
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      s3 = warp_sum(s3);
      s4 = warp_sum(s4);
      if (lane == 0) {
        float* row = acc + c * stats;
        row[0] = __fadd_rn(row[0], s0);
        row[1] = __fadd_rn(row[1], s1);
        row[2] = __fadd_rn(row[2], s2);
        row[3] = __fadd_rn(row[3], s3);
        if (stats == 5) row[4] = __fadd_rn(row[4], s4);
      }
    }
    __syncthreads();
  }

  float* out = partials + static_cast<int64_t>(blockIdx.x) * kp * stats;
  for (int i = threadIdx.x; i < kp * stats; i += kThreads) out[i] = acc[i];
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
// f32 (bf16 = 0) or bf16 bits (bf16 = 1), n_pix a multiple of 1024;
// centroids [kp * 3] f32; weight [n_pix] f32 or null; partials
// [n_blocks * kp * stats] f32 with n_blocks = kmeans_lloyd_grid_blocks;
// out [kp * stats] f32. It allocates nothing and does not synchronise.
int kmeans_lloyd_accumulate(const void* planes, int bf16, int64_t n_pix,
                            int64_t n_valid, const void* centroids, int kp,
                            int k_active, const void* weight, int stats,
                            void* partials, int n_blocks, void* out,
                            void* stream) {
  if (n_pix % kTile != 0 || (stats != 4 && stats != 5) ||
      n_blocks != kmeans_lloyd_grid_blocks(n_pix)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * (static_cast<size_t>(kp) * (4 + stats) +
                                       5 * static_cast<size_t>(kTile)) +
                      sizeof(int) * kTile;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lloyd_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lloyd_tile_kernel<<<n_blocks, kThreads, smem, s>>>(
      planes, bf16, n_pix, n_valid, static_cast<const float*>(centroids), kp,
      k_active, static_cast<const float*>(weight), stats,
      static_cast<float*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = kp * stats;
  sum_blocks_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partials), n_blocks, n,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
