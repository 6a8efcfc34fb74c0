// The factorized CIE94 argmin of `tools/exp_mxu.py`, for Hopper (sm_90a),
// in two bodies: on CUDA cores (factor-vpu) and on tensor cores
// (factor-mxu). An experiment: no entry point of the port calls it; the
// tool `kmeans_tpu_torch/tools/exp_mxu.py` times it.
//
// Replaces the Pallas kernels of `tools/exp_mxu.py::_build_kernels`:
// `_factor_vpu_kernel` (`:94`) and `_factor_mxu_kernel` (`:118`), launched
// by `_run` (`pallas_call` at `:173`). Both read RGBA pixels as u32 words,
// convert them to Lab through the 256-entry gamma table, form the six
// pixel factors of the factorized score (`screen.cuh::screen_factors`, the
// reference's `_pixel_features:73`) and write, per pixel, the index of the
// centroid with the least score `F(p) . G(c)` as one byte (kp <= 256; the
// reference writes i32 and the host casts it to u8). No k <= 16 gate, no
// k_active, no dither.
//
// factor-vpu: a register tile. Each thread keeps kVpuTilePixels pixels
// as runs of 4 consecutive RGBA words (run q of a tile 4 * kThreads
// pixels past run q - 1), each run one 16-byte load, converts them all
// to Lab (`word_lab`) and then forms their factors
// (`screen.cuh::screen_factors`). The `[kp, 7]`
// G-table (`factor_g_table`, the reference's `_g_table:143`) is staged
// padded to 8 columns (`stage_feature_rows`) beside the gamma table, and
// `screen.cuh::scan_factor_tile` scores the tile with the centroid loop
// outermost: two 16-byte shared loads of a row serve the tile's pixels.
// The score is `screen_score4` (each product rounded before its add,
// left to right) and each pixel's carry sees the centroids in index order
// with strict `<`, so the first minimum wins and every index equals the
// twin's, `exp_mxu.py::factor_vpu_reference`, bit for bit. A run's four
// bytes go out as one 32-bit store. The pixels past the last whole tile
// (n is any count) go one a thread through the same scan. The launcher
// takes the image only at a 16-byte aligned address (the wrapper copies a
// view that starts elsewhere, such as a row slice of an odd-width image).
//
// factor-mxu: the score as a matrix product on Hopper's warpgroup MMA.
// Each pixel's eight features `[f0, 1, f2, q, f4, f5, rsh2, 0]` times the
// `[8, kp_pad]` G, as `wgmma.mma_async.m64n64k8.f32.tf32.tf32` (K = 8 is
// exactly this product's depth): a warpgroup (4 warps) takes 128 pixels a
// step, two 64-row tiles, and each instruction scores one tile against a
// chunk of 64 centroids. A comes from registers: each lane converts one
// pixel, rounds its features to TF32 (`cvt.rna.tf32.f32`, to nearest,
// ties away) and stages them through the warp's shared rows into the A
// fragments. B, the host-arranged TF32 G (`exp_mxu.py::mxu_b_operand`:
// per 8 centroids, the 8 x 4 core matrix of features 0-3, then that of
// features 4-7; padded columns score +inf), sits in shared memory behind a
// `wgmma` descriptor without swizzle. A chunk's two products (one per
// tile) run as one stage; while the first chunk's run, the lanes convert
// the next step's pixels, whose words they loaded a step before, so a step
// waits on no load. The accumulators are read only after `wait_group 0`:
// `ptxas` serializes every product (a wait after each) when one is read
// while another product is in flight, which a chunk-to-chunk pipeline
// does. The scan runs on the accumulator fragment, fully unrolled and
// without a column test (a padded column's +inf never passes strict `<`):
// each thread keeps the least score of its even and of its odd columns,
// each in increasing column order with strict `<` across the chunks (two
// independent chains a row), and merges the two and then the quad's (4
// threads of a row) with the lower index winning ties. That is the first
// minimum over all centroids, which is what the reference's chunks give
// (the first minimum inside a chunk, replaced only by a strictly smaller
// one from a later chunk), since each score is the same in both. Products
// of two 11-bit significands are exact in float32, so only the tensor
// core's accumulation separates it from its twin
// (`factor_mxu_reference(tf32=True)`); flips against the twin fall on
// near-ties.
//
// What bounds it on this card: per pixel it reads 4 B and writes 1 B
// (41.5 MB at 4K, 12 us at 3.35 TB/s). factor-vpu does 13 float32
// operations per centroid on CUDA cores (67 TFLOP/s counts an FMA as two):
// 0.10 ms at 4K k = 64. The library is built with `--fmad=false`, so each
// of them is one issue slot, and the card issues 132 SMs x 128 lanes x
// 1.98 GHz, about 33.5 T instructions a second: half that bound's rate, so
// 50% of the bound is the ceiling. The score, its compare and two selects
// are 15 instructions a pair, which exactness fixes (no product fused into
// its add); what the tile cuts is the rest: the shared loads of a row (one
// pair of 16-byte loads a tile, not seven scalar loads a pixel), the loop
// overhead, and the global loads and byte stores a pixel. factor-mxu
// leaves 16 TF32 flops a centroid to the tensor cores (495 TFLOP/s) and
// the compare and select (an FSETP and two selects a pixel-centroid pair)
// and each pixel's conversion (three `powf`, two divides) to the CUDA
// cores, which set its pace. Persistent blocks (a grid-stride loop) stage
// the gamma table and G once per block. Left for later: TMA, a producer
// warp.

#include <cuda_runtime.h>
#include <stdint.h>

#include "colorspace.cuh"
#include "delta_e.cuh"
#include "screen.cuh"

namespace {

using namespace kmeans;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFeatStride = 12; // floats per pixel row of the A staging (no bank conflict)
constexpr int kChunk = 64;      // centroids a wgmma scores (N)
constexpr int kMxuBlocksPerSm = 2;
constexpr int kGroups = kThreads / 128;  // warpgroups a factor-mxu block
constexpr int kStepPixels = 128;         // pixels a warpgroup step: two 64-row tiles
// factor-vpu's register tile (a multiple of 4: runs of one 16-byte load)
// and the blocks an SM its `__launch_bounds__` asks for.
constexpr int kVpuTilePixels = 8;
constexpr int kVpuMinBlocks = 2;

__device__ __forceinline__ void word_lab(uint32_t w, const float* lut, float* l, float* a,
                                         float* b) {
  linear_to_lab(lut[w & 0xFF], lut[(w >> 8) & 0xFF], lut[(w >> 16) & 0xFF], l, a, b);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// The factors of one RGBA word (R in the low byte).
__device__ __forceinline__ ScreenFactors word_factors(uint32_t w, const float* lut) {
  float l, a, b;
  word_lab(w, lut, &l, &a, &b);
  return screen_factors(l, a, b, chroma(a, b));
}

__global__ void __launch_bounds__(kThreads, kVpuMinBlocks)
    factor_vpu_kernel(const uint32_t* __restrict__ rgba, int64_t n,
                      const float* __restrict__ gtab_in, int kp,
                      const float* __restrict__ gamma_lut, uint8_t* __restrict__ out) {
  extern __shared__ float4 smem_vpu[];
  float4* g = smem_vpu;                                       // [2 kp] padded rows
  float* lut = reinterpret_cast<float*>(smem_vpu + 2 * kp);  // [256]
  for (int i = threadIdx.x; i < 256; i += blockDim.x) lut[i] = gamma_lut[i];
  stage_feature_rows(gtab_in, g, kp);
  __syncthreads();
  constexpr int P = kVpuTilePixels;
  const int64_t n_tiles = n / (kThreads * P);
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t p0 = tile * kThreads * P + 4 * threadIdx.x;
    // Every pixel to Lab first, then the factors: converting and factoring
    // pixel by pixel let the compiler recompute one pixel's reciprocal in
    // each pass of the centroid loop (145 instructions a pass, not 126).
    float l[P], a[P], b[P];
#pragma unroll
    for (int q = 0; q < P / 4; ++q) {
      const uint4 w = *reinterpret_cast<const uint4*>(rgba + p0 + q * 4 * kThreads);
      word_lab(w.x, lut, &l[4 * q], &a[4 * q], &b[4 * q]);
      word_lab(w.y, lut, &l[4 * q + 1], &a[4 * q + 1], &b[4 * q + 1]);
      word_lab(w.z, lut, &l[4 * q + 2], &a[4 * q + 2], &b[4 * q + 2]);
      word_lab(w.w, lut, &l[4 * q + 3], &a[4 * q + 3], &b[4 * q + 3]);
    }
    ScreenFactors f[P];
#pragma unroll
    for (int s = 0; s < P; ++s) f[s] = screen_factors(l[s], a[s], b[s], chroma(a[s], b[s]));
    Closest best[P];
    scan_factor_tile<P>(f, best, g, kp);
#pragma unroll
    for (int q = 0; q < P / 4; ++q) {
      *reinterpret_cast<uint32_t*>(out + p0 + q * 4 * kThreads) =
          static_cast<uint32_t>(best[4 * q].k) | static_cast<uint32_t>(best[4 * q + 1].k) << 8 |
          static_cast<uint32_t>(best[4 * q + 2].k) << 16 |
          static_cast<uint32_t>(best[4 * q + 3].k) << 24;
    }
  }
  // The pixels past the last whole tile, one a thread.
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t p = n_tiles * kThreads * P + static_cast<int64_t>(blockIdx.x) * kThreads +
                   threadIdx.x;
       p < n; p += stride) {
    const ScreenFactors f[1] = {word_factors(rgba[p], lut)};
    Closest best[1];
    scan_factor_tile<1>(f, best, g, kp);
    out[p] = static_cast<uint8_t>(best[0].k);
  }
}

// One running minimum of a row: its score and column.
struct Best {
  float d;
  int i;
};

__device__ __forceinline__ void take_if_less(Best* best, float d, int i) {
  if (d < best->d) {
    best->d = d;
    best->i = i;
  }
}

// The lesser of two running minimums, the lower index on ties.
__device__ __forceinline__ Best lesser(Best x, Best y) {
  return (y.d < x.d || (y.d == x.d && y.i < x.i)) ? y : x;
}

// The quad's (4 threads of one row) least score, lower index on ties.
__device__ __forceinline__ Best quad_min(Best x) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    x = lesser(x, Best{__shfl_xor_sync(0xFFFFFFFFu, x.d, off),
                       __shfl_xor_sync(0xFFFFFFFFu, x.i, off)});
  }
  return x;
}

// The `wgmma` shared-memory descriptor of a K-major operand without
// swizzle: start address, leading byte offset (from the core matrix of
// features 0-3 to that of features 4-7: 128 B) and stride byte offset
// (from 8 centroids to the next 8: 256 B), each in 16-byte units.
__device__ __forceinline__ uint64_t b_descriptor(const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Tells the compiler the accumulator changes here, so that no read of it
// moves above the `wait_group` before it.
__device__ __forceinline__ void fence_accumulator(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A (64 x 8, this warp's 16 rows in registers) times B (8 x 64, the
// descriptor's), TF32 in, float32 out; the old d is not read (scale-d 0).
// d[4 j + e] is row g + 8 (e / 2), column 8 j + 2 t + (e & 1) of this
// warp's 16 rows.
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

// A tile's accumulator into the running minimums: best[h][e] keeps row
// g + 8 h over the thread's columns of parity e, in increasing order with
// strict `<`: four independent chains a thread, merged at the end.
__device__ __forceinline__ void scan_tile(const float (&d)[32], Best (&best)[2][2], int col0) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    take_if_less(&best[0][0], d[4 * j], col0 + 8 * j);
    take_if_less(&best[0][1], d[4 * j + 1], col0 + 8 * j + 1);
    take_if_less(&best[1][0], d[4 * j + 2], col0 + 8 * j);
    take_if_less(&best[1][1], d[4 * j + 3], col0 + 8 * j + 1);
  }
}

// This lane's RGBA word at step `step` (0 past the image): the pixel of
// row 16 warp + lane % 16 of tile lane / 16.
__device__ __forceinline__ uint32_t step_word(const uint32_t* __restrict__ rgba, int64_t n,
                                              int64_t step, int warp, int lane) {
  const int64_t q = step * kStepPixels + 64 * (lane / 16) + 16 * warp + lane % 16;
  return q < n ? rgba[q] : 0u;
}

// The pixel's eight features, rounded to TF32, into its row of the warp's
// staging (two 16-byte stores).
__device__ __forceinline__ void stage_features(uint32_t word, const float* lut, float* row) {
  const ScreenFactors f = word_factors(word, lut);
  reinterpret_cast<float4*>(row)[0] =
      make_float4(__uint_as_float(to_tf32(f.f0)), 1.0f, __uint_as_float(to_tf32(f.f2)),
                  __uint_as_float(to_tf32(f.q)));
  reinterpret_cast<float4*>(row)[1] =
      make_float4(__uint_as_float(to_tf32(f.f4)), __uint_as_float(to_tf32(f.f5)),
                  __uint_as_float(to_tf32(f.rsh2)), 0.0f);
}

// A fragments of the two tiles from the warp's staging: rows g, g + 8;
// features t, t + 4.
__device__ __forceinline__ void load_fragments(const float* staging, int g, int t,
                                               uint32_t (&afrag)[2][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const float* r0 = staging + (16 * m + g) * kFeatStride;
    const float* r1 = r0 + 8 * kFeatStride;
    afrag[m][0] = __float_as_uint(r0[t]);
    afrag[m][1] = __float_as_uint(r1[t]);
    afrag[m][2] = __float_as_uint(r0[t + 4]);
    afrag[m][3] = __float_as_uint(r1[t + 4]);
  }
}

__global__ void __launch_bounds__(kThreads, kMxuBlocksPerSm)
    factor_mxu_kernel(const uint32_t* __restrict__ rgba, int64_t n,
                      const uint4* __restrict__ gb_in, int chunks,
                      const float* __restrict__ gamma_lut, uint8_t* __restrict__ out) {
  extern __shared__ __align__(128) uint4 smem_mxu[];
  uint4* gb = smem_mxu;                                              // [chunks * 128]
  float* lut = reinterpret_cast<float*>(smem_mxu + chunks * 128);    // [256]
  float* feat = lut + 256;                                           // [kWarps][32][kFeatStride]
  for (int i = threadIdx.x; i < chunks * 128; i += blockDim.x) gb[i] = gb_in[i];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) lut[i] = gamma_lut[i];
  // The tensor cores read G through the async proxy.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int group = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float* staging = feat + (threadIdx.x / 32) * 32 * kFeatStride;
  const uint64_t desc0 = b_descriptor(gb);
  constexpr uint64_t kChunkDesc = kChunk * 8 * 4 / 16;  // a chunk of G in 16-byte units
  float acc[2][kChunk / 2];
#pragma unroll
  for (int i = 0; i < kChunk / 2; ++i) acc[0][i] = acc[1][i] = 0.0f;

  // While the tensor cores score a step's first chunk, the lanes convert
  // the next step's pixels (their words loaded a step earlier) and load
  // the words of the step after it. The accumulators are read only after
  // `wgmma.wait_group 0`, so `ptxas` serializes no product.
  const int64_t steps = (n + kStepPixels - 1) / kStepPixels;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kGroups;
  int64_t step = static_cast<int64_t>(blockIdx.x) * kGroups + group;
  uint32_t afrag[2][4];
  if (step < steps) {
    stage_features(step_word(rgba, n, step, warp, lane), lut, staging + lane * kFeatStride);
    __syncwarp();
    load_fragments(staging, g, t, afrag);
    __syncwarp();
  }
  uint32_t word_next = step_word(rgba, n, step + stride, warp, lane);
  for (; step < steps; step += stride) {
    const bool more = step + stride < steps;
    // best[m][h][e]: row g + 8 h of tile m, columns of parity e.
    Best best[2][2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) best[m][h][0] = best[m][h][1] = Best{kBig, 0};
    }
    for (int c = 0; c < chunks; ++c) {
      const uint64_t desc = desc0 + c * kChunkDesc;
      wgmma_fence();
      wgmma_m64n64k8(acc[0], afrag[0], desc);
      wgmma_m64n64k8(acc[1], afrag[1], desc);
      wgmma_commit();
      if (c == 0 && more) {
        const uint32_t word = word_next;
        word_next = step_word(rgba, n, step + 2 * stride, warp, lane);
        stage_features(word, lut, staging + lane * kFeatStride);
      }
      wgmma_wait_all();
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        fence_accumulator(acc[m]);
        scan_tile(acc[m], best[m], c * kChunk + 2 * t);
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const Best r = quad_min(lesser(best[m][h][0], best[m][h][1]));
        const int64_t q = step * kStepPixels + 64 * m + 16 * warp + 8 * h + g;
        if (t == 0 && q < n) out[q] = static_cast<uint8_t>(r.i);
      }
    }
    if (more) {
      __syncwarp();
      load_fragments(staging, g, t, afrag);
      __syncwarp();
    }
  }
}

int grid_blocks(int64_t work_blocks, int per_sm) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  const int64_t cap = static_cast<int64_t>(sms) * per_sm;
  return static_cast<int>(work_blocks < cap ? (work_blocks > 0 ? work_blocks : 1) : cap);
}

}  // namespace

extern "C" {

// Launches factor-vpu on `stream`; returns the launch's cudaError_t (0 on
// success). Device pointers: rgba [n] u32 RGBA words (R in the low byte),
// 16-byte aligned; gtab [kp * 7] f32 (`factor_g_table`); gamma_lut [256]
// f32; out [n] u8, 4-byte aligned. 1 <= kp <= 256. It refuses a
// misaligned rgba or out (cudaErrorMisalignedAddress) and never reads one.
// It allocates nothing and does not synchronise.
int exp_factor_vpu(const void* rgba, int64_t n, const void* gtab, int kp,
                   const void* gamma_lut, void* out, void* stream) {
  if (n < 1 || kp < 1 || kp > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(rgba) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 4 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const size_t smem = sizeof(float) * (8 * kp + 256);
  const int64_t tile = static_cast<int64_t>(kThreads) * kVpuTilePixels;
  const int64_t tail_blocks = (n % tile + kThreads - 1) / kThreads;
  const int64_t tiles = n / tile;
  factor_vpu_kernel<<<grid_blocks(tiles > tail_blocks ? tiles : tail_blocks, kVpuMinBlocks),
                      kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rgba), n, static_cast<const float*>(gtab), kp,
      static_cast<const float*>(gamma_lut), static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Launches factor-mxu on `stream`. gb [kp_pad * 8] TF32 values in the
// `wgmma` B layout of `exp_mxu.py::mxu_b_operand` (its padded columns
// score +inf); kp_pad a multiple of 64 with kp <= kp_pad <= 256 and
// 1 <= kp. Other arguments as exp_factor_vpu.
int exp_factor_mxu(const void* rgba, int64_t n, const void* gb, int kp, int kp_pad,
                   const void* gamma_lut, void* out, void* stream) {
  if (n < 1 || kp < 1 || kp_pad % kChunk != 0 || kp_pad < kp || kp_pad > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunks = kp_pad / kChunk;
  const size_t smem = sizeof(float) * (kp_pad * 8 + 256 + kWarps * 32 * kFeatStride);
  const int64_t steps = (n + kStepPixels - 1) / kStepPixels;
  factor_mxu_kernel<<<grid_blocks((steps + kGroups - 1) / kGroups, kMxuBlocksPerSm), kThreads,
                      smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rgba), n, static_cast<const uint4*>(gb), chunks,
      static_cast<const float*>(gamma_lut), static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* exp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
