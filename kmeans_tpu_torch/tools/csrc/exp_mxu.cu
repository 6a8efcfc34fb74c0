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
// factor-vpu: one pixel per thread, the `[kp, 7]` G-table
// (`factor_g_table`, the reference's `_g_table:143`) in shared memory, the
// score `screen.cuh::screen_score` (each product rounded before its add,
// left to right) and strict `<`, so the first minimum wins. Its bits equal
// the twin's, `exp_mxu.py::factor_vpu_reference`.
//
// factor-mxu: the score as a matrix product. Each pixel's eight features
// `[f0, 1, f2, q, f4, f5, rsh2, 0]` times the `[8, kp]` transposed,
// zero-padded G: per warp, 32 pixels as two 16-row A fragments, and per
// 8-centroid n-tile one `mma.sync.aligned.m16n8k8` in TF32 with float32
// accumulation (K = 8 is exactly this product's depth). Both operands are
// rounded to TF32 by `cvt.rna.tf32.f32` (to nearest, ties away) when they
// are staged. Centroids go in chunks of KC = 64 (8 n-tiles): inside a
// chunk each thread keeps the least score of its columns in increasing
// column order (strict `<`), a quad of threads merges its four with the
// lower index winning ties (the chunk's first minimum, `jnp.argmin`'s), and
// the chunk's minimum replaces the pixel's best only when strictly less,
// as the reference merges its chunks. The G fragments are pre-arranged in
// shared memory so each thread reads its two B values for an n-tile as one
// 8-byte word with no bank conflict. Products of two 11-bit significands
// are exact in float32, so only the tensor core's accumulation separates
// it from its twin (`factor_mxu_reference(tf32=True)`); flips against the
// twin fall on near-ties.
//
// What bounds it on this card: per pixel it reads 4 B and writes 1 B
// (41.5 MB at 4K, 12 us at 3.35 TB/s). factor-vpu does 13 float32
// operations per centroid on CUDA cores (67 TFLOP/s): 0.10 ms at 4K
// k = 64. factor-mxu moves the 7 multiply-adds into the tensor core
// (16 flops a centroid at 495 TFLOP/s) and leaves the compare and select
// (2 operations) on CUDA cores: about 4-6x less work. Persistent blocks
// (a grid-stride loop) stage the gamma table and G once per block. Left
// for later: `wgmma`, TMA, deeper pipelining.

#include <cuda_runtime.h>
#include <stdint.h>

#include "colorspace.cuh"
#include "delta_e.cuh"
#include "screen.cuh"

namespace {

using namespace kmeans;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;      // centroids per chunk (KC)
constexpr int kFeatStride = 12; // floats per pixel row of the A staging (no bank conflict)

__device__ __forceinline__ void word_lab(uint32_t w, const float* lut, float* l, float* a,
                                         float* b) {
  linear_to_lab(lut[w & 0xFF], lut[(w >> 8) & 0xFF], lut[(w >> 16) & 0xFF], l, a, b);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__global__ void factor_vpu_kernel(const uint32_t* __restrict__ rgba, int64_t n,
                                  const float* __restrict__ gtab_in, int kp,
                                  const float* __restrict__ gamma_lut,
                                  uint8_t* __restrict__ out) {
  extern __shared__ float smem[];
  float* lut = smem;        // [256]
  float* gtab = smem + 256; // [kp * 7]
  for (int i = threadIdx.x; i < 256; i += blockDim.x) lut[i] = gamma_lut[i];
  for (int i = threadIdx.x; i < kGCols * kp; i += blockDim.x) gtab[i] = gtab_in[i];
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; p < n;
       p += stride) {
    float l, a, b;
    word_lab(rgba[p], lut, &l, &a, &b);
    const ScreenFactors f = screen_factors(l, a, b, chroma(a, b));
    float best_d = kBig;
    int best_k = 0;
    for (int k = 0; k < kp; ++k) {
      const float s = screen_score(f, gtab + kGCols * k);
      if (s < best_d) {
        best_d = s;
        best_k = k;
      }
    }
    out[p] = static_cast<uint8_t>(best_k);
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

// The quad's (4 threads of one row) least score, lower index on ties.
__device__ __forceinline__ Best quad_min(Best x) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    const float od = __shfl_xor_sync(0xFFFFFFFFu, x.d, off);
    const int oi = __shfl_xor_sync(0xFFFFFFFFu, x.i, off);
    if (od < x.d || (od == x.d && oi < x.i)) {
      x.d = od;
      x.i = oi;
    }
  }
  return x;
}

__global__ void factor_mxu_kernel(const uint32_t* __restrict__ rgba, int64_t n,
                                  const float* __restrict__ gmat_in, int kp, int kp_pad,
                                  const float* __restrict__ gamma_lut,
                                  uint8_t* __restrict__ out) {
  extern __shared__ float smem[];
  float* lut = smem;                                        // [256]
  uint32_t* gfrag = reinterpret_cast<uint32_t*>(smem + 256); // [kp_pad / 8][32][2]
  float* feat = smem + 256 + 8 * kp_pad;                    // [kWarps][32][kFeatStride]

  for (int i = threadIdx.x; i < 256; i += blockDim.x) lut[i] = gamma_lut[i];
  // B fragment of n-tile nt for lane (g, t) = (lane / 4, lane % 4): rows
  // t and t + 4 of column g, i.e. features t and t + 4 of centroid
  // nt * 8 + g. gmat_in is [kp_pad, 8], one row per centroid.
  for (int i = threadIdx.x; i < 8 * kp_pad; i += blockDim.x) {
    const int nt = i / 64, lane = (i / 2) % 32, half = i % 2;
    const int c = nt * 8 + lane / 4;
    gfrag[i] = to_tf32(gmat_in[c * 8 + (lane % 4) + 4 * half]);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float* my_feat = feat + warp * 32 * kFeatStride;
  const int64_t n_tiles = (n + 31) / 32;
  for (int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarps + warp; tile < n_tiles;
       tile += static_cast<int64_t>(gridDim.x) * kWarps) {
    // This lane's pixel: its eight features, rounded to TF32, staged.
    const int64_t p = tile * 32 + lane;
    float l, a, b;
    word_lab(p < n ? rgba[p] : 0u, lut, &l, &a, &b);
    const ScreenFactors f = screen_factors(l, a, b, chroma(a, b));
    const float row[8] = {f.f0, 1.0f, f.f2, f.q, f.f4, f.f5, f.rsh2, 0.0f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      my_feat[lane * kFeatStride + j] = __uint_as_float(to_tf32(row[j]));
    }
    __syncwarp();
    // A fragments of the two 16-pixel tiles: rows g, g + 8; columns t, t + 4.
    uint32_t afrag[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float* r0 = my_feat + (m * 16 + g) * kFeatStride;
      const float* r1 = r0 + 8 * kFeatStride;
      afrag[m][0] = __float_as_uint(r0[t]);
      afrag[m][1] = __float_as_uint(r1[t]);
      afrag[m][2] = __float_as_uint(r0[t + 4]);
      afrag[m][3] = __float_as_uint(r1[t + 4]);
    }
    __syncwarp();  // the staging is read before the next tile overwrites it

    // best[m][0]: row g of tile m; best[m][1]: row g + 8.
    Best best[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m) best[m][0] = best[m][1] = Best{kBig, 0};
    for (int c0 = 0; c0 < kp_pad; c0 += kChunk) {
      Best chunk[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m) chunk[m][0] = chunk[m][1] = Best{kBig, 0};
      const int nt_end = min(c0 + kChunk, kp_pad) / 8;
      for (int nt = c0 / 8; nt < nt_end; ++nt) {
        const uint2 bfrag = reinterpret_cast<const uint2*>(gfrag)[nt * 32 + lane];
        const int col0 = nt * 8 + 2 * t;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          float d0, d1, d2, d3;
          asm volatile(
              "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
              : "=f"(d0), "=f"(d1), "=f"(d2), "=f"(d3)
              : "r"(afrag[m][0]), "r"(afrag[m][1]), "r"(afrag[m][2]), "r"(afrag[m][3]),
                "r"(bfrag.x), "r"(bfrag.y), "f"(0.0f));
          if (col0 < kp) {
            take_if_less(&chunk[m][0], d0, col0);
            take_if_less(&chunk[m][1], d2, col0);
          }
          if (col0 + 1 < kp) {
            take_if_less(&chunk[m][0], d1, col0 + 1);
            take_if_less(&chunk[m][1], d3, col0 + 1);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const Best c = quad_min(chunk[m][h]);
          take_if_less(&best[m][h], c.d, c.i);
        }
      }
    }
    if (t == 0) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t q = tile * 32 + m * 16 + h * 8 + g;
          if (q < n) out[q] = static_cast<uint8_t>(best[m][h].i);
        }
      }
    }
  }
}

int grid_blocks(int64_t work_blocks) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  const int64_t cap = static_cast<int64_t>(sms) * 8;
  return static_cast<int>(work_blocks < cap ? (work_blocks > 0 ? work_blocks : 1) : cap);
}

}  // namespace

extern "C" {

// Launches factor-vpu on `stream`; returns the launch's cudaError_t (0 on
// success). Device pointers: rgba [n] u32 RGBA words (R in the low byte);
// gtab [kp * 7] f32 (`factor_g_table`); gamma_lut [256] f32; out [n] u8.
// 1 <= kp <= 256. It allocates nothing and does not synchronise.
int exp_factor_vpu(const void* rgba, int64_t n, const void* gtab, int kp,
                   const void* gamma_lut, void* out, void* stream) {
  if (n < 1 || kp < 1 || kp > 256) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (256 + kGCols * kp);
  factor_vpu_kernel<<<grid_blocks((n + kThreads - 1) / kThreads), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rgba), n, static_cast<const float*>(gtab), kp,
      static_cast<const float*>(gamma_lut), static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Launches factor-mxu on `stream`. gmat [kp_pad * 8] f32: row c is
// centroid c's G row and a zero (rows >= kp are ignored), kp_pad a multiple
// of 8 with kp <= kp_pad; 1 <= kp <= 256. Other arguments as
// exp_factor_vpu.
int exp_factor_mxu(const void* rgba, int64_t n, const void* gmat, int kp, int kp_pad,
                   const void* gamma_lut, void* out, void* stream) {
  if (n < 1 || kp < 1 || kp > 256 || kp_pad % 8 != 0 || kp_pad < kp || kp_pad > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * (256 + 8 * kp_pad + kWarps * 32 * kFeatStride);
  factor_mxu_kernel<<<grid_blocks((n + kThreads - 1) / kThreads), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rgba), n, static_cast<const float*>(gmat), kp, kp_pad,
      static_cast<const float*>(gamma_lut), static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* exp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
