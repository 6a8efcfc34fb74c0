// Fused assign pass for Hopper (sm_90a): u8 sRGB -> Lab -> (Bayer dither)
// -> CIE94 argmin over a palette -> bit-packed palette indices.
//
// Replaces the Pallas TPU kernel `kmeans_tpu/ops/kernels.py::_quantize_kernel`
// in packed-index mode (`fused_assign_packed`), for replace and dither with
// the exact CIE94 metric. The words it writes equal the reference's word for
// word, pad bits included: the plain PyTorch twin
// `kmeans_tpu_torch/ops/kernels.py::assign_packed_reference` is the spec.
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
// divides and square root, not memory bandwidth, are the likely bound.
// Left for later: the factorised CIE94 score (divide-free centroid loop),
// vectorised 16-byte loads, and the colour-out, meld and CIEDE2000 modes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr float kBig = 3.4e38f;

// The reference's constants are Python floats (doubles) rounded to
// float32, so they are written as double literals cast to float here.
#define F32(x) static_cast<float>(x)

__device__ __forceinline__ float lab_f(float t) {
  if (t > F32(0.008856)) {
    return powf(fmaxf(t, 0.0f), F32(1.0 / 3.0));
  }
  return __fadd_rn(__fmul_rn(F32(7.787), t), F32(16.0 / 116.0));
}

// (row0 * r + row1 * g + row2 * b) / wp, summed left to right.
__device__ __forceinline__ float xyz_over_wp(float m0, float m1, float m2,
                                             float r, float g, float b,
                                             float wp) {
  float s = __fadd_rn(__fmul_rn(m0, r), __fmul_rn(m1, g));
  s = __fadd_rn(s, __fmul_rn(m2, b));
  return __fdiv_rn(s, wp);
}

// (M4[y % 4][x % 4] / 16) - 0.5 in closed form
// (kmeans_tpu/ops/kernels.py::_bayer_value).
__device__ __forceinline__ float bayer_value(int64_t x, int64_t y) {
  const int lo = (2 * static_cast<int>(x & 1) + 3 * static_cast<int>(y & 1)) & 3;
  const int hi =
      (2 * static_cast<int>((x >> 1) & 1) + 3 * static_cast<int>((y >> 1) & 1)) & 3;
  const float m = static_cast<float>(4 * lo + hi);
  return __fsub_rn(__fdiv_rn(m, 16.0f), 0.5f);
}

__global__ void assign_packed_kernel(
    const uint8_t* __restrict__ rgb, int64_t n, int64_t width,
    const float* __restrict__ centroids, int kp, int k_active,
    const float* __restrict__ gamma_lut, const float* __restrict__ threshold,
    int dither, int64_t row_offset, int bits, int tile_rows,
    int32_t* __restrict__ out, int64_t n_words) {
  extern __shared__ float smem[];
  float* lut = smem;               // [256]
  float* cent = smem + 256;        // [kp * 3]
  float* chroma = cent + 3 * kp;   // [kp]

  for (int i = threadIdx.x; i < 256; i += blockDim.x) lut[i] = gamma_lut[i];
  for (int i = threadIdx.x; i < kp; i += blockDim.x) {
    const float ca = centroids[3 * i + 1];
    const float cb = centroids[3 * i + 2];
    cent[3 * i + 0] = centroids[3 * i + 0];
    cent[3 * i + 1] = ca;
    cent[3 * i + 2] = cb;
    chroma[i] = __fsqrt_rn(__fadd_rn(__fmul_rn(ca, ca), __fmul_rn(cb, cb)));
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
    float lr = 0.0f, lg = 0.0f, lb = 0.0f;
    if (p < n) {
      lr = lut[rgb[3 * p + 0]];
      lg = lut[rgb[3 * p + 1]];
      lb = lut[rgb[3 * p + 2]];
    } else {
      lr = lg = lb = lut[0];
    }
    // sRGB -> Lab (kmeans_tpu/ops/kernels.py::_lab_from_linear_planes).
    const float fx = lab_f(xyz_over_wp(F32(0.4124564), F32(0.3575761),
                                       F32(0.1804375), lr, lg, lb,
                                       F32(95.0489)));
    const float fy = lab_f(xyz_over_wp(F32(0.2126729), F32(0.7151522),
                                       F32(0.0721750), lr, lg, lb,
                                       F32(100.0)));
    const float fz = lab_f(xyz_over_wp(F32(0.0193339), F32(0.1191920),
                                       F32(0.9503041), lr, lg, lb,
                                       F32(108.8840)));
    float l = __fsub_rn(__fmul_rn(116.0f, fy), 16.0f);
    float a = __fmul_rn(500.0f, __fsub_rn(fx, fy));
    float b = __fmul_rn(200.0f, __fsub_rn(fy, fz));

    if (dither) {
      const int64_t px = p % width;
      const int64_t py = p / width + row_offset;
      const float adjust = __fmul_rn(thr, bayer_value(px, py));
      l = __fadd_rn(l, adjust);
      a = __fadd_rn(a, adjust);
      b = __fadd_rn(b, adjust);
    }

    // Pixel-side CIE94 terms, hoisted out of the centroid loop
    // (kmeans_tpu/ops/kernels.py:823-826).
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
    word |= static_cast<uint32_t>(best_k) << (bits * j);
  }
  out[g] = static_cast<int32_t>(word);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns the launch's cudaError_t
// (0 on success). All pointers are device pointers: rgb [n * 3] u8,
// centroids [kp * 3] f32, gamma_lut [256] f32, threshold [1] f32,
// out [n_words] i32 with n_words = n_pad / ppw, n_pad a multiple of
// tile_rows * 128. It allocates nothing and does not synchronise.
int kmeans_assign_packed(const void* rgb, int64_t n, int64_t width,
                         const void* centroids, int kp, int k_active,
                         const void* gamma_lut, const void* threshold,
                         int dither, int64_t row_offset, int bits,
                         int tile_rows, void* out, int64_t n_words,
                         void* stream) {
  const int threads = 256;
  const int64_t blocks = (n_words + threads - 1) / threads;
  const size_t smem = sizeof(float) * (256 + 4 * static_cast<size_t>(kp));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        assign_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  assign_packed_kernel<<<static_cast<unsigned int>(blocks), threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rgb), n, width,
      static_cast<const float*>(centroids), kp, k_active,
      static_cast<const float*>(gamma_lut),
      static_cast<const float*>(threshold), dither, row_offset, bits,
      tile_rows, static_cast<int32_t*>(out), n_words);
  return static_cast<int>(cudaGetLastError());
}

const char* kmeans_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
