// sRGB <-> CIELAB device functions shared by the port's image kernels
// (`quantize_assign.cu`, `quantize_meld.cu`).
//
// Each float operation is one IEEE float32 operation in the order of the
// plain PyTorch twin `kmeans_tpu_torch/ops/colorspace.py` (itself the
// reference's `kmeans_tpu/ops/kernels.py::_lab_from_linear_planes` and
// `_lab_to_srgb_planes`), written with the _rn intrinsics so that none is
// fused into an FMA. `powf` is the CUDA math library's, the function
// PyTorch's CUDA `pow` calls for a float exponent. The divides by the white
// point go through its reciprocals (recip.cuh), the IEEE quotient in the
// range their dividends take.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "recip.cuh"

// The reference's constants are Python floats (doubles) rounded to
// float32, so they are written as double literals cast to float here.
#ifndef F32
#define F32(x) static_cast<float>(x)
#endif

namespace kmeans {

// The white point's reciprocals, RN(1 / F32(wp)) (checked by
// `tests/test_torch_divide.py`).
constexpr float kRcpWpX = 0x1.58bfb6p-7f;  // 1 / 95.0489
constexpr float kRcpWpY = 0x1.47ae14p-7f;  // 1 / 100.0
constexpr float kRcpWpZ = 0x1.2cf1b2p-7f;  // 1 / 108.8840

// The cube root is taken whatever the branch and then selected, so that a
// pixel's three channels, and the pixels a thread holds, carry no branch
// between them; the bits are those of the branch.
__device__ __forceinline__ float lab_f(float t) {
  const float root = powf(fmaxf(t, 0.0f), F32(1.0 / 3.0));
  const float lin = __fadd_rn(__fmul_rn(F32(7.787), t), F32(16.0 / 116.0));
  return t > F32(0.008856) ? root : lin;
}

// (row0 * r + row1 * g + row2 * b) / wp, summed left to right, divided
// through the white point's reciprocal `rwp` (recip.cuh::div_by_recip):
// the gamma table's entries are 0 or at least 0.03 and the rows'
// coefficients positive and at least 0.019, so s is 0 or in
// [5.8e-4, 96], where that quotient is the IEEE one.
__device__ __forceinline__ float xyz_over_wp(float m0, float m1, float m2,
                                             float r, float g, float b,
                                             float wp, float rwp) {
  float s = __fadd_rn(__fmul_rn(m0, r), __fmul_rn(m1, g));
  s = __fadd_rn(s, __fmul_rn(m2, b));
  return div_by_recip(s, wp, rwp);
}

// Lab of one pixel from its linear R, G, B (x100, from the gamma table).
__device__ __forceinline__ void linear_to_lab(float lr, float lg, float lb,
                                              float* l, float* a, float* b) {
  const float fx = lab_f(xyz_over_wp(F32(0.4124564), F32(0.3575761), F32(0.1804375), lr, lg,
                                     lb, F32(95.0489), kRcpWpX));
  const float fy = lab_f(xyz_over_wp(F32(0.2126729), F32(0.7151522), F32(0.0721750), lr, lg,
                                     lb, F32(100.0), kRcpWpY));
  const float fz = lab_f(xyz_over_wp(F32(0.0193339), F32(0.1191920), F32(0.9503041), lr, lg,
                                     lb, F32(108.8840), kRcpWpZ));
  *l = __fsub_rn(__fmul_rn(116.0f, fy), 16.0f);
  *a = __fmul_rn(500.0f, __fsub_rn(fx, fy));
  *b = __fmul_rn(200.0f, __fsub_rn(fy, fz));
}

// Lab of pixel p of a [n, 3] u8 RGB image; pixels p >= n are the
// reference's zero padding, RGB (0, 0, 0). `lut` is the gamma table.
__device__ __forceinline__ void pixel_lab(const uint8_t* __restrict__ rgb,
                                          int64_t n, int64_t p,
                                          const float* lut, float* l,
                                          float* a, float* b) {
  const bool pad = p >= n;
  const int64_t q = pad ? 0 : p;  // a valid address either way: the loads need no branch
  const float lr = lut[pad ? 0 : rgb[3 * q + 0]];
  const float lg = lut[pad ? 0 : rgb[3 * q + 1]];
  const float lb = lut[pad ? 0 : rgb[3 * q + 2]];
  linear_to_lab(lr, lg, lb, l, a, b);
}

__device__ __forceinline__ float lab_f_inv(float t) {
  const float t3 = __fmul_rn(__fmul_rn(t, t), t);
  return t3 > F32(0.008856)
             ? t3
             : __fdiv_rn(__fsub_rn(t, F32(16.0 / 116.0)), F32(7.787));
}

// One sRGB channel in [0, 1] from its linear value, as u8: rintf rounds
// half to even like torch.round. A NaN (a meld blend of two equal
// centroids) becomes 0: fmaxf drops it, as the twin's nan_to_num does.
// This is the definition; the kernels take `linear_to_srgb8` below.
__device__ __forceinline__ int linear_to_srgb8_pow(float c) {
  const float safe = fmaxf(c, 0.0f);
  const float v = c > F32(0.0031308)
                      ? __fsub_rn(__fmul_rn(F32(1.055), powf(safe, F32(1.0 / 2.4))),
                                  F32(0.055))
                      : __fmul_rn(F32(12.92), c);
  const float clipped = fminf(fmaxf(v, 0.0f), 1.0f);
  return static_cast<int>(rintf(__fmul_rn(clipped, 255.0f)));
}

// `linear_to_srgb8_pow` maps every float32 to a u8 that does not decrease
// with the input, and NaN and every input below +0 to 0: a run of
// `csrc/srgb_steps.cu` over all 2^32 inputs on the card checks both. So
// the byte is the number of step points at or below the input, step point
// j (1..255) the least non-negative float the definition maps to j or
// more. KM_SRGB8_STEPS lists their bits as int32, entry 0 unused
// (`kmeans_tpu_torch/tools/srgb_steps.py` recomputes them on the card).
#define KM_SRGB8_STEPS \
  0, 0x391f22b5, 0x39eeb40e, 0x3a46eb62, 0x3a8b3e5d, 0x3ab3070c, 0x3adacfb7, 0x3b014c33, \
  0x3b153089, 0x3b2914e1, 0x3b3cf936, 0x3b50f2d1, 0x3b65fb9a, 0x3b7c3404, 0x3b89d05f, 0x3b962333, \
  0x3ba314be, 0x3bb0a733, 0x3bbedcb6, 0x3bcdb770, 0x3bdd3966, 0x3bed64b2, 0x3bfe3b44, 0x3c07df92, \
  0x3c10f919, 0x3c1a6b35, 0x3c2436c7, 0x3c2e5cc9, 0x3c38de19, 0x3c43bba6, 0x3c4ef646, 0x3c5a8ee4, \
  0x3c668654, 0x3c72dd73, 0x3c7f9512, 0x3c865703, 0x3c8d148f, 0x3c940396, 0x3c9b247c, 0x3ca277a8, \
  0x3ca9fd79, 0x3cb1b654, 0x3cb9a299, 0x3cc1c2a9, 0x3cca16e3, 0x3cd29fa4, 0x3cdb5d4d, 0x3ce45034, \
  0x3ced78b6, 0x3cf6d72f, 0x3d0035fc, 0x3d051bb6, 0x3d0a1cee, 0x3d0f39d1, 0x3d14728a, 0x3d19c745, \
  0x3d1f382b, 0x3d24c56a, 0x3d2a6f24, 0x3d303586, 0x3d3618b9, 0x3d3c18e6, 0x3d423634, 0x3d4870cb, \
  0x3d4ec8d3, 0x3d553e77, 0x3d5bd1d4, 0x3d62831c, 0x3d69526b, 0x3d703ff2, 0x3d774bce, 0x3d7e762b, \
  0x3d82df92, 0x3d869376, 0x3d8a56cc, 0x3d8e29ae, 0x3d920c28, 0x3d95fe51, 0x3d9a0036, 0x3d9e11ee, \
  0x3da23384, 0x3da66513, 0x3daaa6a0, 0x3daef849, 0x3db35a17, 0x3db7cc20, 0x3dbc4e6c, 0x3dc0e119, \
  0x3dc5842a, 0x3dca37bd, 0x3dcefbd6, 0x3dd3d093, 0x3dd8b5f6, 0x3dddac1c, 0x3de2b30a, 0x3de7cadc, \
  0x3decf395, 0x3df22d52, 0x3df7781a, 0x3dfcd401, 0x3e012088, 0x3e03dfb0, 0x3e06a77c, 0x3e0977f9, \
  0x3e0c5127, 0x3e0f3316, 0x3e121dc6, 0x3e151145, 0x3e180d95, 0x3e1b12c4, 0x3e1e20d1, 0x3e2137cc, \
  0x3e2457b7, 0x3e27809c, 0x3e2ab27c, 0x3e2ded6a, 0x3e313160, 0x3e347e73, 0x3e37d49d, 0x3e3b33ee, \
  0x3e3e9c68, 0x3e420e18, 0x3e4588fa, 0x3e490d25, 0x3e4c9a8f, 0x3e50314f, 0x3e53d15c, 0x3e577acd, \
  0x3e5b2d99, 0x3e5ee9d6, 0x3e62af7c, 0x3e667ea1, 0x3e6a5740, 0x3e6e3968, 0x3e722513, 0x3e761a58, \
  0x3e7a192d, 0x3e7e21aa, 0x3e8119e2, 0x3e8327ca, 0x3e853a87, 0x3e875224, 0x3e896e9e, 0x3e8b8fff, \
  0x3e8db641, 0x3e8fe172, 0x3e92118b, 0x3e944698, 0x3e968095, 0x3e98bf8b, 0x3e9b0377, 0x3e9d4c63, \
  0x3e9f9a4b, 0x3ea1ed3a, 0x3ea4452a, 0x3ea6a228, 0x3ea9042d, 0x3eab6b45, 0x3eadd76b, 0x3eb048ac, \
  0x3eb2bf01, 0x3eb53a75, 0x3eb7bb01, 0x3eba40b4, 0x3ebccb86, 0x3ebf5b85, 0x3ec1f0a7, 0x3ec48afc, \
  0x3ec72a7c, 0x3ec9cf35, 0x3ecc791e, 0x3ecf2844, 0x3ed1dca2, 0x3ed49644, 0x3ed75521, 0x3eda1948, \
  0x3edce2b1, 0x3edfb169, 0x3ee2856a, 0x3ee55ebf, 0x3ee83d61, 0x3eeb215f, 0x3eee0ab0, 0x3ef0f960, \
  0x3ef3ed69, 0x3ef6e6da, 0x3ef9e5a7, 0x3efce9e0, 0x3efff37f, 0x3f018147, 0x3f030b82, 0x3f04987a, \
  0x3f062827, 0x3f07ba94, 0x3f094fba, 0x3f0ae7a1, 0x3f0c8244, 0x3f0e1fac, 0x3f0fbfd2, 0x3f1162bf, \
  0x3f13086e, 0x3f14b0e6, 0x3f165c22, 0x3f180a2a, 0x3f19baf9, 0x3f1b6e97, 0x3f1d24fe, 0x3f1ede37, \
  0x3f209a3b, 0x3f225914, 0x3f241abb, 0x3f25df39, 0x3f27a688, 0x3f2970b0, 0x3f2b3dac, 0x3f2d0d83, \
  0x3f2ee033, 0x3f30b5c0, 0x3f328e25, 0x3f34696b, 0x3f36478c, 0x3f382891, 0x3f3a0c73, 0x3f3bf33c, \
  0x3f3ddce5, 0x3f3fc977, 0x3f41b8eb, 0x3f43ab4a, 0x3f45a08f, 0x3f4798c1, 0x3f4993db, 0x3f4b91e4, \
  0x3f4d92d8, 0x3f4f96bf, 0x3f519d91, 0x3f53a75a, 0x3f55b410, 0x3f57c3bf, 0x3f59d65e, 0x3f5bebf8, \
  0x3f5e0485, 0x3f60200f, 0x3f623e91, 0x3f64600f, 0x3f668486, 0x3f68abfe, 0x3f6ad671, 0x3f6d03e8, \
  0x3f6f345b, 0x3f7167d5, 0x3f739e4d, 0x3f75d7cf, 0x3f781452, 0x3f7a53e0, 0x3f7c9671, 0x3f7edc11
static __device__ const int kSrgb8Steps[256] = {KM_SRGB8_STEPS};

// `linear_to_srgb8_pow`'s byte by an 8-step search of the step points
// `steps` (a shared copy of kSrgb8Steps): positive floats order as their
// bits do; NaN, -0 and negatives search from 0 or INT_MIN and find none.
__device__ __forceinline__ int linear_to_srgb8(float c, const int* steps) {
  const int x = c >= 0.0f ? __float_as_int(c) : 0;
  int pos = 0;
#pragma unroll
  for (int s = 128; s >= 1; s >>= 1) pos += x >= steps[pos + s] ? s : 0;
  return pos;
}

// Lab -> u8 sRGB (kmeans_tpu_torch/ops/colorspace.py::lab_to_srgb), the
// encode by the step points `steps`.
__device__ __forceinline__ void lab_to_srgb8(float l, float a, float b, const int* steps,
                                             int* r8, int* g8, int* b8) {
  const float fy = __fdiv_rn(__fadd_rn(l, 16.0f), 116.0f);
  const float fx = __fadd_rn(__fdiv_rn(a, 500.0f), fy);
  const float fz = __fsub_rn(fy, __fdiv_rn(b, 200.0f));
  const float x = __fmul_rn(lab_f_inv(fx), F32(95.0489 / 100.0));
  const float y = __fmul_rn(lab_f_inv(fy), F32(100.0 / 100.0));
  const float z = __fmul_rn(lab_f_inv(fz), F32(108.8840 / 100.0));
  const float r = __fadd_rn(__fadd_rn(__fmul_rn(F32(3.2404542), x),
                                      __fmul_rn(F32(-1.5371385), y)),
                            __fmul_rn(F32(-0.4985314), z));
  const float g = __fadd_rn(__fadd_rn(__fmul_rn(F32(-0.9692660), x),
                                      __fmul_rn(F32(1.8760108), y)),
                            __fmul_rn(F32(0.0415560), z));
  const float bl = __fadd_rn(__fadd_rn(__fmul_rn(F32(0.0556434), x),
                                       __fmul_rn(F32(-0.2040259), y)),
                             __fmul_rn(F32(1.0572252), z));
  *r8 = linear_to_srgb8(r, steps);
  *g8 = linear_to_srgb8(g, steps);
  *b8 = linear_to_srgb8(bl, steps);
}

}  // namespace kmeans
