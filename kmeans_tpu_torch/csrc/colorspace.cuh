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
__device__ __forceinline__ int linear_to_srgb8(float c) {
  const float safe = fmaxf(c, 0.0f);
  const float v = c > F32(0.0031308)
                      ? __fsub_rn(__fmul_rn(F32(1.055), powf(safe, F32(1.0 / 2.4))),
                                  F32(0.055))
                      : __fmul_rn(F32(12.92), c);
  const float clipped = fminf(fmaxf(v, 0.0f), 1.0f);
  return static_cast<int>(rintf(__fmul_rn(clipped, 255.0f)));
}

// Lab -> u8 sRGB (kmeans_tpu_torch/ops/colorspace.py::lab_to_srgb).
__device__ __forceinline__ void lab_to_srgb8(float l, float a, float b,
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
  *r8 = linear_to_srgb8(r);
  *g8 = linear_to_srgb8(g);
  *b8 = linear_to_srgb8(bl);
}

}  // namespace kmeans
