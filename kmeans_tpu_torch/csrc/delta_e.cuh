// Squared CIE94 and CIEDE2000 colour differences, shared by the port's
// three kernels (`quantize_assign.cu`, `quantize_meld.cu`,
// `lloyd_accumulate.cu`).
//
// The plain PyTorch twin is `kmeans_tpu_torch/ops/delta_e.py`
// (`distance_cie94_sq`, `cie2000_sq_planes`), which follows the reference's
// XLA form `kmeans_tpu/ops/delta_e.py:55,91` (Sharma et al.'s CIEDE2000).
// Each float operation is one IEEE float32 operation in the twin's order,
// spelled with an _rn intrinsic so that none is fused into an FMA; `x ** 7`
// is `lax.integer_pow`'s `(x * x^2) * x^4`. `atan2f`, `sinf`, `cosf` and
// `expf` are the CUDA math library's functions, the ones PyTorch's CUDA
// `atan2`, `sin`, `cos` and `exp` call for float32, so the kernels and the
// twin run on the card see the same values. (The TPU kernel uses a
// polynomial atan2, `kmeans_tpu/ops/kernels.py:356`, because Mosaic has
// none; the port does not need one.)
//
// The first colour is the pixel: its chroma `c1` (and CIE94's S_C and S_H
// weights) are computed once per pixel and passed in, hoisted out of the
// centroid loop; the second colour's chroma `c2` comes from a per-centroid
// table. Hoisting changes no bit: each is the same expression of the same
// inputs.

#pragma once

#include <cuda_runtime.h>

#include "recip.cuh"

#ifndef F32
#define F32(x) static_cast<float>(x)
#endif

namespace kmeans {

constexpr float kBig = 3.4e38f;
constexpr int kMetricCie94 = 0;
constexpr int kMetricCie2000 = 1;

// float32(deg2rad(x)) of the reference's constants, and 25^7.
#define KM_RAD(deg) F32((deg) * (3.14159265358979323846 / 180.0))
#define KM_DEG360 KM_RAD(360.0)
#define KM_DEG180 KM_RAD(180.0)
#define KM_RAD30 KM_RAD(30.0)
#define KM_RAD6 KM_RAD(6.0)
#define KM_RAD63 KM_RAD(63.0)
#define KM_RAD275 KM_RAD(275.0)
#define KM_RAD25 KM_RAD(25.0)
#define KM_POW25_7 F32(6103515625.0)

__device__ __forceinline__ float chroma(float a, float b) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)));
}

// CIE94's pixel-side weights S_C and S_H^2 for a first colour of chroma c1.
__device__ __forceinline__ void cie94_weights(float c1, float* sc, float* sh2) {
  *sc = __fadd_rn(1.0f, __fmul_rn(F32(0.045), c1));
  const float sh = __fadd_rn(1.0f, __fmul_rn(F32(0.015), c1));
  *sh2 = __fmul_rn(sh, sh);
}

__device__ __forceinline__ float cie94_sq(float l1, float a1, float b1, float c1,
                                          float sc, float sh2, float l2,
                                          float a2, float b2, float c2) {
  const float dl = __fsub_rn(l1, l2);
  const float da = __fsub_rn(a1, a2);
  const float db = __fsub_rn(b1, b2);
  const float dcab = __fsub_rn(c1, c2);
  const float hsq = __fsub_rn(__fadd_rn(__fmul_rn(da, da), __fmul_rn(db, db)),
                              __fmul_rn(dcab, dcab));
  const float dhab_sq = fmaxf(hsq, 0.0f);
  const float t = __fdiv_rn(dcab, sc);
  return __fadd_rn(__fadd_rn(__fmul_rn(dl, dl), __fmul_rn(t, t)),
                   __fdiv_rn(dhab_sq, sh2));
}

// One pixel's side of CIE94 with the reciprocals of its weights hoisted,
// so that `cie94_sq_recip` spends three FMA-unit operations on a divide
// instead of an IEEE division subroutine. `ok` says whether the pixel is
// in the range where the tiled loop's quotients need only the small-
// dividend check: S_C and S_H^2 in [1, 2^32] (so c1 < 2^23) and
// |a|, |b| <= 2^30. With a centroid of |a|, |b| <= 2^30 (`cie94_centroid_ok`)
// that bounds every dividend: |dcab| < 2^31 and dhab_sq <= 2^63.
struct Cie94Pixel {
  float l, a, b, c1, sc, rsc, sh2, rsh2;
  bool ok;
};

__device__ __forceinline__ Cie94Pixel cie94_pixel(float l, float a, float b, float c1) {
  Cie94Pixel p;
  p.l = l;
  p.a = a;
  p.b = b;
  p.c1 = c1;
  cie94_weights(c1, &p.sc, &p.sh2);
  p.rsc = __frcp_rn(p.sc);
  p.rsh2 = __frcp_rn(p.sh2);
  p.ok = p.sc >= 1.0f && p.sc <= 0x1p32f && p.sh2 >= 1.0f && p.sh2 <= 0x1p32f &&
         fabsf(a) <= 0x1p30f && fabsf(b) <= 0x1p30f;
  return p;
}

// The centroid's side of the same range (NaN is out of it).
__device__ __forceinline__ bool cie94_centroid_ok(float a, float b) {
  return fabsf(a) <= 0x1p30f && fabsf(b) <= 0x1p30f;
}

// `cie94_sq` to a centroid (L, a, b, chroma) in the same order, each divide
// by `div_by_recip`. `*tiny` keeps the least bits(|x|) - 1 over the
// dividends: the result equals `cie94_sq`'s bits whenever the pixel and the
// centroid are in range and `*tiny` stays at or above `kTinyDividend`
// (dhab_sq >= +0, so its bits need no mask).
__device__ __forceinline__ float cie94_sq_recip(const Cie94Pixel& p, float4 c,
                                                unsigned* tiny) {
  const float dl = __fsub_rn(p.l, c.x);
  const float da = __fsub_rn(p.a, c.y);
  const float db = __fsub_rn(p.b, c.z);
  const float dcab = __fsub_rn(p.c1, c.w);
  const float hsq = __fsub_rn(__fadd_rn(__fmul_rn(da, da), __fmul_rn(db, db)),
                              __fmul_rn(dcab, dcab));
  const float dhab_sq = fmaxf(hsq, 0.0f);
  *tiny = min(*tiny, min(__float_as_uint(fabsf(dcab)) - 1u, __float_as_uint(dhab_sq) - 1u));
  const float t = div_by_recip(dcab, p.sc, p.rsc);
  return __fadd_rn(__fadd_rn(__fmul_rn(dl, dl), __fmul_rn(t, t)),
                   div_by_recip(dhab_sq, p.sh2, p.rsh2));
}

__device__ __forceinline__ float pow7(float x) {
  const float x2 = __fmul_rn(x, x);
  return __fmul_rn(__fmul_rn(x, x2), __fmul_rn(x2, x2));
}

// Hue angle in [0, 2 pi), 0 for a grey (b == ap == 0).
__device__ __forceinline__ float hue(float b, float ap) {
  float h = atan2f(b, ap);
  if (h < 0.0f) h = __fadd_rn(h, KM_DEG360);
  return (b == 0.0f && ap == 0.0f) ? 0.0f : h;
}

__device__ __forceinline__ float cie2000_sq(float l1, float a1, float b1,
                                            float c1, float l2, float a2,
                                            float b2, float c2) {
  const float bar_c7 = pow7(__fmul_rn(__fadd_rn(c1, c2), 0.5f));
  const float g = __fmul_rn(
      0.5f, __fsub_rn(1.0f, __fsqrt_rn(__fdiv_rn(bar_c7, __fadd_rn(bar_c7, KM_POW25_7)))));
  const float g1 = __fadd_rn(1.0f, g);
  const float a1p = __fmul_rn(g1, a1);
  const float a2p = __fmul_rn(g1, a2);
  const float c1p = chroma(a1p, b1);
  const float c2p = chroma(a2p, b2);
  const float h1p = hue(b1, a1p);
  const float h2p = hue(b2, a2p);

  const float dlp = __fsub_rn(l2, l1);
  const float dcp = __fsub_rn(c2p, c1p);
  const float dh = __fsub_rn(h2p, h1p);
  const float abs_dh = fabsf(dh);
  float dhp = dh;
  if (!(abs_dh <= KM_DEG180)) {
    dhp = h2p <= h1p ? __fadd_rn(dh, KM_DEG360) : __fsub_rn(dh, KM_DEG360);
  }
  const float c12 = __fmul_rn(c1p, c2p);
  const bool zero = c12 == 0.0f;
  if (zero) dhp = 0.0f;
  const float d_big_h =
      __fmul_rn(__fmul_rn(2.0f, __fsqrt_rn(c12)), sinf(__fmul_rn(dhp, 0.5f)));

  const float bar_lp = __fmul_rn(__fadd_rn(l1, l2), 0.5f);
  const float bar_cp = __fmul_rn(__fadd_rn(c1p, c2p), 0.5f);
  const float h_sum = __fadd_rn(h1p, h2p);
  float bar_h = __fmul_rn(h_sum, 0.5f);
  if (abs_dh > KM_DEG180) {
    bar_h = h_sum < KM_DEG360 ? __fmul_rn(__fadd_rn(h_sum, KM_DEG360), 0.5f)
                              : __fmul_rn(__fsub_rn(h_sum, KM_DEG360), 0.5f);
  }
  if (zero) bar_h = h_sum;

  float t = __fsub_rn(1.0f, __fmul_rn(F32(0.17), cosf(__fsub_rn(bar_h, KM_RAD30))));
  t = __fadd_rn(t, __fmul_rn(F32(0.24), cosf(__fmul_rn(2.0f, bar_h))));
  t = __fadd_rn(t, __fmul_rn(F32(0.32), cosf(__fadd_rn(__fmul_rn(3.0f, bar_h), KM_RAD6))));
  t = __fsub_rn(t, __fmul_rn(F32(0.20), cosf(__fsub_rn(__fmul_rn(4.0f, bar_h), KM_RAD63))));

  const float arg = __fdiv_rn(__fsub_rn(bar_h, KM_RAD275), KM_RAD25);
  const float d_theta = __fmul_rn(KM_RAD30, expf(-__fmul_rn(arg, arg)));
  const float bar_cp7 = pow7(bar_cp);
  const float r_c =
      __fmul_rn(2.0f, __fsqrt_rn(__fdiv_rn(bar_cp7, __fadd_rn(bar_cp7, KM_POW25_7))));
  const float lm = __fsub_rn(bar_lp, 50.0f);
  const float lm50 = __fmul_rn(lm, lm);
  const float s_l = __fadd_rn(
      1.0f, __fdiv_rn(__fmul_rn(F32(0.015), lm50), __fsqrt_rn(__fadd_rn(20.0f, lm50))));
  const float s_c = __fadd_rn(1.0f, __fmul_rn(F32(0.045), bar_cp));
  const float s_h = __fadd_rn(1.0f, __fmul_rn(__fmul_rn(F32(0.015), bar_cp), t));
  const float r_t = __fmul_rn(-sinf(__fmul_rn(2.0f, d_theta)), r_c);

  const float tl = __fdiv_rn(dlp, s_l);
  const float tc = __fdiv_rn(dcp, s_c);
  const float th = __fdiv_rn(d_big_h, s_h);
  const float s = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(tl, tl), __fmul_rn(tc, tc)), __fmul_rn(th, th)),
      __fmul_rn(__fmul_rn(r_t, tc), th));
  // max(s, 0) that keeps a NaN, as `torch.clamp` and `jnp.maximum` do
  // (fmaxf would make it 0, the nearest distance there is).
  return s < 0.0f ? 0.0f : s;
}

// Squared distance from a pixel to one centroid under `Metric`, with the
// pixel's chroma c1 and CIE94 weights sc, sh2 hoisted by the caller. Each
// kernel is instantiated once per metric and its launcher picks the
// instance, so no centroid loop carries a branch on the metric and the
// CIE94 instances compile to the loop they had before CIEDE2000 came.
template <int Metric>
__device__ __forceinline__ float pixel_distance(float l, float a, float b,
                                                float c1, float sc, float sh2,
                                                float cl, float ca, float cb,
                                                float cc) {
  if constexpr (Metric == kMetricCie2000) {
    return cie2000_sq(l, a, b, c1, cl, ca, cb, cc);
  } else {
    return cie94_sq(l, a, b, c1, sc, sh2, cl, ca, cb, cc);
  }
}

}  // namespace kmeans
