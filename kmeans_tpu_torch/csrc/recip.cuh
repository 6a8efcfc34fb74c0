// An exact float32 quotient from a hoisted reciprocal, shared by the exact
// tiers of the assign and accumulator kernels (`delta_e.cuh`'s CIE94 form,
// `colorspace.cuh`'s divides by the white point).

#pragma once

#include <cuda_runtime.h>

namespace kmeans {

// x / d from y = RN(1 / d), the correctly rounded reciprocal: with
// q0 = RN(x y), the negated residual nr = d q0 - x is exact in one FMA and
// RN(q0 - nr y) is the correctly rounded quotient (Markstein's theorem),
// provided nothing underflows or overflows: d in [1, 2^32] and x zero or
// 2^-64 <= |x| <= 2^64. A zero x keeps its sign. `__fmaf_rn` is an
// explicit FMA: --fmad=false only stops the compiler from contracting.
// `tests/test_torch_divide.py` checks the sequence in exact arithmetic.
__device__ __forceinline__ float div_by_recip(float x, float d, float y) {
  const float q0 = __fmul_rn(x, y);
  const float nr = __fmaf_rn(d, q0, -x);
  return __fmaf_rn(-nr, y, q0);
}

// The bits of 2^-64 less one: a dividend x of `div_by_recip` is below
// 2^-64 and not zero exactly when bits(|x|) - 1 (unsigned) is below this.
constexpr unsigned kTinyDividend = 0x1f800000u - 1u;

}  // namespace kmeans
