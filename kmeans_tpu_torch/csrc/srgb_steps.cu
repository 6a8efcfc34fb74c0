// The sRGB encode's step points, computed and checked over every float32
// input on the card (sm_90a).
//
// The meld kernel (`quantize_meld.cu`) turns each blended channel into a
// byte by searching the 255 step points `colorspace.cuh::kSrgb8Steps`
// instead of calling `powf`. That is the byte of the definition,
// `linear_to_srgb8_pow` (the CUDA math library's `powf`, the function
// PyTorch's CUDA `pow` calls), only if the definition never decreases
// with its input and gives 0 for NaN and for every input below +0, and if
// the committed points are the definition's. One launch checks all 2^32
// bit patterns: it counts the inputs where the definition breaks either
// rule and the inputs where the search over the committed points gives
// another byte, and writes the step points it finds (the least
// non-negative float mapped to j or more, as int32 bits) for the caller
// to compare with the committed ones
// (`kmeans_tpu_torch/tools/srgb_steps.py`).

#include <cuda_runtime.h>
#include <stdint.h>

#include "colorspace.cuh"

namespace {

using namespace kmeans;

constexpr int kThreads = 256;
constexpr uint64_t kSpan = 4096;  // consecutive bit patterns a thread checks
constexpr uint32_t kPosInf = 0x7f800000u;

__global__ void srgb8_steps_kernel(int* __restrict__ steps,
                                   unsigned long long* __restrict__ counts) {
  __shared__ int table[256];
  for (int i = threadIdx.x; i < 256; i += kThreads) table[i] = kSrgb8Steps[i];
  __syncthreads();
  const uint64_t start = (static_cast<uint64_t>(blockIdx.x) * kThreads + threadIdx.x) * kSpan;
  unsigned long long broken = 0, differ = 0;
  // The byte of the pattern before this one, where both are in [+0, +inf].
  int prev = start >= 1 && start - 1 <= kPosInf
                 ? linear_to_srgb8_pow(__uint_as_float(static_cast<uint32_t>(start - 1)))
                 : 0;
  for (uint64_t i = 0; i < kSpan; ++i) {
    const uint32_t x = static_cast<uint32_t>(start + i);
    const float c = __uint_as_float(x);
    const int v = linear_to_srgb8_pow(c);
    if (x <= kPosInf) {
      if (x >= 1) {
        if (v < prev) ++broken;
        for (int j = prev + 1; j <= v; ++j) steps[j] = static_cast<int>(x);
      } else if (v != 0) {
        ++broken;
      }
    } else if (v != 0) {  // NaN, -0 and the negatives
      ++broken;
    }
    if (linear_to_srgb8(c, table) != v) ++differ;
    prev = v;
  }
  if (broken) atomicAdd(&counts[0], broken);
  if (differ) atomicAdd(&counts[1], differ);
}

}  // namespace

extern "C" {

// Launches the check on `stream` and returns its cudaError_t (0 on
// success). steps [256] int32, counts [2] uint64 (zeroed by the caller):
// counts[0] the inputs that break the encode's two rules, counts[1] those
// where the committed step points give another byte. steps[j] for
// j = 1..255 receives step point j; entry 0 is left alone. It allocates
// nothing and does not synchronise.
int kmeans_srgb8_steps(void* steps, void* counts, void* stream) {
  const uint64_t threads = (uint64_t{1} << 32) / kSpan;
  srgb8_steps_kernel<<<static_cast<unsigned int>(threads / kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(steps), static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
