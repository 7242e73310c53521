// Loads and rounding shared by the port's kernels (resblock_pair.cu,
// scale_disc_head.cu): one element of device memory widened to float, and
// rounding to the working precision, in f32 or bf16.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace port_kernels {

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(p[0]);
}

// Round to the working precision: a no-op for f32, bf16 rounding for bf16.
template <typename T>
__device__ __forceinline__ float working(float v) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return __bfloat162float(__float2bfloat16(v));
  } else {
    return v;
  }
}

}  // namespace port_kernels
