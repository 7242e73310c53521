// Loads, stores and rounding shared by the port's kernels
// (resblock_pair.cu, scale_disc_head.cu): VEC consecutive channels of device
// memory widened to float and stored back, in f32 or bf16.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace port_kernels {

// ---- VEC consecutive channels of device memory, widened to float ----------

template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    v[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    p[0] = v[0];
  }
};

template <>
struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    __nv_bfloat162 lo, hi;
    lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    const float2 flo = __bfloat1622float2(lo);
    const float2 fhi = __bfloat1622float2(hi);
    v[0] = flo.x;
    v[1] = flo.y;
    v[2] = fhi.x;
    v[3] = fhi.y;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<const uint32_t*>(&lo);
    q.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = q;
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    v[0] = __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    p[0] = __float2bfloat16(v[0]);
  }
};

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
