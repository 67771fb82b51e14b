// Element conversions and 16-byte vector loads shared by the port's kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace common {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// One 16-byte load. The address must be 16-byte aligned.
__device__ __forceinline__ uint4 ld16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// 16 bytes of N elements, widened to fp32 (`load` reads them first).
template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void widen(const uint4& u, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    widen(ld16(p), out);
  }
};
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void widen(const uint4& u, float* out) {
    const float4 f = *reinterpret_cast<const float4*>(&u);
    out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
  }
  __device__ __forceinline__ static void load(const float* p, float* out) {
    widen(ld16(p), out);
  }
};

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace common
