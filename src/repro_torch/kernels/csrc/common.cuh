// Element conversions, vector loads and a row group's reduction, shared by
// the port's kernels.
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

// N elements of E held in registers, moved to and from device memory in
// one piece of N * sizeof(E) bytes (8, 16 or 32; the address aligned to 16
// bytes, or to 8 for a piece of 8) or element by element.
template <typename E, int N>
struct Pack {
  static constexpr int kBytes = N * (int)sizeof(E);
  static_assert(kBytes == 8 || kBytes % 16 == 0, "a piece of 8 or 16k bytes");
  alignas(kBytes >= 16 ? 16 : 8) E v[N];

  __device__ __forceinline__ void load(const E* p) {
    if constexpr (kBytes == 8) {
      *reinterpret_cast<uint2*>(v) = *reinterpret_cast<const uint2*>(p);
    } else {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i)
        reinterpret_cast<uint4*>(v)[i] = reinterpret_cast<const uint4*>(p)[i];
    }
  }
  __device__ __forceinline__ void store(E* p) const {
    if constexpr (kBytes == 8) {
      *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(v);
    } else {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i)
        reinterpret_cast<uint4*>(p)[i] = reinterpret_cast<const uint4*>(v)[i];
    }
  }
  __device__ __forceinline__ float operator[](int j) const { return to_f(v[j]); }
};

// op over a row held by a group of W consecutive warps of the block (W a
// power of two): each warp's shuffle tree, then, with W > 1, the W warps'
// values in a fixed order through `red` (one slot a warp of the block),
// after one barrier. Every lane of the group ends with the same value.
// With W == 1 there is no barrier; with W > 1 every thread of the block
// calls it, and each call of a kernel has slots of its own (no barrier
// guards their reuse).
template <typename V, typename Op>
__device__ __forceinline__ V group_reduce(V v, Op op, V* red, int W) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (W == 1) return v;
  const int warp = threadIdx.x / 32;
  const int first = warp & -W;
  if (threadIdx.x % 32 == 0) red[warp] = v;
  __syncthreads();
  v = red[first];
  for (int i = 1; i < W; ++i) v = op(v, red[first + i]);
  return v;
}

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace common
