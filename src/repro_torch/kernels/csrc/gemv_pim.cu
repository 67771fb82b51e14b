// GEMV/GEMM with fp32 accumulation and a fused bias + activation epilogue.
//
// Replaces the TPU kernel src/repro/kernels/gemv_pim.py::gemv_pim_float
// (Pallas body _gemv_float_kernel, epilogue _epilogue_lut).
//
// out[m, r] = act(sum_c x[m, c] * w[r, c] + bias[r]), x (M, C), w (R, C),
// both row-major in bf16 or f32; out in x's dtype. act is none, the LUT
// interpolation of a piecewise-linear table (slope/intercept rows in
// shared memory, idx = clip(floor((acc - lo) * inv_step) + 1, 0, S + 1)),
// or the tanh GELU.
//
// What bounds it on the H100: at decode widths (M = slots, a handful of
// rows) every weight byte is read once for a few FLOPs, so the kernel is
// bound by the weight stream over HBM (3.35 TB/s). The design streams
// each weight row once with 16-byte loads: one warp owns one output row r
// and walks C in a loop (Hopper has no sequential grid axis to carry the
// TPU kernel's contraction accumulator), keeping MT rows of x in fp32
// registers per pass; grid.y covers M in tiles of MT rows, so a prefill
// chunk re-reads each weight row ceil(M / MT) times, mostly from L2. The
// ragged edge of R and M is masked; C of any size takes the scalar path
// when it is not a multiple of the vector width. No tensor cores yet.
#include "common.cuh"
#include "lut.cuh"

namespace {

using common::Vec;
using common::from_f;
using common::to_f;

constexpr int kWarps = 8;          // output rows per block
constexpr int kMT = 8;             // x rows per pass
constexpr int kMaxTableRows = lut::kMaxTableRows; // TABLE_PAD of the TPU kernel

enum { ACT_NONE = 0, ACT_LUT = 1, ACT_GELU = 2 };

__device__ __forceinline__ float epilogue(float a, int act, const float* wb,
                                          float lo, float inv_step, int sections) {
  if (act == ACT_LUT) return lut::eval(a, wb, lo, inv_step, sections);
  if (act == ACT_GELU) {
    const float k0 = 0.7978845608028654f;           // sqrt(2 / pi)
    return 0.5f * a * (1.0f + tanhf(k0 * (a + 0.044715f * a * a * a)));
  }
  return a;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
gemv_kernel(const T* __restrict__ x, const T* __restrict__ w,
            const T* __restrict__ bias, const float* __restrict__ table,
            T* __restrict__ out, int M, int C, int R, int act, float lo,
            float inv_step, int sections) {
  __shared__ float wb_s[2 * kMaxTableRows];
  if (act == ACT_LUT) {
    for (int i = threadIdx.x; i < 2 * (sections + 2); i += blockDim.x) wb_s[i] = table[i];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kWarps + warp;
  const int m0 = blockIdx.y * kMT;
  if (r >= R) return;
  const int mt = min(kMT, M - m0);
  const T* wr = w + (size_t)r * C;
  const T* xb = x + (size_t)m0 * C;

  float acc[kMT];
#pragma unroll
  for (int m = 0; m < kMT; ++m) acc[m] = 0.0f;

  if (kVec) {
    constexpr int N = Vec<T>::N;
#pragma unroll 4
    for (int c = lane * N; c < C; c += 32 * N) {
      float wv[N];
      Vec<T>::load(wr + c, wv);
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        if (m < mt) {
          float xv[N];
          Vec<T>::load(xb + (size_t)m * C + c, xv);
#pragma unroll
          for (int j = 0; j < N; ++j) acc[m] = fmaf(xv[j], wv[j], acc[m]);
        }
      }
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      const float wv = to_f(wr[c]);
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        if (m < mt) acc[m] = fmaf(to_f(xb[(size_t)m * C + c]), wv, acc[m]);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kMT; ++m) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
  }
  const float b = bias != nullptr ? to_f(bias[r]) : 0.0f;
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    if (m < mt && lane == m) {
      float a = acc[m] + b;
      a = epilogue(a, act, wb_s, lo, inv_step, sections);
      out[(size_t)(m0 + m) * R + r] = from_f<T>(a);
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, const void* bias, const void* table,
            void* out, int M, int C, int R, int act, float lo, float inv_step,
            int sections, cudaStream_t stream) {
  dim3 grid((R + kWarps - 1) / kWarps, (M + kMT - 1) / kMT);
  dim3 block(kWarps * 32);
  // 16-byte loads need every row of x and w to start on a 16-byte boundary.
  if (C % Vec<T>::N == 0 && common::aligned16(x) && common::aligned16(w)) {
    gemv_kernel<T, true><<<grid, block, 0, stream>>>(
        (const T*)x, (const T*)w, (const T*)bias, (const float*)table, (T*)out,
        M, C, R, act, lo, inv_step, sections);
  } else {
    gemv_kernel<T, false><<<grid, block, 0, stream>>>(
        (const T*)x, (const T*)w, (const T*)bias, (const float*)table, (T*)out,
        M, C, R, act, lo, inv_step, sections);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. act: 0 none, 1 LUT table, 2 tanh GELU.
// bias and table may be null. Returns cudaGetLastError().
int gemv_pim_float(const void* x, const void* w, const void* bias,
                   const void* table, void* out, int M, int C, int R, int dtype,
                   int act, float lo, float inv_step, int sections, void* stream) {
  if (act == ACT_LUT && (table == nullptr || sections + 2 > kMaxTableRows))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    launch<__nv_bfloat16>(x, w, bias, table, out, M, C, R, act, lo, inv_step,
                          sections, s);
  } else if (dtype == 0) {
    launch<float>(x, w, bias, table, out, M, C, R, act, lo, inv_step, sections, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* gemv_pim_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
