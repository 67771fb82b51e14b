// GEMV/GEMM with fp32 accumulation and a fused bias + activation epilogue.
//
// Replaces the TPU kernel src/repro/kernels/gemv_pim.py::gemv_pim_float
// (Pallas body _gemv_float_kernel, epilogue _epilogue_lut).
//
// out[m, r] = act(sum_c x[m, c] * w[r, c] + bias[r]), x (M, C), w (R, C),
// both row-major in bf16 or f32; out in x's dtype. act is none, the LUT
// interpolation of a piecewise-linear table (lut.cuh, bit-exact to
// apply_table) or the tanh GELU, applied once to the whole fp32 sum.
//
// What bounds it on the H100: at decode widths (M = 4 slots) every weight
// byte is read once for 2 M FLOPs, so the weight stream over HBM
// (3.35 TB/s) is the bound: 2.1 MB for a d x d projection is 0.63 us. At a
// 64-token chunk the FLOPs are 64x as many and would take 8 us on the
// CUDA cores (67 TFLOP/s f32) against 0.5 us on the bf16 tensor cores, so
// the tensor cores are needed to stay on the byte bound.
//
// Tensor-core kernel (bf16, C a multiple of 8, 16-byte aligned operands):
// the wgmma skeleton of gemv_tc.cuh (TMA ring, C split over a cluster,
// partial tiles reduced in rank order over distributed shared memory) with
// f32 sums, then the bias and the activation applied once, bf16 out.
//
// CUDA-core kernel (f32, or C not a multiple of 8, or unaligned): one warp
// owns one output row and walks C with 16-byte loads (the scalar path when
// C is not a multiple of the vector width), keeping 8 rows of x in fp32
// registers per pass. The wrapper (kernels/gemv_pim.py::gemv_plan) picks
// the kernel and the tiling; the C entries check what they are given.
#include "common.cuh"
#include "gemv_tc.cuh"
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


// ---------------------------------------------------------------------------
// Tensor-core kernel: gemv_tc.cuh's skeleton with bf16 operands, f32 sums
// and this epilogue.
// ---------------------------------------------------------------------------

// bias (bf16) and the activation on the cluster's f32 sum; bf16 out.
struct FloatEpi {
  template <int N> using Mma = gemv_tc::DirectMma<FloatEpi, N>;
  using Acc = float;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr int kElem = 2;
  struct Smem {
    float wb[2 * kMaxTableRows];
  };
  const __nv_bfloat16* bias;
  const float* table;
  __nv_bfloat16* out;
  int R, act;
  float lo, inv_step;
  int sections;
  __device__ void stage(Smem& s) const {
    if (act == ACT_LUT) lut::stage(s.wb, table, sections);
  }
  __device__ __forceinline__ void operator()(const Smem& s, const float (&sum)[4], int m,
                                             int r) const {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (r + u < R) {
        float a = sum[u];
        if (bias != nullptr) a += __bfloat162float(bias[r + u]);
        a = epilogue(a, act, s.wb, lo, inv_step, sections);
        out[(size_t)m * R + r + u] = __float2bfloat16(a);
      }
    }
  }
};

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

// The tensor-core kernel: bf16 x (M, C), w (R, C), bias (R,) or null, out
// (M, R). n_tile is the token tile (8, 16, 32, 64, 128 or 256), cluster the
// blocks splitting C (1, 2, 4 or 8, at most the 64-wide K tiles of C); C
// must be a multiple of 8 and x and w 16-byte aligned (TMA). Returns a
// CUDA error code (0 on success).
int gemv_pim_float_tc(const void* x, const void* w, const void* bias, const void* table,
                      void* out, int M, int C, int R, int act, float lo, float inv_step,
                      int sections, int n_tile, int cluster, void* stream) {
  if (act == ACT_LUT && (table == nullptr || sections + 2 > kMaxTableRows))
    return (int)cudaErrorInvalidValue;
  const FloatEpi epi{(const __nv_bfloat16*)bias, (const float*)table, (__nv_bfloat16*)out, R,
                     act, lo, inv_step, sections};
  return gemv_tc::run(x, w, epi, M, C, R, n_tile, cluster, stream);
}

const char* gemv_pim_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
