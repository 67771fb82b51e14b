// The quantized GEMVs of the S-ALU datapath: int8 with f32 row scales, and
// Q-format fixed16 with a wrapping int32 accumulator, shift and saturate.
//
// Replaces the TPU kernels src/repro/kernels/gemv_pim.py::gemv_pim_int8
// (Pallas body _gemv_int8_kernel) and ::gemv_pim_fixed (body
// _gemv_fixed_kernel), held bit for bit to ref.gemv_pim_int8_ref and
// ref.gemv_pim_fixed_ref through the plain versions in gemv_pim.py.
//
// gemv_pim_int8: x (M, C) int8, x_scale (M,) f32, w (R, C) int8, w_scale
// (R,) f32, optional bias (R,) f32 -> out (M, R) f32,
//   out[m, r] = ((float)sum_c x[m, c] w[r, c] * x_scale[m]) * w_scale[r] (+ bias[r]),
// the sum exact in int32 (__dp4a on four packed bytes; |sum| < 2^26 at
// C = 4096), each float operation rounded on its own (__fmul_rn and
// __fadd_rn keep nvcc from contracting the bias add into an FMA).
//
// gemv_pim_fixed: x (M, C) int16, w (R, C) int16 -> out (M, R) int16,
//   out[m, r] = clip((int32)(sum_c x[m, c] w[r, c] mod 2^32) >> shift, -32768, 32767).
// Each int16 product fits in int32 (at most 2^30), but a sum over C = 4096
// can pass 2^31: XLA's int32 dot wraps modulo 2^32, so the sum runs in
// uint32 (defined wrap-around; signed overflow is undefined in C++) and
// is reinterpreted as int32 before the arithmetic shift.
//
// What bounds them on the H100: at decode widths every weight byte is
// read once for two integer operations a row of x, so both are bound by
// the weight stream over HBM (3.35 TB/s): 1 byte an element for int8
// (plus 4 bytes of scale a row), 2 for fixed16. At a 64-token chunk the
// int8 GEMV does 64x the operations: the s8 tensor cores keep it on the
// byte bound, where the CUDA cores' __dp4a would not.
//
// gemv_pim_int8 on the tensor cores (C a multiple of 16, 16-byte aligned
// x and w): the wgmma skeleton of gemv_tc.cuh, which the float GEMV shares,
// on s8 operands (128-element K tiles, m64nNk32 s8 wgmmas into int32
// registers); the cluster's int32 partial tiles sum exactly, so their
// order does not matter, and each block's epilogue applies (acc * x_scale)
// * w_scale (+ bias) in f32 as above to its slice of the tile.
//
// The CUDA-core kernels (gemv_pim_fixed always; gemv_pim_int8 when C is
// not a multiple of 16 or a row is misaligned): one warp owns one output
// row and walks C with 16-byte loads (16 int8 or 8 int16 elements a lane),
// keeping kMT rows of x per pass, grid.y covering M in tiles of kMT rows;
// the ragged edge of R and M is masked, and C that is not a multiple of
// the vector width (or a misaligned row) takes the scalar path. No tensor
// core has an int16 mode.
//
// quantize_int8_rows: x (rows, C) in f32 or bf16 -> q int8 (rows, C) and
// scale (rows,) in x's dtype, core/quant.py::quantize_int8_rows in one
// pass a row: absmax, scale = max(absmax, 1e-8) / 127, q = clip(round(x /
// scale), +-127). Each step rounds as PyTorch's kernels do in x's dtype:
// in bf16 the division is an f32 division rounded to bf16, round() is
// half to even, so the result is bit for bit the plain function's. One
// block a row (256 threads: a decode step's x has only 4 rows); bound by
// reading x and writing q.
#include "common.cuh"
#include "gemv_tc.cuh"

namespace {

constexpr int kWarps = 8;   // output rows per block
constexpr int kMT = 8;      // x rows per pass

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
gemv_int8_kernel(const int8_t* __restrict__ x, const float* __restrict__ x_scale,
                 const int8_t* __restrict__ w, const float* __restrict__ w_scale,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int M, int C, int R) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kWarps + warp;
  const int m0 = blockIdx.y * kMT;
  if (r >= R) return;
  const int mt = min(kMT, M - m0);
  const int8_t* wr = w + (size_t)r * C;
  const int8_t* xb = x + (size_t)m0 * C;

  int acc[kMT];
#pragma unroll
  for (int m = 0; m < kMT; ++m) acc[m] = 0;

  if (kVec) {
#pragma unroll 4
    for (int c = lane * 16; c < C; c += 32 * 16) {
      const int4 wv = *reinterpret_cast<const int4*>(wr + c);
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        if (m < mt) {
          const int4 xv = *reinterpret_cast<const int4*>(xb + (size_t)m * C + c);
          acc[m] = __dp4a(xv.x, wv.x, acc[m]);
          acc[m] = __dp4a(xv.y, wv.y, acc[m]);
          acc[m] = __dp4a(xv.z, wv.z, acc[m]);
          acc[m] = __dp4a(xv.w, wv.w, acc[m]);
        }
      }
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      const int wv = wr[c];
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        if (m < mt) acc[m] = (int)((unsigned)acc[m] + (unsigned)(xb[(size_t)m * C + c] * wv));
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kMT; ++m) acc[m] = (int)warp_sum((unsigned)acc[m]);
  const float ws = w_scale[r];
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    if (m < mt && lane == m) {
      float a = __fmul_rn(__fmul_rn((float)acc[m], x_scale[m0 + m]), ws);
      if (bias != nullptr) a = __fadd_rn(a, bias[r]);
      out[(size_t)(m0 + m) * R + r] = a;
    }
  }
}

// Sign-extend the two int16 halves of a 32-bit word.
__device__ __forceinline__ int lo16(unsigned u) { return (int)(int16_t)(u & 0xffffu); }
__device__ __forceinline__ int hi16(unsigned u) { return (int)u >> 16; }

template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
gemv_fixed_kernel(const int16_t* __restrict__ x, const int16_t* __restrict__ w,
                  int16_t* __restrict__ out, int M, int C, int R, int shift) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kWarps + warp;
  const int m0 = blockIdx.y * kMT;
  if (r >= R) return;
  const int mt = min(kMT, M - m0);
  const int16_t* wr = w + (size_t)r * C;
  const int16_t* xb = x + (size_t)m0 * C;

  unsigned acc[kMT];
#pragma unroll
  for (int m = 0; m < kMT; ++m) acc[m] = 0u;

  if (kVec) {
#pragma unroll 4
    for (int c = lane * 8; c < C; c += 32 * 8) {
      const uint4 wu = *reinterpret_cast<const uint4*>(wr + c);
      const unsigned wwords[4] = {wu.x, wu.y, wu.z, wu.w};
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        if (m < mt) {
          const uint4 xu = *reinterpret_cast<const uint4*>(xb + (size_t)m * C + c);
          const unsigned xwords[4] = {xu.x, xu.y, xu.z, xu.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[m] += (unsigned)(lo16(xwords[j]) * lo16(wwords[j]));
            acc[m] += (unsigned)(hi16(xwords[j]) * hi16(wwords[j]));
          }
        }
      }
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      const int wv = wr[c];
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        if (m < mt) acc[m] += (unsigned)((int)xb[(size_t)m * C + c] * wv);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kMT; ++m) acc[m] = warp_sum(acc[m]);
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    if (m < mt && lane == m) {
      const int s = (int)acc[m] >> shift;            // arithmetic shift
      out[(size_t)(m0 + m) * R + r] = (int16_t)min(max(s, -32768), 32767);
    }
  }
}


// ---------------------------------------------------------------------------
// gemv_pim_int8 on the s8 tensor cores
// ---------------------------------------------------------------------------

// The epilogue of gemv_tc.cuh's skeleton on s8 operands: the cluster's
// exact int32 sum, scaled as above; f32 out.
struct Int8Epi {
  using Acc = int;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr int kElem = 1;
  struct Smem {};
  const float* x_scale;
  const float* w_scale;
  const float* bias;
  float* out;
  int R;
  __device__ void stage(Smem&) const {}
  __device__ __forceinline__ void operator()(const Smem&, const int (&sum)[4], int m,
                                             int r) const {
    const float xs = x_scale[m];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (r + u < R) {
        float a = __fmul_rn(__fmul_rn((float)sum[u], xs), w_scale[r + u]);
        if (bias != nullptr) a = __fadd_rn(a, bias[r + u]);
        out[(size_t)m * R + r + u] = a;
      }
    }
  }
};

// ---------------------------------------------------------------------------
// quantize_int8_rows
// ---------------------------------------------------------------------------

constexpr int kQuantThreads = 256;   // a block a row

__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// max and min that keep a NaN, as torch's amax and clamp do (fmaxf and
// fminf drop it); one instruction each, as fmaxf and fminf are.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q, T* __restrict__ scale,
                     int C) {
  __shared__ float red[kQuantThreads / 32];
  const size_t row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32;
  const T* xr = x + row * C;
  float amax = 0.0f;                        // |x| and max are exact in T
  for (int c = tid; c < C; c += kQuantThreads) amax = max_nan(amax, fabsf(common::to_f(xr[c])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = max_nan(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (lane == 0) red[tid / 32] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) amax = max_nan(amax, red[w]);
  // clamp(absmax, min=1e-8) against 1e-8 in T, then / 127 rounded to T. A
  // row holding a NaN gets a NaN scale and NaN quotients, which the clip
  // keeps and the int8 conversion turns into what torch's does.
  const float lo = round_to(1e-8f, T{});
  const float s = round_to(__fdiv_rn(max_nan(amax, lo), 127.0f), T{});
  if (tid == 0) scale[row] = common::from_f<T>(s);
  int8_t* qr = q + row * C;
  for (int c = tid; c < C; c += kQuantThreads) {
    const float v = rintf(round_to(__fdiv_rn(common::to_f(xr[c]), s), T{}));
    qr[c] = (int8_t)min_nan(max_nan(v, -127.0f), 127.0f);
  }
}

}  // namespace

extern "C" {

// The CUDA-core kernel; bias may be null. Returns cudaGetLastError().
int gemv_pim_int8(const void* x, const void* x_scale, const void* w, const void* w_scale,
                  const void* bias, void* out, int M, int C, int R, void* stream) {
  dim3 grid((R + kWarps - 1) / kWarps, (M + kMT - 1) / kMT);
  dim3 block(kWarps * 32);
  cudaStream_t s = (cudaStream_t)stream;
  // 16-byte loads need every row of x and w to start on a 16-byte boundary.
  if (C % 16 == 0 && common::aligned16(x) && common::aligned16(w)) {
    gemv_int8_kernel<true><<<grid, block, 0, s>>>(
        (const int8_t*)x, (const float*)x_scale, (const int8_t*)w, (const float*)w_scale,
        (const float*)bias, (float*)out, M, C, R);
  } else {
    gemv_int8_kernel<false><<<grid, block, 0, s>>>(
        (const int8_t*)x, (const float*)x_scale, (const int8_t*)w, (const float*)w_scale,
        (const float*)bias, (float*)out, M, C, R);
  }
  return (int)cudaGetLastError();
}

// The tensor-core kernel: x (M, C) and w (R, C) int8, 16-byte aligned, C a
// multiple of 16 (TMA's stride rule); n_tile the token tile (8, 16, 32,
// 64, 128 or 256), cluster the blocks splitting C (1, 2, 4 or 8, at most
// the 128-wide K tiles of C). Returns a CUDA error code (0 on success).
int gemv_pim_int8_tc(const void* x, const void* x_scale, const void* w, const void* w_scale,
                     const void* bias, void* out, int M, int C, int R, int n_tile, int cluster,
                     void* stream) {
  const Int8Epi epi{(const float*)x_scale, (const float*)w_scale, (const float*)bias,
                    (float*)out, R};
  return gemv_tc::run(x, w, epi, M, C, R, n_tile, cluster, stream);
}

// x (rows, C) contiguous, dtype 0 = float32, 1 = bfloat16; q (rows, C)
// int8 and scale (rows,) in x's dtype. Returns cudaGetLastError().
int quantize_int8_rows(const void* x, void* q, void* scale, int rows, int C, int dtype,
                       void* stream) {
  if (rows <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    quantize_rows_kernel<float><<<rows, kQuantThreads, 0, s>>>((const float*)x, (int8_t*)q,
                                                               (float*)scale, C);
  } else if (dtype == 1) {
    quantize_rows_kernel<__nv_bfloat16><<<rows, kQuantThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (int8_t*)q, (__nv_bfloat16*)scale, C);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// 0 <= shift < 32. Returns cudaGetLastError().
int gemv_pim_fixed(const void* x, const void* w, void* out, int M, int C, int R, int shift,
                   void* stream) {
  if (shift < 0 || shift > 31) return (int)cudaErrorInvalidValue;
  dim3 grid((R + kWarps - 1) / kWarps, (M + kMT - 1) / kMT);
  dim3 block(kWarps * 32);
  cudaStream_t s = (cudaStream_t)stream;
  if (C % 8 == 0 && common::aligned16(x) && common::aligned16(w)) {
    gemv_fixed_kernel<true><<<grid, block, 0, s>>>(
        (const int16_t*)x, (const int16_t*)w, (int16_t*)out, M, C, R, shift);
  } else {
    gemv_fixed_kernel<false><<<grid, block, 0, s>>>(
        (const int16_t*)x, (const int16_t*)w, (int16_t*)out, M, C, R, shift);
  }
  return (int)cudaGetLastError();
}

const char* gemv_pim_quant_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
