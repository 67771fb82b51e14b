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
// (plus 4 bytes of scale a row), 2 for fixed16. The design is the float
// GEMV's (gemv_pim.cu): one warp owns one output row and walks C with
// 16-byte loads (16 int8 or 8 int16 elements a lane), keeping kMT rows of
// x per pass, grid.y covering M in tiles of kMT rows; the ragged edge of
// R and M is masked, and C that is not a multiple of the vector width (or
// a misaligned row) takes the scalar path. CUDA cores only: no tensor
// core has an int16 mode, and int8 mma/wgmma is later work.
#include "common.cuh"

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

}  // namespace

extern "C" {

// bias may be null. Returns cudaGetLastError().
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
