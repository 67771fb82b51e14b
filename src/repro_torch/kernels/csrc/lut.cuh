// Device-side LUT evaluation shared by the port's kernels: the piecewise-
// linear interpolation of core/lut.py::apply_table and its range-reduced
// reciprocal and rsqrt (lut_reciprocal, lut_rsqrt).
//
// A table is (sections + 2) rows of (slope, intercept) in fp32, rows 0 and
// sections + 1 the out-of-range guards (at most kMaxTableRows rows), kept
// in shared memory by the caller (`stage`) or read from device memory,
// where a staging barrier would cost more than the few evaluations it
// serves. Each arithmetic step is rounded on
// its own (__fsub_rn, __fmul_rn, __fadd_rn), as the plain versions'
// separate PyTorch ops are: nvcc would otherwise contract w * x + b into an
// FMA. So one evaluation is bit-exact to apply_table.
#pragma once

#include <cuda_runtime.h>

namespace lut {

constexpr int kMaxTableRows = 128;

// idx = clamp(floor((x - lo) * inv_step) + 1, 0, sections + 1), then
// w[idx] * x + b[idx]. The clamp happens before the int conversion, so
// that huge or infinite x convert safely (as section_index does).
__device__ __forceinline__ float eval(float x, const float* wb, float lo, float inv_step,
                                      int sections) {
  float f = floorf(__fmul_rn(__fsub_rn(x, lo), inv_step));
  f = fminf(fmaxf(f, -1.0f), (float)sections);
  const int idx = (int)f + 1;
  return __fadd_rn(__fmul_rn(wb[2 * idx], x), wb[2 * idx + 1]);
}

// x = m * 2^e with m in [0.5, 1), taken from the bits of a positive finite
// x, as core/lut.py's _frexp does.
__device__ __forceinline__ float frexp_bits(float x, int* e) {
  const int bits = __float_as_int(x);
  *e = ((bits >> 23) & 0xFF) - 126;
  return __int_as_float((bits & 0x007FFFFF) | 0x3F000000);
}

// y * 2^n, as ldexpf: one exact multiply where 2^n is a normal float.
__device__ __forceinline__ float scale2(float y, int n) {
  return n >= -126 && n <= 127 ? __fmul_rn(y, __int_as_float((127 + n) << 23)) : ldexpf(y, n);
}

// 1/x for x > 0: the table (1/m on [0.5, 1]) on the mantissa, times 2^-e
// rebuilt exactly.
__device__ __forceinline__ float reciprocal(float x, const float* wb, float lo,
                                            float inv_step, int sections) {
  int e;
  const float m = frexp_bits(x, &e);
  return scale2(eval(m, wb, lo, inv_step, sections), -e);
}

// 1/sqrt(x) for x > 0: an odd exponent is folded into the mantissa, which
// then lies in [0.25, 1) (the table's range), and the even exponent halved.
__device__ __forceinline__ float rsqrt(float x, const float* wb, float lo, float inv_step,
                                       int sections) {
  int e;
  float m = frexp_bits(x, &e);
  if (e & 1) {
    m = __fmul_rn(m, 0.5f);
    e += 1;
  }
  return scale2(eval(m, wb, lo, inv_step, sections), -(e / 2));
}

// Copy a table of `sections` + 2 rows into shared memory `dst`; the
// caller synchronises before reading it.
__device__ __forceinline__ void stage(float* dst, const float* wb, int sections) {
  for (int i = threadIdx.x; i < 2 * (sections + 2); i += blockDim.x) dst[i] = wb[i];
}

}  // namespace lut
