// Row softmax by the paper's PIM flow: max -> LUT exp -> sum -> range-
// reduced LUT reciprocal -> multiply, over the last axis of (N, S) scores
// of float32 or bf16, out in the same dtype.
//
// Replaces the TPU kernel src/repro/kernels/softmax_lut.py::softmax_lut
// (Pallas body _softmax_kernel, reciprocal _recip_range_reduced). With no
// mask it computes that kernel's function, with the plain version's guard
// m = 0 when the row maximum is not finite. The dense prefill attention
// also needs the causal and sliding-window mask of _masked_softmax_attn:
// row n holds the query at absolute position q_offset + n % Sq, and key k
// is valid when (not causal or k <= qpos) and (no window or
// k > qpos - window). No mask tensor exists; each row derives its range of
// valid keys. Masked entries are never evaluated (the plain version's
// LUT(-inf) is NaN before its `where` zeroes it) and come out 0; a row
// with no valid key takes m = 0 and comes out all zeros.
//
// What bounds it on the H100: bytes, one read and one write of the scores.
// The design gives one row to a block of 256 threads: a block max, a block
// sum of the LUT exps, one reciprocal, then a pass that recomputes each
// exp (the same value) and scales it, so the row is read three times, the
// later two mostly from L1/L2. The exp and reciprocal tables sit in
// shared memory (lut.cuh, each step rounded on its own).
#include "common.cuh"
#include "lut.cuh"

namespace {

using common::from_f;
using common::to_f;

constexpr int kThreads = 256;

struct Table {
  const float* wb;
  float lo;
  float inv_step;
  int sections;
};

__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = is_max ? fmaxf(v, o) : v + o;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < n_warps ? red[lane] : (is_max ? -INFINITY : 0.0f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v, off);
      v = is_max ? fmaxf(v, o) : v + o;
    }
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  v = red[0];
  __syncthreads();
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
softmax_lut_kernel(const T* __restrict__ x, T* __restrict__ out, int S, Table e, Table r,
                   int masked, int q_offset, int Sq, int causal, int window) {
  __shared__ float ewb[2 * lut::kMaxTableRows];
  __shared__ float rwb[2 * lut::kMaxTableRows];
  __shared__ float red[32];
  lut::stage(ewb, e.wb, e.sections);
  lut::stage(rwb, r.wb, r.sections);
  const size_t row = blockIdx.x;
  const T* xr = x + row * S;
  T* orow = out + row * S;
  int k_lo = 0, k_hi = S;                       // valid keys: [k_lo, k_hi)
  if (masked) {
    const int qpos = q_offset + (int)(row % Sq);
    if (causal) k_hi = max(0, min(S, qpos + 1));
    if (window > 0) k_lo = max(0, qpos - window + 1);
  }
  float m = -INFINITY;
  for (int k = k_lo + threadIdx.x; k < k_hi; k += blockDim.x) m = fmaxf(m, to_f(xr[k]));
  m = block_reduce(m, red, true);               // also orders the table stores
  if (!isfinite(m)) m = 0.0f;                   // fully masked rows
  float s = 0.0f;
  for (int k = k_lo + threadIdx.x; k < k_hi; k += blockDim.x)
    s += lut::eval(__fsub_rn(to_f(xr[k]), m), ewb, e.lo, e.inv_step, e.sections);
  s = block_reduce(s, red, false);
  const float inv = lut::reciprocal(fmaxf(s, 1e-9f), rwb, r.lo, r.inv_step, r.sections);
  for (int k = threadIdx.x; k < S; k += blockDim.x) {
    float p = 0.0f;
    if (k >= k_lo && k < k_hi)
      p = __fmul_rn(lut::eval(__fsub_rn(to_f(xr[k]), m), ewb, e.lo, e.inv_step, e.sections),
                    inv);
    orow[k] = from_f<T>(p);
  }
}

}  // namespace

extern "C" {

// dtype (x's and out's): 0 = float32, 1 = bfloat16. The exp table's and the
// reciprocal table's rows are fp32 on the device. masked = 0 ignores
// q_offset, Sq, causal and window (window <= 0: no window). Returns a CUDA
// error code (0 on success).
int softmax_lut(const void* x, void* out, const float* exp_wb, const float* recip_wb,
                int n_rows, int S, float e_lo, float e_inv, int e_sec, float r_lo,
                float r_inv, int r_sec, int masked, int q_offset, int Sq, int causal,
                int window, int dtype, void* stream) {
  if (n_rows <= 0 || S <= 0) return 0;
  if (exp_wb == nullptr || recip_wb == nullptr || e_sec + 2 > lut::kMaxTableRows ||
      r_sec + 2 > lut::kMaxTableRows || (masked && Sq <= 0))
    return (int)cudaErrorInvalidValue;
  const Table e{exp_wb, e_lo, e_inv, e_sec}, r{recip_wb, r_lo, r_inv, r_sec};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    softmax_lut_kernel<float><<<n_rows, kThreads, 0, s>>>(
        (const float*)x, (float*)out, S, e, r, masked, q_offset, Sq, causal, window);
  } else if (dtype == 1) {
    softmax_lut_kernel<__nv_bfloat16><<<n_rows, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)out, S, e, r, masked, q_offset, Sq, causal,
        window);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* softmax_lut_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
