// Row LayerNorm or RMSNorm, with the reciprocal square root from the
// range-reduced LUT (the paper's C2) or from rsqrtf, over (N, d) rows of
// float32 or bf16 (out in x's dtype), gamma and beta in float32 or bf16.
//
// Replaces the TPU kernel src/repro/kernels/layernorm_lut.py::layernorm_lut
// (Pallas body _ln_kernel, rsqrt _rsqrt_range_reduced), in the same order:
//
//   LayerNorm: mean = sum(x) / d; xc = x - mean; var = sum(xc * xc) / d
//   RMSNorm:   xc = x;            var = sum(x * x) / d
//   inv = rsqrt(var + eps)   (LUT on the mantissa, exponent halved, or rsqrtf)
//   out = xc * inv * g [+ beta],  g = gamma or, with plus_one, 1 + gamma
//
// two passes for the statistics (the mean, then the centred variance; no
// Welford). Each sum adds fp32 terms in fp64 and is rounded to fp32 once,
// after the division, as the plain version does: two fp64 sums of the same
// terms in different orders round to the same fp32 value (but for a
// 2^-29 chance), so the kernel is bit-exact to the plain version although
// it adds in another order. Every float operation of the output is rounded
// on its own, as the plain version's separate PyTorch ops are. Rows may be
// strided (the final norm takes x[:, -1]); the last axis is contiguous.
//
// What bounds it on the H100: bytes, one read and one write of each row
// (gamma and beta are shared by all rows). The design gives one row to a
// block of 256 threads with block reductions by shuffles; the row is read
// two or three times, the later passes from L1. GPT-2 medium at decode has
// 4 rows of 1024: 4 blocks, so the call is one short, latency-bound pass.
#include "common.cuh"
#include "lut.cuh"

namespace {

using common::from_f;
using common::to_f;

constexpr int kThreads = 256;

// The block's sum of v, then divided by d and rounded to fp32.
__device__ __forceinline__ float block_mean(double v, double* red, int d) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < n_warps ? red[lane] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  v = red[0];
  __syncthreads();
  return (float)(v / (double)d);
}

struct Args {
  const void* x;
  const void* gamma;
  const void* beta;       // or null
  const float* rsqrt_wb;  // (sections + 2, 2) or null
  void* out;
  int d;
  long long x_stride;     // elements between rows of x
  float eps;
  int use_lut;
  float lo;
  float inv_step;
  int sections;
  int rms;
  int plus_one;
};

template <typename T, typename G>
__global__ void __launch_bounds__(kThreads) layernorm_kernel(Args a) {
  __shared__ float wb[2 * lut::kMaxTableRows];
  __shared__ double red[32];
  if (a.use_lut) lut::stage(wb, a.rsqrt_wb, a.sections);
  const T* xr = reinterpret_cast<const T*>(a.x) + blockIdx.x * a.x_stride;
  T* orow = reinterpret_cast<T*>(a.out) + (size_t)blockIdx.x * a.d;
  const G* gamma = reinterpret_cast<const G*>(a.gamma);
  const G* beta = reinterpret_cast<const G*>(a.beta);
  double s = 0.0;
  for (int i = threadIdx.x; i < a.d; i += blockDim.x) {
    const float v = to_f(xr[i]);
    s += a.rms ? (double)__fmul_rn(v, v) : (double)v;
  }
  const float m = block_mean(s, red, a.d);   // also orders the table stores
  float mean = 0.0f, var = m;
  if (!a.rms) {
    mean = m;
    double s2 = 0.0;
    for (int i = threadIdx.x; i < a.d; i += blockDim.x) {
      const float c = __fsub_rn(to_f(xr[i]), mean);
      s2 += (double)__fmul_rn(c, c);
    }
    var = block_mean(s2, red, a.d);
  }
  const float v = __fadd_rn(var, a.eps);
  const float inv = a.use_lut ? lut::rsqrt(v, wb, a.lo, a.inv_step, a.sections) : rsqrtf(v);
  for (int i = threadIdx.x; i < a.d; i += blockDim.x) {
    const float xc = a.rms ? to_f(xr[i]) : __fsub_rn(to_f(xr[i]), mean);
    float g = to_f(gamma[i]);
    if (a.plus_one) g = __fadd_rn(1.0f, g);
    float o = __fmul_rn(__fmul_rn(xc, inv), g);
    if (beta != nullptr) o = __fadd_rn(o, to_f(beta[i]));
    orow[i] = from_f<T>(o);
  }
}

template <typename T>
int launch_g(const Args& a, int n_rows, int gdtype, cudaStream_t s) {
  if (gdtype == 0) layernorm_kernel<T, float><<<n_rows, kThreads, 0, s>>>(a);
  else if (gdtype == 1) layernorm_kernel<T, __nv_bfloat16><<<n_rows, kThreads, 0, s>>>(a);
  else return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

// dtype (x's and out's) and gdtype (gamma's and beta's): 0 = float32,
// 1 = bfloat16. beta and rsqrt_wb may be null (rsqrt_wb when use_lut is 0).
// out is (n_rows, d) contiguous. Returns a CUDA error code (0 on success).
int layernorm_lut(const void* x, const void* gamma, const void* beta, const float* rsqrt_wb,
                  void* out, int n_rows, int d, long long x_stride, float eps, int use_lut,
                  float lo, float inv_step, int sections, int rms, int plus_one, int dtype,
                  int gdtype, void* stream) {
  if (n_rows <= 0) return 0;
  if (d <= 0 || (use_lut && (rsqrt_wb == nullptr || sections + 2 > lut::kMaxTableRows)))
    return (int)cudaErrorInvalidValue;
  const Args a{x, gamma, beta, rsqrt_wb, out, d, x_stride, eps, use_lut, lo, inv_step,
               sections, rms, plus_one};
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (dtype == 0) rc = launch_g<float>(a, n_rows, gdtype, s);
  else if (dtype == 1) rc = launch_g<__nv_bfloat16>(a, n_rows, gdtype, s);
  else return (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

const char* layernorm_lut_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
