// The backward passes of the three LUT kernels, for training on the card:
// each computes what autograd of its kernel's plain PyTorch version
// computes (kernels/lut_interp.py, layernorm_lut.py, softmax_lut.py,
// `*_backward_plain`). They replace no TPU kernel: the JAX package
// differentiates its LUT functions with XLA's autodiff (no custom rule), so
// the gradient of a table is its section's slope, and the range-reduced
// reciprocal and rsqrt, which read the float's bits, have gradient 0.
//
//   lut_interp_backward:   dx = dy * w[sec(x)] in fp32, cast to x's dtype
//                          (bit for bit the plain twin).
//   layernorm_lut_backward: LayerNorm / RMSNorm (plus_one too). With the
//                          LUT rsqrt, inv is a constant under the gradient:
//                          dx = inv * (g dy - mean(g dy)) (RMSNorm:
//                          inv * g dy); with rsqrtf the full derivative,
//                          dx = inv * (g dy - mean(g dy) - xhat * mean(g dy xhat))
//                          (RMSNorm without the first mean). dgamma =
//                          sum_rows dy * xhat, dbeta = sum_rows dy, reduced
//                          without atomics: each block sums a chunk of rows
//                          into its own partial row, and a second kernel adds
//                          the partials in order, so the result is the same
//                          bits on every run.
//   softmax_lut_backward:  the masked LUT softmax (the causal / window mask
//                          of _masked_softmax_attn, derived per row as the
//                          forward kernel does). r = 1 / sum is a constant
//                          under the gradient; on a visible key
//                          t_j = (dy_j * r) * w_exp[sec(x_j - m)], and the
//                          row's max element(s) also get -sum_j t_j, shared
//                          equally among ties (the gradient of the max);
//                          masked keys get 0.
//
// What bounds them on the H100: bytes. Each reads its inputs and writes its
// outputs once in principle; these first versions are simple and read a
// row again from L1/L2 in each of their passes (the statistics, the sums,
// the output). The element kernel is a grid-stride loop; the norm takes a
// block a row; the softmax a warp a row over the row's visible range only.
#include "common.cuh"
#include "lut.cuh"

namespace {

using common::from_f;
using common::to_f;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ---------------------------------------------------------------------------
// lut_interp_backward
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
lut_backward_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                    const float* __restrict__ wb, long long n, float lo, float inv_step,
                    int sections) {
  __shared__ float wb_s[2 * lut::kMaxTableRows];
  lut::stage(wb_s, wb, sections);
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    dx[i] = from_f<T>(__fmul_rn(to_f(dy[i]), lut::slope(to_f(x[i]), wb_s, lo, inv_step,
                                                         sections)));
}

// ---------------------------------------------------------------------------
// layernorm_lut_backward
// ---------------------------------------------------------------------------

// Sum over the block (kThreads threads); every thread gets the result.
template <typename V>
__device__ __forceinline__ V block_sum(V v, V* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32;
  __syncthreads();                      // red may still be read by a previous call
  if (threadIdx.x % 32 == 0) red[warp] = v;
  __syncthreads();
  V t = red[0];
  for (int i = 1; i < kWarps; ++i) t += red[i];
  return t;
}

struct NormArgs {
  const void* x;          // (n, d) contiguous
  const void* dy;         // (n, d) contiguous
  const void* gamma;      // (d,)
  const float* rsqrt_wb;  // or null: rsqrtf
  void* dx;               // (n, d) in x's dtype
  float* mean;            // (n,) scratch: each row's mean (0 for RMSNorm)
  float* inv;             // (n,) scratch: each row's inv
  long long n_rows;
  int d;
  float eps;
  float lo, inv_step;
  int sections;
  int rms, plus_one;
};

template <typename T, typename G>
__global__ void __launch_bounds__(kThreads) norm_backward_rows(NormArgs a) {
  __shared__ double red64[kWarps];
  __shared__ float red32[kWarps];
  const long long row = blockIdx.x;
  const T* x = (const T*)a.x + row * a.d;
  const T* dy = (const T*)a.dy + row * a.d;
  const G* gamma = (const G*)a.gamma;
  const int d = a.d;
  float mean = 0.0f;
  if (!a.rms) {
    double s = 0.0;
    for (int j = threadIdx.x; j < d; j += kThreads) s += (double)to_f(x[j]);
    mean = (float)(block_sum(s, red64) / d);
  }
  double s2 = 0.0;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    const float c = __fsub_rn(to_f(x[j]), mean);
    s2 += (double)__fmul_rn(c, c);
  }
  const float var = (float)(block_sum(s2, red64) / d);
  const float v = __fadd_rn(var, a.eps);
  const float inv = a.rsqrt_wb != nullptr
      ? lut::rsqrt(v, a.rsqrt_wb, a.lo, a.inv_step, a.sections) : rsqrtf(v);
  // Sums of g dy and of g dy xhat.
  float sg = 0.0f, sgx = 0.0f;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    float g = to_f(gamma[j]);
    if (a.plus_one) g = 1.0f + g;
    const float gdy = g * to_f(dy[j]);
    sg += gdy;
    sgx += gdy * ((to_f(x[j]) - mean) * inv);
  }
  const bool exact = a.rsqrt_wb == nullptr;
  const float mg = a.rms ? 0.0f : block_sum(sg, red32) / d;
  const float mgx = exact ? block_sum(sgx, red32) / d : 0.0f;
  T* dx = (T*)a.dx + row * a.d;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    float g = to_f(gamma[j]);
    if (a.plus_one) g = 1.0f + g;
    const float gdy = g * to_f(dy[j]);
    const float xhat = (to_f(x[j]) - mean) * inv;
    dx[j] = from_f<T>(inv * (gdy - mg - xhat * mgx));
  }
  if (threadIdx.x == 0) {
    a.mean[row] = mean;
    a.inv[row] = inv;
  }
}

// partial[c, j] = sum over rows [c * rows_per_chunk, ...) of dy * xhat
// (and of dy into partial_b when it is given), a thread a column.
template <typename T>
__global__ void __launch_bounds__(kThreads)
norm_backward_cols(const T* __restrict__ x, const T* __restrict__ dy,
                   const float* __restrict__ mean, const float* __restrict__ inv,
                   float* __restrict__ partial_g, float* __restrict__ partial_b,
                   long long n_rows, int d, int rows_per_chunk) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= d) return;
  const long long r0 = (long long)blockIdx.y * rows_per_chunk;
  const long long r1 = min(n_rows, r0 + rows_per_chunk);
  float sg = 0.0f, sb = 0.0f;
  for (long long r = r0; r < r1; ++r) {
    const float g = to_f(dy[r * d + j]);
    sg += g * ((to_f(x[r * d + j]) - mean[r]) * inv[r]);
    sb += g;
  }
  partial_g[(long long)blockIdx.y * d + j] = sg;
  if (partial_b != nullptr) partial_b[(long long)blockIdx.y * d + j] = sb;
}

// out[j] = sum over chunks, in order, of partial[c, j] (fp64), in G.
template <typename G>
__global__ void __launch_bounds__(kThreads)
norm_backward_sum(const float* __restrict__ partial, G* __restrict__ out, int n_chunks, int d) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= d) return;
  double s = 0.0;
  for (int c = 0; c < n_chunks; ++c) s += (double)partial[(long long)c * d + j];
  out[j] = from_f<G>((float)s);
}

template <typename T, typename G>
int launch_norm(const NormArgs& a, void* dgamma, void* dbeta, float* partial, int rows_per_chunk,
                cudaStream_t s) {
  norm_backward_rows<T, G><<<(unsigned)a.n_rows, kThreads, 0, s>>>(a);
  const int n_chunks = (int)((a.n_rows + rows_per_chunk - 1) / rows_per_chunk);
  const dim3 grid((a.d + kThreads - 1) / kThreads, n_chunks);
  float* pb = dbeta != nullptr ? partial + (long long)n_chunks * a.d : nullptr;
  norm_backward_cols<T><<<grid, kThreads, 0, s>>>(
      (const T*)a.x, (const T*)a.dy, a.mean, a.inv, partial, pb, a.n_rows, a.d, rows_per_chunk);
  const unsigned col_blocks = (a.d + kThreads - 1) / kThreads;
  norm_backward_sum<G><<<col_blocks, kThreads, 0, s>>>(partial, (G*)dgamma, n_chunks, a.d);
  if (dbeta != nullptr)
    norm_backward_sum<G><<<col_blocks, kThreads, 0, s>>>(pb, (G*)dbeta, n_chunks, a.d);
  return 0;
}

// ---------------------------------------------------------------------------
// softmax_lut_backward
// ---------------------------------------------------------------------------

struct SoftmaxArgs {
  const void* x;
  const void* dy;
  void* dx;
  long long n_rows;
  int S;
  const float* exp_wb;
  float e_lo, e_inv;
  int e_sec;
  const float* recip_wb;
  float r_lo, r_inv;
  int r_sec;
  int masked, q_offset, Sq, causal, window;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) softmax_backward_kernel(SoftmaxArgs a) {
  __shared__ float e_s[2 * lut::kMaxTableRows];
  __shared__ float r_s[2 * lut::kMaxTableRows];
  lut::stage(e_s, a.exp_wb, a.e_sec);
  lut::stage(r_s, a.recip_wb, a.r_sec);
  __syncthreads();
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= a.n_rows) return;
  const int lane = threadIdx.x % 32;
  const T* x = (const T*)a.x + row * a.S;
  const T* dy = (const T*)a.dy + row * a.S;
  T* dx = (T*)a.dx + row * a.S;
  int lo = 0, hi = a.S;                 // the row's visible keys [lo, hi)
  if (a.masked) {
    const int qpos = a.q_offset + (int)(row % a.Sq);
    if (a.causal) hi = max(0, min(a.S, qpos + 1));
    if (a.window > 0) lo = max(0, qpos - a.window + 1);
  }
  for (int j = lane; j < a.S; j += 32)
    if (j < lo || j >= hi) dx[j] = from_f<T>(0.0f);
  if (lo >= hi) return;                 // no visible key: the output was all zeros
  float m = -INFINITY;
  for (int j = lo + lane; j < hi; j += 32) m = fmaxf(m, to_f(x[j]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float s = 0.0f;
  for (int j = lo + lane; j < hi; j += 32)
    s += lut::eval(__fsub_rn(to_f(x[j]), m), e_s, a.e_lo, a.e_inv, a.e_sec);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const float r = lut::reciprocal(fmaxf(s, 1e-9f), r_s, a.r_lo, a.r_inv, a.r_sec);
  float tsum = 0.0f;
  int ties = 0;
  for (int j = lo + lane; j < hi; j += 32) {
    const float xj = to_f(x[j]);
    tsum += __fmul_rn(__fmul_rn(to_f(dy[j]), r),
                      lut::slope(__fsub_rn(xj, m), e_s, a.e_lo, a.e_inv, a.e_sec));
    ties += xj == m;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    tsum += __shfl_xor_sync(0xffffffffu, tsum, off);
    ties += __shfl_xor_sync(0xffffffffu, ties, off);
  }
  const float share = -tsum / (float)ties;
  for (int j = lo + lane; j < hi; j += 32) {
    const float xj = to_f(x[j]);
    float t = __fmul_rn(__fmul_rn(to_f(dy[j]), r),
                        lut::slope(__fsub_rn(xj, m), e_s, a.e_lo, a.e_inv, a.e_sec));
    if (xj == m) t += share;
    dx[j] = from_f<T>(t);
  }
}

}  // namespace

extern "C" {

// dtype (x, dy, dx): 0 = float32, 1 = bfloat16. Returns a CUDA error code.
int lut_interp_backward(const void* x, const void* dy, void* dx, const float* wb, long long n,
                        float lo, float inv_step, int sections, int dtype, void* stream) {
  if (n <= 0) return 0;
  if (wb == nullptr || sections < 1 || sections + 2 > lut::kMaxTableRows)
    return (int)cudaErrorInvalidValue;
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    lut_backward_kernel<float><<<blocks, kThreads, 0, s>>>(
        (const float*)x, (const float*)dy, (float*)dx, wb, n, lo, inv_step, sections);
  else if (dtype == 1)
    lut_backward_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)dy, (__nv_bfloat16*)dx, wb, n, lo,
        inv_step, sections);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x, dy, dx (n_rows, d) contiguous in dtype; gamma, dgamma and dbeta (d,)
// in gdtype (dbeta null: no beta); rsqrt_wb null: exact rsqrt. mean and inv
// (n_rows,) and partial (2 or 1, ceil(n_rows / rows_per_chunk), d) fp32
// scratch. Returns a CUDA error code.
int layernorm_lut_backward(const void* x, const void* dy, const void* gamma,
                           const float* rsqrt_wb, void* dx, void* dgamma, void* dbeta,
                           float* mean, float* inv, float* partial, long long n_rows, int d,
                           float eps, float lo, float inv_step, int sections, int rms,
                           int plus_one, int rows_per_chunk, int dtype, int gdtype,
                           void* stream) {
  if (n_rows <= 0 || d <= 0) return 0;
  if (n_rows > 0x7fffffffLL || rows_per_chunk < 1 || dtype < 0 || dtype > 1 || gdtype < 0 ||
      gdtype > 1 || (rsqrt_wb != nullptr && sections + 2 > lut::kMaxTableRows))
    return (int)cudaErrorInvalidValue;
  const NormArgs a{x, dy, gamma, rsqrt_wb, dx, mean, inv, n_rows, d, eps, lo, inv_step,
                   sections, rms, plus_one};
  cudaStream_t s = (cudaStream_t)stream;
  using bf = __nv_bfloat16;
  if (dtype == 0 && gdtype == 0) launch_norm<float, float>(a, dgamma, dbeta, partial, rows_per_chunk, s);
  else if (dtype == 0) launch_norm<float, bf>(a, dgamma, dbeta, partial, rows_per_chunk, s);
  else if (gdtype == 0) launch_norm<bf, float>(a, dgamma, dbeta, partial, rows_per_chunk, s);
  else launch_norm<bf, bf>(a, dgamma, dbeta, partial, rows_per_chunk, s);
  return (int)cudaGetLastError();
}

// x, dy, dx (n_rows, S) contiguous in dtype; the mask as softmax_lut's
// (masked = 0 ignores q_offset, Sq, causal and window; window <= 0: no
// window). Returns a CUDA error code.
int softmax_lut_backward(const void* x, const void* dy, void* dx, const float* exp_wb,
                         const float* recip_wb, long long n_rows, int S, float e_lo,
                         float e_inv, int e_sec, float r_lo, float r_inv, int r_sec,
                         int masked, int q_offset, int Sq, int causal, int window, int dtype,
                         void* stream) {
  if (n_rows <= 0 || S <= 0) return 0;
  if (exp_wb == nullptr || recip_wb == nullptr || e_sec + 2 > lut::kMaxTableRows ||
      r_sec + 2 > lut::kMaxTableRows || (masked && Sq <= 0) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const SoftmaxArgs a{x, dy, dx, n_rows, S, exp_wb, e_lo, e_inv, e_sec, recip_wb, r_lo, r_inv,
                      r_sec, masked, q_offset, Sq, causal, window};
  const long long blocks = (n_rows + kWarps - 1) / kWarps;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) softmax_backward_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(a);
  else softmax_backward_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

const char* backward_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
