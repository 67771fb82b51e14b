// Elementwise LUT interpolation: out = w[sec(x)] * x + b[sec(x)] over n
// elements of float32 or bfloat16, computed in fp32, written in x's dtype.
//
// Replaces the TPU kernel src/repro/kernels/lut_interp.py::lut_interp_2d
// (Pallas body _lut_interp_kernel), which fetched each lane's (slope,
// intercept) row as a one-hot matmul on the MXU over (rows, 128) tiles.
// Here every block stages the table (at most 128 rows of 2 floats) in
// shared memory and each thread reads its rows by index (lut.cuh), which
// makes the result bit-exact to core/lut.py::apply_table. Any shape: the
// wrapper passes the element count, no padding to 128 lanes.
//
// What bounds it on the H100: bytes. Each element is read once and written
// once for two flops, so the pass is one stream in and one out over HBM.
// The design is a grid-stride loop of 16-byte loads and stores (8 bf16 or
// 4 f32 elements a thread a trip) when both pointers are aligned, scalar
// otherwise and for the tail.
#include "common.cuh"
#include "lut.cuh"

namespace {

using common::from_f;
using common::to_f;

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
lut_interp_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ wb,
                  long long n, int vec, float lo, float inv_step, int sections) {
  __shared__ float wb_s[2 * lut::kMaxTableRows];
  lut::stage(wb_s, wb, sections);
  __syncthreads();
  constexpr int N = common::Vec<T>::N;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / N;
    for (long long i = tid; i < nv; i += stride) {
      float f[N];
      common::Vec<T>::load(x + i * N, f);
      alignas(16) T o[N];
#pragma unroll
      for (int k = 0; k < N; ++k) o[k] = from_f<T>(lut::eval(f[k], wb_s, lo, inv_step, sections));
      *reinterpret_cast<uint4*>(out + i * N) = *reinterpret_cast<const uint4*>(o);
    }
    done = nv * N;
  }
  for (long long i = done + tid; i < n; i += stride)
    out[i] = from_f<T>(lut::eval(to_f(x[i]), wb_s, lo, inv_step, sections));
}

// No work: the launch floor that lut_interp's time is held against.
__global__ void noop_kernel() {}

template <typename T>
int launch(const void* x, void* out, const float* wb, long long n, float lo, float inv_step,
           int sections, cudaStream_t stream) {
  const int vec = common::aligned16(x) && common::aligned16(out);
  const long long work = vec ? n / common::Vec<T>::N + 1 : n;
  const long long want = (work + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  lut_interp_kernel<T><<<blocks, kThreads, 0, stream>>>(
      (const T*)x, (T*)out, wb, n, vec, lo, inv_step, sections);
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out). wb: (sections + 2, 2)
// fp32 rows on the device. Returns a CUDA error code (0 on success).
int lut_interp(const void* x, void* out, const float* wb, long long n, float lo,
               float inv_step, int sections, int dtype, void* stream) {
  if (n <= 0) return 0;
  if (wb == nullptr || sections < 1 || sections + 2 > lut::kMaxTableRows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) launch<float>(x, out, wb, n, lo, inv_step, sections, s);
  else if (dtype == 1) launch<__nv_bfloat16>(x, out, wb, n, lo, inv_step, sections, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// One launch of an empty kernel (1 block of 32 threads). Returns
// cudaGetLastError().
int empty_kernel(void* stream) {
  noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

const char* lut_interp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
