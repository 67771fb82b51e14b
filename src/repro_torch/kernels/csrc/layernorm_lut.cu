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
// (gamma and beta are shared by all rows). At decode a call is 4 rows of
// 1024 (16 KB in bf16), one latency-bound pass near the launch floor, so
// the design cuts that pass's serial steps (layernorm_plan in
// kernels/layernorm_lut.py picks its shape):
//   * a row belongs to a group of W warps, each lane holding C pieces of 16
//     bytes of it in registers, read once with 16-byte loads where the row
//     start, its stride and d allow and element by element where not, with
//     gamma and beta loaded beside it so that their latency overlaps; a
//     call of few rows spreads a row until a lane holds 8 values (d = 1024
//     in bf16: 4 warps, one piece a lane), which measured faster on the
//     card than a warp a row, whose lanes each add 32 values in series;
//   * both statistics come from the registers: fp64 shuffle trees, and
//     with W > 1 the group's warps in order through shared memory after one
//     barrier;
//   * the rsqrt table, one evaluation a row, is read from device memory,
//     not staged; the output is written from the registers;
//   * rows past 8 warps' registers (d > 16384 in bf16, 8192 in f32:
//     nemotron-4-340B's 18432) take a block a row and are streamed: read
//     once a pass (the mean, the centred variance, the output), in 16-byte
//     pieces where allowed, with the same fp64 sums, so the result is the
//     same bits as the plain version's.
#include "common.cuh"
#include "lut.cuh"

namespace {

using common::from_f;
using common::Pack;
using common::to_f;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Args {
  const void* x;
  const void* gamma;
  const void* beta;       // or null
  const float* rsqrt_wb;  // (sections + 2, 2) or null
  void* out;
  long long n_rows;
  int d;
  long long x_stride;     // elements between rows of x
  float eps;
  int use_lut;
  float lo;
  float inv_step;
  int sections;
  int rms;
  int plus_one;
  int wshift;             // log2 of W, the warps of a row's group (1, 2, 4 or 8)
  int rows_per_block;     // groups a block: blockDim.x = 32 * W * rows_per_block
  int vec;                // 16-byte pieces
};

struct Add {
  __device__ double operator()(double a, double b) const { return a + b; }
};

// The group's sum of its lanes' sums s, divided by d and rounded to fp32.
__device__ __forceinline__ float row_mean(double s, double* red, int W, int d) {
  return (float)(common::group_reduce(s, Add(), red, W) / (double)d);
}

// Lane t of a row's group holds elements (c * 32 * W + t) * N + j, c < C,
// j < N.
template <typename T, typename G, int C>
__global__ void __launch_bounds__(kThreads) layernorm_rows(Args a) {
  constexpr int N = 16 / (int)sizeof(T);
  __shared__ double red[2][kWarps];
  const int W = 1 << a.wshift;
  const int warp = threadIdx.x / 32;
  const int t = (warp & (W - 1)) * 32 + threadIdx.x % 32;
  const int GT = 32 * W;
  const long long row = (long long)blockIdx.x * a.rows_per_block + (warp >> a.wshift);
  const int d = row < a.n_rows ? a.d : 0;      // a dead group reads and writes nothing
  const T* xr = static_cast<const T*>(a.x) + row * a.x_stride;
  const G* gamma = static_cast<const G*>(a.gamma);
  const G* beta = static_cast<const G*>(a.beta);

  Pack<T, N> x[C];
  Pack<G, N> g[C], b[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k0 = (c * GT + t) * N;
    if (a.vec) {
      if (k0 < d) {
        x[c].load(xr + k0);
        g[c].load(gamma + k0);
        if (beta != nullptr) b[c].load(beta + k0);
      }
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (k0 + j < d) {
          x[c].v[j] = xr[k0 + j];
          g[c].v[j] = gamma[k0 + j];
          if (beta != nullptr) b[c].v[j] = beta[k0 + j];
        }
      }
    }
  }

  double s = 0.0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if ((c * GT + t) * N + j < d) {
        const float v = x[c][j];
        s += a.rms ? (double)__fmul_rn(v, v) : (double)v;
      }
    }
  }
  const float m = row_mean(s, red[0], W, a.d);
  float mean = 0.0f, var = m;
  if (!a.rms) {
    mean = m;
    s = 0.0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if ((c * GT + t) * N + j < d) {
          const float xc = __fsub_rn(x[c][j], mean);
          s += (double)__fmul_rn(xc, xc);
        }
      }
    }
    var = row_mean(s, red[1], W, a.d);
  }
  const float v = __fadd_rn(var, a.eps);
  const float inv = a.use_lut ? lut::rsqrt(v, a.rsqrt_wb, a.lo, a.inv_step, a.sections)
                              : rsqrtf(v);

  T* orow = static_cast<T*>(a.out) + row * a.d;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k0 = (c * GT + t) * N;
    if (k0 >= d) continue;
    Pack<T, N> o;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float xc = a.rms ? x[c][j] : __fsub_rn(x[c][j], mean);
      float gj = g[c][j];
      if (a.plus_one) gj = __fadd_rn(1.0f, gj);
      float r = __fmul_rn(__fmul_rn(xc, inv), gj);
      if (beta != nullptr) r = __fadd_rn(r, b[c][j]);
      o.v[j] = from_f<T>(r);
    }
    if (a.vec) {
      o.store(orow + k0);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (k0 + j < d) orow[k0 + j] = o.v[j];
    }
  }
}

// Rows past the registers: a block a row, streamed from device memory.
// Thread t takes the pieces i = t, t + kThreads, ... of N elements: with
// a.vec the 16-byte piece at i * N, else the elements
// (i / kThreads) * kThreads * N + j * kThreads + i % kThreads, so that a
// warp's loads stay coalesced either way.
template <typename T, typename G>
__global__ void __launch_bounds__(kThreads) layernorm_stream(Args a) {
  constexpr int N = 16 / (int)sizeof(T);
  __shared__ double red[2][kWarps];
  const long long row = blockIdx.x;
  const int d = a.d;
  const T* xr = static_cast<const T*>(a.x) + row * a.x_stride;
  const G* gamma = static_cast<const G*>(a.gamma);
  const G* beta = static_cast<const G*>(a.beta);
  T* orow = static_cast<T*>(a.out) + row * d;
  constexpr int kSpan = kThreads * N;
  const int n_pieces = a.vec ? d / N : (d + kSpan - 1) / kSpan * kThreads;

  // The index of element j of piece i, or -1 past d.
  auto index = [&](int i, int j) {
    const int k = a.vec ? i * N + j
                        : (i / kThreads) * kThreads * N + j * kThreads + i % kThreads;
    return k < d ? k : -1;
  };
  auto load = [&](int i, Pack<T, N>& x) {
    if (a.vec) {
      x.load(xr + i * N);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int k = index(i, j);
        if (k >= 0) x.v[j] = xr[k];
      }
    }
  };

  double s = 0.0;
  for (int i = threadIdx.x; i < n_pieces; i += kThreads) {
    Pack<T, N> x;
    load(i, x);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (index(i, j) >= 0) {
        const float v = x[j];
        s += a.rms ? (double)__fmul_rn(v, v) : (double)v;
      }
    }
  }
  const float m = row_mean(s, red[0], kWarps, d);
  float mean = 0.0f, var = m;
  if (!a.rms) {
    mean = m;
    s = 0.0;
    for (int i = threadIdx.x; i < n_pieces; i += kThreads) {
      Pack<T, N> x;
      load(i, x);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (index(i, j) >= 0) {
          const float xc = __fsub_rn(x[j], mean);
          s += (double)__fmul_rn(xc, xc);
        }
      }
    }
    var = row_mean(s, red[1], kWarps, d);
  }
  const float v = __fadd_rn(var, a.eps);
  const float inv = a.use_lut ? lut::rsqrt(v, a.rsqrt_wb, a.lo, a.inv_step, a.sections)
                              : rsqrtf(v);

  for (int i = threadIdx.x; i < n_pieces; i += kThreads) {
    Pack<T, N> x, o;
    Pack<G, N> g, b;
    load(i, x);
    if (a.vec) {
      g.load(gamma + i * N);
      if (beta != nullptr) b.load(beta + i * N);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int k = index(i, j);
      if (k < 0) continue;
      const float xc = a.rms ? x[j] : __fsub_rn(x[j], mean);
      float gj = a.vec ? g[j] : to_f(gamma[k]);
      if (a.plus_one) gj = __fadd_rn(1.0f, gj);
      float r = __fmul_rn(__fmul_rn(xc, inv), gj);
      if (beta != nullptr) r = __fadd_rn(r, a.vec ? b[j] : to_f(beta[k]));
      o.v[j] = from_f<T>(r);
      if (!a.vec) orow[k] = o.v[j];
    }
    if (a.vec) o.store(orow + i * N);
  }
}

template <typename T, typename G>
int launch(const Args& a, int chunks, cudaStream_t s) {
  constexpr int N = 16 / (int)sizeof(T);
  if (chunks == 0) {
    layernorm_stream<T, G><<<(unsigned)a.n_rows, kThreads, 0, s>>>(a);
    return 0;
  }
  const int W = 1 << a.wshift, R = a.rows_per_block;
  if (R < 1 || W * R > kWarps || (long long)chunks * 32 * W * N < a.d)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((a.n_rows + R - 1) / R));
  const int threads = 32 * W * R;
  switch (chunks) {
    case 1: layernorm_rows<T, G, 1><<<grid, threads, 0, s>>>(a); break;
    case 2: layernorm_rows<T, G, 2><<<grid, threads, 0, s>>>(a); break;
    case 4: layernorm_rows<T, G, 4><<<grid, threads, 0, s>>>(a); break;
    case 8: layernorm_rows<T, G, 8><<<grid, threads, 0, s>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <typename T>
int launch_g(const Args& a, int chunks, int gdtype, cudaStream_t s) {
  if (gdtype == 0) return launch<T, float>(a, chunks, s);
  if (gdtype == 1) return launch<T, __nv_bfloat16>(a, chunks, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype (x's and out's) and gdtype (gamma's and beta's): 0 = float32,
// 1 = bfloat16. beta and rsqrt_wb may be null (rsqrt_wb when use_lut is 0).
// out is (n_rows, d) contiguous. chunks, warps_per_row and rows_per_block
// are layernorm_plan's (chunks 0: a block a row, streamed); vec asks for
// 16-byte pieces (x, out, gamma and beta 16-byte aligned, x_stride and d
// multiples of 16 bytes of x's elements).
// Returns a CUDA error code (0 on success).
int layernorm_lut(const void* x, const void* gamma, const void* beta, const float* rsqrt_wb,
                  void* out, long long n_rows, int d, long long x_stride, float eps,
                  int use_lut, float lo, float inv_step, int sections, int rms, int plus_one,
                  int chunks, int warps_per_row, int rows_per_block, int vec, int dtype,
                  int gdtype, void* stream) {
  if (n_rows <= 0) return 0;
  if (d <= 0 || dtype < 0 || dtype > 1 ||
      (use_lut && (rsqrt_wb == nullptr || sections + 2 > lut::kMaxTableRows)))
    return (int)cudaErrorInvalidValue;
  const int elem = dtype == 0 ? 4 : 2;
  const int wshift = warps_per_row == 1 ? 0 : warps_per_row == 2 ? 1 : warps_per_row == 4 ? 2
                     : warps_per_row == 8 ? 3 : -1;
  if (wshift < 0 ||
      (vec && (!common::aligned16(x) || !common::aligned16(out) || !common::aligned16(gamma) ||
               (beta != nullptr && !common::aligned16(beta)) || (x_stride * elem) % 16 != 0 ||
               (d * elem) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const Args a{x, gamma, beta, rsqrt_wb, out, n_rows, d, x_stride, eps, use_lut, lo, inv_step,
               sections, rms, plus_one, wshift, rows_per_block, vec};
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = dtype == 0 ? launch_g<float>(a, chunks, gdtype, s)
                            : launch_g<__nv_bfloat16>(a, chunks, gdtype, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

const char* layernorm_lut_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
