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
// valid keys [k_lo, k_hi). Masked entries are never read or evaluated (the
// plain version's LUT(-inf) is NaN before its `where` zeroes it) and come
// out 0; a row with no valid key takes m = 0 and comes out all zeros.
//
// What bounds it on the H100: bytes, each valid key read once and every
// entry written once. At the main path's widths a call is short (a
// 128-token prefill: 2048 rows of 128 f32 keys, 1.5 MB, a few
// microseconds), so one pass's latency and instructions count as much as
// the bytes. The design (softmax_plan in kernels/softmax_lut.py picks its
// shape) reads a row once, evaluates each exp once and, for short rows,
// takes no barrier:
//   * a warp a row up to S = 1024 (a few-row call spreads a row over up to
//     8 warps, _build.row_plan): each lane holds C pieces of 16 bytes of
//     the row in registers (at most 32 values), read once, with 16-byte
//     loads where S and the base allow and element by element where not,
//     and only where the piece meets [k_lo, k_hi);
//   * the max and the sum are shuffle trees (a group of W > 1 warps adds
//     its warps' values in order through shared memory after a barrier);
//     each exp is evaluated once and kept in registers from the sum to the
//     scaling; the sum has a fixed order, so two launches agree bit for
//     bit;
//   * the exp table is staged in shared memory, under a block's one
//     barrier, only where a lane evaluates it 16 times or more; shorter
//     rows read it, and every row reads its one reciprocal, from device
//     memory through L1, with no staging and no barrier;
//   * rows past 8 warps' registers (S > 8192) take a block a row and are
//     streamed: read three times, each exp evaluated twice.
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
  void* out;
  long long n_rows;
  int S;
  const float* exp_wb;
  float e_lo, e_inv;
  int e_sec;
  const float* recip_wb;
  float r_lo, r_inv;
  int r_sec;
  int masked, q_offset, Sq, causal, window;
  int wshift;             // log2 of W, the warps of a row's group (1, 2, 4 or 8)
  int rows_per_block;     // groups a block: blockDim.x = 32 * W * rows_per_block
  int vec;                // 16-byte loads and stores
};

struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct Add {
  __device__ float operator()(float a, float b) const { return a + b; }
};

// The valid keys [lo, hi) of a row; a 32-bit modulo where the row allows.
__device__ __forceinline__ void key_range(const Args& a, long long row, int* lo, int* hi) {
  *lo = 0;
  *hi = a.S;
  if (a.masked) {
    const int q = row <= 0x7fffffff ? (int)((unsigned)row % (unsigned)a.Sq) : (int)(row % a.Sq);
    const int qpos = a.q_offset + q;
    if (a.causal) *hi = max(0, min(a.S, qpos + 1));
    if (a.window > 0) *lo = max(0, qpos - a.window + 1);
  }
}

// Rows held in registers: lane t of the group holds elements
// (c * 32 * W + t) * N + j, c < C, j < N. The exp table is staged in shared
// memory where a lane evaluates it 16 times or more, else read through L1.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads) softmax_rows(Args a) {
  constexpr int N = 16 / (int)sizeof(T);
  constexpr bool kStaged = C * N >= 16;
  __shared__ float ewb[kStaged ? 2 * lut::kMaxTableRows : 1];
  __shared__ float red[2][kWarps];
  const int W = 1 << a.wshift;
  const int warp = threadIdx.x / 32;
  const int t = (warp & (W - 1)) * 32 + threadIdx.x % 32;
  const int G = 32 * W;
  const long long row = (long long)blockIdx.x * a.rows_per_block + (warp >> a.wshift);
  const bool live = row < a.n_rows;
  int k_lo = 0, k_hi = 0;                       // a dead group reads and writes nothing
  if (live) key_range(a, row, &k_lo, &k_hi);
  const T* xr = static_cast<const T*>(a.x) + row * a.S;

  float v[C][N];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k0 = (c * G + t) * N;
    if (k0 < k_hi && k0 + N > k_lo) {
      if (a.vec) {
        common::Vec<T>::load(xr + k0, v[c]);
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j)
          if (k0 + j >= k_lo && k0 + j < k_hi) v[c][j] = to_f(xr[k0 + j]);
      }
    }
  }
  if constexpr (kStaged) {
    lut::stage(ewb, a.exp_wb, a.e_sec);
    __syncthreads();
  }
  const float* etab = kStaged ? ewb : a.exp_wb;

  float m = -INFINITY;
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int k = (c * G + t) * N + j;
      if (k >= k_lo && k < k_hi) m = fmaxf(m, v[c][j]);
    }
  }
  m = common::group_reduce(m, Max(), red[0], W);
  if (!isfinite(m)) m = 0.0f;                   // fully masked rows
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int k = (c * G + t) * N + j;
      if (k >= k_lo && k < k_hi) {
        v[c][j] = lut::eval(__fsub_rn(v[c][j], m), etab, a.e_lo, a.e_inv, a.e_sec);
        s += v[c][j];
      }
    }
  }
  s = common::group_reduce(s, Add(), red[1], W);
  const float inv = lut::reciprocal(fmaxf(s, 1e-9f), a.recip_wb, a.r_lo, a.r_inv, a.r_sec);

  if (!live) return;
  T* orow = static_cast<T*>(a.out) + row * a.S;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k0 = (c * G + t) * N;
    if (k0 >= a.S) continue;
    Pack<T, N> o;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int k = k0 + j;
      o.v[j] = from_f<T>(k >= k_lo && k < k_hi ? __fmul_rn(v[c][j], inv) : 0.0f);
    }
    if (a.vec) {
      o.store(orow + k0);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (k0 + j < a.S) orow[k0 + j] = o.v[j];
    }
  }
}

// Rows past the registers: a block a row, streamed from device memory.
template <typename T>
__global__ void __launch_bounds__(kThreads) softmax_stream(Args a) {
  __shared__ float ewb[2 * lut::kMaxTableRows];
  __shared__ float red[2][kWarps];
  const long long row = blockIdx.x;
  int k_lo, k_hi;
  key_range(a, row, &k_lo, &k_hi);
  const T* xr = static_cast<const T*>(a.x) + row * a.S;
  T* orow = static_cast<T*>(a.out) + row * a.S;
  lut::stage(ewb, a.exp_wb, a.e_sec);
  __syncthreads();
  float m = -INFINITY;
  for (int k = k_lo + threadIdx.x; k < k_hi; k += kThreads) m = fmaxf(m, to_f(xr[k]));
  m = common::group_reduce(m, Max(), red[0], kWarps);
  if (!isfinite(m)) m = 0.0f;
  float s = 0.0f;
  for (int k = k_lo + threadIdx.x; k < k_hi; k += kThreads)
    s += lut::eval(__fsub_rn(to_f(xr[k]), m), ewb, a.e_lo, a.e_inv, a.e_sec);
  s = common::group_reduce(s, Add(), red[1], kWarps);
  const float inv = lut::reciprocal(fmaxf(s, 1e-9f), a.recip_wb, a.r_lo, a.r_inv, a.r_sec);
  for (int k = threadIdx.x; k < a.S; k += kThreads) {
    float p = 0.0f;
    if (k >= k_lo && k < k_hi)
      p = __fmul_rn(lut::eval(__fsub_rn(to_f(xr[k]), m), ewb, a.e_lo, a.e_inv, a.e_sec), inv);
    orow[k] = from_f<T>(p);
  }
}

template <typename T>
int launch(const Args& a, int chunks, cudaStream_t s) {
  constexpr int N = 16 / (int)sizeof(T);
  if (chunks == 0) {
    softmax_stream<T><<<(unsigned)a.n_rows, kThreads, 0, s>>>(a);
    return 0;
  }
  const int W = 1 << a.wshift, R = a.rows_per_block;
  if (R < 1 || W * R > kWarps || (long long)chunks * 32 * W * N < a.S || chunks * N > 32)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((a.n_rows + R - 1) / R));
  const int threads = 32 * W * R;
  switch (chunks) {
    case 1: softmax_rows<T, 1><<<grid, threads, 0, s>>>(a); break;
    case 2: softmax_rows<T, 2><<<grid, threads, 0, s>>>(a); break;
    case 4: softmax_rows<T, 4><<<grid, threads, 0, s>>>(a); break;
    case 8:
      if constexpr (N * 8 <= 32) {
        softmax_rows<T, 8><<<grid, threads, 0, s>>>(a);
        break;
      }
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

extern "C" {

// dtype (x's and out's): 0 = float32, 1 = bfloat16. The exp table's and the
// reciprocal table's rows are fp32 on the device. masked = 0 ignores
// q_offset, Sq, causal and window (window <= 0: no window). chunks,
// warps_per_row and rows_per_block are softmax_plan's (chunks 0: a block a
// row, streamed); vec asks for 16-byte loads and stores (x and out 16-byte
// aligned, S a multiple of 16 bytes of elements). Returns a CUDA error code
// (0 on success).
int softmax_lut(const void* x, void* out, const float* exp_wb, const float* recip_wb,
                long long n_rows, int S, float e_lo, float e_inv, int e_sec, float r_lo,
                float r_inv, int r_sec, int masked, int q_offset, int Sq, int causal,
                int window, int chunks, int warps_per_row, int rows_per_block, int vec,
                int dtype, void* stream) {
  if (n_rows <= 0 || S <= 0) return 0;
  if (exp_wb == nullptr || recip_wb == nullptr || e_sec + 2 > lut::kMaxTableRows ||
      r_sec + 2 > lut::kMaxTableRows || (masked && Sq <= 0) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int elem = dtype == 0 ? 4 : 2;
  const int wshift = warps_per_row == 1 ? 0 : warps_per_row == 2 ? 1 : warps_per_row == 4 ? 2
                     : warps_per_row == 8 ? 3 : -1;
  if (wshift < 0 ||
      (vec && (!common::aligned16(x) || !common::aligned16(out) || (S * elem) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const Args a{x, out, n_rows, S, exp_wb, e_lo, e_inv, e_sec, recip_wb, r_lo, r_inv, r_sec,
               masked, q_offset, Sq, causal, window, wshift, rows_per_block, vec};
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = dtype == 0 ? launch<float>(a, chunks, s) : launch<__nv_bfloat16>(a, chunks, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

const char* softmax_lut_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
