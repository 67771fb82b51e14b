// Decode attention over a dense per-slot KV arena: one new query token per
// sequence against its cached keys.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (Pallas body _decode_attn_kernel).
//
// q (B, H, D), k and v (B, Hkv, S, D) of q's dtype (float32 or bf16),
// lengths (B,) int32 -> out (B, H, D) in q's dtype. GQA: the g = H / Hkv
// query heads of kv head h are rows h*g .. h*g + g - 1 and share one K/V
// stream. Key position p is valid when p < min(length, S) and, with a
// window, p >= length - window. Optional softcap and LUT exp.
//
// The TPU kernel's sequential grid axis over 256-key blocks becomes a loop
// inside one block for each (b, kv head), with the same online softmax,
// block by block, in the same algebra:
//
//   scores = (q . k) * scale [-> softcap * tanh(scores / softcap)]
//   masked scores = -1e30; m_new = max(m_prev, max(scores))
//   p = exp(scores - m_new), corr = exp(m_prev - m_new)           exact
//   p = LUT(scores - m_new), corr = LUT(max(m_prev - m_new, lo))   LUT
//   p = 0 outside the mask; l = l * corr + sum(p); acc = acc * corr + p . v
//   out = acc / max(l, 1e-9)
//
// Unlike the TPU kernel, S need not be a multiple of the block: the last
// block is cut at S. Blocks that hold no valid key (wholly past the length
// or wholly before the window) are skipped; in them the TPU kernel's l and
// acc only scale by corr = 1 (LUT(0) = 1 in LUT mode), so skipping them
// changes nothing. Keys outside the mask are never read.
//
// What bounds it on the H100: each step reads every valid K and V vector
// once for 4 flops an element, so the bytes of the valid keys over HBM.
// The design: per block of keys, (1) tpk threads share each key's dot
// product (tpk = the 16-byte vectors of a row, 8 for bf16 at D = 64, so
// one warp reads four whole rows, coalesced), reduced with shuffles;
// (2) one warp per query row runs the softmax statistics; (3) each thread
// sums p . v over a slice of the keys for one 16-byte column vector, and
// the slices are added in shared memory. GPT-2 has g = 1, so 4 x 16 = 64
// blocks at 4 slots: the kernel is latency-bound, not bandwidth-bound, and
// its three passes per block of keys run one after another.
#include "common.cuh"
#include "lut.cuh"

namespace {

using common::from_f;
using common::to_f;

constexpr int kThreads = 256;
constexpr int kBlockS = 256;          // keys a step: the TPU kernel's block_s
constexpr float kNegInf = -1e30f;
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemMax = 227 * 1024;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  const float* exp_wb;   // (sections + 2, 2) or null
  void* out;
  int H;
  int hkv;
  int S;
  int d;
  float scale;
  float softcap;         // <= 0: off
  int window;            // <= 0: off
  int use_lut;
  float lo;
  float inv_step;
  int sections;
};

// Elements a column unit holds: one 16-byte vector, or one element.
template <typename T, bool kVec>
__host__ __device__ constexpr int unit() { return kVec ? common::Vec<T>::N : 1; }

__host__ __device__ inline int next_pow2(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// Shared memory, in 4-byte words: q, acc (g * D each), sc (g * kBlockS),
// m, l, corr (g each), the exp table, and the p . v slice partials.
__host__ __device__ inline int slices_for(int cols) {
  return cols >= kThreads ? 1 : kThreads / cols;
}

__host__ __device__ inline int smem_words(int g, int d, int cols) {
  return 2 * g * d + g * kBlockS + 3 * g + 2 * lut::kMaxTableRows + slices_for(cols) * d;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(Args a) {
  extern __shared__ float smem[];
  constexpr int N = unit<T, kVec>();
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int n_warps = blockDim.x / 32;
  const int D = a.d;
  const int g = a.H / a.hkv;
  const int cols = D / N;                      // column units of a row
  const int tpk = min(32, next_pow2(cols));    // threads per key dot product
  const int slices = slices_for(cols);

  float* q_s = smem;
  float* acc = q_s + g * D;
  float* sc = acc + g * D;
  float* m = sc + g * kBlockS;
  float* l = m + g;
  float* corr = l + g;
  float* wb = corr + g;
  float* red = wb + 2 * lut::kMaxTableRows;

  const T* qb = reinterpret_cast<const T*>(a.q) + ((size_t)b * a.H + (size_t)h * g) * D;
  const size_t kv_off = ((size_t)b * a.hkv + h) * a.S * D;
  const T* kb = reinterpret_cast<const T*>(a.k) + kv_off;
  const T* vb = reinterpret_cast<const T*>(a.v) + kv_off;

  for (int i = tid; i < g * D; i += blockDim.x) {
    q_s[i] = to_f(qb[i]);
    acc[i] = 0.0f;
  }
  for (int r = tid; r < g; r += blockDim.x) {
    m[r] = kNegInf;
    l[r] = 0.0f;
  }
  if (a.use_lut) lut::stage(wb, a.exp_wb, a.sections);
  __syncthreads();

  const int length = a.lengths[b];
  const int k_hi = max(0, min(length, a.S));                 // valid keys: [k_lo, k_hi)
  const int k_lo = a.window > 0 ? max(0, length - a.window) : 0;

  for (int s0 = (k_lo / kBlockS) * kBlockS; s0 < k_hi; s0 += kBlockS) {
    const int j_lo = max(k_lo - s0, 0);
    const int j_hi = min(k_hi - s0, kBlockS);
    // (1) Scores of every (row, key) pair of the block. The loop bounds are
    // the same for every thread, so whole warps reach the shuffles.
    for (int r = 0; r < g; ++r) {
      const float* qr = q_s + r * D;
      for (int t0 = 0; t0 < kBlockS * tpk; t0 += blockDim.x) {
        const int t = t0 + tid;
        const int j = t / tpk;
        const int sub = t % tpk;
        const bool valid = j >= j_lo && j < j_hi;
        float dot = 0.0f;
        if (valid) {
          const T* kr = kb + (size_t)(s0 + j) * D;
          for (int c = sub; c < cols; c += tpk) {
            if constexpr (kVec) {
              float f[N];
              common::Vec<T>::load(kr + c * N, f);
#pragma unroll
              for (int n = 0; n < N; ++n) dot = fmaf(qr[c * N + n], f[n], dot);
            } else {
              dot = fmaf(qr[c], to_f(kr[c]), dot);
            }
          }
        }
        for (int off = tpk / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (sub == 0) {
          float s = dot * a.scale;
          if (a.softcap > 0.0f) s = a.softcap * tanhf(s / a.softcap);
          sc[r * kBlockS + j] = valid ? s : kNegInf;
        }
      }
    }
    __syncthreads();
    // (2) Online-softmax statistics, one warp per row.
    for (int r = warp; r < g; r += n_warps) {
      float* scr = sc + r * kBlockS;
      const float m_prev = m[r];
      float m_cur = kNegInf;
      for (int j = lane; j < kBlockS; j += 32) m_cur = fmaxf(m_cur, scr[j]);
      const float m_new = fmaxf(m_prev, warp_max(m_cur));
      const float c = a.use_lut
          ? lut::eval(fmaxf(m_prev - m_new, a.lo), wb, a.lo, a.inv_step, a.sections)
          : expf(m_prev - m_new);
      float lsum = 0.0f;
      for (int j = lane; j < kBlockS; j += 32) {
        float p = 0.0f;
        if (j >= j_lo && j < j_hi)
          p = a.use_lut ? lut::eval(scr[j] - m_new, wb, a.lo, a.inv_step, a.sections)
                        : expf(scr[j] - m_new);
        scr[j] = p;
        lsum += p;
      }
      lsum = warp_sum(lsum);
      if (lane == 0) {
        l[r] = l[r] * c + lsum;
        m[r] = m_new;
        corr[r] = c;
      }
    }
    __syncthreads();
    // (3) acc = acc * corr + p . V over the block's valid keys: thread
    // (slice sl, column unit cu) sums keys j_lo + sl, j_lo + sl + slices, ...
    for (int r = 0; r < g; ++r) {
      const float* pr = sc + r * kBlockS;
      for (int t = tid; t < slices * cols; t += blockDim.x) {
        const int cu = t % cols;
        const int sl = t / cols;
        float part[N];
#pragma unroll
        for (int n = 0; n < N; ++n) part[n] = 0.0f;
        for (int j = j_lo + sl; j < j_hi; j += slices) {
          const float p = pr[j];
          const T* vr = vb + (size_t)(s0 + j) * D + cu * N;
          if constexpr (kVec) {
            float f[N];
            common::Vec<T>::load(vr, f);
#pragma unroll
            for (int n = 0; n < N; ++n) part[n] = fmaf(p, f[n], part[n]);
          } else {
            part[0] = fmaf(p, to_f(*vr), part[0]);
          }
        }
#pragma unroll
        for (int n = 0; n < N; ++n) red[sl * D + cu * N + n] = part[n];
      }
      __syncthreads();
      for (int i = tid; i < D; i += blockDim.x) {
        float s = 0.0f;
        for (int sl = 0; sl < slices; ++sl) s += red[sl * D + i];
        acc[r * D + i] = acc[r * D + i] * corr[r] + s;
      }
      __syncthreads();
    }
  }

  T* ob = reinterpret_cast<T*>(a.out) + ((size_t)b * a.H + (size_t)h * g) * D;
  for (int i = tid; i < g * D; i += blockDim.x)
    ob[i] = from_f<T>(acc[i] / fmaxf(l[i / D], 1e-9f));
}

template <typename T, bool kVec>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int g = a.H / a.hkv;
  const int smem = 4 * smem_words(g, a.d, a.d / unit<T, kVec>());
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > kSmemDefault) {
    cudaError_t e = cudaFuncSetAttribute(decode_attention_kernel<T, kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, a.hkv);
  decode_attention_kernel<T, kVec><<<grid, kThreads, smem, stream>>>(a);
  return 0;
}

template <typename T>
int dispatch(const Args& a, int B, cudaStream_t stream) {
  const bool vec = (a.d * sizeof(T)) % 16 == 0 && common::aligned16(a.k) &&
                   common::aligned16(a.v);
  return vec ? launch<T, true>(a, B, stream) : launch<T, false>(a, B, stream);
}

}  // namespace

extern "C" {

// dtype (q's, k's and v's): 0 = float32, 1 = bfloat16. softcap <= 0 and
// window <= 0 turn those masks off; exp_wb may be null when use_lut is 0.
// Returns a CUDA error code (0 on success).
int decode_attention(const void* q, const void* k, const void* v, const int* lengths,
                     const float* exp_wb, void* out, int B, int H, int Hkv, int S, int D,
                     float scale, float softcap, int window, int use_lut, float lo,
                     float inv_step, int sections, int dtype, void* stream) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || D <= 0 || S < 0 ||
      (use_lut && (exp_wb == nullptr || sections + 2 > lut::kMaxTableRows)))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, lengths, exp_wb, out, H, Hkv, S, D, scale, softcap, window, use_lut, lo,
         inv_step, sections};
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (dtype == 0) rc = dispatch<float>(a, B, s);
  else if (dtype == 1) rc = dispatch<__nv_bfloat16>(a, B, s);
  else return (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
