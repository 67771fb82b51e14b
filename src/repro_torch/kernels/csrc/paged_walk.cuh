// The block-table page walk of the paged prefill (paged_prefill.cu); its
// pool formats, their row readers (Row) and the dispatch also serve the
// decode walk (decode_walk.cuh: the single walk, the KV split and the
// dense arena).
//
// One thread block owns `rows` query rows of one (sequence b, kv head h),
// a block of the Sq * g rows of a prefill chunk. It walks the sequence's
// block table itself (Hopper has no scalar prefetch) over the logical
// pages [page_lo, page_hi) it is given. It stages a chunk of up to
// kMaxChunkPages pages of K and V in shared memory (dequantized in fp32
// as the plain versions do, then held as fp64: each value is converted
// once, not at each of its uses), and then runs
// the TPU kernels' online softmax page by page, in the same order and with
// the same algebra:
//
//   scores = (q . k) * scale [-> softcap * tanh(scores / softcap)]
//   masked scores = NEG_INF (-1e30); m_new = max(m_prev, max(scores))
//   p = exp(scores - m_new), corr = exp(m_prev - m_new)         exact
//   p = LUT(scores - m_new), corr = LUT(max(m_prev - m_new, lo)) LUT
//   p = 0 outside the mask; l = l * corr + sum(p); acc = acc * corr + p . v
//
// and the caller writes acc / max(l, 1e-9), rounded to fp32 and then to
// q's dtype. A key position k is valid for the row with absolute query
// position qpos when k < length, k <= qpos and, with a window, k >
// qpos - window. Pages past the last valid key of the block are not read.
// Physical page ids outside the pool read the trash page 0.
//
// Every sum, the scores, the statistics and acc are fp64 (q, K and V,
// fp32 values, are exact in it, and so is each product); a LUT is evaluated
// in fp32, as core/lut.py's table, on its fp64 argument rounded to fp32.
// The output is then within a few fp64 ulps of the exact one whatever the
// order of the sums, so it rounds to the bits of the plain version
// (`paged_prefill_attention_plain`, fp64 too) but where the exact output
// lies within those ulps of a rounding boundary: bit for bit in practice.
// An fp32 walk's last bits move 1e-4 of its bf16 outputs, and a quantized
// datapath (int8 activations) turns each moved bit into moved int8 codes:
// a 28-layer model's first logits then drift from the plain path's by
// 5.7e-2 (qwen2-1.5B, q1, scripts/logit_drift.py), past their gate.
//
// Pool formats (template parameter Pool of the staging copy), each
// widened to fp32 as it is staged, as `_dequant_page` does after its DMA
// (and stored as fp64 by the prefill walk):
//   FpPool<T>    pages of the model dtype T (float or bf16), D values a row;
//   Int8Pool<S>  int8 payload, D bytes a row, times the row's scale (S =
//                float or bf16, read in its storage dtype);
//   Int4Pool<S>  nibble-packed int4 payload, D/2 bytes a row: byte i holds
//                element i in its low nibble and element i + D/2 in its
//                high nibble, sign-extended in int arithmetic, times the
//                row's scale.
//
// The walk is latency-bound at the engine's sizes (8 rows a prefill
// block), so it takes a chunk of up to kMaxChunkPages pages (as many as
// kWalkSmem holds) at a time, each step of the page walk a pass over the
// whole chunk by the whole block, a barrier between passes: the staging
// copy (kLoadIlp 16-byte loads of K and of V in flight before it stores
// any), every (row, key) score (a dot product split over a group of up to
// 32 threads when there are few, four partial sums each), each page's
// maximum of a row, the running maximum and corr of a row page by page,
// every p, each page's sum of p of a row, and acc (and l) page by page,
// each output's p . V in four partial sums. So a chunk of 8 pages takes 8
// barriers where a walk page by page takes 26.
#pragma once

#include "common.cuh"
#include "lut.cuh"

namespace paged {

using common::from_f;
using common::to_f;

constexpr float kNegInf = -1e30f;
constexpr double kNegInfD = -1e30;
constexpr int kThreads = 256;
constexpr int kMaxTableRows = lut::kMaxTableRows;
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemMax = 227 * 1024;
constexpr int kMaxChunkPages = 8;
constexpr int kWalkSmem = 226 * 1024;
constexpr int kLoadIlp = 4;

struct Args {
  const void* k_pages;      // (P, Hkv, page, D); D/2 bytes a row for packed int4
  const void* v_pages;
  const void* k_scales;     // (P, Hkv, page) scale rows, or null for fp pools
  const void* v_scales;
  const int* block_tables;  // (B, n_table)
  const int* lengths;       // (B,)
  const float* exp_wb;      // (sections + 2, 2) or null
  int n_pool;               // P
  int n_table;
  int hkv;
  int page;
  int d;
  float scale;
  float softcap;            // <= 0: off
  int window;               // <= 0: off
  int use_lut;
  float lo;
  float inv_step;
  int sections;
  int chunk_pages;
  int vec;                  // 1: payload rows are whole 16-byte vectors, pools aligned
};

// Shared-memory layout: the fp64 state first (8-byte aligned), then the
// fp32 staging, then ints. K rows are padded to D + 1 so that the per-key
// dot products of neighbouring threads hit distinct banks.
struct Smem {
  double* acc;   // rows * D
  double* q;     // rows * D
  double* m;     // rows
  double* l;     // rows
  double* corr;  // rows * kMaxChunkPages: each page's corr
  double* pm;    // rows * kMaxChunkPages: each page's maximum, then m_new
  double* ps;    // rows * kMaxChunkPages: each page's sum of p
  double* sc;    // rows * chunk * page: scores, then p
  double* k;     // chunk * page * (D + 1)
  double* v;     // chunk * page * D
  float* wb;     // 2 * kMaxTableRows
  int* qpos;     // rows
  int* tbl;      // kMaxChunkPages
};

__host__ __device__ inline int fixed_bytes(int rows, int d) {
  return 8 * (2 * rows * d + 2 * rows + 3 * rows * kMaxChunkPages) +
         4 * (2 * kMaxTableRows + rows + kMaxChunkPages);
}

__host__ __device__ inline int page_bytes(int rows, int d, int page) {
  return 8 * (rows * page + page * (d + 1) + page * d);
}

__host__ __device__ inline int smem_bytes(int rows, int d, int page, int chunk) {
  return fixed_bytes(rows, d) + chunk * page_bytes(rows, d, page);
}

// Largest page chunk within kWalkSmem (at least 1 page, at most
// kMaxChunkPages); 0 when even one page exceeds the SM's limit.
inline int pick_chunk(int rows, int d, int page) {
  const int fixed = fixed_bytes(rows, d);
  const int per = page_bytes(rows, d, page);
  if (fixed + per > kSmemMax) return 0;
  int ch = (kWalkSmem - fixed) / per;
  if (ch < 1) ch = 1;
  if (ch > kMaxChunkPages) ch = kMaxChunkPages;
  return ch;
}

// ---------------------------------------------------------------------------
// Pool formats. Each names its payload element P, the payload elements of
// one K/V row, and how a 16-byte vector or one payload element of a row
// lands in fp32 staging at row column c.
// ---------------------------------------------------------------------------

template <typename T>
struct FpPool {
  using P = T;
  static constexpr bool kScaled = false;
  __host__ __device__ static int row_payload(int d) { return d; }
  __device__ __forceinline__ static float scale(const void*, size_t) { return 1.0f; }
  template <typename O>
  __device__ __forceinline__ static void put16(const uint4& raw, float, O* row, int c, int) {
    float f[common::Vec<T>::N];
    common::Vec<T>::widen(raw, f);
#pragma unroll
    for (int n = 0; n < common::Vec<T>::N; ++n) row[c + n] = f[n];
  }
  template <typename O>
  __device__ __forceinline__ static void put1(P x, float, O* row, int c, int) {
    row[c] = to_f(x);
  }
};

template <typename S>
struct Int8Pool {
  using P = int8_t;
  static constexpr bool kScaled = true;
  __host__ __device__ static int row_payload(int d) { return d; }
  __device__ __forceinline__ static float scale(const void* sc, size_t i) {
    return to_f(reinterpret_cast<const S*>(sc)[i]);
  }
  template <typename O>
  __device__ __forceinline__ static void put16(const uint4& raw, float sc, O* row, int c, int) {
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int n = 0; n < 16; ++n) row[c + n] = (float)b[n] * sc;
  }
  template <typename O>
  __device__ __forceinline__ static void put1(P x, float sc, O* row, int c, int) {
    row[c] = (float)x * sc;
  }
};

template <typename S>
struct Int4Pool {
  using P = int8_t;
  static constexpr bool kScaled = true;
  __host__ __device__ static int row_payload(int d) { return d / 2; }
  __device__ __forceinline__ static float scale(const void* sc, size_t i) {
    return to_f(reinterpret_cast<const S*>(sc)[i]);
  }
  // Low nibble: element c, sign-extended as ((x & 0xF) ^ 8) - 8; high
  // nibble: element c + D/2, sign-extended by the arithmetic shift x >> 4.
  __device__ __forceinline__ static float lo4(int v) { return (float)(((v & 0xF) ^ 8) - 8); }
  __device__ __forceinline__ static float hi4(int v) { return (float)(v >> 4); }
  template <typename O>
  __device__ __forceinline__ static void put1(P x, float sc, O* row, int c, int d) {
    row[c] = lo4(x) * sc;
    row[c + d / 2] = hi4(x) * sc;
  }
  template <typename O>
  __device__ __forceinline__ static void put16(const uint4& raw, float sc, O* row, int c, int d) {
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int n = 0; n < 16; ++n) put1(b[n], sc, row, c + n, d);
  }
};

// A K/V row in the pool's storage type, unscaled, for the kernels that
// stage pages as stored (decode_walk.cuh, paged_prefill.cu's tensor-core
// kernel): bytes and elems, the row's payload bytes and elements; at,
// element dd (0..D-1) of the row. The decode walk's scores read a row in
// units: kUnit bytes a unit when vec_units (16-byte vectors of rows staged
// by cp.async), else one payload element; dotu is q . unit u and acc1 adds
// q . payload element e to acc; val is element dd times the row's scale sc
// (dotu and acc1 leave the scale to the caller: kInline is false).
template <class Pool> struct Row;

template <typename T>
struct Row<FpPool<T>> {
  static constexpr int kUnit = 16;
  static constexpr bool kInline = false;
  __host__ __device__ static int bytes(int d) { return d * (int)sizeof(T); }
  __device__ static int elems(int d) { return d; }
  __device__ static bool vec_units(int, int vec) { return vec != 0; }
  __device__ __forceinline__ static float dotu(const uint8_t* p, const float* q, int u, int,
                                               float) {
    constexpr int N = common::Vec<T>::N;
    float f[N];
    common::Vec<T>::widen(common::ld16(p), f);
    const float* qq = q + u * N;
    float s = 0.0f;
#pragma unroll
    for (int n = 0; n < N; ++n) s = fmaf(qq[n], f[n], s);
    return s;
  }
  __device__ __forceinline__ static float acc1(const uint8_t* row, const float* q, int e, int,
                                               float acc, float) {
    return fmaf(q[e], to_f(reinterpret_cast<const T*>(row)[e]), acc);
  }
  __device__ __forceinline__ static float at(const uint8_t* row, int dd, int) {
    return to_f(reinterpret_cast<const T*>(row)[dd]);
  }
  __device__ __forceinline__ static float val(const uint8_t* row, int dd, int d, float sc) {
    return at(row, dd, d) * sc;
  }
};

template <typename S>
struct Row<Int8Pool<S>> {
  static constexpr int kUnit = 16;
  static constexpr bool kInline = false;
  __host__ __device__ static int bytes(int d) { return d; }
  __device__ static int elems(int d) { return d; }
  __device__ static bool vec_units(int, int vec) { return vec != 0; }
  __device__ __forceinline__ static float dotu(const uint8_t* p, const float* q, int u, int,
                                               float) {
    const uint4 raw = common::ld16(p);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
    const float* qq = q + 16 * u;
    float s = 0.0f;
#pragma unroll
    for (int n = 0; n < 16; ++n) s = fmaf(qq[n], (float)b[n], s);
    return s;
  }
  __device__ __forceinline__ static float acc1(const uint8_t* row, const float* q, int e, int,
                                               float acc, float) {
    return fmaf(q[e], (float)reinterpret_cast<const int8_t*>(row)[e], acc);
  }
  __device__ __forceinline__ static float at(const uint8_t* row, int dd, int) {
    return (float)reinterpret_cast<const int8_t*>(row)[dd];
  }
  __device__ __forceinline__ static float val(const uint8_t* row, int dd, int d, float sc) {
    return at(row, dd, d) * sc;
  }
};

// Byte i holds element i in its low nibble and element i + D/2 in its high
// nibble (Int4Pool's lo4 and hi4).
template <typename S>
struct Row<Int4Pool<S>> {
  using F = Int4Pool<S>;
  static constexpr int kUnit = 16;
  static constexpr bool kInline = false;
  __host__ __device__ static int bytes(int d) { return d / 2; }
  __device__ static int elems(int d) { return d / 2; }
  __device__ static bool vec_units(int, int vec) { return vec != 0; }
  __device__ __forceinline__ static float dotu(const uint8_t* p, const float* q, int u, int d,
                                               float) {
    const uint4 raw = common::ld16(p);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
    const float* qq = q + 16 * u;
    float s = 0.0f;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      s = fmaf(qq[n], F::lo4(b[n]), s);
      s = fmaf(qq[n + d / 2], F::hi4(b[n]), s);
    }
    return s;
  }
  __device__ __forceinline__ static float acc1(const uint8_t* row, const float* q, int e, int d,
                                               float acc, float) {
    const int v = reinterpret_cast<const int8_t*>(row)[e];
    return fmaf(q[e + d / 2], F::hi4(v), fmaf(q[e], F::lo4(v), acc));
  }
  __device__ __forceinline__ static float at(const uint8_t* row, int dd, int d) {
    const int h = d / 2;
    const int v = reinterpret_cast<const int8_t*>(row)[dd < h ? dd : dd - h];
    return dd < h ? F::lo4(v) : F::hi4(v);
  }
  __device__ __forceinline__ static float val(const uint8_t* row, int dd, int d, float sc) {
    return at(row, dd, d) * sc;
  }
};

// 1 when every payload row starts on a 16-byte boundary of an aligned pool.
template <class Pool>
inline int use_vec(const void* k_pages, const void* v_pages, int d) {
  return (Pool::row_payload(d) * sizeof(typename Pool::P)) % 16 == 0 &&
         common::aligned16(k_pages) && common::aligned16(v_pages);
}

// Pool format codes of the C entries: 0 = pools of q's dtype, 1 = int8
// with f32 scale rows, 2 = int8 with bf16 scale rows, 3 = int4 (packed)
// with bf16 scale rows. q's dtype codes: 0 = float32, 1 = bfloat16.
// Calls f(T{}, Pool{}) with q's element type T and the pool format.
template <typename T, typename F>
int with_pool(int fmt, F&& f) {
  switch (fmt) {
    case 0: return f(T{}, FpPool<T>{});
    case 1: return f(T{}, Int8Pool<float>{});
    case 2: return f(T{}, Int8Pool<__nv_bfloat16>{});
    case 3: return f(T{}, Int4Pool<__nv_bfloat16>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename F>
int dispatch(int dtype, int fmt, F&& f) {
  if (dtype == 0) return with_pool<float>(fmt, f);
  if (dtype == 1) return with_pool<__nv_bfloat16>(fmt, f);
  return (int)cudaErrorInvalidValue;
}

__device__ inline Smem carve(double* base, int rows, int d, int page, int chunk) {
  Smem s;
  double* pd = base;
  s.acc = pd; pd += rows * d;
  s.q = pd; pd += rows * d;
  s.m = pd; pd += rows;
  s.l = pd; pd += rows;
  s.corr = pd; pd += rows * kMaxChunkPages;
  s.pm = pd; pd += rows * kMaxChunkPages;
  s.ps = pd; pd += rows * kMaxChunkPages;
  s.sc = pd; pd += rows * chunk * page;
  s.k = pd; pd += chunk * page * (d + 1);
  s.v = pd; pd += chunk * page * d;
  float* p = reinterpret_cast<float*>(pd);
  s.wb = p; p += 2 * kMaxTableRows;
  s.qpos = reinterpret_cast<int*>(p); p += rows;
  s.tbl = reinterpret_cast<int*>(p);
  return s;
}

__device__ __forceinline__ bool key_valid(int kpos, int qpos, int length, int window) {
  return kpos < length && kpos <= qpos && (window <= 0 || kpos > qpos - window);
}

// Copy `nch` pages of this block's kv head, whose physical ids are in
// s.tbl, into s.k (padded rows) and s.v, dequantized in fp32 with their
// scale rows when the pool is quantized, held as fp64.
template <class Pool>
__device__ void stage_pages(const Args& a, const Smem& s, int h, int nch) {
  using P = typename Pool::P;
  const P* kp = reinterpret_cast<const P*>(a.k_pages);
  const P* vp = reinterpret_cast<const P*>(a.v_pages);
  const int D = a.d;
  const int rp = Pool::row_payload(D);          // payload elements a K/V row
  const int page_elems = a.page * rp;
  if (a.vec) {
    constexpr int N = 16 / sizeof(P);
    const int nvec = nch * page_elems / N;
    for (int base = threadIdx.x; base < nvec; base += kLoadIlp * blockDim.x) {
      uint4 kr[kLoadIlp], vr[kLoadIlp];
      float ks[kLoadIlp], vs[kLoadIlp];
#pragma unroll
      for (int u = 0; u < kLoadIlp; ++u) {
        const int e = (base + u * blockDim.x) * N;
        ks[u] = vs[u] = 1.0f;
        if (e < nvec * N) {
          const int i = e / page_elems;
          const size_t pg = (size_t)s.tbl[i] * a.hkv + h;
          const int off = e - i * page_elems;
          kr[u] = common::ld16(kp + pg * page_elems + off);
          vr[u] = common::ld16(vp + pg * page_elems + off);
          if constexpr (Pool::kScaled) {
            ks[u] = Pool::scale(a.k_scales, pg * a.page + off / rp);
            vs[u] = Pool::scale(a.v_scales, pg * a.page + off / rp);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kLoadIlp; ++u) {
        const int e = (base + u * blockDim.x) * N;
        if (e < nvec * N) {
          const int row = e / rp;                     // i * page + j
          const int c = e - row * rp;
          Pool::put16(kr[u], ks[u], s.k + row * (D + 1), c, D);
          Pool::put16(vr[u], vs[u], s.v + row * D, c, D);
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < nch * page_elems; e += blockDim.x) {
      const int i = e / page_elems;
      const size_t pg = (size_t)s.tbl[i] * a.hkv + h;
      const int off = e - i * page_elems;
      const int row = e / rp;
      const int c = e - row * rp;
      float ks = 1.0f, vs = 1.0f;
      if constexpr (Pool::kScaled) {
        ks = Pool::scale(a.k_scales, pg * a.page + off / rp);
        vs = Pool::scale(a.v_scales, pg * a.page + off / rp);
      }
      Pool::put1(kp[pg * page_elems + off], ks, s.k + row * (D + 1), c, D);
      Pool::put1(vp[pg * page_elems + off], vs, s.v + row * D, c, D);
    }
  }
}

// sum over i = first, first + step, ... < n of a[i] * b[i * stride] in
// fp64, in four independent partial sums so that the shared-memory loads
// overlap.
__device__ __forceinline__ double strided_dot(const double* a, const double* b, int first,
                                              int step, int n, int stride) {
  double d0 = 0.0, d1 = 0.0, d2 = 0.0, d3 = 0.0;
  int i = first;
  for (; i + 3 * step < n; i += 4 * step) {
    d0 = fma(a[i], b[i * stride], d0);
    d1 = fma(a[i + step], b[(i + step) * stride], d1);
    d2 = fma(a[i + 2 * step], b[(i + 2 * step) * stride], d2);
    d3 = fma(a[i + 3 * step], b[(i + 3 * step) * stride], d3);
  }
  for (; i < n; i += step) d0 = fma(a[i], b[i * stride], d0);
  return (d0 + d1) + (d2 + d3);
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

// The exp table at an fp64 argument: core/lut.py's fp32 evaluation of it
// rounded to fp32.
__device__ __forceinline__ double lut_exp(const Args& a, const float* wb, double x) {
  return (double)lut::eval((float)x, wb, a.lo, a.inv_step, a.sections);
}

// Before the call the block has filled s.q (rows x D, fp32 values), s.qpos, and
// s.wb (when use_lut), and synchronised. After it, s.m, s.l and s.acc hold
// the running max, the softmax denominator and the unnormalised output of
// every row over the logical pages [page_lo, page_hi) of the table, fp64.
template <class Pool>
__device__ void walk(const Args& a, const Smem& s, int b, int h, int rows,
                     int page_lo, int page_hi) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int D = a.d;
  const int page = a.page;
  const int cp = a.chunk_pages;
  const int length = a.lengths[b];
  const double scale = a.scale, cap = a.softcap;

  for (int i = tid; i < rows; i += nt) {
    s.m[i] = kNegInfD;
    s.l[i] = 0.0;
  }
  for (int i = tid; i < rows * D; i += nt) s.acc[i] = 0.0;

  // Keys past the block's last query position are masked for every row.
  int max_q = -1;
  for (int r = 0; r < rows; ++r) max_q = max(max_q, s.qpos[r]);
  const int kv_end = min(length, max_q + 1);
  int n_pages = kv_end > 0 ? (kv_end + page - 1) / page : 0;
  n_pages = min(n_pages, min(a.n_table, page_hi));
  __syncthreads();

  for (int p0 = page_lo; p0 < n_pages; p0 += cp) {
    const int nch = min(cp, n_pages - p0);
    const int keys = nch * page;
    const int base_pos = p0 * page;
    for (int i = tid; i < nch; i += nt) {
      int phys = a.block_tables[(size_t)b * a.n_table + p0 + i];
      s.tbl[i] = (phys >= 0 && phys < a.n_pool) ? phys : 0;
    }
    __syncthreads();
    stage_pages<Pool>(a, s, h, nch);
    __syncthreads();

    // Scores of every (row, key) pair of the chunk: tpk threads (a power
    // of two, at most a warp) a dot product, as many as keep the block
    // busy. The loop bound is the same for every thread, so whole warps
    // reach the shuffles.
    const int n_pairs = rows * keys;
    int tpk = 1;
    while (tpk < 32 && 2 * tpk * n_pairs <= nt) tpk *= 2;
    for (int t0 = 0; t0 < n_pairs * tpk; t0 += nt) {
      const int t = t0 + tid;
      const int pair = t / tpk;
      const int sub = t % tpk;
      double dot = 0.0;
      if (pair < n_pairs) {
        const int r = pair / keys;
        dot = strided_dot(s.q + r * D, s.k + (pair - r * keys) * (D + 1), sub, tpk, D, 1);
      }
      for (int off = tpk / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (pair < n_pairs && sub == 0) {
        const int r = pair / keys;
        const int kk = pair - r * keys;
        double sc = dot * scale;
        if (cap > 0.0) sc = cap * tanh(sc / cap);
        s.sc[r * cp * page + kk] =
            key_valid(base_pos + kk, s.qpos[r], length, a.window) ? sc : kNegInfD;
      }
    }
    __syncthreads();
    // Each page's maximum of each row. Page i starts at its key i % page,
    // so that neighbouring threads read distinct banks.
    for (int t = tid; t < rows * nch; t += nt) {
      const int r = t / nch, i = t - r * nch;
      const double* sp = s.sc + r * cp * page + i * page;
      double mx = kNegInfD;
      for (int j = 0, jj = i % page; j < page; ++j, jj = jj + 1 < page ? jj + 1 : 0)
        mx = fmax(mx, sp[jj]);
      s.pm[r * kMaxChunkPages + i] = mx;
    }
    __syncthreads();
    // The running maximum of each row page by page: m_new and corr.
    for (int r = tid; r < rows; r += nt) {
      double m = s.m[r];
      for (int i = 0; i < nch; ++i) {
        const double m_new = fmax(m, s.pm[r * kMaxChunkPages + i]);
        s.corr[r * kMaxChunkPages + i] =
            a.use_lut ? lut_exp(a, s.wb, fmax(m - m_new, (double)a.lo)) : exp(m - m_new);
        s.pm[r * kMaxChunkPages + i] = m_new;
        m = m_new;
      }
      s.m[r] = m;
    }
    __syncthreads();
    // p of every (row, key) pair, 0 outside the mask.
    for (int t = tid; t < rows * keys; t += nt) {
      const int r = t / keys, kk = t - r * keys;
      double* sp = s.sc + r * cp * page + kk;
      const double x = *sp - s.pm[r * kMaxChunkPages + kk / page];
      double p = a.use_lut ? lut_exp(a, s.wb, x) : exp(x);
      if (!key_valid(base_pos + kk, s.qpos[r], length, a.window)) p = 0.0;
      *sp = p;
    }
    __syncthreads();
    // Each page's sum of p of each row.
    for (int t = tid; t < rows * nch; t += nt) {
      const int r = t / nch, i = t - r * nch;
      const double* sp = s.sc + r * cp * page + i * page;
      double sum = 0.0;
      for (int j = 0, jj = i % page; j < page; ++j, jj = jj + 1 < page ? jj + 1 : 0)
        sum += sp[jj];
      s.ps[r * kMaxChunkPages + i] = sum;
    }
    __syncthreads();
    // l = l * corr + sum(p) and acc = acc * corr + p . V, page by page.
    for (int r = tid; r < rows; r += nt) {
      double l = s.l[r];
      for (int i = 0; i < nch; ++i)
        l = l * s.corr[r * kMaxChunkPages + i] + s.ps[r * kMaxChunkPages + i];
      s.l[r] = l;
    }
    for (int t = tid; t < rows * D; t += nt) {
      const int r = t / D;
      const int dd = t - r * D;
      const double* pr = s.sc + r * cp * page;
      double acc = s.acc[t];
      for (int i = 0; i < nch; ++i)
        acc = acc * s.corr[r * kMaxChunkPages + i] +
              strided_dot(pr + i * page, s.v + (i * page) * D + dd, 0, 1, page, D);
      s.acc[t] = acc;
    }
    __syncthreads();
  }
}

}  // namespace paged
