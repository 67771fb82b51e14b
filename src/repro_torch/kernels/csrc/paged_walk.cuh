// The block-table page walk of the CUDA-core (f32) paged prefill
// (paged_prefill.cu); its pool formats, their row readers (Row) and the
// dispatch also serve the decode walk (decode_walk.cuh: the single walk,
// the KV split and the dense arena) and the tensor-core prefill.
//
// One thread block owns `rows` query rows of one (sequence b, kv head h),
// a block of the Sq * g rows of a prefill chunk. It walks the sequence's
// block table itself (Hopper has no scalar prefetch) over the logical
// pages [page_lo, page_hi) it is given. It stages a chunk of up to kMaxChunkPages pages of K and V in shared
// memory as fp32, and then runs the TPU kernels' online softmax page by
// page, in the same order and with the same algebra:
//
//   scores = (q . k) * scale [-> softcap * tanh(scores / softcap)]
//   masked scores = NEG_INF (-1e30); m_new = max(m_prev, max(scores))
//   p = exp(scores - m_new), corr = exp(m_prev - m_new)         exact
//   p = LUT(scores - m_new), corr = LUT(max(m_prev - m_new, lo)) LUT
//   p = 0 outside the mask; l = l * corr + sum(p); acc = acc * corr + p . v
//
// and the caller writes acc / max(l, 1e-9). A key position k is valid for the row with
// absolute query position qpos when k < length, k <= qpos and, with a
// window, k > qpos - window. Pages past the last valid key of the block
// are not read. Physical page ids outside the pool read the trash page 0.
//
// Pool formats (template parameter Pool of the staging copy), each
// widened to fp32 as it is staged, as `_dequant_page` does after its DMA:
//   FpPool<T>    pages of the model dtype T (float or bf16), D values a row;
//   Int8Pool<S>  int8 payload, D bytes a row, times the row's scale (S =
//                float or bf16, read in its storage dtype);
//   Int4Pool<S>  nibble-packed int4 payload, D/2 bytes a row: byte i holds
//                element i in its low nibble and element i + D/2 in its
//                high nibble, sign-extended in int arithmetic, times the
//                row's scale.
//
// The walk is latency-bound at the engine's sizes (16 rows a prefill
// block), so each pass spreads its work over
// the whole block and keeps independent work in flight per thread: the
// staging copy issues kLoadIlp 16-byte loads of K and of V before it
// stores any, each (row, key) dot product is split over a group of up to
// 32 threads that reduce with shuffles and runs four partial sums, the
// p . V sums run four partial sums over the page's keys, and the softmax
// statistics of a row are one warp's work.
#pragma once

#include "common.cuh"
#include "lut.cuh"

namespace paged {

using common::from_f;
using common::to_f;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kMaxTableRows = lut::kMaxTableRows;
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemMax = 227 * 1024;
constexpr int kMaxChunkPages = 8;
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

// Shared-memory layout, all 4-byte words. K rows are padded to D + 1 so
// that the per-key dot products of neighbouring threads hit distinct banks.
struct Smem {
  float* q;      // rows * D
  float* acc;    // rows * D
  float* m;      // rows
  float* l;      // rows
  float* corr;   // rows
  int* qpos;     // rows
  float* sc;     // rows * page
  float* k;      // chunk * page * (D + 1)
  float* v;      // chunk * page * D
  int* tbl;      // chunk
  float* wb;     // 2 * kMaxTableRows
};

__host__ __device__ inline int fixed_words(int rows, int d, int page) {
  return 2 * rows * d + 4 * rows + rows * page + 2 * kMaxTableRows;
}

__host__ __device__ inline int page_words(int d, int page) {
  return page * (d + 1) + page * d + 1;
}

__host__ __device__ inline int smem_bytes(int rows, int d, int page, int chunk) {
  return 4 * (fixed_words(rows, d, page) + chunk * page_words(d, page));
}

// Largest page chunk that keeps the block within 48 KB (at least 1 page,
// at most kMaxChunkPages); 0 when even one page exceeds the SM's limit.
inline int pick_chunk(int rows, int d, int page) {
  const int fixed = 4 * fixed_words(rows, d, page);
  const int per = 4 * page_words(d, page);
  if (fixed + per > kSmemMax) return 0;
  int ch = (kSmemDefault - fixed) / per;
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
  __device__ __forceinline__ static void put16(const uint4& raw, float, float* row, int c, int) {
    float f[common::Vec<T>::N];
    common::Vec<T>::widen(raw, f);
#pragma unroll
    for (int n = 0; n < common::Vec<T>::N; ++n) row[c + n] = f[n];
  }
  __device__ __forceinline__ static void put1(P x, float, float* row, int c, int) {
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
  __device__ __forceinline__ static void put16(const uint4& raw, float sc, float* row, int c, int) {
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int n = 0; n < 16; ++n) row[c + n] = (float)b[n] * sc;
  }
  __device__ __forceinline__ static void put1(P x, float sc, float* row, int c, int) {
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
  __device__ __forceinline__ static void put1(P x, float sc, float* row, int c, int d) {
    row[c] = lo4(x) * sc;
    row[c + d / 2] = hi4(x) * sc;
  }
  __device__ __forceinline__ static void put16(const uint4& raw, float sc, float* row, int c, int d) {
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

__device__ inline Smem carve(float* base, int rows, int d, int page, int chunk) {
  Smem s;
  float* p = base;
  s.q = p; p += rows * d;
  s.acc = p; p += rows * d;
  s.m = p; p += rows;
  s.l = p; p += rows;
  s.corr = p; p += rows;
  s.qpos = reinterpret_cast<int*>(p); p += rows;
  s.sc = p; p += rows * page;
  s.wb = p; p += 2 * kMaxTableRows;
  s.k = p; p += chunk * page * (d + 1);
  s.v = p; p += chunk * page * d;
  s.tbl = reinterpret_cast<int*>(p);
  return s;
}

__device__ __forceinline__ bool key_valid(int kpos, int qpos, int length, int window) {
  return kpos < length && kpos <= qpos && (window <= 0 || kpos > qpos - window);
}

// Copy `nch` pages of this block's kv head, whose physical ids are in
// s.tbl, into s.k (padded rows) and s.v as fp32, dequantized with their
// scale rows when the pool is quantized.
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

// sum over i = first, first + step, ... < n of a[i] * b[i * stride], in
// four independent partial sums so that the shared-memory loads overlap.
__device__ __forceinline__ float strided_dot(const float* a, const float* b, int first,
                                             int step, int n, int stride) {
  float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, d3 = 0.0f;
  int i = first;
  for (; i + 3 * step < n; i += 4 * step) {
    d0 = fmaf(a[i], b[i * stride], d0);
    d1 = fmaf(a[i + step], b[(i + step) * stride], d1);
    d2 = fmaf(a[i + 2 * step], b[(i + 2 * step) * stride], d2);
    d3 = fmaf(a[i + 3 * step], b[(i + 3 * step) * stride], d3);
  }
  for (; i < n; i += step) d0 = fmaf(a[i], b[i * stride], d0);
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

// Before the call the block has filled s.q (rows x D, fp32), s.qpos, and
// s.wb (when use_lut), and synchronised. After it, s.m, s.l and s.acc hold
// the running max, the softmax denominator and the unnormalised output of
// every row over the logical pages [page_lo, page_hi) of the table.
template <class Pool>
__device__ void walk(const Args& a, const Smem& s, int b, int h, int rows,
                     int page_lo, int page_hi) {
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int n_warps = blockDim.x / 32;
  const int D = a.d;
  const int page = a.page;
  const int length = a.lengths[b];

  for (int i = tid; i < rows; i += blockDim.x) {
    s.m[i] = kNegInf;
    s.l[i] = 0.0f;
  }
  for (int i = tid; i < rows * D; i += blockDim.x) s.acc[i] = 0.0f;

  // Keys past the block's last query position are masked for every row.
  int max_q = -1;
  for (int r = 0; r < rows; ++r) max_q = max(max_q, s.qpos[r]);
  const int kv_end = min(length, max_q + 1);
  int n_pages = kv_end > 0 ? (kv_end + page - 1) / page : 0;
  n_pages = min(n_pages, min(a.n_table, page_hi));

  // tpk threads (a power of two, at most a warp) share one (row, key) dot
  // product: as many as keep the block's threads busy.
  const int n_pairs = rows * page;
  int tpk = 1;
  while (tpk < 32 && 2 * tpk * n_pairs <= (int)blockDim.x) tpk *= 2;
  __syncthreads();

  for (int p0 = page_lo; p0 < n_pages; p0 += a.chunk_pages) {
    const int nch = min(a.chunk_pages, n_pages - p0);
    for (int i = tid; i < nch; i += blockDim.x) {
      int phys = a.block_tables[(size_t)b * a.n_table + p0 + i];
      s.tbl[i] = (phys >= 0 && phys < a.n_pool) ? phys : 0;
    }
    __syncthreads();
    stage_pages<Pool>(a, s, h, nch);
    __syncthreads();

    for (int i = 0; i < nch; ++i) {
      const int base_pos = (p0 + i) * page;
      // Scores of every (row, key) pair of this page. The loop bound is the
      // same for every thread, so whole warps reach the shuffles.
      for (int t0 = 0; t0 < n_pairs * tpk; t0 += blockDim.x) {
        const int t = t0 + tid;
        const int pair = t / tpk;
        const int sub = t % tpk;
        float dot = 0.0f;
        if (pair < n_pairs) {
          const int r = pair / page;
          const float* qr = s.q + r * D;
          const float* kr = s.k + (i * page + pair - r * page) * (D + 1);
          dot = strided_dot(qr, kr, sub, tpk, D, 1);
        }
        for (int off = tpk / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (pair < n_pairs && sub == 0) {
          const int r = pair / page;
          const int j = pair - r * page;
          float sc = dot * a.scale;
          if (a.softcap > 0.0f) sc = a.softcap * tanhf(sc / a.softcap);
          s.sc[pair] = key_valid(base_pos + j, s.qpos[r], length, a.window) ? sc : kNegInf;
        }
      }
      __syncthreads();
      // Online-softmax statistics, one warp per row.
      for (int r = warp; r < rows; r += n_warps) {
        float* scr = s.sc + r * page;
        const float m_prev = s.m[r];
        float m_cur = kNegInf;
        for (int j = lane; j < page; j += 32) m_cur = fmaxf(m_cur, scr[j]);
        const float m_new = fmaxf(m_prev, warp_max(m_cur));
        float corr;
        if (a.use_lut) {
          corr = lut::eval(fmaxf(m_prev - m_new, a.lo), s.wb, a.lo, a.inv_step, a.sections);
        } else {
          corr = expf(m_prev - m_new);
        }
        float lsum = 0.0f;
        for (int j = lane; j < page; j += 32) {
          float p = a.use_lut ? lut::eval(scr[j] - m_new, s.wb, a.lo, a.inv_step, a.sections)
                              : expf(scr[j] - m_new);
          if (!key_valid(base_pos + j, s.qpos[r], length, a.window)) p = 0.0f;
          scr[j] = p;
          lsum += p;
        }
        lsum = warp_sum(lsum);
        if (lane == 0) {
          s.l[r] = s.l[r] * corr + lsum;
          s.m[r] = m_new;
          s.corr[r] = corr;
        }
      }
      __syncthreads();
      // acc = acc * corr + p . V over this page.
      for (int t = tid; t < rows * D; t += blockDim.x) {
        const int r = t / D;
        const int dd = t - r * D;
        const float* pr = s.sc + r * page;
        const float* vv = s.v + (i * page) * D + dd;
        s.acc[t] = s.acc[t] * s.corr[r] + strided_dot(pr, vv, 0, 1, page, D);
      }
      __syncthreads();
    }
  }
}

}  // namespace paged
