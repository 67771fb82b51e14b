// Paged decode attention: one query token per sequence over a shared KV
// page pool read through a block table.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::
// paged_attention (Pallas body _paged_attn_kernel, dequant _dequant_page)
// on its single-walk path; kv_splits > 1 at long context goes to
// paged_attention_split.cu instead.
//
// q (B, H, D), pools (P, Hkv, page, D) of q's dtype, or int8 (P, Hkv,
// page, D) / packed int4 (P, Hkv, page, D/2) payload with (P, Hkv, page)
// f32 or bf16 scale rows; block_tables (B, n_pages) int32, lengths (B,)
// int32 -> out (B, H, D) in q's dtype. GQA: the g = H / Hkv query heads of
// kv head h are rows h*g .. h*g + g - 1.
//
// The function is the TPU kernel's page-ordered online softmax. With m_j
// the running max through page j (m_-1 = -1e30) and, for page j,
//   corr_j = exp(m_{j-1} - m_j)   or LUT(max(m_{j-1} - m_j, lo)),
//   p_k    = exp(s_k - m_j)       or LUT(s_k - m_j)  (0 outside the mask),
// the walk leaves l = sum_j (prod_{i>j} corr_i) sum_{k in j} p_k, and acc
// the same with p_k v_k; out = acc / max(l, 1e-9). LUT(a) LUT(b) is not
// LUT(a + b), so the kernel evaluates the LUT on exactly these arguments
// and changes only the order of the fp32 roundings.
//
// What bounds it on the H100: each step reads every valid K and V vector
// (and its scale) once for 4 FLOPs an element, so the KV bytes over HBM
// bound it: 4.86 us for 4 x 16 heads x 960..1024 bf16 keys. At GPT-2's 4
// slots x 16 kv heads there are only 64 (slot, kv head) pairs for 132 SMs,
// so latency, not bandwidth, decides the time. The design:
//  * A cluster of up to 8 blocks shares one (slot, kv head); each block
//    takes an equal run of the sequence's pages. Every block computes all
//    of its scores and pushes its maximum into the shared memory of the
//    later blocks of the cluster; after one cluster barrier each knows
//    m_{j-1} at its first page. A warp a row then forms every m_j and
//    corr_j by a prefix-max scan and the weights prod_{i>j} corr_i by a
//    suffix-product scan over the run; the block sums its weighted p and
//    p . V and pushes them, with its run's product of corr, into block 0,
//    which after a second barrier combines the runs in order, Horner style
//    (acc = acc * C_b + acc_b): the walk's recurrence regrouped.
//  * Staging: a page of one kv head is a contiguous page x D run of the
//    pool. The block feeds a ring of 4 stages of up to 16 KB (several pages
//    of K, then of V) with 16-byte cp.async copies from every thread that
//    arrive on an mbarrier, so the V pages arrive while the scores are
//    computed; pages stay in the pool's storage type in shared memory and
//    are widened or dequantized in registers. Pools whose rows are not
//    whole 16-byte vectors are copied by the block instead.
//  * A block keeps its whole run in shared memory: every key's scores and
//    K/V scales, each page's m_j, weight and id, beside the ring. So the
//    wrapper (kernels/paged_attention.py::decode_cluster) grows the
//    cluster with the table's width until a run fits, and refuses a table
//    wider than 8 blocks hold (decode_max_pages: 101888 keys at g = 1,
//    head_dim 64; 30976 at g = 6, head_dim 128). launch() checks the size.
//  * Work inside a block: the scores of a stage are one pass of 16-byte
//    dot products (a group of threads a key, shuffle-reduced), then one
//    barrier; p . V is one pass with threads over (row, dim) and key
//    groups, then one barrier. No per-page barriers.
//  * What is left (scripts/sweep_clusters.py on the H100 80GB HBM3 at
//    700 W): the copies are not what bounds it, since L2-warm pools run as
//    fast as cold ones; the time grows with the stages of a run, so the
//    per-stage work (scores, p . V, the hand-off) is the next target, and a
//    cluster of 4 (runs of 16 pages at 1024 keys) beats 8.
#include <cooperative_groups.h>

#include "hopper.cuh"
#include "paged_walk.cuh"

namespace {

namespace cg = cooperative_groups;
using common::to_f;
using paged::kNegInf;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;
constexpr int kStageTarget = 16384;  // bytes a ring stage aims for
constexpr int kMaxPairs = 4;         // (row, dim) pairs a thread: g * D <= 1024
constexpr int kMaxCluster = 8;

// Dot products and element reads of a K/V row in the pool's storage type:
// bytes and elems, the row's payload bytes and elements; dot16, q . the
// 16-byte vector at byte offset o of the row; dot1, q . payload element e;
// at, element dd (0..D-1) of the row.
template <class Pool> struct Row;

template <typename T>
struct Row<paged::FpPool<T>> {
  __host__ __device__ static int bytes(int d) { return d * (int)sizeof(T); }
  __device__ static int elems(int d) { return d; }
  __device__ __forceinline__ static float dot16(const uint4& raw, const float* q, int o, int) {
    constexpr int N = common::Vec<T>::N;
    float f[N];
    common::Vec<T>::widen(raw, f);
    const float* qq = q + o / (int)sizeof(T);
    float s = 0.0f;
#pragma unroll
    for (int n = 0; n < N; ++n) s = fmaf(qq[n], f[n], s);
    return s;
  }
  __device__ __forceinline__ static float dot1(const uint8_t* row, const float* q, int e, int) {
    return q[e] * to_f(reinterpret_cast<const T*>(row)[e]);
  }
  __device__ __forceinline__ static float at(const uint8_t* row, int dd, int) {
    return to_f(reinterpret_cast<const T*>(row)[dd]);
  }
};

template <typename S>
struct Row<paged::Int8Pool<S>> {
  __host__ __device__ static int bytes(int d) { return d; }
  __device__ static int elems(int d) { return d; }
  __device__ __forceinline__ static float dot16(const uint4& raw, const float* q, int o, int) {
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
    float s = 0.0f;
#pragma unroll
    for (int n = 0; n < 16; ++n) s = fmaf(q[o + n], (float)b[n], s);
    return s;
  }
  __device__ __forceinline__ static float dot1(const uint8_t* row, const float* q, int e, int) {
    return q[e] * (float)reinterpret_cast<const int8_t*>(row)[e];
  }
  __device__ __forceinline__ static float at(const uint8_t* row, int dd, int) {
    return (float)reinterpret_cast<const int8_t*>(row)[dd];
  }
};

// Byte i holds element i in its low nibble and element i + D/2 in its high
// nibble (serving/quantize.py's halves), sign-extended in int arithmetic.
template <typename S>
struct Row<paged::Int4Pool<S>> {
  __host__ __device__ static int bytes(int d) { return d / 2; }
  __device__ static int elems(int d) { return d / 2; }
  __device__ __forceinline__ static float lo4(int v) { return (float)(((v & 0xF) ^ 8) - 8); }
  __device__ __forceinline__ static float hi4(int v) { return (float)(v >> 4); }
  __device__ __forceinline__ static float dot16(const uint4& raw, const float* q, int o, int d) {
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
    float s = 0.0f;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      s = fmaf(q[o + n], lo4(b[n]), s);
      s = fmaf(q[o + n + d / 2], hi4(b[n]), s);
    }
    return s;
  }
  __device__ __forceinline__ static float dot1(const uint8_t* row, const float* q, int e, int d) {
    const int v = reinterpret_cast<const int8_t*>(row)[e];
    return q[e] * lo4(v) + q[e + d / 2] * hi4(v);
  }
  __device__ __forceinline__ static float at(const uint8_t* row, int dd, int d) {
    const int h = d / 2;
    const int v = reinterpret_cast<const int8_t*>(row)[dd < h ? dd : dd - h];
    return dd < h ? lo4(v) : hi4(v);
  }
};

struct Args {
  const void* q;
  void* out;
  const uint8_t* k_pages;
  const uint8_t* v_pages;
  const void* k_scales;     // (P, Hkv, page), or null for fp pools
  const void* v_scales;
  const int* block_tables;  // (B, n_table)
  const int* lengths;       // (B,)
  const float* exp_wb;      // (sections + 2, 2) or null
  int H, hkv, g, d, page, n_pool, n_table;
  float scale;
  float softcap;            // <= 0: off
  int window;               // <= 0: off
  int use_lut;
  float lo, inv_step;
  int sections;
  int chunk_pages;          // pages a ring stage
  int run_pages;            // most pages a block's run holds: ceil(n_table / cluster)
  int vec;                  // 1: rows are whole 16-byte vectors of aligned pools
};

// Shared-memory carve-up, in bytes, 16-byte aligned pieces.
struct Layout {
  int ring, bars, q, sc, ksc, vsc, m, w, tbl, red, bm_in, recv, wb, total;
};

__host__ __device__ inline int take(int& o, int bytes) {
  const int at = o;
  o += (bytes + 15) & ~15;
  return at;
}

// A run's results as block 0 receives them: its product of corr (g), its
// weighted sum of p (g) and of p . V (g * D).
__host__ __device__ inline int slot_floats(int g, int d) { return 2 * g + g * d; }

__host__ __device__ inline Layout layout(int g, int d, int page, int run_pages,
                                         int stage_bytes) {
  Layout L;
  int o = 0;
  const int keys = run_pages * page;
  L.ring = take(o, kStages * stage_bytes);
  L.bars = take(o, 8 * kStages);
  L.q = take(o, 4 * g * d);
  L.sc = take(o, 4 * g * keys);         // scores, then weighted p
  L.ksc = take(o, 4 * keys);
  L.vsc = take(o, 4 * keys);
  L.m = take(o, 4 * g * run_pages);     // page maxima, then m_j
  L.w = take(o, 4 * g * run_pages);     // corr_j, then prod_{i>j} corr_i
  L.tbl = take(o, 4 * run_pages);
  L.red = take(o, 4 * kThreads);
  L.bm_in = take(o, 4 * kMaxCluster * g);                  // the earlier runs' maxima
  L.recv = take(o, 4 * kMaxCluster * slot_floats(g, d));   // block 0: every run's results
  L.wb = take(o, 4 * 2 * paged::kMaxTableRows);
  L.total = o;
  return L;
}

__device__ __forceinline__ float warp_max(float x) { return paged::warp_max(x); }
__device__ __forceinline__ float warp_sum(float x) { return paged::warp_sum(x); }

__device__ __forceinline__ float softmax_exp(const Args& a, const float* wb, float x) {
  return a.use_lut ? lut::eval(x, wb, a.lo, a.inv_step, a.sections) : expf(x);
}

// Pages and bytes of ring item i: items [0, nkc) are K chunks, [nkc, 2 nkc)
// the same chunks of V.
struct Item {
  int chunk, first, n;
  bool is_v;
};

__device__ __forceinline__ Item item(const Args& a, int i, int nkc, int np) {
  Item it;
  it.is_v = i >= nkc;
  it.chunk = it.is_v ? i - nkc : i;
  it.first = it.chunk * a.chunk_pages;
  it.n = min(a.chunk_pages, np - it.first);
  return it;
}

// Every thread: start its 16-byte cp.async copies of item i into the
// item's stage, and arrive on the stage's barrier when they land.
template <class Pool>
__device__ void issue(const Args& a, const Layout& L, uint32_t base, const int* tbl, int h,
                      int i, int nkc, int np) {
  const Item it = item(a, i, nkc, np);
  const int page_bytes = a.page * Row<Pool>::bytes(a.d);
  const int page_vecs = page_bytes / 16;
  const int s = i % kStages;
  const uint32_t dst = base + L.ring + s * a.chunk_pages * page_bytes;
  const uint8_t* pool = it.is_v ? a.v_pages : a.k_pages;
  for (int v = threadIdx.x; v < it.n * page_vecs; v += kThreads) {
    const int j = v / page_vecs;
    const size_t pg = (size_t)tbl[it.first + j] * a.hkv + h;
    hopper::cp_async16(dst + 16 * v, pool + pg * page_bytes + 16 * (v - j * page_vecs));
  }
  hopper::cp_async_arrive(base + L.bars + 8 * s);
}

// The whole block: copy item i into its stage (pools without whole
// 16-byte rows); the caller synchronises.
template <class Pool>
__device__ void copy_item(const Args& a, const Layout& L, uint8_t* smem, const int* tbl, int h,
                          int i, int nkc, int np) {
  const Item it = item(a, i, nkc, np);
  const int page_bytes = a.page * Row<Pool>::bytes(a.d);
  uint8_t* dst = smem + L.ring + (i % kStages) * a.chunk_pages * page_bytes;
  const uint8_t* pool = it.is_v ? a.v_pages : a.k_pages;
  for (int e = threadIdx.x; e < it.n * page_bytes; e += blockDim.x) {
    const int j = e / page_bytes;
    const size_t pg = (size_t)tbl[it.first + j] * a.hkv + h;
    dst[e] = pool[pg * page_bytes + (e - j * page_bytes)];
  }
}

// Item i's stage, once its copies have landed (or after the block has
// copied it).
template <class Pool>
__device__ __forceinline__ const uint8_t* acquire(const Args& a, const Layout& L, uint8_t* smem,
                                                  uint32_t base, const int* tbl, int h, int i,
                                                  int nkc, int np) {
  const int s = i % kStages;
  if (a.vec) {
    hopper::mbar_wait(base + L.bars + 8 * s, (i / kStages) & 1);
  } else {
    copy_item<Pool>(a, L, smem, tbl, h, i, nkc, np);
    __syncthreads();
  }
  return smem + L.ring + s * a.chunk_pages * a.page * Row<Pool>::bytes(a.d);
}

// Every thread is done with item i: refill its stage with item i + kStages.
template <class Pool>
__device__ __forceinline__ void release(const Args& a, const Layout& L, uint32_t base,
                                        const int* tbl, int h, int i, int nkc, int np) {
  __syncthreads();
  if (a.vec && i + kStages < 2 * nkc) issue<Pool>(a, L, base, tbl, h, i + kStages, nkc, np);
}

// At most 64 registers a thread, so that four blocks share an SM and a
// grid of 8-block clusters fits the card in one wave.
template <typename T, class Pool>
__global__ void __launch_bounds__(kThreads, 4)
paged_decode_kernel(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.x / cs;
  const int b = bh / a.hkv;
  const int h = bh - b * a.hkv;
  const int g = a.g, D = a.d, page = a.page;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row_bytes = Row<Pool>::bytes(D);
  const int page_bytes = page * row_bytes;
  const Layout L = layout(g, D, page, a.run_pages, a.chunk_pages * page_bytes);
  const uint32_t base = hopper::smem_u32(smem);
  float* s_q = reinterpret_cast<float*>(smem + L.q);
  float* s_sc = reinterpret_cast<float*>(smem + L.sc);
  float* s_ksc = reinterpret_cast<float*>(smem + L.ksc);
  float* s_vsc = reinterpret_cast<float*>(smem + L.vsc);
  float* s_m = reinterpret_cast<float*>(smem + L.m);
  float* s_w = reinterpret_cast<float*>(smem + L.w);
  int* s_tbl = reinterpret_cast<int*>(smem + L.tbl);
  float* s_red = reinterpret_cast<float*>(smem + L.red);
  float* s_bm_in = reinterpret_cast<float*>(smem + L.bm_in);
  float* s_wb = reinterpret_cast<float*>(smem + L.wb);
  // This run's slot in block 0's shared memory: C, l, then acc.
  float* slot = cluster.map_shared_rank(reinterpret_cast<float*>(smem + L.recv), 0) +
                rank * slot_floats(g, D);
  const int keys_max = a.run_pages * page;

  // This block's run of the pages that hold a valid key.
  const int length = a.lengths[b];
  const int n_pages = length > 0 ? min((length + page - 1) / page, a.n_table) : 0;
  const int p_lo = rank * n_pages / cs;
  const int np = (rank + 1) * n_pages / cs - p_lo;
  const int keys = np * page;
  const int nkc = (np + a.chunk_pages - 1) / a.chunk_pages;
  const int n_items = 2 * nkc;

  // Arrive now and wait before the first store to another block's shared
  // memory: every block of the cluster has started by then.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  for (int i = tid; i < np; i += kThreads) {
    const int phys = a.block_tables[(size_t)b * a.n_table + p_lo + i];
    s_tbl[i] = (phys >= 0 && phys < a.n_pool) ? phys : 0;
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(base + L.bars + 8 * s, kThreads);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (a.vec) {
    for (int i = 0; i < min(kStages, n_items); ++i) issue<Pool>(a, L, base, s_tbl, h, i, nkc, np);
  }
  const T* q = reinterpret_cast<const T*>(a.q);
  for (int i = tid; i < g * D; i += kThreads)
    s_q[i] = to_f(q[((size_t)b * a.H + h * g) * D + i]);
  for (int k = tid; k < keys; k += kThreads) {
    const size_t pg = (size_t)s_tbl[k / page] * a.hkv + h;
    s_ksc[k] = Pool::scale(a.k_scales, pg * page + k % page);
    s_vsc[k] = Pool::scale(a.v_scales, pg * page + k % page);
  }
  if (a.use_lut) lut::stage(s_wb, a.exp_wb, a.sections);
  __syncthreads();

  // Scores: a group of tpk threads (a power of two, at most a warp) a key.
  const int units = a.vec ? row_bytes / 16 : Row<Pool>::elems(D);
  int tpk = 1;
  while (tpk < 32 && 2 * tpk <= units) tpk *= 2;
  const int sub = tid % tpk;
  const int qpos = length - 1;
  for (int c = 0; c < nkc; ++c) {
    const uint8_t* stage = acquire<Pool>(a, L, smem, base, s_tbl, h, c, nkc, np);
    const int first_key = c * a.chunk_pages * page;
    const int nk = min(a.chunk_pages, np - c * a.chunk_pages) * page;
    for (int k0 = 0; k0 < nk; k0 += kThreads / tpk) {
      const int kl = k0 + tid / tpk;
      const uint8_t* row = stage + (size_t)min(kl, nk - 1) * row_bytes;
      for (int r = 0; r < g; ++r) {
        const float* qr = s_q + r * D;
        float dot = 0.0f;
        if (kl < nk) {
          if (a.vec) {
            for (int v = sub; v < units; v += tpk)
              dot += Row<Pool>::dot16(common::ld16(row + 16 * v), qr, 16 * v, D);
          } else {
            for (int e = sub; e < units; e += tpk) dot += Row<Pool>::dot1(row, qr, e, D);
          }
        }
        for (int off = tpk / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (kl < nk && sub == 0) {
          const int k = first_key + kl;
          float s = dot * s_ksc[k] * a.scale;
          if (a.softcap > 0.0f) s = a.softcap * tanhf(s / a.softcap);
          const bool ok = paged::key_valid(p_lo * page + k, qpos, length, a.window);
          s_sc[r * keys_max + k] = ok ? s : kNegInf;
        }
      }
    }
    release<Pool>(a, L, base, s_tbl, h, c, nkc, np);
  }

  // Page maxima, and the run's maximum, pushed to the later runs.
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int r = warp; r < g; r += kWarps) {
    float bm = kNegInf;
    for (int j = lane; j < np; j += 32) {
      float pm = kNegInf;
      for (int t = 0; t < page; ++t) pm = fmaxf(pm, s_sc[r * keys_max + j * page + t]);
      s_m[r * a.run_pages + j] = pm;
      bm = fmaxf(bm, pm);
    }
    bm = warp_max(bm);
    for (int rk = rank + 1 + lane; rk < cs; rk += 32)
      cluster.map_shared_rank(s_bm_in, rk)[rank * g + r] = bm;
  }
  cluster.sync();

  // m_j by a prefix-max scan from the earlier runs' maximum, corr_j, then
  // w_j = prod_{i>j} corr_i by a suffix-product scan; one warp a row.
  for (int r = warp; r < g; r += kWarps) {
    float carry = kNegInf;
    for (int rk = 0; rk < rank; ++rk) carry = fmaxf(carry, s_bm_in[rk * g + r]);
    float* mr = s_m + r * a.run_pages;
    float* wr = s_w + r * a.run_pages;
    for (int j0 = 0; j0 < np; j0 += 32) {
      const int j = j0 + lane;
      float x = j < np ? mr[j] : kNegInf;
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x = fmaxf(x, y);
      }
      const float m = fmaxf(carry, x);
      float m_prev = __shfl_up_sync(0xffffffffu, m, 1);
      if (lane == 0) m_prev = carry;
      if (j < np) {
        const float diff = m_prev - m;
        mr[j] = m;
        wr[j] = a.use_lut ? lut::eval(fmaxf(diff, a.lo), s_wb, a.lo, a.inv_step, a.sections)
                          : expf(diff);
      }
      carry = __shfl_sync(0xffffffffu, m, 31);
    }
    __syncwarp();
    float prod = 1.0f;
    for (int j0 = (np - 1) / 32 * 32; np > 0 && j0 >= 0; j0 -= 32) {
      const int j = j0 + lane;
      const float corr = j < np ? wr[j] : 1.0f;
      float x = corr;                                   // prod_{i>=j} in this group
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_down_sync(0xffffffffu, x, off);
        if (lane + off < 32) x *= y;
      }
      float after = __shfl_down_sync(0xffffffffu, x, 1);
      if (lane == 31) after = 1.0f;
      if (j < np) wr[j] = after * prod;
      prod *= __shfl_sync(0xffffffffu, x, 0);
    }
    if (lane == 0) slot[r] = prod;
  }
  __syncthreads();

  // p_k = exp or LUT of s_k - m_j, weighted by w_j, in place of the scores.
  for (int t = tid; t < g * keys; t += kThreads) {
    const int r = t / keys;
    const int k = t - r * keys;
    const int j = k / page;
    float* sp = s_sc + r * keys_max + k;
    float p = 0.0f;
    if (paged::key_valid(p_lo * page + k, qpos, length, a.window))
      p = softmax_exp(a, s_wb, *sp - s_m[r * a.run_pages + j]);
    *sp = p * s_w[r * a.run_pages + j];
  }
  __syncthreads();
  for (int r = warp; r < g; r += kWarps) {
    float l = 0.0f;
    for (int k = lane; k < keys; k += 32) l += s_sc[r * keys_max + k];
    l = warp_sum(l);
    if (lane == 0) slot[g + r] = l;
  }

  // p . V: threads over (row, dim) pairs and kg key groups.
  const int pairs = g * D;
  const int KG = pairs <= kThreads ? kThreads / pairs : 1;
  const int kg = pairs <= kThreads ? tid / pairs : 0;
  float acc[kMaxPairs];
#pragma unroll
  for (int u = 0; u < kMaxPairs; ++u) acc[u] = 0.0f;
  for (int c = 0; c < nkc; ++c) {
    const uint8_t* stage = acquire<Pool>(a, L, smem, base, s_tbl, h, nkc + c, nkc, np);
    if (kg < KG) {
      const int first_key = c * a.chunk_pages * page;
      const int nk = min(a.chunk_pages, np - c * a.chunk_pages) * page;
#pragma unroll
      for (int u = 0; u < kMaxPairs; ++u) {
        const int pr = (pairs <= kThreads ? tid % pairs : tid) + u * kThreads;
        if ((pairs <= kThreads && u > 0) || pr >= pairs) continue;
        const int r = pr / D;
        const int dd = pr - r * D;
        const float* pw = s_sc + r * keys_max + first_key;
        const float* vs = s_vsc + first_key;
        const uint8_t* col = stage + (size_t)kg * row_bytes;
        // Four keys at a time, their loads issued before the sums.
        int kl = kg;
        for (; kl + 3 * KG < nk; kl += 4 * KG, col += 4 * (size_t)KG * row_bytes) {
          float v[4], p[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            v[t] = Row<Pool>::at(col + (size_t)t * KG * row_bytes, dd, D) * vs[kl + t * KG];
            p[t] = pw[kl + t * KG];
          }
#pragma unroll
          for (int t = 0; t < 4; ++t) acc[u] = fmaf(p[t], v[t], acc[u]);
        }
        for (; kl < nk; kl += KG, col += (size_t)KG * row_bytes)
          acc[u] = fmaf(pw[kl], Row<Pool>::at(col, dd, D) * vs[kl], acc[u]);
      }
    }
    release<Pool>(a, L, base, s_tbl, h, nkc + c, nkc, np);
  }
  if (pairs <= kThreads) {
    if (kg < KG) s_red[kg * pairs + tid % pairs] = acc[0];
    __syncthreads();
    for (int pr = tid; pr < pairs; pr += kThreads) {
      float v = s_red[pr];
      for (int j = 1; j < KG; ++j) v += s_red[j * pairs + pr];
      slot[2 * g + pr] = v;
    }
  } else {
#pragma unroll
    for (int u = 0; u < kMaxPairs; ++u) {
      if (tid + u * kThreads < pairs) slot[2 * g + tid + u * kThreads] = acc[u];
    }
  }
  // Every run's results are in block 0, which no other block reads: the
  // others may leave after this barrier.
  cluster.sync();

  // Block 0 merges the runs in order: X = X * C_b + X_b.
  if (rank == 0) {
    const float* recv = reinterpret_cast<const float*>(smem + L.recv);
    const int sf = slot_floats(g, D);
    T* out = reinterpret_cast<T*>(a.out);
    for (int pr = tid; pr < pairs; pr += kThreads) {
      const int r = pr / D;
      float l = recv[g + r], x = recv[2 * g + pr];
      for (int rk = 1; rk < cs; ++rk) {
        const float* sl = recv + rk * sf;
        l = l * sl[r] + sl[g + r];
        x = x * sl[r] + sl[2 * g + pr];
      }
      out[((size_t)b * a.H + h * g) * D + pr] = common::from_f<T>(x / fmaxf(l, 1e-9f));
    }
  }
}

template <typename T, class Pool>
int launch(Args a, int B, int cluster, cudaStream_t stream) {
  const int row_bytes = Row<Pool>::bytes(a.d);
  const int page_bytes = a.page * row_bytes;
  a.vec = row_bytes % 16 == 0 && common::aligned16(a.k_pages) && common::aligned16(a.v_pages);
  a.run_pages = (a.n_table + cluster - 1) / cluster;
  a.chunk_pages = max(1, min(kStageTarget / page_bytes, a.run_pages));
  const int smem = layout(a.g, a.d, a.page, a.run_pages, a.chunk_pages * page_bytes).total;
  if (smem > paged::kSmemMax) return (int)cudaErrorInvalidValue;
  auto kernel = paged_decode_kernel<T, Pool>;
  static int sized = paged::kSmemDefault;      // largest size allowed so far
  if (smem > sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * a.hkv * cluster), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, a);
}

}  // namespace

extern "C" {

// dtype (q's): 0 = float32, 1 = bfloat16; pool_fmt as paged::with_pool
// (scale pointers null for fp pools). softcap <= 0 and window <= 0 turn
// those masks off; exp_wb may be null when use_lut is 0. cluster: the
// blocks that share one (slot, kv head), 1, 2, 4 or 8, at most n_table.
// Needs g * D <= 1024. Returns a CUDA error code (0 on success).
int paged_attention(const void* q, const void* k_pages, const void* v_pages,
                    const void* k_scales, const void* v_scales,
                    const int* block_tables, const int* lengths,
                    const float* exp_wb, void* out, int B, int H, int Hkv,
                    int D, int page, int n_pool, int n_table, float scale,
                    float softcap, int window, int use_lut, float lo,
                    float inv_step, int sections, int dtype, int pool_fmt,
                    int cluster, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || (H / Hkv) * D > kMaxPairs * kThreads || n_table < 1 ||
      cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) != 0 ||
      cluster > n_table ||
      (use_lut && (exp_wb == nullptr || sections + 2 > paged::kMaxTableRows)))
    return (int)cudaErrorInvalidValue;
  Args a{q, out, (const uint8_t*)k_pages, (const uint8_t*)v_pages, k_scales, v_scales,
         block_tables, lengths, exp_wb, H, Hkv, H / Hkv, D, page, n_pool, n_table,
         scale, softcap, window, use_lut, lo, inv_step, sections, 0, 0, 0};
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = paged::dispatch(dtype, pool_fmt, [&](auto tq, auto pool) {
    return launch<decltype(tq), decltype(pool)>(a, B, cluster, s);
  });
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
