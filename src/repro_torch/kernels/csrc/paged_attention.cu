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
//  * A block keeps a window of its run in shared memory: every key's
//    scores and K/V scales, each page's m_j and weight, beside the ring.
//    The wrapper (kernels/paged_attention.py::decode_plan) grows the
//    cluster with the table's width until a run fits one window. A run
//    wider than that (past 101888 keys at g = 1, head_dim 64; 30976 at
//    g = 6, head_dim 128) is walked in windows of whole ring stages: a
//    first pass reads the run's K once and keeps only its maximum a row,
//    which the block publishes as above; then each window re-reads its K,
//    recomputes its scores, forms m_j and corr_j by the same prefix-max
//    scan with m_{j-1} carried across windows (so the LUT sees the page
//    walk's own arguments), and folds its weighted l and p . V into the
//    run's by Horner's rule, beside the run's product of corr. No shared
//    memory grows with the table's width. g * D past the block's threads
//    is summed pair by pair into shared memory. launch() checks the size.
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
using paged::Row;
using paged::kNegInf;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;
constexpr int kStageTarget = 16384;  // bytes a ring stage aims for
constexpr int kMaxCluster = 8;

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
  int win_pages;            // pages a window: a whole run, or a multiple of chunk_pages
  int vec;                  // 1: rows are whole 16-byte vectors of aligned pools
};

// Shared-memory carve-up, in bytes, 16-byte aligned pieces.
struct Layout {
  int ring, bars, q, sc, ksc, vsc, m, w, tbl, red, bm_in, recv, wb, st, racc, wacc, total;
};

__host__ __device__ inline int take(int& o, int bytes) {
  const int at = o;
  o += (bytes + 15) & ~15;
  return at;
}

// A run's results as block 0 receives them: its product of corr (g), its
// weighted sum of p (g) and of p . V (g * D).
__host__ __device__ inline int slot_floats(int g, int d) { return 2 * g + g * d; }

// Per-row run state (floats of g each): the run's maximum from the first
// pass, the carried m_j, a window's product of corr, the run's l and its
// product of corr.
constexpr int kRowState = 5;

__host__ __device__ inline Layout layout(int g, int d, int page, int win_pages,
                                         int stage_bytes, int cluster) {
  Layout L;
  int o = 0;
  const int keys = win_pages * page;
  L.ring = take(o, kStages * stage_bytes);
  L.bars = take(o, 8 * kStages);
  L.q = take(o, 4 * g * d);
  L.sc = take(o, 4 * g * keys);         // scores, then weighted p
  L.ksc = take(o, 4 * keys);
  L.vsc = take(o, 4 * keys);
  L.m = take(o, 4 * g * win_pages);     // page maxima, then m_j
  L.w = take(o, 4 * g * win_pages);     // corr_j, then prod_{i>j} corr_i in the window
  L.tbl = take(o, 4 * win_pages);
  L.red = take(o, 4 * kThreads);
  L.bm_in = take(o, 4 * cluster * g);                  // the earlier runs' maxima
  L.recv = take(o, 4 * cluster * slot_floats(g, d));   // block 0: every run's results
  L.wb = take(o, 4 * 2 * paged::kMaxTableRows);
  L.st = take(o, 4 * kRowState * g);
  L.racc = take(o, 4 * g * d);          // the run's p . V
  L.wacc = take(o, 4 * g * d);          // a window's p . V when g * D > kThreads
  L.total = o;
  return L;
}

__device__ __forceinline__ float warp_max(float x) { return paged::warp_max(x); }
__device__ __forceinline__ float warp_sum(float x) { return paged::warp_sum(x); }

__device__ __forceinline__ float softmax_exp(const Args& a, const float* wb, float x) {
  return a.use_lut ? lut::eval(x, wb, a.lo, a.inv_step, a.sections) : expf(x);
}

__device__ __forceinline__ int clamp_page(const Args& a, int phys) {
  return (phys >= 0 && phys < a.n_pool) ? phys : 0;
}

// The ring's items. With one window (the run fits): the K chunks of the
// run, then its V chunks. With several: the first pass's K chunks of the
// whole run (p1 = nkc items), then per window its K chunks and its V
// chunks. cw: chunks a window.
struct Item {
  int chunk, first, n;
  bool is_v;
};

struct Sched {
  int np, nkc, cw, nw, p1, n_items;
};

__device__ __forceinline__ Item item(const Args& a, const Sched& S, int i) {
  Item it;
  if (i < S.p1) {
    it.is_v = false;
    it.chunk = i;
  } else {
    const int j = i - S.p1;
    const int w = j / (2 * S.cw);
    const int r = j - w * 2 * S.cw;
    const int n = min(S.cw, S.nkc - w * S.cw);
    it.is_v = r >= n;
    it.chunk = w * S.cw + (it.is_v ? r - n : r);
  }
  it.first = it.chunk * a.chunk_pages;
  it.n = min(a.chunk_pages, S.np - it.first);
  return it;
}

// Every thread: start its 16-byte cp.async copies of item i into the
// item's stage, and arrive on the stage's barrier when they land. tbl
// holds the run's physical page ids.
template <class Pool>
__device__ void issue(const Args& a, const Layout& L, const Sched& S, uint32_t base,
                      const int* tbl, int h, int i) {
  const Item it = item(a, S, i);
  const int page_bytes = a.page * Row<Pool>::bytes(a.d);
  const int page_vecs = page_bytes / 16;
  const int s = i % kStages;
  const uint32_t dst = base + L.ring + s * a.chunk_pages * page_bytes;
  const uint8_t* pool = it.is_v ? a.v_pages : a.k_pages;
  for (int v = threadIdx.x; v < it.n * page_vecs; v += kThreads) {
    const int j = v / page_vecs;
    const size_t pg = (size_t)clamp_page(a, tbl[it.first + j]) * a.hkv + h;
    hopper::cp_async16(dst + 16 * v, pool + pg * page_bytes + 16 * (v - j * page_vecs));
  }
  hopper::cp_async_arrive(base + L.bars + 8 * s);
}

// The whole block: copy item i into its stage (pools without whole
// 16-byte rows); the caller synchronises.
template <class Pool>
__device__ void copy_item(const Args& a, const Layout& L, const Sched& S, uint8_t* smem,
                          const int* tbl, int h, int i) {
  const Item it = item(a, S, i);
  const int page_bytes = a.page * Row<Pool>::bytes(a.d);
  uint8_t* dst = smem + L.ring + (i % kStages) * a.chunk_pages * page_bytes;
  const uint8_t* pool = it.is_v ? a.v_pages : a.k_pages;
  for (int e = threadIdx.x; e < it.n * page_bytes; e += blockDim.x) {
    const int j = e / page_bytes;
    const size_t pg = (size_t)clamp_page(a, tbl[it.first + j]) * a.hkv + h;
    dst[e] = pool[pg * page_bytes + (e - j * page_bytes)];
  }
}

// Item i's stage, once its copies have landed (or after the block has
// copied it).
template <class Pool>
__device__ __forceinline__ const uint8_t* acquire(const Args& a, const Layout& L,
                                                  const Sched& S, uint8_t* smem, uint32_t base,
                                                  const int* tbl, int h, int i) {
  const int s = i % kStages;
  if (a.vec) {
    hopper::mbar_wait(base + L.bars + 8 * s, (i / kStages) & 1);
  } else {
    copy_item<Pool>(a, L, S, smem, tbl, h, i);
    __syncthreads();
  }
  return smem + L.ring + s * a.chunk_pages * a.page * Row<Pool>::bytes(a.d);
}

// Every thread is done with item i: refill its stage with item i + kStages.
template <class Pool>
__device__ __forceinline__ void release(const Args& a, const Layout& L, const Sched& S,
                                        uint32_t base, const int* tbl, int h, int i) {
  __syncthreads();
  if (a.vec && i + kStages < S.n_items) issue<Pool>(a, L, S, base, tbl, h, i + kStages);
}

// At most 64 registers a thread, so that four blocks share an SM and a
// grid of 8-block clusters fits the card in one wave.
// kWin: runs may be wider than a window (the instantiation without it
// holds none of the windowed walk's code).
template <typename T, class Pool, bool kWin>
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
  const int W = a.win_pages;
  const Layout L = layout(g, D, page, W, a.chunk_pages * page_bytes, cs);
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
  float* s_rmax = reinterpret_cast<float*>(smem + L.st);
  float* s_carry = s_rmax + g;
  float* s_cw = s_carry + g;
  float* s_rl = s_cw + g;
  float* s_rprod = s_rl + g;
  float* s_racc = reinterpret_cast<float*>(smem + L.racc);
  float* s_wacc = reinterpret_cast<float*>(smem + L.wacc);
  // This run's slot in block 0's shared memory: C, l, then acc.
  float* slot = cluster.map_shared_rank(reinterpret_cast<float*>(smem + L.recv), 0) +
                rank * slot_floats(g, D);
  const int keys_max = W * page;               // a window's keys: the score rows' stride

  // This block's run of the pages that hold a valid key, in windows of W
  // pages (one window when the run fits).
  const int length = a.lengths[b];
  const int n_pages = length > 0 ? min((length + page - 1) / page, a.n_table) : 0;
  const int p_lo = rank * n_pages / cs;
  Sched S;
  S.np = (rank + 1) * n_pages / cs - p_lo;
  S.nkc = (S.np + a.chunk_pages - 1) / a.chunk_pages;
  S.cw = (W + a.chunk_pages - 1) / a.chunk_pages;
  S.nw = (S.nkc + S.cw - 1) / S.cw;
  S.p1 = S.nw > 1 ? S.nkc : 0;
  S.n_items = S.p1 + 2 * S.nkc;
  const bool one = !kWin || S.nw <= 1;
  const int* tbl = one ? s_tbl : a.block_tables + (size_t)b * a.n_table + p_lo;

  // Arrive now and wait before the first store to another block's shared
  // memory: every block of the cluster has started by then.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (one) {
    for (int i = tid; i < S.np; i += kThreads)
      s_tbl[i] = clamp_page(a, a.block_tables[(size_t)b * a.n_table + p_lo + i]);
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(base + L.bars + 8 * s, kThreads);
    hopper::mbar_init_fence();
  }
  for (int r = tid; r < g; r += kThreads) {
    s_rmax[r] = kNegInf;
    s_rl[r] = 0.0f;
    s_rprod[r] = 1.0f;
  }
  for (int i = tid; i < g * D; i += kThreads) {
    s_racc[i] = 0.0f;
    s_wacc[i] = 0.0f;
  }
  __syncthreads();
  if (a.vec) {
    for (int i = 0; i < min(kStages, S.n_items); ++i) issue<Pool>(a, L, S, base, tbl, h, i);
  }
  const T* q = reinterpret_cast<const T*>(a.q);
  for (int i = tid; i < g * D; i += kThreads)
    s_q[i] = to_f(q[((size_t)b * a.H + h * g) * D + i]);
  if (a.use_lut) lut::stage(s_wb, a.exp_wb, a.sections);

  // K (and V) scales of the window whose pages start at run page wp0.
  auto load_scales = [&](int wp0, int wnp, bool with_v) {
    for (int k = tid; k < wnp * page; k += kThreads) {
      const size_t pg = (size_t)clamp_page(a, tbl[wp0 + k / page]) * a.hkv + h;
      s_ksc[k] = Pool::scale(a.k_scales, pg * page + k % page);
      if (with_v) s_vsc[k] = Pool::scale(a.v_scales, pg * page + k % page);
    }
  };

  // Scores: a group of tpk threads (a power of two, at most a warp) a key.
  const int units = a.vec ? row_bytes / 16 : Row<Pool>::elems(D);
  int tpk = 1;
  while (tpk < 32 && 2 * tpk <= units) tpk *= 2;
  const int sub = tid % tpk;
  const int qpos = length - 1;
  int it = 0;                                   // the next ring item
  // Window w's scores (its K items), at window-local key positions.
  auto score = [&](int w) {
    const int c_end = min(S.nkc, (w + 1) * S.cw);
    for (int c = w * S.cw; c < c_end; ++c, ++it) {
      const uint8_t* stage = acquire<Pool>(a, L, S, smem, base, tbl, h, it);
      const int first_key = (c - w * S.cw) * a.chunk_pages * page;
      const int nk = min(a.chunk_pages, S.np - c * a.chunk_pages) * page;
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
            float s = dot * s_ksc[first_key + kl] * a.scale;
            if (a.softcap > 0.0f) s = a.softcap * tanhf(s / a.softcap);
            const bool ok = paged::key_valid((p_lo + c * a.chunk_pages) * page + kl, qpos,
                                             length, a.window);
            s_sc[r * keys_max + first_key + kl] = ok ? s : kNegInf;
          }
        }
      }
      release<Pool>(a, L, S, base, tbl, h, it);
    }
  };
  // Page maxima of a window's wnp pages into s_m; returns this lane's part
  // of the row's maximum (warp r of every g-th row).
  auto page_maxima = [&](int r, int wnp) {
    float bm = kNegInf;
    for (int j = lane; j < wnp; j += 32) {
      float pm = kNegInf;
      for (int t = 0; t < page; ++t) pm = fmaxf(pm, s_sc[r * keys_max + j * page + t]);
      s_m[r * W + j] = pm;
      bm = fmaxf(bm, pm);
    }
    return warp_max(bm);
  };

  if (one) {
    load_scales(0, S.np, true);
    __syncthreads();
    score(0);
  } else {
    // First pass: the run's maximum, one window of scores at a time.
    for (int w = 0; w < S.nw; ++w) {
      const int wp0 = w * W;
      const int wnp = min(W, S.np - wp0);
      load_scales(wp0, wnp, false);
      __syncthreads();
      score(w);
      for (int r = warp; r < g; r += kWarps) {
        float bm = kNegInf;
        for (int k = lane; k < wnp * page; k += 32) bm = fmaxf(bm, s_sc[r * keys_max + k]);
        bm = warp_max(bm);
        if (lane == 0) s_rmax[r] = fmaxf(s_rmax[r], bm);
      }
      __syncthreads();
    }
  }

  // The run's maximum, pushed to the later runs.
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int r = warp; r < g; r += kWarps) {
    const float bm = one ? page_maxima(r, S.np) : s_rmax[r];
    for (int rk = rank + 1 + lane; rk < cs; rk += 32)
      cluster.map_shared_rank(s_bm_in, rk)[rank * g + r] = bm;
  }
  cluster.sync();

  const int pairs = g * D;
  const int KG = pairs <= kThreads ? kThreads / pairs : 1;
  const int kg = pairs <= kThreads ? tid / pairs : 0;
  for (int w = 0; w < S.nw; ++w) {
    const int wp0 = w * W;
    const int wnp = min(W, S.np - wp0);
    const int wkeys = wnp * page;
    if (!one) {
      load_scales(wp0, wnp, true);
      __syncthreads();
      score(w);
      for (int r = warp; r < g; r += kWarps) page_maxima(r, wnp);
      __syncthreads();
    }

    // m_j by a prefix-max scan from the carry (the earlier runs' maximum,
    // or the last m_j of the previous window), corr_j, then the window's
    // w_j = prod_{i>j} corr_i by a suffix-product scan; one warp a row.
    for (int r = warp; r < g; r += kWarps) {
      float carry = kNegInf;
      if (w == 0) {
        for (int rk = 0; rk < rank; ++rk) carry = fmaxf(carry, s_bm_in[rk * g + r]);
      } else {
        carry = s_carry[r];
      }
      float* mr = s_m + r * W;
      float* wr = s_w + r * W;
      for (int j0 = 0; j0 < wnp; j0 += 32) {
        const int j = j0 + lane;
        float x = j < wnp ? mr[j] : kNegInf;
        for (int off = 1; off < 32; off <<= 1) {
          const float y = __shfl_up_sync(0xffffffffu, x, off);
          if (lane >= off) x = fmaxf(x, y);
        }
        const float m = fmaxf(carry, x);
        float m_prev = __shfl_up_sync(0xffffffffu, m, 1);
        if (lane == 0) m_prev = carry;
        if (j < wnp) {
          const float diff = m_prev - m;
          mr[j] = m;
          wr[j] = a.use_lut ? lut::eval(fmaxf(diff, a.lo), s_wb, a.lo, a.inv_step, a.sections)
                            : expf(diff);
        }
        carry = __shfl_sync(0xffffffffu, m, 31);
      }
      __syncwarp();
      float prod = 1.0f;
      for (int j0 = (wnp - 1) / 32 * 32; wnp > 0 && j0 >= 0; j0 -= 32) {
        const int j = j0 + lane;
        const float corr = j < wnp ? wr[j] : 1.0f;
        float x = corr;                                   // prod_{i>=j} in this group
        for (int off = 1; off < 32; off <<= 1) {
          const float y = __shfl_down_sync(0xffffffffu, x, off);
          if (lane + off < 32) x *= y;
        }
        float after = __shfl_down_sync(0xffffffffu, x, 1);
        if (lane == 31) after = 1.0f;
        if (j < wnp) wr[j] = after * prod;
        prod *= __shfl_sync(0xffffffffu, x, 0);
      }
      if (lane == 0) {
        s_cw[r] = prod;
        s_carry[r] = carry;
      }
    }
    __syncthreads();

    // p_k = exp or LUT of s_k - m_j, weighted by w_j, in place of the scores.
    for (int t = tid; t < g * wkeys; t += kThreads) {
      const int r = t / wkeys;
      const int k = t - r * wkeys;
      const int j = k / page;
      float* sp = s_sc + r * keys_max + k;
      float p = 0.0f;
      if (paged::key_valid((p_lo + wp0) * page + k, qpos, length, a.window))
        p = softmax_exp(a, s_wb, *sp - s_m[r * W + j]);
      *sp = p * s_w[r * W + j];
    }
    __syncthreads();
    // The run's l and product of corr take the window by Horner's rule.
    for (int r = warp; r < g; r += kWarps) {
      float l = 0.0f;
      for (int k = lane; k < wkeys; k += 32) l += s_sc[r * keys_max + k];
      l = warp_sum(l);
      if (lane == 0 && one) {           // the run is this window: straight to block 0
        slot[r] = s_cw[r];
        slot[g + r] = l;
      } else if (lane == 0) {
        s_rl[r] = s_rl[r] * s_cw[r] + l;
        s_rprod[r] *= s_cw[r];
      }
    }

    // p . V: threads over (row, dim) pairs and kg key groups; past
    // kThreads pairs, each thread owns pairs tid, tid + kThreads, ... and
    // sums each V chunk into the window's s_wacc.
    // acc += sum over the stage's keys of p * V[key][dd] for pair pr.
    auto pv = [&](const uint8_t* stage, int pr, int first_key, int nk, float& acc) {
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
        for (int t = 0; t < 4; ++t) acc = fmaf(p[t], v[t], acc);
      }
      for (; kl < nk; kl += KG, col += (size_t)KG * row_bytes)
        acc = fmaf(pw[kl], Row<Pool>::at(col, dd, D) * vs[kl], acc);
    };
    float acc = 0.0f;
    const int c_end = min(S.nkc, (w + 1) * S.cw);
    for (int c = w * S.cw; c < c_end; ++c, ++it) {
      const uint8_t* stage = acquire<Pool>(a, L, S, smem, base, tbl, h, it);
      const int first_key = (c - w * S.cw) * a.chunk_pages * page;
      const int nk = min(a.chunk_pages, S.np - c * a.chunk_pages) * page;
      if (pairs <= kThreads) {
        if (kg < KG) pv(stage, tid % pairs, first_key, nk, acc);
      } else {
        for (int pr = tid; pr < pairs; pr += kThreads) {
          float part = 0.0f;
          pv(stage, pr, first_key, nk, part);
          s_wacc[pr] += part;
        }
      }
      release<Pool>(a, L, S, base, tbl, h, it);
    }
    if (pairs <= kThreads) {
      if (kg < KG) s_red[kg * pairs + tid % pairs] = acc;
      __syncthreads();
      for (int pr = tid; pr < pairs; pr += kThreads) {
        float v = s_red[pr];
        for (int j = 1; j < KG; ++j) v += s_red[j * pairs + pr];
        if (one) {
          slot[2 * g + pr] = v;
        } else {
          s_racc[pr] = s_racc[pr] * s_cw[pr / D] + v;
        }
      }
    } else {
      for (int pr = tid; pr < pairs; pr += kThreads) {
        if (one) {
          slot[2 * g + pr] = s_wacc[pr];
        } else {
          s_racc[pr] = s_racc[pr] * s_cw[pr / D] + s_wacc[pr];
          s_wacc[pr] = 0.0f;
        }
      }
    }
    if (!one) __syncthreads();
  }

  // The run's results into block 0 (done above for a run of one window).
  if (!one || S.nw == 0) {
    for (int r = tid; r < g; r += kThreads) {
      slot[r] = s_rprod[r];
      slot[g + r] = s_rl[r];
    }
    for (int pr = tid; pr < pairs; pr += kThreads) slot[2 * g + pr] = s_racc[pr];
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
  const int run_pages = (a.n_table + cluster - 1) / cluster;
  a.win_pages = min(a.win_pages, run_pages);
  a.chunk_pages = max(1, min(kStageTarget / page_bytes, a.win_pages));
  // A window shorter than the run holds whole ring stages.
  if (a.win_pages < run_pages && a.win_pages % a.chunk_pages != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = layout(a.g, a.d, a.page, a.win_pages, a.chunk_pages * page_bytes,
                          cluster).total;
  if (smem > paged::kSmemMax) return (int)cudaErrorInvalidValue;
  const bool win = a.win_pages < run_pages;
  auto kernel = win ? paged_decode_kernel<T, Pool, true> : paged_decode_kernel<T, Pool, false>;
  static int sized[2] = {paged::kSmemDefault, paged::kSmemDefault};   // largest allowed so far
  if (smem > sized[win]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized[win] = smem;
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
// blocks that share one (slot, kv head), 1, 2, 4 or 8, at most n_table;
// win_pages: the pages of a window, at least a run (ceil(n_table /
// cluster)) when a run fits, else a multiple of the ring's stage pages
// (kernels/paged_attention.py::decode_plan). Returns a CUDA error code (0
// on success).
int paged_attention(const void* q, const void* k_pages, const void* v_pages,
                    const void* k_scales, const void* v_scales,
                    const int* block_tables, const int* lengths,
                    const float* exp_wb, void* out, int B, int H, int Hkv,
                    int D, int page, int n_pool, int n_table, float scale,
                    float softcap, int window, int use_lut, float lo,
                    float inv_step, int sections, int dtype, int pool_fmt,
                    int cluster, int win_pages, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || n_table < 1 || win_pages < 1 ||
      cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) != 0 ||
      cluster > n_table ||
      (use_lut && (exp_wb == nullptr || sections + 2 > paged::kMaxTableRows)))
    return (int)cudaErrorInvalidValue;
  Args a{q, out, (const uint8_t*)k_pages, (const uint8_t*)v_pages, k_scales, v_scales,
         block_tables, lengths, exp_wb, H, Hkv, H / Hkv, D, page, n_pool, n_table,
         scale, softcap, window, use_lut, lo, inv_step, sections, 0, win_pages, 0};
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
