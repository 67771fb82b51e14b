// Chunked paged prefill attention: a chunk of Sq query tokens per sequence
// over the shared KV page pool, causal at absolute positions.
//
// Replaces the TPU kernel src/repro/kernels/paged_prefill.py::
// paged_prefill_attention (Pallas body _paged_prefill_kernel), for pools
// of q's dtype and for int8 / packed int4 pools with scale rows.
//
// q (B, Sq, H, D) at positions start[b] .. start[b] + Sq - 1, pools
// (P, Hkv, page, D) (packed int4: D/2) holding every key in
// [0, length[b]) (the chunk's own K/V already written), block_tables
// (B, n_pages), lengths and starts (B,) int32 -> out (B, Sq, H, D) in q's
// dtype. Per (b, kv head h) there are Sq * g rows; row r is query r / g,
// head h * g + r % g, at position start + r / g, and attends to keys
// k < length with k <= start + r / g. Each row runs the TPU kernel's
// page-ordered online softmax (paged_walk.cuh gives the algebra), so LUT
// mode computes the same function as the Pallas kernel.
//
// What bounds it on the H100: a 64-token chunk of GPT-2 medium does 64
// rows of work per key vector read, still well below the card's ridge,
// so KV bytes bound it at the chunk sizes the engine uses; at so few
// bytes (0.23 us at start 64) latency and parallelism decide the time.
//
// Tensor-core kernel (bf16 q; D of 16, 32, 64 or 128; pages of at most 32
// keys that are whole 16-byte vectors of aligned pools):
//  * Blocks: (b, kv head, 16-row tile) x a cluster of up to 4 blocks, 4
//    warps each. The tile's pages, up to its last query's page (from its
//    first query's window), are cut into one run per warp of the cluster.
//  * Staging: each warp feeds its own ring of 3 page slots with 16-byte
//    cp.async copies of its pages in their storage type (bf16, int8 or
//    packed int4), waited on per thread and joined by __syncwarp: no block
//    barrier inside the walk. A warp waits only on its own copies, so its
//    commit groups do what the decode kernel's mbarriers (shared by a
//    block's threads) do there.
//  * Math: QK^T and P.V are mma.sync m16n8k16 bf16 products with fp32
//    sums. bf16, int8 and int4 payloads are exact in bf16: the scores are
//    taken on the payload and multiplied by each key's scale in fp32, and
//    v_scale is folded into P, which is then split into three bf16 parts
//    (each the bf16 rounding of what the earlier ones leave), three
//    products, so that P keeps f32's precision: with two parts (16 bits)
//    the chunk's outputs flip more bf16 roundings, and a quantized drain's
//    first logits (q1) left their 3e-2 gate.
//  * The LUT function: every run but the last first reads its K to find
//    its maximum a row; after a cluster barrier each run starts its walk
//    from the maximum of the earlier runs (m_{j-1} at its first page), so
//    every corr_j and p sees the page walk's own arguments, and leaves its
//    l, p.V and product of corr. The block merges its warps' runs and
//    block 0 the blocks', in order, by Horner's rule (X = X * C_r + X_r).
//    The decode kernel's prefix-max and suffix-product scans would instead
//    keep every score of a run (16 rows x its keys) until its maximum is
//    known, which grows with the chunk's start; the first pass keeps one
//    maximum a row at the cost of a second read of K
//    (scripts/prefill_max_pass.py times it).
//
// The CUDA-core kernel (f32 q and every other shape): the rows are split
// over blocks of kRows (grid (B, Hkv, ceil(Sq * g / kRows))), each block
// walking the pages up to its own last query position through
// paged_walk.cuh, which stages them as fp32. The wrapper
// (kernels/paged_prefill.py::prefill_plan) picks the kernel and the
// cluster; the C entries check what they are given.
#include <cooperative_groups.h>

#include <type_traits>

#include "hopper.cuh"
#include "paged_walk.cuh"

namespace {

constexpr int kRows = 16;

template <typename T, class Pool>
__global__ void __launch_bounds__(paged::kThreads)
paged_prefill_kernel(const T* __restrict__ q, T* __restrict__ out,
                     const int* __restrict__ starts, paged::Args a, int Sq,
                     int H, int g) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int r0 = blockIdx.z * kRows;
  const int rows = min(kRows, Sq * g - r0);
  const int D = a.d;
  paged::Smem s = paged::carve(smem, kRows, D, a.page, a.chunk_pages);
  const int start = starts[b];
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int rr = r0 + i / D;
    const int dd = i % D;
    s.q[i] = paged::to_f(q[(((size_t)b * Sq + rr / g) * H + h * g + rr % g) * D + dd]);
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) s.qpos[r] = start + (r0 + r) / g;
  if (a.use_lut) {
    for (int i = threadIdx.x; i < 2 * (a.sections + 2); i += blockDim.x) s.wb[i] = a.exp_wb[i];
  }
  __syncthreads();
  paged::walk<Pool>(a, s, b, h, rows, 0, a.n_table);
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D;
    const int rr = r0 + r;
    const int dd = i % D;
    const float l = fmaxf(s.l[r], 1e-9f);
    out[(((size_t)b * Sq + rr / g) * H + h * g + rr % g) * D + dd] =
        paged::from_f<T>(s.acc[i] / l);
  }
}

template <typename T, class Pool>
int launch(const void* q, void* out, const int* starts, paged::Args a,
           int B, int Sq, int H, cudaStream_t stream) {
  a.vec = paged::use_vec<Pool>(a.k_pages, a.v_pages, a.d);
  const int g = H / a.hkv;
  const int smem = paged::smem_bytes(kRows, a.d, a.page, a.chunk_pages);
  if (smem > paged::kSmemDefault) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_kernel<T, Pool>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, a.hkv, (Sq * g + kRows - 1) / kRows);
  paged_prefill_kernel<T, Pool><<<grid, paged::kThreads, smem, stream>>>(
      (const T*)q, (T*)out, starts, a, Sq, H, g);
  return 0;
}


// ---------------------------------------------------------------------------
// Tensor-core kernel
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kTcWarps = 4;        // runs a block
constexpr int kTcStages = 3;       // page slots of a warp's ring
constexpr int kMaxPageTiles = 2;   // 16-key MMA tiles a page: page <= 32
constexpr int kMaxTcCluster = 4;

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A K or V row of the pool in its storage type (paged::Row), read as bf16
// MMA operands: kpair, elements d and d + 1 packed (d even; with int4 they
// lie in the same half, as D % 16 == 0); at, element d in the low half.
// Payload values are exact in bf16; bf16 pools' bits are taken as stored.
template <class Pool>
struct Frag {
  using R = paged::Row<Pool>;
  __device__ __forceinline__ static uint32_t kpair(const uint8_t* row, int d, int D) {
    return pack2(R::at(row, d, D), R::at(row, d + 1, D));
  }
  __device__ __forceinline__ static uint32_t at(const uint8_t* row, int d, int D) {
    return pack2(R::at(row, d, D), 0.0f) & 0xffffu;
  }
};

template <>
struct Frag<paged::FpPool<__nv_bfloat16>> {
  __device__ __forceinline__ static uint32_t kpair(const uint8_t* row, int d, int) {
    return *reinterpret_cast<const uint32_t*>(row + 2 * d);
  }
  __device__ __forceinline__ static uint32_t at(const uint8_t* row, int d, int) {
    return *reinterpret_cast<const uint16_t*>(row + 2 * d);
  }
};

// c[4] += a (16 x 16, row-major fragment) . b (16 x 8, column fragment).
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Floats of one run's results: its product of corr (16 rows), l (16), then
// acc (16 x D).
__host__ __device__ inline int res_floats(int d) { return 32 + 16 * d; }

__host__ __device__ inline int tc_smem_bytes(int d, int page_bytes) {
  return kTcWarps * kTcStages * 2 * page_bytes + 4 * 2 * paged::kMaxTableRows +
         4 * kTcWarps * 16 + 4 * kTcWarps * res_floats(d);
}

template <int D, class Pool>
__global__ void __launch_bounds__(kTcWarps * 32)
prefill_tc_kernel(const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
                  const int* __restrict__ starts, const paged::Args a, int Sq, int H, int g,
                  int tiles) {
  extern __shared__ __align__(16) uint8_t smem_tc[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int blk = blockIdx.x / cs;
  const int tile = blk % tiles;
  const int b = blk / tiles / a.hkv;
  const int h = blk / tiles - b * a.hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tq = lane % 4;
  const int page = a.page;
  const int row_bytes = paged::Row<Pool>::bytes(D);
  const int page_bytes = page * row_bytes;
  const int rows = Sq * g;
  const int r0 = 16 * tile;
  const int start = starts[b];
  const int length = a.lengths[b];

  uint8_t* ring = smem_tc + warp * kTcStages * 2 * page_bytes;
  float* s_wb = reinterpret_cast<float*>(smem_tc + kTcWarps * kTcStages * 2 * page_bytes);
  float* s_bm = s_wb + 2 * paged::kMaxTableRows;          // [warp][16] run maxima
  float* s_res = s_bm + kTcWarps * 16;                    // [warp][res_floats]
  float* res = s_res + warp * res_floats(D);
  if (a.use_lut) lut::stage(s_wb, a.exp_wb, a.sections);

  // This thread's two rows (gid, gid + 8) and their query positions.
  int qpos[2];
  const __nv_bfloat16* qrow[2];
  for (int i = 0; i < 2; ++i) {
    const int rr = r0 + gid + 8 * i;
    qpos[i] = rr < rows ? start + rr / g : -1;
    qrow[i] = rr < rows ? q + (((size_t)b * Sq + rr / g) * H + h * g + rr % g) * D : nullptr;
  }
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const __nv_bfloat16* qr = qrow[f & 1];
      const int d = 16 * kk + 8 * (f >> 1) + 2 * tq;
      const uint32_t lo = qr ? *reinterpret_cast<const uint16_t*>(qr + d) : 0u;
      const uint32_t hi = qr ? *reinterpret_cast<const uint16_t*>(qr + d + 1) : 0u;
      qa[kk][f] = lo | (hi << 16);
    }
  }

  // The tile's pages: from the first query's window to the last query's
  // position; this warp's run of them.
  const int rlast = min(r0 + 15, rows - 1);
  const int kv_end = min(length, start + rlast / g + 1);
  const int n_pg = kv_end > 0 ? min((kv_end + page - 1) / page, a.n_table) : 0;
  const int w_lo = a.window > 0 ? start + r0 / g - a.window + 1 : 0;
  const int p_first = min(max(w_lo, 0) / page, n_pg);
  const int n_runs = cs * kTcWarps;
  const int run = rank * kTcWarps + warp;
  const int pg0 = p_first + run * (n_pg - p_first) / n_runs;
  const int np = p_first + (run + 1) * (n_pg - p_first) / n_runs - pg0;
  const int* tbl = a.block_tables + (size_t)b * a.n_table + pg0;
  const uint8_t* kpool = reinterpret_cast<const uint8_t*>(a.k_pages);
  const uint8_t* vpool = reinterpret_cast<const uint8_t*>(a.v_pages);
  const int vecs = page_bytes / 16;
  const int n_tiles = (page + 15) / 16;

  auto phys_of = [&](int j) {
    const int p = tbl[j];
    return (size_t)((p >= 0 && p < a.n_pool) ? p : 0) * a.hkv + h;
  };
  // Start the copies of run page j (K, and V when with_v) into its slot.
  auto issue = [&](int j, bool with_v) {
    const uint32_t dst = hopper::smem_u32(ring + (j % kTcStages) * 2 * page_bytes);
    const size_t off = phys_of(j) * page_bytes;
    for (int v = lane; v < vecs; v += 32) {
      hopper::cp_async16(dst + 16 * v, kpool + off + 16 * v);
      if (with_v) hopper::cp_async16(dst + page_bytes + 16 * v, vpool + off + 16 * v);
    }
  };
  // The scores of run page j (slot k): s[t][n][e] is row gid + 8 (e / 2),
  // key 16 t + 8 n + 2 tq + e % 2 of the page; -1e30 where masked.
  float s[kMaxPageTiles][2][4];
  auto scores = [&](int j, const uint8_t* k) {
    const size_t pg = phys_of(j);
    const int kpos0 = (pg0 + j) * page;
#pragma unroll
    for (int t = 0; t < kMaxPageTiles; ++t) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (t < n_tiles) {
          const int key = 16 * t + 8 * n + gid;
          const uint8_t* row = k + key * row_bytes;
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t b0 = key < page ? Frag<Pool>::kpair(row, 16 * kk + 2 * tq, D) : 0u;
            const uint32_t b1 =
                key < page ? Frag<Pool>::kpair(row, 16 * kk + 8 + 2 * tq, D) : 0u;
            mma16816(c, qa[kk], b0, b1);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 16 * t + 8 * n + 2 * tq + (e & 1);
          float sc = paged::kNegInf;
          if (t < n_tiles && key < page &&
              paged::key_valid(kpos0 + key, qpos[e >> 1], length, a.window)) {
            sc = c[e] * Pool::scale(a.k_scales, pg * page + key) * a.scale;
            if (a.softcap > 0.0f) sc = a.softcap * tanhf(sc / a.softcap);
          }
          s[t][n][e] = sc;
        }
      }
    }
  };
  // A pass over the run's pages: body(j, slot) once each page has landed.
  auto pass = [&](bool with_v, auto&& body) {
    for (int i = 0; i < kTcStages - 1; ++i) {
      if (i < np) issue(i, with_v);
      hopper::cp_async_commit();
    }
    for (int j = 0; j < np; ++j) {
      if (j + kTcStages - 1 < np) issue(j + kTcStages - 1, with_v);
      hopper::cp_async_commit();
      hopper::cp_async_wait<kTcStages - 1>();
      __syncwarp();
      body(j, ring + (j % kTcStages) * 2 * page_bytes);
      __syncwarp();
    }
    hopper::cp_async_wait<0>();
  };

  // First pass: the run's maximum a row (the last run needs none). Built
  // with PREFILL_NO_MAX_PASS (scripts/prefill_max_pass.py) no run takes it,
  // which times the walk without its second read of K; that build does not
  // compute the function.
#ifdef PREFILL_NO_MAX_PASS
  constexpr bool kMaxPass = false;
#else
  constexpr bool kMaxPass = true;
#endif
  float bm[2] = {paged::kNegInf, paged::kNegInf};
  if (kMaxPass && run < n_runs - 1) {
    pass(false, [&](int j, const uint8_t* k) {
      scores(j, k);
#pragma unroll
      for (int t = 0; t < kMaxPageTiles; ++t)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) bm[e >> 1] = fmaxf(bm[e >> 1], s[t][n][e]);
    });
  }
  bm[0] = quad_max(bm[0]);
  bm[1] = quad_max(bm[1]);
  if (tq == 0) {
    s_bm[warp * 16 + gid] = bm[0];
    s_bm[warp * 16 + gid + 8] = bm[1];
  }
  cluster.sync();

  // The walk from the earlier runs' maximum.
  float m[2] = {paged::kNegInf, paged::kNegInf};
  for (int rk = 0; rk <= rank; ++rk) {
    const float* bmr = cluster.map_shared_rank(s_bm, rk);
    for (int w = 0; w < (rk < rank ? kTcWarps : warp); ++w) {
      m[0] = fmaxf(m[0], bmr[w * 16 + gid]);
      m[1] = fmaxf(m[1], bmr[w * 16 + gid + 8]);
    }
  }
  float l[2] = {0.0f, 0.0f}, C[2] = {1.0f, 1.0f};
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  pass(true, [&](int j, const uint8_t* k) {
    scores(j, k);
    const uint8_t* v = k + page_bytes;
    float pm[2] = {paged::kNegInf, paged::kNegInf};
#pragma unroll
    for (int t = 0; t < kMaxPageTiles; ++t)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pm[e >> 1] = fmaxf(pm[e >> 1], s[t][n][e]);
    float corr[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(pm[i]));
      corr[i] = a.use_lut
                    ? lut::eval(fmaxf(m[i] - m_new, a.lo), s_wb, a.lo, a.inv_step, a.sections)
                    : expf(m[i] - m_new);
      m[i] = m_new;
    }
    const size_t pg = phys_of(j);
    const int kpos0 = (pg0 + j) * page;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
#pragma unroll
    for (int t = 0; t < kMaxPageTiles; ++t) {
      if (t >= n_tiles) continue;
      // p, its row sums, then p * v_scale split into three bf16 parts whose
      // sum holds it to f32's precision.
      uint32_t ph[4], pmid[4], pl[4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float pv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 16 * t + 8 * n + 2 * tq + (e & 1);
          float p = 0.0f;
          if (key < page && paged::key_valid(kpos0 + key, qpos[e >> 1], length, a.window)) {
            const float x = s[t][n][e] - m[e >> 1];
            p = a.use_lut ? lut::eval(x, s_wb, a.lo, a.inv_step, a.sections) : expf(x);
          }
          psum[e >> 1] += p;
          pv[e] = key < page ? p * Pool::scale(a.v_scales, pg * page + key) : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const __nv_bfloat162 hi = __floats2bfloat162_rn(pv[2 * i], pv[2 * i + 1]);
          const float2 hf = __bfloat1622float2(hi);
          const float r0 = pv[2 * i] - hf.x, r1 = pv[2 * i + 1] - hf.y;
          const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
          const float2 mf = __bfloat1622float2(mid);
          ph[2 * n + i] = *reinterpret_cast<const uint32_t*>(&hi);
          pmid[2 * n + i] = *reinterpret_cast<const uint32_t*>(&mid);
          pl[2 * n + i] = pack2(r0 - mf.x, r1 - mf.y);
        }
      }
      // o += P . V over this tile's 16 keys: keys 2 tq (+1) and 8 + 2 tq (+1).
      const int k0 = 16 * t + 2 * tq;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int d = 8 * n + gid;
        uint32_t bv[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int key = k0 + 8 * half;
          const uint32_t x0 = key < page ? Frag<Pool>::at(v + key * row_bytes, d, D) : 0u;
          const uint32_t x1 =
              key + 1 < page ? Frag<Pool>::at(v + (key + 1) * row_bytes, d, D) : 0u;
          bv[half] = x0 | (x1 << 16);
        }
        mma16816(o[n], pl, bv[0], bv[1]);
        mma16816(o[n], pmid, bv[0], bv[1]);
        mma16816(o[n], ph, bv[0], bv[1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = l[i] * corr[i] + quad_sum(psum[i]);
      C[i] *= corr[i];
    }
  });

  // This run's results, then the block's runs merged in order into run 0's.
  if (tq == 0) {
    for (int i = 0; i < 2; ++i) {
      res[gid + 8 * i] = C[i];
      res[16 + gid + 8 * i] = l[i];
    }
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      res[32 + (gid + 8 * (e >> 1)) * D + 8 * n + 2 * tq + (e & 1)] = o[n][e];
  __syncthreads();
  for (int i = tid; i < res_floats(D); i += kTcWarps * 32) {
    const int r = i < 32 ? i % 16 : (i - 32) / D;
    float x = s_res[i];
    for (int w = 1; w < kTcWarps; ++w) {
      const float* rw = s_res + w * res_floats(D);
      x = i < 16 ? x * rw[i] : x * rw[r] + rw[i];
    }
    s_res[i] = x;
  }
  cluster.sync();

  // Block 0 merges the blocks' results in order and writes the rows.
  if (rank == 0) {
    for (int i = tid; i < 16 * D; i += kTcWarps * 32) {
      const int r = i / D;
      const int rr = r0 + r;
      if (rr >= rows) continue;
      float x = s_res[32 + i], lsum = s_res[16 + r];
      for (int rk = 1; rk < cs; ++rk) {
        const float* rb = cluster.map_shared_rank(s_res, rk);
        x = x * rb[r] + rb[32 + i];
        lsum = lsum * rb[r] + rb[16 + r];
      }
      out[(((size_t)b * Sq + rr / g) * H + h * g + rr % g) * D + i % D] =
          __float2bfloat16(x / fmaxf(lsum, 1e-9f));
    }
  }
  // No block leaves while block 0 may still read its results.
  cluster.sync();
}

template <int D, class Pool>
int launch_tc_d(const void* q, void* out, const int* starts, const paged::Args& a, int B,
                int Sq, int H, int cluster, cudaStream_t stream) {
  const int g = H / a.hkv;
  const int tiles = (Sq * g + 15) / 16;
  const int smem = tc_smem_bytes(D, a.page * paged::Row<Pool>::bytes(D));
  if (smem > paged::kSmemMax) return (int)cudaErrorInvalidValue;
  auto kernel = prefill_tc_kernel<D, Pool>;
  static int sized = paged::kSmemDefault;
  if (smem > sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * a.hkv * tiles * cluster), 1, 1);
  cfg.blockDim = dim3(kTcWarps * 32, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, (const __nv_bfloat16*)q, (__nv_bfloat16*)out,
                                 starts, a, Sq, H, g, tiles);
}

template <class Pool>
int launch_tc(const void* q, void* out, const int* starts, const paged::Args& a, int B, int Sq,
              int H, int cluster, cudaStream_t stream) {
  const int pb = a.page * paged::Row<Pool>::bytes(a.d);
  if (pb % 16 != 0 || !common::aligned16(a.k_pages) || !common::aligned16(a.v_pages))
    return (int)cudaErrorInvalidValue;
  switch (a.d) {
    case 16: return launch_tc_d<16, Pool>(q, out, starts, a, B, Sq, H, cluster, stream);
    case 32: return launch_tc_d<32, Pool>(q, out, starts, a, B, Sq, H, cluster, stream);
    case 64: return launch_tc_d<64, Pool>(q, out, starts, a, B, Sq, H, cluster, stream);
    case 128: return launch_tc_d<128, Pool>(q, out, starts, a, B, Sq, H, cluster, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The CUDA-core kernel. Same conventions as paged_attention() in
// paged_attention.cu; starts (B,) int32 is the absolute position of each
// chunk's first query.
int paged_prefill_attention(const void* q, const void* k_pages,
                            const void* v_pages, const void* k_scales,
                            const void* v_scales, const int* block_tables,
                            const int* lengths, const int* starts,
                            const float* exp_wb, void* out, int B, int Sq,
                            int H, int Hkv, int D, int page, int n_pool,
                            int n_table, float scale, float softcap, int window,
                            int use_lut, float lo, float inv_step, int sections,
                            int dtype, int pool_fmt, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || (use_lut && (exp_wb == nullptr ||
      sections + 2 > paged::kMaxTableRows)))
    return (int)cudaErrorInvalidValue;
  const int chunk = paged::pick_chunk(kRows, D, page);
  if (chunk == 0) return (int)cudaErrorInvalidValue;
  paged::Args a{k_pages, v_pages, k_scales, v_scales, block_tables, lengths, exp_wb,
                n_pool, n_table, Hkv, page, D, scale, softcap, window, use_lut, lo,
                inv_step, sections, chunk, 0};
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = paged::dispatch(dtype, pool_fmt, [&](auto tq, auto pool) {
    return launch<decltype(tq), decltype(pool)>(q, out, starts, a, B, Sq, H, s);
  });
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The tensor-core kernel: q bf16 (dtype code 1), D of 16, 32, 64 or 128,
// page <= 32 keys whose payload is a multiple of 16 bytes, 16-byte aligned
// pools; cluster the blocks sharing a row tile (1, 2 or 4). Otherwise as
// paged_prefill_attention().
int paged_prefill_attention_tc(const void* q, const void* k_pages, const void* v_pages,
                               const void* k_scales, const void* v_scales,
                               const int* block_tables, const int* lengths, const int* starts,
                               const float* exp_wb, void* out, int B, int Sq, int H, int Hkv,
                               int D, int page, int n_pool, int n_table, float scale,
                               float softcap, int window, int use_lut, float lo,
                               float inv_step, int sections, int pool_fmt, int cluster,
                               void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || page < 1 || page > 16 * kMaxPageTiles || cluster < 1 ||
      cluster > kMaxTcCluster || (cluster & (cluster - 1)) != 0 ||
      (use_lut && (exp_wb == nullptr || sections + 2 > paged::kMaxTableRows)))
    return (int)cudaErrorInvalidValue;
  paged::Args a{k_pages, v_pages, k_scales, v_scales, block_tables, lengths, exp_wb,
                n_pool, n_table, Hkv, page, D, scale, softcap, window, use_lut, lo,
                inv_step, sections, 0, 1};
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = paged::with_pool<__nv_bfloat16>(pool_fmt, [&](auto, auto pool) {
    return launch_tc<decltype(pool)>(q, out, starts, a, B, Sq, H, cluster, s);
  });
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

const char* paged_prefill_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
