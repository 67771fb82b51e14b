// The tensor-core GEMV skeleton shared by gemv_pim_float (gemv_pim.cu,
// bf16 -> f32 sums), gemv_pim_int8 (gemv_pim_quant.cu, s8 -> exact s32
// sums) and gemv_pim_fixed (gemv_pim_quant.cu, int16 products as four
// byte-plane products -> uint32 sums modulo 2^32):
// out[m, r] = epilogue(sum_c x[m, c] w[r, c]); gemv_pim_int8_linear (the
// same file) quantizes x in its load path through the policy hooks below.
//
//  * A and B swapped: a 64-row weight tile is the wgmma A operand (M side)
//    and x, padded by TMA's zero fill to N tokens (8, 16, ... 256), is the
//    B operand (N side), so a decode step's 4 tokens waste no 64-row tile.
//    Both are K-major as stored, loaded by TMA with the 128-byte swizzle
//    in boxes of one 128-byte swizzle row (64 bf16, 128 int8), a stage
//    holding one such box of each operand or, for the fixed GEMV, as many
//    as cover 128 K elements of its source type.
//  * One producer warp keeps a ring of up to 8 stages (no more than the
//    block's K tiles, so that small rings let several blocks share an SM)
//    of W and x tiles in flight through TMA and mbarriers; one consumer
//    warpgroup runs the stage's product through the epilogue's Mma policy
//    (DirectMma: 4 wgmmas a stage, m64nNk16 bf16 or m64nNk32 s8, straight
//    from the ring into registers of the accumulator type; the fixed
//    GEMV's policy first splits the tiles into byte planes, W's into the
//    wgmma A registers and x's into shared memory, and runs 16 wgmmas).
//  * Enough blocks: a cluster of up to 8 blocks splits C (R = 1024 gives
//    only 16 row tiles; 8 x 16 blocks then fill the 132 SMs). Each block
//    writes its partial tile to shared memory; after a cluster barrier
//    each block reduces an equal slice of the tile over distributed shared
//    memory, loading every rank's 16-byte vector first (one round trip)
//    and adding the partials in rank order (no atomics: two launches give
//    the same bits; integer sums are exact in any order), then hands each
//    four rows' sums to the epilogue once.
//  * Ragged edges: TMA fills rows past R or M and columns past C with
//    zeros; the epilogue sees only rows < R and tokens < M.
//
// An epilogue type Epi names its Mma policy (template <int N> using Mma),
// the operands' TMA element type (kType) and size (kElem bytes), its
// shared memory (Smem), stage(Smem&) run by every thread before the first
// barrier, and operator()(const Smem&, const Acc (&sum)[4], m, r), which
// writes out[m, r + u] = f(sum[u]) for the u < 4 with r + u < R (Acc the
// policy's accumulator type: float, int or unsigned).
//
// A Mma policy holds the consumer's accumulators: Acc; kBoxes and
// kXBoxes, the TMA boxes of W and of x a stage (kXBoxes 0: x does not ride
// the ring); kK, the K elements a stage; plane_bytes(nk), the shared memory
// of its own beside the ring for a block of nk K tiles; kPrologue, whether
// the consumers run preload(epi, kt0, nk, M) first thing (before the
// block's first barrier) and prologue(epi, es, planes, kt0, nk, M) before
// the first stage; init();
// step(epi, w, x, planes, i), which adds stage i's product (w and x the
// shared-memory addresses of the stage's tiles, planes that of its own
// memory) and leaves the stage free to refill; and value(j), the j-th
// accumulator of this thread's fragment.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "wgmma.cuh"

namespace gemv_tc {

namespace cg = cooperative_groups;

constexpr int kRows = 64;                // weight rows a block: the wgmma M side
constexpr int kKBytes = 128;             // K tile: one 128-byte swizzle row
constexpr int kConsumers = 128;          // one warpgroup runs the wgmmas
constexpr int kThreads = kConsumers + 32;     // + the producer warp
constexpr int kPartStride = kRows + 4;   // accumulators a token row of the partial tile
constexpr int kMaxCluster = 8;

// Dynamic shared memory a block may use: the card's 232448 bytes less
// room for the epilogue's static Smem (a LUT table: 1 KB).
constexpr int kSmemMax = 232448 - 4096;

// The default policy: each stage's K tile goes straight from the ring to
// 4 wgmmas (32 bytes of K each) into registers of the epilogue's Acc.
template <class Epi, int N>
struct DirectMma {
  using Acc = typename Epi::Acc;
  static constexpr int kBoxes = 1;
  static constexpr int kXBoxes = 1;
  static constexpr int kK = kKBytes / Epi::kElem;
  static constexpr bool kPrologue = false;
  __host__ __device__ static int plane_bytes(int) { return 0; }
  Acc acc[N / 2];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  }
  __device__ __forceinline__ void step(const Epi&, uint32_t w, uint32_t x, uint32_t, int) {
    wgmma::fence_regs<N / 2>(acc);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma::mma<N>(acc, wgmma::desc_sw128(w + 32 * kk), wgmma::desc_sw128(x + 32 * kk));
    wgmma::commit();
    wgmma::wait_all();
    wgmma::fence_regs<N / 2>(acc);
  }
  __device__ __forceinline__ Acc value(int i) const { return acc[i]; }
};

template <class Mma, int N>
struct Cfg {
  static constexpr int kMaxStages = N <= 64 ? 8 : (N == 128 ? 6 : 3);
  static constexpr int kWBytes = Mma::kBoxes * kRows * kKBytes;
  static constexpr int kXBytes = Mma::kXBoxes * N * kKBytes;
  static constexpr int kStageBytes = kWBytes + kXBytes;     // a multiple of 1024
  static constexpr int kPartBytes = N * kPartStride * 4;    // aliases the ring
  // The ring holds `stages` stages (at most the K tiles of a block), then
  // the policy's planes for a block of nk K tiles (1024-byte aligned),
  // 2 * stages mbarriers, and room to align the data to 1024 bytes.
  __host__ __device__ static int data_bytes(int stages) {
    const int d = stages * kStageBytes > kPartBytes ? stages * kStageBytes : kPartBytes;
    return (d + 1023) & ~1023;
  }
  static int smem_bytes(int stages, int nk) {
    return data_bytes(stages) + Mma::plane_bytes(nk) + 16 * stages + 1024;
  }
  // The most stages that fit beside the planes.
  static int max_stages(int nk) {
    int s = kMaxStages;
    while (s > 1 && smem_bytes(s, nk) > kSmemMax) --s;
    return s;
  }
};

template <class Epi, int N>
__global__ void __launch_bounds__(kThreads, 1)
kernel(const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_x,
       const Epi epi, int M, int k_tiles, int stages) {
  using Mma = typename Epi::template Mma<N>;
  using C = Cfg<Mma, N>;
  using Acc = typename Mma::Acc;
  using Acc4 = std::conditional_t<std::is_same<Acc, float>::value, float4,
                                  std::conditional_t<std::is_same<Acc, int>::value, int4, uint4>>;
  constexpr int kK = Mma::kK;                        // K elements a stage
  constexpr int kBoxK = kKBytes / Epi::kElem;        // K elements a TMA box
  extern __shared__ uint8_t smem_raw[];
  __shared__ typename Epi::Smem es;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / cs) * kRows;
  const int tok0 = blockIdx.y * N;
  const int kt0 = rank * k_tiles / cs;
  const int nk = (rank + 1) * k_tiles / cs - kt0;
  const int per_block = (k_tiles + cs - 1) / cs;    // the most K tiles a rank holds
  const int tid = threadIdx.x;
  // A kernel launched after this one with programmatic stream
  // serialization (a weight's quantize_int8_rows) may start now; it waits
  // for this grid before it writes.
  hopper::pdl_launch_dependents();

  // The 128-byte swizzle wants 1024-byte aligned tiles.
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  Acc* part = reinterpret_cast<Acc*>(smem_raw + (base - raw));
  const uint32_t planes = base + C::data_bytes(stages);
  const uint32_t full0 = planes + Mma::plane_bytes(per_block);
  const uint32_t empty0 = full0 + 8 * stages;
  Mma mma;
  if constexpr (Mma::kPrologue) {
    if (tid < kConsumers) mma.preload(epi, kt0, nk, M);
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(full0 + 8 * s, 1);
      hopper::mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    hopper::mbar_init_fence();
  }
  epi.stage(es);
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer warp: one lane keeps the ring full (W alone, or W and x).
    if (tid == kConsumers) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_w))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_x))
                   : "memory");
      for (int i = 0; i < nk; ++i) {
        const int s = i % stages;
        const uint32_t round = i / stages;
        hopper::mbar_wait(empty0 + 8 * s, (round & 1) ^ 1);
        const uint32_t stage = base + s * C::kStageBytes;
        hopper::mbar_expect_tx(full0 + 8 * s, C::kStageBytes);
#pragma unroll
        for (int b = 0; b < Mma::kBoxes; ++b) {
          const int k = (kt0 + i) * kK + b * kBoxK;
          hopper::tma_load_2d(stage + b * kRows * kKBytes, &tm_w, full0 + 8 * s, k, row0);
          if constexpr (Mma::kXBoxes > 0)
            hopper::tma_load_2d(stage + C::kWBytes + b * N * kKBytes, &tm_x, full0 + 8 * s, k,
                                tok0);
        }
      }
    }
    __syncwarp();
  } else {
    mma.init();
    if constexpr (Mma::kPrologue) mma.prologue(epi, es, planes, kt0, nk, M);
    for (int i = 0; i < nk; ++i) {
      const int s = i % stages;
      hopper::mbar_wait(full0 + 8 * s, (i / stages) & 1);
      const uint32_t a = base + s * C::kStageBytes;
      mma.step(epi, a, a + C::kWBytes, planes, i);
      if (tid % 32 == 0) hopper::mbar_arrive(empty0 + 8 * s);
    }
    // The partial tile, token-major (part[token][row]), in the ring that
    // every consumer warp is done with.
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    const int w = tid / 32, l = tid % 32;
#pragma unroll
    for (int c = 0; c < N / 8; ++c) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int row = 16 * w + l / 4 + 8 * i;
          const int col = 8 * c + 2 * (l % 4) + j;
          part[col * kPartStride + row] = mma.value(4 * c + 2 * i + j);
        }
      }
    }
  }
  cluster.sync();

  // This block's slice of the tile, four rows at a time, summed over the
  // cluster in rank order; every rank's vector is loaded before the sums,
  // so the slice costs one round trip over distributed shared memory.
  constexpr int V = N * kRows / 4;
  const int v1 = (rank + 1) * V / cs;
  for (int v = rank * V / cs + tid; v < v1; v += kThreads) {
    const int m = v / (kRows / 4);
    const int r = 4 * (v - m * (kRows / 4));
    const int off = m * kPartStride + r;
    Acc4 p[kMaxCluster];
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j) {
      if (j < cs) p[j] = *reinterpret_cast<const Acc4*>(cluster.map_shared_rank(part, j) + off);
    }
    Acc sum[4] = {p[0].x, p[0].y, p[0].z, p[0].w};
#pragma unroll
    for (int j = 1; j < kMaxCluster; ++j) {
      if (j < cs) {
        sum[0] += p[j].x;
        sum[1] += p[j].y;
        sum[2] += p[j].z;
        sum[3] += p[j].w;
      }
    }
    if (tok0 + m < M) epi(es, sum, tok0 + m, row0 + r);
  }
  // No block leaves while another may still read its partial tile.
  cluster.sync();
}

template <class Epi, int N>
int launch(const void* x, const void* w, const Epi& epi, int M, int C, int R, int cluster,
           cudaStream_t stream) {
  using Mma = typename Epi::template Mma<N>;
  using Cf = Cfg<Mma, N>;
  constexpr int kK = Mma::kK;
  constexpr int kBoxK = kKBytes / Epi::kElem;
  CUtensorMap tm_w, tm_x;
  int rc = hopper::tensor_map_2d(&tm_w, w, Epi::kType, Epi::kElem, R, C, kBoxK, kRows);
  if (rc == 0) {
    if constexpr (Mma::kXBoxes > 0)
      rc = hopper::tensor_map_2d(&tm_x, x, Epi::kType, Epi::kElem, M, C, kBoxK, N);
    else
      tm_x = tm_w;              // unused: x does not ride the ring
  }
  if (rc != 0) return rc;
  const int k_tiles = (C + kK - 1) / kK;
  const int per_block = (k_tiles + cluster - 1) / cluster;
  const int most = Cf::max_stages(per_block);
  const int stages = per_block < most ? per_block : most;
  const int smem = Cf::smem_bytes(stages, per_block);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  auto kern = kernel<Epi, N>;
  static int sized = 0;             // the largest size allowed so far
  if (smem > sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((R + kRows - 1) / kRows * cluster), (unsigned)((M + N - 1) / N),
                     1);
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
  return (int)cudaLaunchKernelEx(&cfg, kern, tm_w, tm_x, epi, M, k_tiles, stages);
}

// The C entries' checks and launch: x (M, C) and w (R, C) row-major,
// 16-byte aligned, rows of whole 16-byte vectors (TMA's stride rule);
// n_tile the token tile (8, 16, 32, 64, 128 or 256; at most kMaxN),
// cluster the blocks splitting C (1, 2, 4 or 8, at most the K tiles of
// C). Returns a CUDA error code (0 on success).
template <class Epi, int kMaxN = 256>
int run(const void* x, const void* w, const Epi& epi, int M, int C, int R, int n_tile,
        int cluster, void* stream) {
  constexpr int kK = Epi::template Mma<8>::kK;
  const int k_tiles = (C + kK - 1) / kK;
  if (M <= 0 || R <= 0 || C <= 0 || (C * Epi::kElem) % 16 != 0 || !common::aligned16(x) ||
      !common::aligned16(w) || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0 || cluster > k_tiles)
    return (int)cudaErrorInvalidValue;
  if (n_tile > kMaxN) return (int)cudaErrorInvalidValue;
  auto go = [&](auto n) {
    constexpr int kN = decltype(n)::value <= kMaxN ? decltype(n)::value : kMaxN;
    return launch<Epi, kN>(x, w, epi, M, C, R, cluster, (cudaStream_t)stream);
  };
  int rc;
  switch (n_tile) {
    case 8: rc = go(std::integral_constant<int, 8>{}); break;
    case 16: rc = go(std::integral_constant<int, 16>{}); break;
    case 32: rc = go(std::integral_constant<int, 32>{}); break;
    case 64: rc = go(std::integral_constant<int, 64>{}); break;
    case 128: rc = go(std::integral_constant<int, 128>{}); break;
    case 256: rc = go(std::integral_constant<int, 256>{}); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // namespace gemv_tc
