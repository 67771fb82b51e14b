// GEMV/GEMM with fp32 accumulation and a fused bias + activation epilogue.
//
// Replaces the TPU kernel src/repro/kernels/gemv_pim.py::gemv_pim_float
// (Pallas body _gemv_float_kernel, epilogue _epilogue_lut).
//
// out[m, r] = act(sum_c x[m, c] * w[r, c] + bias[r]), x (M, C), w (R, C),
// both row-major in bf16 or f32; out in x's dtype. act is none, the LUT
// interpolation of a piecewise-linear table (lut.cuh, bit-exact to
// apply_table) or the tanh GELU, applied once to the whole fp32 sum.
//
// What bounds it on the H100: at decode widths (M = 4 slots) every weight
// byte is read once for 2 M FLOPs, so the weight stream over HBM
// (3.35 TB/s) is the bound: 2.1 MB for a d x d projection is 0.63 us. At a
// 64-token chunk the FLOPs are 64x as many and would take 8 us on the
// CUDA cores (67 TFLOP/s f32) against 0.5 us on the bf16 tensor cores, so
// the tensor cores are needed to stay on the byte bound.
//
// Tensor-core kernel (bf16, C a multiple of 8, 16-byte aligned operands):
//  * A and B swapped: a 64-row weight tile is the wgmma A operand (M side)
//    and x, padded by TMA's zero fill to N tokens (8, 16, ... 256), is the
//    B operand (N side), so a decode step's 4 tokens waste no 64-row tile.
//    Both are K-major as stored, with 64-element (128-byte) K tiles loaded
//    by TMA with the 128-byte swizzle that the wgmma descriptors name.
//  * One producer warp keeps a ring of up to 8 stages (no more than the
//    block's K tiles, so that small rings let several blocks share an SM)
//    of W and x tiles in flight through TMA and mbarriers; one consumer
//    warpgroup runs 4 m64nNk16 wgmmas a stage into fp32 registers.
//  * Enough blocks: a cluster of up to 8 blocks splits C (R = 1024 gives
//    only 16 row tiles; 8 x 16 blocks then fill the 132 SMs). Each block
//    writes its fp32 partial tile to shared memory; after a cluster barrier
//    each block reduces an equal slice of the tile over distributed shared
//    memory, loading every rank's 16-byte vector first (one round trip)
//    and adding the partials in rank order (no float atomics: two launches
//    give the same bits), then adds the bias and applies the activation
//    once, and writes bf16.
//  * Ragged edges: TMA fills rows past R or M and columns past C with
//    zeros; the epilogue writes only rows < R and tokens < M.
//
// CUDA-core kernel (f32, or C not a multiple of 8, or unaligned): one warp
// owns one output row and walks C with 16-byte loads (the scalar path when
// C is not a multiple of the vector width), keeping 8 rows of x in fp32
// registers per pass. The wrapper (kernels/gemv_pim.py::gemv_plan) picks
// the kernel and the tiling; the C entries check what they are given.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "lut.cuh"
#include "wgmma.cuh"

namespace {

using common::Vec;
using common::from_f;
using common::to_f;

constexpr int kWarps = 8;          // output rows per block
constexpr int kMT = 8;             // x rows per pass
constexpr int kMaxTableRows = lut::kMaxTableRows; // TABLE_PAD of the TPU kernel

enum { ACT_NONE = 0, ACT_LUT = 1, ACT_GELU = 2 };

__device__ __forceinline__ float epilogue(float a, int act, const float* wb,
                                          float lo, float inv_step, int sections) {
  if (act == ACT_LUT) return lut::eval(a, wb, lo, inv_step, sections);
  if (act == ACT_GELU) {
    const float k0 = 0.7978845608028654f;           // sqrt(2 / pi)
    return 0.5f * a * (1.0f + tanhf(k0 * (a + 0.044715f * a * a * a)));
  }
  return a;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
gemv_kernel(const T* __restrict__ x, const T* __restrict__ w,
            const T* __restrict__ bias, const float* __restrict__ table,
            T* __restrict__ out, int M, int C, int R, int act, float lo,
            float inv_step, int sections) {
  __shared__ float wb_s[2 * kMaxTableRows];
  if (act == ACT_LUT) {
    for (int i = threadIdx.x; i < 2 * (sections + 2); i += blockDim.x) wb_s[i] = table[i];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kWarps + warp;
  const int m0 = blockIdx.y * kMT;
  if (r >= R) return;
  const int mt = min(kMT, M - m0);
  const T* wr = w + (size_t)r * C;
  const T* xb = x + (size_t)m0 * C;

  float acc[kMT];
#pragma unroll
  for (int m = 0; m < kMT; ++m) acc[m] = 0.0f;

  if (kVec) {
    constexpr int N = Vec<T>::N;
#pragma unroll 4
    for (int c = lane * N; c < C; c += 32 * N) {
      float wv[N];
      Vec<T>::load(wr + c, wv);
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        if (m < mt) {
          float xv[N];
          Vec<T>::load(xb + (size_t)m * C + c, xv);
#pragma unroll
          for (int j = 0; j < N; ++j) acc[m] = fmaf(xv[j], wv[j], acc[m]);
        }
      }
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      const float wv = to_f(wr[c]);
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        if (m < mt) acc[m] = fmaf(to_f(xb[(size_t)m * C + c]), wv, acc[m]);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kMT; ++m) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
  }
  const float b = bias != nullptr ? to_f(bias[r]) : 0.0f;
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    if (m < mt && lane == m) {
      float a = acc[m] + b;
      a = epilogue(a, act, wb_s, lo, inv_step, sections);
      out[(size_t)(m0 + m) * R + r] = from_f<T>(a);
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, const void* bias, const void* table,
            void* out, int M, int C, int R, int act, float lo, float inv_step,
            int sections, cudaStream_t stream) {
  dim3 grid((R + kWarps - 1) / kWarps, (M + kMT - 1) / kMT);
  dim3 block(kWarps * 32);
  // 16-byte loads need every row of x and w to start on a 16-byte boundary.
  if (C % Vec<T>::N == 0 && common::aligned16(x) && common::aligned16(w)) {
    gemv_kernel<T, true><<<grid, block, 0, stream>>>(
        (const T*)x, (const T*)w, (const T*)bias, (const float*)table, (T*)out,
        M, C, R, act, lo, inv_step, sections);
  } else {
    gemv_kernel<T, false><<<grid, block, 0, stream>>>(
        (const T*)x, (const T*)w, (const T*)bias, (const float*)table, (T*)out,
        M, C, R, act, lo, inv_step, sections);
  }
}


// ---------------------------------------------------------------------------
// Tensor-core kernel
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kTcRows = 64;              // weight rows a block: the wgmma M side
constexpr int kTcK = 64;                 // K tile: 64 bf16, one 128-byte swizzle row
constexpr int kConsumers = 128;          // one warpgroup runs the wgmmas
constexpr int kTcThreads = kConsumers + 32;   // + the producer warp
constexpr int kPartStride = kTcRows + 4; // floats a token row of the partial tile
constexpr int kMaxCluster = 8;

template <int N>
struct TcCfg {
  static constexpr int kMaxStages = N <= 64 ? 8 : (N == 128 ? 6 : 3);
  static constexpr int kWBytes = kTcRows * kTcK * 2;
  static constexpr int kXBytes = N * kTcK * 2;
  static constexpr int kStageBytes = kWBytes + kXBytes;     // a multiple of 1024
  static constexpr int kPartBytes = N * kPartStride * 4;    // aliases the ring
  // The ring holds `stages` stages (at most the K tiles of a block): the
  // data, 2 * stages mbarriers, and room to align the data to 1024 bytes.
  __host__ __device__ static int data_bytes(int stages) {
    return stages * kStageBytes > kPartBytes ? stages * kStageBytes : kPartBytes;
  }
  static int smem_bytes(int stages) { return data_bytes(stages) + 16 * stages + 1024; }
};

template <int N>
__global__ void __launch_bounds__(kTcThreads, 1)
gemv_tc_kernel(const __grid_constant__ CUtensorMap tm_w,
               const __grid_constant__ CUtensorMap tm_x,
               const __nv_bfloat16* __restrict__ bias, const float* __restrict__ table,
               __nv_bfloat16* __restrict__ out, int M, int R, int k_tiles, int stages,
               int act, float lo, float inv_step, int sections) {
  using Cfg = TcCfg<N>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float wb_s[2 * kMaxTableRows];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / cs) * kTcRows;
  const int tok0 = blockIdx.y * N;
  const int kt0 = rank * k_tiles / cs;
  const int nk = (rank + 1) * k_tiles / cs - kt0;
  const int tid = threadIdx.x;

  // The 128-byte swizzle wants 1024-byte aligned tiles.
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* part = reinterpret_cast<float*>(smem_raw + (base - raw));
  const uint32_t full0 = base + Cfg::data_bytes(stages);
  const uint32_t empty0 = full0 + 8 * stages;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(full0 + 8 * s, 1);
      hopper::mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    hopper::mbar_init_fence();
  }
  if (act == ACT_LUT) lut::stage(wb_s, table, sections);
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer warp: one lane keeps the ring full.
    if (tid == kConsumers) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_w))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_x))
                   : "memory");
      for (int i = 0; i < nk; ++i) {
        const int s = i % stages;
        const uint32_t round = i / stages;
        hopper::mbar_wait(empty0 + 8 * s, (round & 1) ^ 1);
        const uint32_t stage = base + s * Cfg::kStageBytes;
        hopper::mbar_expect_tx(full0 + 8 * s, Cfg::kStageBytes);
        hopper::tma_load_2d(stage, &tm_w, full0 + 8 * s, (kt0 + i) * kTcK, row0);
        hopper::tma_load_2d(stage + Cfg::kWBytes, &tm_x, full0 + 8 * s, (kt0 + i) * kTcK,
                            tok0);
      }
    }
    __syncwarp();
  } else {
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
    for (int i = 0; i < nk; ++i) {
      const int s = i % stages;
      hopper::mbar_wait(full0 + 8 * s, (i / stages) & 1);
      const uint32_t a = base + s * Cfg::kStageBytes;
      const uint32_t b = a + Cfg::kWBytes;
      wgmma::fence_regs<N / 2>(acc);
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < kTcK / 16; ++kk)
        wgmma::mma<N>(acc, wgmma::desc_sw128(a + 32 * kk), wgmma::desc_sw128(b + 32 * kk));
      wgmma::commit();
      wgmma::wait_all();
      wgmma::fence_regs<N / 2>(acc);
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
          part[col * kPartStride + row] = acc[4 * c + 2 * i + j];
        }
      }
    }
  }
  cluster.sync();

  // This block's slice of the tile, four rows at a time, summed over the
  // cluster in rank order; every rank's vector is loaded before the sums,
  // so the slice costs one round trip over distributed shared memory.
  constexpr int V = N * kTcRows / 4;
  const int v1 = (rank + 1) * V / cs;
  for (int v = rank * V / cs + tid; v < v1; v += kTcThreads) {
    const int m = v / (kTcRows / 4);
    const int r = 4 * (v - m * (kTcRows / 4));
    const int off = m * kPartStride + r;
    float4 p[kMaxCluster];
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j) {
      if (j < cs) p[j] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, j) + off);
    }
    float sum[4] = {p[0].x, p[0].y, p[0].z, p[0].w};
#pragma unroll
    for (int j = 1; j < kMaxCluster; ++j) {
      if (j < cs) {
        sum[0] += p[j].x;
        sum[1] += p[j].y;
        sum[2] += p[j].z;
        sum[3] += p[j].w;
      }
    }
    const int gm = tok0 + m;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int gr = row0 + r + u;
      if (gr < R && gm < M) {
        float a = sum[u];
        if (bias != nullptr) a += __bfloat162float(bias[gr]);
        a = epilogue(a, act, wb_s, lo, inv_step, sections);
        out[(size_t)gm * R + gr] = __float2bfloat16(a);
      }
    }
  }
  // No block leaves while another may still read its partial tile.
  cluster.sync();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's entry-point
// query, so that the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A (rows, cols) row-major bf16 matrix read in boxes of box_rows x 64.
int tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kTcK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int N>
int launch_tc(const void* x, const void* w, const void* bias, const void* table, void* out,
              int M, int C, int R, int cluster, int act, float lo, float inv_step,
              int sections, cudaStream_t stream) {
  CUtensorMap tm_w, tm_x;
  int rc = tensor_map(&tm_w, w, R, C, kTcRows);
  if (rc == 0) rc = tensor_map(&tm_x, x, M, C, N);
  if (rc != 0) return rc;
  const int k_tiles = (C + kTcK - 1) / kTcK;
  const int per_block = (k_tiles + cluster - 1) / cluster;
  const int stages = per_block < TcCfg<N>::kMaxStages ? per_block : TcCfg<N>::kMaxStages;
  const int smem = TcCfg<N>::smem_bytes(stages);
  auto kernel = gemv_tc_kernel<N>;
  static int sized = 0;             // the largest size allowed so far
  if (smem > sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((R + kTcRows - 1) / kTcRows * cluster),
                     (unsigned)((M + N - 1) / N), 1);
  cfg.blockDim = dim3(kTcThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, tm_w, tm_x, (const __nv_bfloat16*)bias,
                                 (const float*)table, (__nv_bfloat16*)out, M, R, k_tiles,
                                 stages, act, lo, inv_step, sections);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. act: 0 none, 1 LUT table, 2 tanh GELU.
// bias and table may be null. Returns cudaGetLastError().
int gemv_pim_float(const void* x, const void* w, const void* bias,
                   const void* table, void* out, int M, int C, int R, int dtype,
                   int act, float lo, float inv_step, int sections, void* stream) {
  if (act == ACT_LUT && (table == nullptr || sections + 2 > kMaxTableRows))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    launch<__nv_bfloat16>(x, w, bias, table, out, M, C, R, act, lo, inv_step,
                          sections, s);
  } else if (dtype == 0) {
    launch<float>(x, w, bias, table, out, M, C, R, act, lo, inv_step, sections, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The tensor-core kernel: bf16 x (M, C), w (R, C), bias (R,) or null, out
// (M, R). n_tile is the token tile (8, 16, 32, 64, 128 or 256), cluster the
// blocks splitting C (1, 2, 4 or 8, at most the 64-wide K tiles of C); C
// must be a multiple of 8 and x and w 16-byte aligned (TMA). Returns a
// CUDA error code (0 on success).
int gemv_pim_float_tc(const void* x, const void* w, const void* bias, const void* table,
                      void* out, int M, int C, int R, int act, float lo, float inv_step,
                      int sections, int n_tile, int cluster, void* stream) {
  if (act == ACT_LUT && (table == nullptr || sections + 2 > kMaxTableRows))
    return (int)cudaErrorInvalidValue;
  const int k_tiles = (C + kTcK - 1) / kTcK;
  if (M <= 0 || R <= 0 || C <= 0 || C % 8 != 0 || !common::aligned16(x) ||
      !common::aligned16(w) || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0 || cluster > k_tiles)
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto n) {
    return launch_tc<decltype(n)::value>(x, w, bias, table, out, M, C, R, cluster, act, lo,
                                         inv_step, sections, (cudaStream_t)stream);
  };
  int rc;
  switch (n_tile) {
    case 8: rc = run(std::integral_constant<int, 8>{}); break;
    case 16: rc = run(std::integral_constant<int, 16>{}); break;
    case 32: rc = run(std::integral_constant<int, 32>{}); break;
    case 64: rc = run(std::integral_constant<int, 64>{}); break;
    case 128: rc = run(std::integral_constant<int, 128>{}); break;
    case 256: rc = run(std::integral_constant<int, 256>{}); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

const char* gemv_pim_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
