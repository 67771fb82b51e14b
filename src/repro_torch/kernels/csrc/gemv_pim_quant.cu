// The quantized GEMVs of the S-ALU datapath: int8 with row scales, and
// Q-format fixed16 with a wrapping int32 accumulator, shift and saturate,
// each with the linear layer's epilogue (bias, cast, LUT activation).
//
// Replaces the TPU kernels src/repro/kernels/gemv_pim.py::gemv_pim_int8
// (Pallas body _gemv_int8_kernel) and ::gemv_pim_fixed (body
// _gemv_fixed_kernel), held bit for bit to ref.gemv_pim_int8_ref and
// ref.gemv_pim_fixed_ref through the plain versions in gemv_pim.py, and
// the XLA ops around them in core/salpim.py::SalPimEngine.linear.
//
// gemv_pim_int8: x (M, C) int8, x_scale (M,), w (R, C) int8, w_scale (R,),
// optional bias (R,) (each vector f32 or bf16) -> out (M, R) in f32 or bf16,
//   a = ((float)sum_c x[m, c] w[r, c] * x_scale[m]) * w_scale[r] (+ bias[r]),
//   out[m, r] = lut(round(a)) or round(a), round to out's dtype,
// the sum exact in int32 (|sum| < 2^26 at C = 4096), each float operation
// rounded on its own (__fmul_rn and __fadd_rn keep nvcc from contracting
// the bias add into an FMA), the LUT (lut.cuh) applied to the value in
// out's dtype, as SalPimEngine.linear applies it after the cast.
//
// gemv_pim_fixed: x (M, C) int16, w (R, C) int16 -> out (M, R) int16,
//   out[m, r] = clip((int32)(sum_c x[m, c] w[r, c] mod 2^32) >> shift, -32768, 32767).
// Each int16 product fits in int32 (at most 2^30), but a sum over C = 4096
// can pass 2^31: XLA's int32 dot wraps modulo 2^32, so the sum runs in
// uint32 (defined wrap-around; signed overflow is undefined in C++) and
// is reinterpreted as int32 before the arithmetic shift.
//
// gemv_pim_fixed_linear: the fixed16 linear layer in one launch. x (M, C)
// and w (R, C) in f32 or bf16 are quantized in the load path, q =
// clip(rint(v * 2^frac), -32768, 32767) with frac_x for x and frac_w for
// w: bit for bit QFormat.quantize (the power-of-two scaling is exact in
// f32, rint rounds half to even as torch.round does). The sum as above,
// >> frac_w, saturated to int16, times 2^-frac_x (exact), rounded to x's
// dtype, + bias rounded to x's dtype (an f32 add rounded once, as
// PyTorch's bf16 add), then optionally the LUT on that value.
//
// What bounds them on the H100: at decode widths every weight element is
// read once for two integer operations a row of x, so all are bound by
// the weight stream over HBM (3.35 TB/s): 1 byte an element for int8
// (plus the scales), 2 for a bf16 or int16 weight of the fixed GEMV. At a
// 64-token chunk the operations are 64x as many: the 8-bit tensor cores
// keep both on the byte bound, where the CUDA cores would not.
//
// Tensor cores (C a multiple of 16, 16-byte aligned x and w): the wgmma
// skeleton of gemv_tc.cuh, which the float GEMV shares. int8: s8 operands
// straight from the TMA ring (128-element K tiles, m64nNk32 s8 wgmmas into
// int32 registers); the cluster's int32 partial tiles sum exactly, so
// their order does not matter. fixed16: there is no 16-bit integer mode,
// but an int16 product splits into four 8-bit ones. With v = 256 hi + lo,
// hi = v >> 8 (s8) and lo = v & 0xFF (u8, never sign-extended),
//   x w = 65536 xh wh + 256 (xh wl + xl wh) + xl wl,
// so the consumer warpgroup quantizes each stage's W and x tiles (bf16,
// f32 or int16 as TMA brought them), splits W's straight into the wgmma A
// fragments in registers and writes x's hi and lo byte planes to shared
// memory in the 128-byte swizzle of the s8 descriptors (two plane
// buffers, so one barrier a stage), and runs 16 wgmmas a stage (s8.s8,
// s8.u8, u8.s8, u8.u8) into three s32 accumulator sets. The
// accumulators hold at most 2^28 at C = 4096 and wrap past 2^31 anyway
// (no .satfinite); the epilogue combines them in uint32, so every step is
// arithmetic modulo 2^32 and the sum equals XLA's wrapping int32 dot. The
// token tile stops at 64 (three accumulator sets of 32 registers).
//
// CUDA cores (C not a multiple of 16, or a misaligned row): one warp owns
// one output row and walks C with 16-byte loads (16 int8, 8 int16 or
// bf16, 4 f32 elements a lane; the fixed kernel quantizes each element as
// it loads it), keeping kMT rows of x per pass, grid.y covering M in
// tiles of kMT rows; the ragged edge of R and M is masked, and C that is
// not a multiple of the vector width (or a misaligned row) takes the
// scalar path. int8 sums four bytes at a time with __dp4a.
//
// gemv_pim_int8_linear: the int8 linear layer in one launch at decode
// widths (one token tile holds all of M, and a block's share of x is at
// most kMaxXPieces pieces of 16 elements): x (M, C) in f32 or bf16 is
// quantized per row inside the kernel, as quantize_int8_rows below does
// (in x's dtype, or in f32 for bf16 x), then the s8 product and the int8
// epilogue with each row's scale from shared memory. Each block loads its
// C-share of x (its first 4 pieces a consumer thread) into registers first
// thing, takes each row's absmax (from those pieces when they are its
// whole rows, else reading its rows whole: x is a few rows, in L2) and
// quantizes its share (any further pieces loaded as it goes) straight
// into the swizzled s8
// tiles that its wgmmas read (x stays in shared memory for the whole K
// loop, so only W rides the TMA ring, whose loads start while x is
// quantized).
//
// quantize_int8_rows: x (rows, C) in f32 or bf16 -> q int8 (rows, C) and
// scale (rows,) in the compute dtype CT (x's, or f32 for bf16 x),
// core/quant.py::quantize_int8_rows of x cast to CT: absmax, scale =
// max(absmax, 1e-8) / 127, q = clip(round(x / scale), +-127). Each step
// rounds as PyTorch's kernels do in CT: in bf16 the division is an f32
// division rounded to bf16, round() is half to even, so the result is bit
// for bit the plain function's. The quotient is x * r corrected once by an
// FMA (r the correctly rounded 1 / scale, one a row), which gives the
// correctly rounded x / scale where a full division costs some ten
// instructions; the card tests hold it bit for bit to the plain function
// over every bf16 value. Bound by bytes (reading x, writing q: 3 bytes an
// element of a bf16 weight), at about 10^12 elements a second on the H100.
// The design is the row kernels' (softmax_lut.cu, layernorm_lut.cu): a row
// is held in the registers of a group of 1-8 warps, read once in 16-byte
// pieces, its absmax taken by shuffle trees with max.NaN (one barrier
// across a group's warps), quantized from the registers and stored in
// packed 4- or 8-byte pieces; quant_plan in kernels/gemv_pim.py picks the
// group and the groups a block, a persistent grid that fills the card
// once walks the rows, and a call of few rows (x of a decode step) is
// spread over more warps. Rows too wide for 8 warps' registers are
// streamed by a block, read twice.
#include "common.cuh"
#include "gemv_tc.cuh"
#include "lut.cuh"

namespace {

constexpr int kWarps = 8;   // output rows per block
constexpr int kMT = 8;      // x rows per pass
constexpr int kFixedMaxN = 64;   // token tile of the fixed16 tensor-core kernel

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// v rounded to the output's dtype: bf16 or, when bf is false, f32.
__device__ __forceinline__ float round_to_out(float v, int bf) { return bf ? round_bf16(v) : v; }

// ---------------------------------------------------------------------------
// The int8 row quantization's arithmetic, in CT (float or bf16)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) { return round_bf16(v); }

// max and min that keep a NaN, as torch's amax and clamp do (fmaxf and
// fminf drop it); one instruction each, as fmaxf and fminf are.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
struct MaxNan {
  __device__ __forceinline__ float operator()(float a, float b) const { return max_nan(a, b); }
};

// A row's scale from its absmax (exact in any dtype): clamp(absmax,
// min=1e-8) against 1e-8 rounded to CT, then / 127 rounded to CT. A row
// holding a NaN gets a NaN scale, one holding an inf an inf scale.
template <typename CT>
__device__ __forceinline__ float row_scale(float amax) {
  const float lo = round_to(1e-8f, CT{});
  return round_to(__fdiv_rn(max_nan(amax, lo), 127.0f), CT{});
}

// x / s rounded to nearest, from r = 1 / s rounded to nearest (__frcp_rn):
// q0 = x r, its remainder x - q0 s (exact in one FMA) and one correction
// q0 + (x - q0 s) r (Markstein): three instructions where __fdiv_rn takes
// some ten. Markstein's theorem asks for a faithful q0, which x r rounded
// once may miss by an ulp; tests/test_torch_kernels.py holds the result to
// the division on the card over every bf16 x and absmax, in bf16 and in
// f32, and over f32 ties, near-ties and the 1e-8 floor.
__device__ __forceinline__ float div_by(float x, float s, float r) {
  const float q0 = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q0, s, x), r, q0);
}

// The int8 value of x in the low byte of the result: clip(round(x / s),
// +-127), the quotient rounded to CT and then to an integer, half to even.
// With a finite scale every quotient is finite (|x| <= absmax): clamped,
// then rounded by adding 1.5 * 2^23, whose float's low byte is then the
// int8 value. A NaN or inf scale takes the conversion, which turns a NaN
// quotient into 0 as torch's int8 conversion does.
__device__ __forceinline__ uint32_t q8_of(float v, bool finite) {
  if (finite) return __float_as_uint(__fadd_rn(fminf(fmaxf(v, -127.0f), 127.0f), 12582912.0f));
  return (uint32_t)min(max(__float2int_rn(v), -127), 127);
}
template <typename CT>
__device__ __forceinline__ uint32_t q8(float x, float s, float r, bool finite) {
  return q8_of(round_to(div_by(x, s, r), CT{}), finite);
}
// Two at a time: in bf16 the two quotients round in one packed conversion.
template <typename CT>
__device__ __forceinline__ void q8x2(float x0, float x1, float s, float r, bool finite,
                                     uint32_t& b0, uint32_t& b1) {
  float v0 = div_by(x0, s, r), v1 = div_by(x1, s, r);
  if constexpr (std::is_same<CT, __nv_bfloat16>::value) {
    const float2 f = __bfloat1622float2(__floats2bfloat162_rn(v0, v1));
    v0 = f.x;
    v1 = f.y;
  }
  b0 = q8_of(v0, finite);
  b1 = q8_of(v1, finite);
}

// The low bytes of four words, in order, as one word.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// Element i of an f32 (bf == 0) or bf16 (bf == 1) vector, as f32.
__device__ __forceinline__ float load_f(const void* p, size_t i, int bf) {
  return bf ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
            : reinterpret_cast<const float*>(p)[i];
}
__device__ __forceinline__ void store_f(void* p, size_t i, int bf, float v) {
  if (bf) reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else reinterpret_cast<float*>(p)[i] = v;
}

// ---------------------------------------------------------------------------
// The epilogues, one for both routes of each GEMV
// ---------------------------------------------------------------------------

// int8: the scales (f32 or bf16), the bias (f32 or bf16), the cast to
// out's dtype and the LUT on the cast value.
struct Int8Out {
  const void* x_scale;
  const void* w_scale;
  const void* bias;       // or null
  const float* table;     // the LUT's (slope, intercept) rows, when act
  void* out;
  int R, xs_bf, ws_bf, bias_bf, out_bf, act;
  float lo, inv_step;
  int sections;
  // xs: x's scale of row m (x_scale[m], or from shared memory where x is
  // quantized in the kernel).
  __device__ __forceinline__ void store(int acc, float xs, int m, int r, const float* wb) const {
    float a = __fmul_rn(__fmul_rn((float)acc, xs), load_f(w_scale, r, ws_bf));
    if (bias != nullptr) a = __fadd_rn(a, load_f(bias, r, bias_bf));
    a = round_to_out(a, out_bf);
    if (act) a = lut::eval(a, wb, lo, inv_step, sections);
    store_f(out, (size_t)m * R + r, out_bf, a);
  }
};

// fixed16: the writeback (>> shift, saturate), then either the int16
// value (kind 2) or its dequantization in f32 (kind 0) or bf16 (kind 1)
// with the bias and the LUT.
struct FixedOut {
  void* out;
  const void* bias;       // or null
  const float* table;     // the LUT's rows, when act
  int R, shift, kind, bias_bf, act;
  float x_inv;            // 2^-frac_x
  float lo, inv_step;
  int sections;
  __device__ __forceinline__ void store(unsigned sum, int m, int r, const float* wb) const {
    const int s = min(max((int)sum >> shift, -32768), 32767);   // arithmetic shift
    const size_t i = (size_t)m * R + r;
    if (kind == 2) {
      reinterpret_cast<int16_t*>(out)[i] = (int16_t)s;
      return;
    }
    const int bf = kind;
    float v = round_to_out(__fmul_rn((float)s, x_inv), bf);
    if (bias != nullptr)
      v = round_to_out(__fadd_rn(v, round_to_out(load_f(bias, r, bias_bf), bf)), bf);
    if (act) v = lut::eval(v, wb, lo, inv_step, sections);
    store_f(out, i, bf, v);
  }
};

// ---------------------------------------------------------------------------
// Q-format quantization in the load path
// ---------------------------------------------------------------------------

// QFormat.quantize of one f32 value: rint(v * 2^frac) (mul = 2^frac,
// exact), saturated to int16 (the int32 conversion saturates first).
__device__ __forceinline__ int q16(float v, float mul) {
  return min(max(__float2int_rn(__fmul_rn(v, mul)), -32768), 32767);
}
__device__ __forceinline__ unsigned pack16(int a, int b) {
  return ((unsigned)a & 0xffffu) | ((unsigned)b << 16);
}

// Sixteen bytes of a source row as int16 values packed in pairs (element
// 2k in the low half of word k): int16 as it is, bf16 and f32 quantized.
template <typename Src> struct Quant;
template <> struct Quant<int16_t> {
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_UINT16;
  static constexpr int kWords = 4;
  __device__ __forceinline__ static void words(const uint4& v, float, unsigned* w) {
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
  __device__ __forceinline__ static void words4(const uint2& v, float, unsigned* w) {
    w[0] = v.x; w[1] = v.y;
  }
  __device__ __forceinline__ static int one(int16_t v, float) { return v; }
};
template <> struct Quant<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr int kWords = 4;
  __device__ __forceinline__ static void words(const uint4& v, float mul, unsigned* w) {
    const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = pack16(q16(__uint_as_float(u[k] << 16), mul),
                    q16(__uint_as_float(u[k] & 0xffff0000u), mul));
  }
  __device__ __forceinline__ static void words4(const uint2& v, float mul, unsigned* w) {
    const unsigned u[2] = {v.x, v.y};
#pragma unroll
    for (int k = 0; k < 2; ++k)
      w[k] = pack16(q16(__uint_as_float(u[k] << 16), mul),
                    q16(__uint_as_float(u[k] & 0xffff0000u), mul));
  }
  __device__ __forceinline__ static int one(__nv_bfloat16 v, float mul) {
    return q16(__bfloat162float(v), mul);
  }
};
template <> struct Quant<float> {
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static constexpr int kWords = 2;
  __device__ __forceinline__ static void words(const uint4& v, float mul, unsigned* w) {
    w[0] = pack16(q16(__uint_as_float(v.x), mul), q16(__uint_as_float(v.y), mul));
    w[1] = pack16(q16(__uint_as_float(v.z), mul), q16(__uint_as_float(v.w), mul));
  }
  __device__ __forceinline__ static void words4(const uint4& v, float mul, unsigned* w) {
    words(v, mul, w);
  }
  __device__ __forceinline__ static int one(float v, float mul) { return q16(v, mul); }
};

// Sign-extend the two int16 halves of a 32-bit word.
__device__ __forceinline__ int lo16(unsigned u) { return (int)(int16_t)(u & 0xffffu); }
__device__ __forceinline__ int hi16(unsigned u) { return (int)u >> 16; }

// ---------------------------------------------------------------------------
// CUDA-core kernels
// ---------------------------------------------------------------------------

template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
gemv_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, const Int8Out o,
                 int M, int C) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kWarps + warp;
  const int m0 = blockIdx.y * kMT;
  if (r >= o.R) return;
  const int mt = min(kMT, M - m0);
  const int8_t* wr = w + (size_t)r * C;
  const int8_t* xb = x + (size_t)m0 * C;

  int acc[kMT];
#pragma unroll
  for (int m = 0; m < kMT; ++m) acc[m] = 0;

  if (kVec) {
#pragma unroll 4
    for (int c = lane * 16; c < C; c += 32 * 16) {
      const int4 wv = *reinterpret_cast<const int4*>(wr + c);
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        if (m < mt) {
          const int4 xv = *reinterpret_cast<const int4*>(xb + (size_t)m * C + c);
          acc[m] = __dp4a(xv.x, wv.x, acc[m]);
          acc[m] = __dp4a(xv.y, wv.y, acc[m]);
          acc[m] = __dp4a(xv.z, wv.z, acc[m]);
          acc[m] = __dp4a(xv.w, wv.w, acc[m]);
        }
      }
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      const int wv = wr[c];
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        if (m < mt) acc[m] = (int)((unsigned)acc[m] + (unsigned)(xb[(size_t)m * C + c] * wv));
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kMT; ++m) acc[m] = (int)warp_sum((unsigned)acc[m]);
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    if (m < mt && lane == m) o.store(acc[m], load_f(o.x_scale, m0 + m, o.xs_bf), m0 + m, r, o.table);
  }
}

// x_mul and w_mul: 2^frac_x and 2^frac_w (unused for int16 operands).
template <typename Src, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
gemv_fixed_kernel(const Src* __restrict__ x, const Src* __restrict__ w, const FixedOut o,
                  float x_mul, float w_mul, int M, int C) {
  using Q = Quant<Src>;
  constexpr int V = 16 / (int)sizeof(Src);    // elements a 16-byte load
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kWarps + warp;
  const int m0 = blockIdx.y * kMT;
  if (r >= o.R) return;
  const int mt = min(kMT, M - m0);
  const Src* wr = w + (size_t)r * C;
  const Src* xb = x + (size_t)m0 * C;

  unsigned acc[kMT];
#pragma unroll
  for (int m = 0; m < kMT; ++m) acc[m] = 0u;

  if (kVec) {
#pragma unroll 4
    for (int c = lane * V; c < C; c += 32 * V) {
      unsigned ww[Q::kWords];
      Q::words(*reinterpret_cast<const uint4*>(wr + c), w_mul, ww);
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        if (m < mt) {
          unsigned xw[Q::kWords];
          Q::words(*reinterpret_cast<const uint4*>(xb + (size_t)m * C + c), x_mul, xw);
#pragma unroll
          for (int j = 0; j < Q::kWords; ++j) {
            acc[m] += (unsigned)(lo16(xw[j]) * lo16(ww[j]));
            acc[m] += (unsigned)(hi16(xw[j]) * hi16(ww[j]));
          }
        }
      }
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      const int wv = Q::one(wr[c], w_mul);
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        if (m < mt) acc[m] += (unsigned)(Q::one(xb[(size_t)m * C + c], x_mul) * wv);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kMT; ++m) acc[m] = warp_sum(acc[m]);
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    if (m < mt && lane == m) o.store(acc[m], m0 + m, r, o.table);
  }
}

// ---------------------------------------------------------------------------
// Tensor cores: gemv_tc.cuh's skeleton
// ---------------------------------------------------------------------------

// int8: s8 operands straight from the ring; the cluster's exact int32 sum
// through Int8Out.
struct Int8Epi {
  template <int N> using Mma = gemv_tc::DirectMma<Int8Epi, N>;
  using Acc = int;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr int kElem = 1;
  struct Smem {
    float wb[2 * lut::kMaxTableRows];
  };
  Int8Out o;
  __device__ void stage(Smem& s) const {
    if (o.act) lut::stage(s.wb, o.table, o.sections);
  }
  __device__ __forceinline__ void operator()(const Smem& s, const int (&sum)[4], int m,
                                             int r) const {
    const float xs = load_f(o.x_scale, m, o.xs_bf);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (r + u < o.R) o.store(sum[u], xs, m, r + u, s.wb);
    }
  }
};

__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ uint2 lds64(uint32_t a) {
  uint2 v;
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ void sts128(uint32_t a, const uint4& v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// One stage's tile of `Rows` rows x 128 K elements of Src, as TMA left it
// (sizeof(Src) boxes of Rows x 128 bytes, each in the 128-byte swizzle),
// quantized (mul = 2^frac) and split into its hi (s8) and lo (u8) byte
// planes of Rows x 128 bytes in the same swizzle: 16-byte chunk c of row
// r at r * 128 + ((c ^ (r % 8)) << 4). A work item is 16 elements of a
// row, one chunk of each plane; the consumer warpgroup shares the items.
template <typename Src, int Rows>
__device__ __forceinline__ void split_tile(uint32_t src, uint32_t hi, uint32_t lo, float mul) {
  using Q = Quant<Src>;
  constexpr int E = (int)sizeof(Src);
  constexpr int kBox = Rows * gemv_tc::kKBytes;
  for (int it = threadIdx.x; it < Rows * 8; it += gemv_tc::kConsumers) {
    const int row = it >> 3, c = it & 7;
    const uint32_t rowa = src + ((16 * c * E) >> 7) * kBox + row * gemv_tc::kKBytes;
    const int q0 = ((16 * c * E) & 127) >> 4;
    unsigned wd[8];
#pragma unroll
    for (int j = 0; j < E; ++j)
      Q::words(lds128(rowa + (((q0 + j) ^ (row & 7)) << 4)), mul, wd + Q::kWords * j);
    uint4 h, l;
    h.x = __byte_perm(wd[0], wd[1], 0x7531);
    l.x = __byte_perm(wd[0], wd[1], 0x6420);
    h.y = __byte_perm(wd[2], wd[3], 0x7531);
    l.y = __byte_perm(wd[2], wd[3], 0x6420);
    h.z = __byte_perm(wd[4], wd[5], 0x7531);
    l.z = __byte_perm(wd[4], wd[5], 0x6420);
    h.w = __byte_perm(wd[6], wd[7], 0x7531);
    l.w = __byte_perm(wd[6], wd[7], 0x6420);
    const uint32_t off = row * gemv_tc::kKBytes + ((c ^ (row & 7)) << 4);
    sts128(hi + off, h);
    sts128(lo + off, l);
  }
}

// This thread's wgmma A fragments of one stage's W tile (kRows x 128 K
// elements of Src as TMA left it), quantized and split: hi[kk] and lo[kk]
// the s8 and u8 fragments of K step kk (32 elements), a[i + 2 g] holding
// row 16 (t / 32) + (t % 32) / 4 + 8 i, columns 32 kk + 16 g + 4 (t % 4)
// .. + 3 (wgmma.cuh, mma_i8_rs).
template <typename Src>
__device__ __forceinline__ void split_a_frags(uint32_t src, float mul, uint32_t (&hi)[4][4],
                                              uint32_t (&lo)[4][4]) {
  using Q = Quant<Src>;
  constexpr int E = (int)sizeof(Src);
  constexpr int kBox = gemv_tc::kRows * gemv_tc::kKBytes;
  const int t = threadIdx.x;
  const int r0 = 16 * (t / 32) + (t % 32) / 4;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        const int cb = (32 * kk + 16 * g + 4 * (t % 4)) * E;   // byte of the row
        const uint32_t a = src + (cb >> 7) * kBox + r * gemv_tc::kKBytes +
                           ((((cb & 127) >> 4) ^ (r & 7)) << 4) + (cb & 15);
        unsigned w[2];
        if constexpr (E == 4) Q::words4(lds128(a), mul, w);
        else Q::words4(lds64(a), mul, w);
        hi[kk][i + 2 * g] = __byte_perm(w[0], w[1], 0x7531);
        lo[kk][i + 2 * g] = __byte_perm(w[0], w[1], 0x6420);
      }
    }
  }
}

// The fixed16 product on the 8-bit tensor cores: each stage's W tile
// quantized and split straight into this thread's wgmma A fragments, x's
// into its byte planes in shared memory (double-buffered: stage i writes
// buffer i % 2, so the one barrier a stage also tells that every warp is
// done with the wgmmas that read the buffer two stages ago), then the
// four plane products. (W's planes in shared memory beside x's, read
// through descriptors, measured slower on an H100 SXM at 700 W: 1.221
// against 1.198 ms for a decode step's 145 linears, 14.84 against 13.69 us
// for w_up at M = 64.)
template <typename Src, int N>
struct SplitMma {
  using Acc = unsigned;
  static constexpr int kBoxes = (int)sizeof(Src);   // 128 K elements of Src a stage
  static constexpr int kXBoxes = kBoxes;
  static constexpr int kK = gemv_tc::kKBytes;
  static constexpr bool kPrologue = false;
  static constexpr int kXPlane = N * gemv_tc::kKBytes;
  __host__ __device__ static int plane_bytes(int) { return 4 * kXPlane; }   // hi, lo; 2 buffers
  int hh[N / 2], md[N / 2], ll[N / 2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) hh[i] = md[i] = ll[i] = 0;
  }
  template <class Epi>
  __device__ __forceinline__ void step(const Epi& epi, uint32_t w, uint32_t x, uint32_t planes,
                                       int i) {
    using wgmma::I8;
    const uint32_t xh = planes + (i & 1) * 2 * kXPlane, xl = xh + kXPlane;
    uint32_t ah[4][4], al[4][4];
    split_a_frags<Src>(w, epi.w_mul, ah, al);
    split_tile<Src, N>(x, xh, xl, epi.x_mul);
    // x's planes, written through the generic proxy, are read by wgmma
    // through the async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(gemv_tc::kConsumers) : "memory");
    wgmma::fence_regs<16>(reinterpret_cast<int*>(&ah[0][0]));
    wgmma::fence_regs<16>(reinterpret_cast<int*>(&al[0][0]));
    wgmma::fence_regs<N / 2>(hh);
    wgmma::fence_regs<N / 2>(md);
    wgmma::fence_regs<N / 2>(ll);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {       // 32 elements of K a step
      const uint64_t bh = wgmma::desc_sw128(xh + 32 * kk), bl = wgmma::desc_sw128(xl + 32 * kk);
      wgmma::mma_i8_rs<N, I8::s8, I8::s8>(hh, ah[kk], bh);
      wgmma::mma_i8_rs<N, I8::s8, I8::u8>(md, ah[kk], bl);
      wgmma::mma_i8_rs<N, I8::u8, I8::s8>(md, al[kk], bh);
      wgmma::mma_i8_rs<N, I8::u8, I8::u8>(ll, al[kk], bl);
    }
    wgmma::commit();
    wgmma::wait_all();
    // The A fragments stay live until the wgmmas that read them are done.
    wgmma::fence_regs<16>(reinterpret_cast<int*>(&ah[0][0]));
    wgmma::fence_regs<16>(reinterpret_cast<int*>(&al[0][0]));
    wgmma::fence_regs<N / 2>(hh);
    wgmma::fence_regs<N / 2>(md);
    wgmma::fence_regs<N / 2>(ll);
  }
  // 65536 hh + 256 md + ll modulo 2^32.
  __device__ __forceinline__ unsigned value(int i) const {
    return ((unsigned)hh[i] << 16) + ((unsigned)md[i] << 8) + (unsigned)ll[i];
  }
};

template <typename Src>
struct FixedEpi {
  template <int N> using Mma = SplitMma<Src, N>;
  static constexpr CUtensorMapDataType kType = Quant<Src>::kType;
  static constexpr int kElem = (int)sizeof(Src);
  struct Smem {
    float wb[2 * lut::kMaxTableRows];
  };
  FixedOut o;
  float x_mul, w_mul;     // 2^frac_x, 2^frac_w
  __device__ void stage(Smem& s) const {
    if (o.act) lut::stage(s.wb, o.table, o.sections);
  }
  __device__ __forceinline__ void operator()(const Smem& s, const unsigned (&sum)[4], int m,
                                             int r) const {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (r + u < o.R) o.store(sum[u], m, r + u, s.wb);
    }
  }
};

// n_tile 0: the CUDA-core kernel; else the tensor-core one.
template <typename Src>
int launch_fixed(const void* x, const void* w, const FixedOut& o, float x_mul, float w_mul,
                 int M, int C, int n_tile, int cluster, cudaStream_t s) {
  if (n_tile > 0) {
    const FixedEpi<Src> epi{o, x_mul, w_mul};
    return gemv_tc::run<FixedEpi<Src>, kFixedMaxN>(x, w, epi, M, C, o.R, n_tile, cluster, s);
  }
  dim3 grid((o.R + kWarps - 1) / kWarps, (M + kMT - 1) / kMT);
  dim3 block(kWarps * 32);
  // 16-byte loads need every row of x and w to start on a 16-byte boundary.
  if ((C * (int)sizeof(Src)) % 16 == 0 && common::aligned16(x) && common::aligned16(w)) {
    gemv_fixed_kernel<Src, true><<<grid, block, 0, s>>>((const Src*)x, (const Src*)w, o, x_mul,
                                                        w_mul, M, C);
  } else {
    gemv_fixed_kernel<Src, false><<<grid, block, 0, s>>>((const Src*)x, (const Src*)w, o, x_mul,
                                                         w_mul, M, C);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// quantize_int8_rows
// ---------------------------------------------------------------------------

constexpr int kQuantThreads = 256;   // 8 warps: a block's row groups, or one streamed row

struct QuantArgs {
  const void* x;
  int8_t* q;
  void* scale;            // (n_rows,) in CT
  long long n_rows;
  int C;
  int wshift;             // log2 of W, the warps of a row's group (1, 2, 4 or 8)
  int rows_per_block;     // groups a block: blockDim.x = 32 * W * rows_per_block
  int vec;                // 16-byte pieces: x 16-byte aligned, C * sizeof(T) % 16 == 0
  int early;              // x is written by no kernel in flight: read it before pdl_wait
};

// One piece of N elements of a row (n valid), quantized and stored: packed
// in one 8-byte (bf16) or 4-byte (f32) store, or byte by byte.
template <typename CT, typename T, int N>
__device__ __forceinline__ void store_piece(const common::Pack<T, N>& p, float s, float r,
                                            bool fin, int8_t* dst, bool vec, int n) {
  uint32_t b[N];
#pragma unroll
  for (int j = 0; j < N; j += 2) q8x2<CT>(p[j], p[j + 1], s, r, fin, b[j], b[j + 1]);
  if (vec) {
    if constexpr (N == 8) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(pack4(b[0], b[1], b[2], b[3]),
                                                  pack4(b[4], b[5], b[6], b[7]));
    } else {
      *reinterpret_cast<uint32_t*>(dst) = pack4(b[0], b[1], b[2], b[3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j < n) dst[j] = (int8_t)b[j];
  }
}

// max(a, |x|) over a piece's first n elements; a whole bf16 piece in
// packed bf16 pairs (abs and max are exact in bf16, and __hmax2_nan keeps
// a NaN as max.NaN does).
template <typename T, int N>
__device__ __forceinline__ float piece_absmax(const common::Pack<T, N>& p, float a, int n) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (n >= N) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p.v);
      __nv_bfloat162 m = __habs2(h[0]);
#pragma unroll
      for (int j = 1; j < N / 2; ++j) m = __hmax2_nan(m, __habs2(h[j]));
      return max_nan(a, max_nan(__low2float(m), __high2float(m)));
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < n) a = max_nan(a, fabsf(p[j]));
  return a;
}

// A row's scale, its reciprocal and whether it is finite; thread 0 of the
// row stores the scale.
template <typename CT>
struct RowScale {
  float s, r;
  bool fin;
  __device__ __forceinline__ RowScale(float amax, void* scale, long long row, bool first) {
    s = row_scale<CT>(amax);
    r = __frcp_rn(s);
    fin = isfinite(s);
    if (first) static_cast<CT*>(scale)[row] = common::from_f<CT>(s);
  }
};

// Rows held in registers: lane t of a row's group of W warps holds pieces
// c * 32 * W + t (c < CH) of N = 16 / sizeof(T) elements. The grid walks
// the rows, rows_per_block groups a block at a time; every group of a
// block takes the same number of turns, so the group reduction's barrier
// (W > 1) is reached by all, its slots alternating between turns.
template <typename T, typename CT, int CH>
__global__ void __launch_bounds__(kQuantThreads) quantize_rows_kernel(const QuantArgs a) {
  constexpr int N = 16 / (int)sizeof(T);
  __shared__ float red[2][kQuantThreads / 32];
  const int W = 1 << a.wshift;
  const int warp = threadIdx.x / 32;
  const int t = (warp & (W - 1)) * 32 + threadIdx.x % 32;
  const int GT = 32 * W;
  const long long turn = (long long)gridDim.x * a.rows_per_block;
  hopper::pdl_launch_dependents();
  if (!a.early) hopper::pdl_wait();
  int buf = 0;
  for (long long row0 = (long long)blockIdx.x * a.rows_per_block; row0 < a.n_rows;
       row0 += turn, buf ^= 1) {
    const long long row = row0 + (warp >> a.wshift);
    const int d = row < a.n_rows ? a.C : 0;    // a dead group reads and writes nothing
    const T* xr = static_cast<const T*>(a.x) + row * a.C;
    common::Pack<T, N> x[CH];
    float amax = 0.0f;                        // |x| and max are exact in T
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int k0 = (c * GT + t) * N;
      if (a.vec) {
        if (k0 < d) x[c].load(xr + k0);
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j)
          if (k0 + j < d) x[c].v[j] = xr[k0 + j];
      }
      if (k0 < d) amax = piece_absmax(x[c], amax, d - k0);
    }
    amax = common::group_reduce(amax, MaxNan(), red[buf], W);
    if (d == 0) continue;
    hopper::pdl_wait();                       // the outputs may be memory the kernel before reads
    const RowScale<CT> rs(amax, a.scale, row, t == 0);
    int8_t* qr = a.q + row * a.C;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int k0 = (c * GT + t) * N;
      if (k0 < d) store_piece<CT>(x[c], rs.s, rs.r, rs.fin, qr + k0, a.vec, d - k0);
    }
  }
}

// Rows wider than 8 warps' registers: a block a row, read twice (the
// absmax, then the quantization).
template <typename T, typename CT>
__global__ void __launch_bounds__(kQuantThreads) quantize_rows_streamed(const QuantArgs a) {
  constexpr int N = 16 / (int)sizeof(T);
  __shared__ float red[2][kQuantThreads / 32];
  const int tid = threadIdx.x;
  hopper::pdl_launch_dependents();
  if (!a.early) hopper::pdl_wait();
  int buf = 0;
  for (long long row = blockIdx.x; row < a.n_rows; row += gridDim.x, buf ^= 1) {
    const T* xr = static_cast<const T*>(a.x) + row * a.C;
    float amax = 0.0f;
    if (a.vec) {
      for (int k0 = tid * N; k0 < a.C; k0 += kQuantThreads * N) {
        common::Pack<T, N> p;
        p.load(xr + k0);
        amax = piece_absmax(p, amax, N);
      }
    } else {
      for (int c = tid; c < a.C; c += kQuantThreads)
        amax = max_nan(amax, fabsf(common::to_f(xr[c])));
    }
    amax = common::group_reduce(amax, MaxNan(), red[buf], kQuantThreads / 32);
    hopper::pdl_wait();
    const RowScale<CT> rs(amax, a.scale, row, tid == 0);
    int8_t* qr = a.q + row * a.C;
    if (a.vec) {
      for (int k0 = tid * N; k0 < a.C; k0 += kQuantThreads * N) {
        common::Pack<T, N> p;
        p.load(xr + k0);
        store_piece<CT>(p, rs.s, rs.r, rs.fin, qr + k0, true, N);
      }
    } else {
      for (int c = tid; c < a.C; c += kQuantThreads)
        qr[c] = (int8_t)q8<CT>(common::to_f(xr[c]), rs.s, rs.r, rs.fin);
    }
  }
}

// Blocks of `threads` threads of kernel K resident on the card at once
// (the occupancy calculator's count an SM times the SMs), once a shape.
template <auto K>
int resident_blocks(int threads) {
  static int cached[kQuantThreads / 32 + 1] = {};
  int& n = cached[threads / 32];
  if (n == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, K, threads, 0) != cudaSuccess)
      return 0;
    n = sms * (per_sm > 0 ? per_sm : 1);
  }
  return n;
}

template <auto K>
int launch_rows(const QuantArgs& a, int threads, int rows_per_block, cudaStream_t s) {
  const long long need = (a.n_rows + rows_per_block - 1) / rows_per_block;
  const int most = resident_blocks<K>(threads);
  if (most == 0) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(need < most ? need : most), 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, K, a);
}

// chunks 0 streams a row a block; else chunks pieces a lane (1, 2, 4 or 8).
template <typename T, typename CT>
int launch_quant(const QuantArgs& a, int chunks, cudaStream_t s) {
  constexpr int N = 16 / (int)sizeof(T);
  const int W = 1 << a.wshift, R = a.rows_per_block;
  if (chunks == 0) return launch_rows<quantize_rows_streamed<T, CT>>(a, kQuantThreads, 1, s);
  if (R < 1 || W * R > kQuantThreads / 32 || (long long)chunks * 32 * W * N < a.C)
    return (int)cudaErrorInvalidValue;
  const int threads = 32 * W * R;
  switch (chunks) {
    case 1: return launch_rows<quantize_rows_kernel<T, CT, 1>>(a, threads, R, s);
    case 2: return launch_rows<quantize_rows_kernel<T, CT, 2>>(a, threads, R, s);
    case 4: return launch_rows<quantize_rows_kernel<T, CT, 4>>(a, threads, R, s);
    case 8: return launch_rows<quantize_rows_kernel<T, CT, 8>>(a, threads, R, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The int8 linear layer with x quantized in the load path
// ---------------------------------------------------------------------------

constexpr int kMaxXRows = 32;   // its token tile: one tile holds every row of x
constexpr int kXItems = 4;      // 16-element pieces of x a consumer thread holds
constexpr int kMaxXPieces = 2048;  // 16-element pieces of x a block quantizes

// x stays in shared memory: the block's K tiles of x, quantized once
// before the first stage into s8 tiles of N x 128 bytes in the 128-byte
// swizzle; only W rides the ring, and each stage's 4 wgmmas read x's tile
// of that stage. The consumers load their pieces of x into registers
// first thing, so that the loads overlap the block's set-up and W's first
// TMA loads.
template <class Epi, int N>
struct ResidentXMma : gemv_tc::DirectMma<Epi, N> {
  using Base = gemv_tc::DirectMma<Epi, N>;
  static constexpr int kXBoxes = 0;
  static constexpr bool kPrologue = true;
  __host__ __device__ static int plane_bytes(int nk) { return nk * N * gemv_tc::kKBytes; }
  typename Epi::XRegs xr;
  __device__ __forceinline__ void preload(const Epi& epi, int kt0, int nk, int M) {
    epi.load_x(xr, kt0, nk, M);
  }
  __device__ __forceinline__ void prologue(const Epi& epi, typename Epi::Smem& es,
                                           uint32_t planes, int kt0, int nk, int M) {
    epi.template quantize_x<N>(xr, es, planes, kt0, nk, M);
  }
  __device__ __forceinline__ void step(const Epi& epi, uint32_t w, uint32_t, uint32_t planes,
                                       int i) {
    Base::step(epi, w, planes + i * N * gemv_tc::kKBytes, 0, i);
  }
};

// x (M, C) in T quantized per row in CT, then Int8Out with each row's
// scale from shared memory. A piece is 16 elements of a row's C-share
// (one 16-byte chunk of its s8 tile); piece j of the block's M x (nk * 8)
// is thread j % 128's (j / 128)-th, so a warp reads a row's share in
// 32-byte runs.
template <typename T, typename CT>
struct Int8XEpi {
  template <int N> using Mma = ResidentXMma<Int8XEpi, N>;
  using Acc = int;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr int kElem = 1;
  static constexpr int kV = 16 / (int)sizeof(T);        // elements a 16-byte load
  struct XRegs {
    uint4 v[kXItems][16 / kV];
  };
  struct Smem {
    float wb[2 * lut::kMaxTableRows];
    unsigned amax[kMaxXRows];   // each row's absmax (a block holding whole rows), as bits
    float xs[kMaxXRows];        // each row's scale
    float xr[kMaxXRows];        // and its reciprocal
  };
  Int8Out o;
  const T* x;
  int C;
  __device__ void stage(Smem& s) const {
    if (o.act) lut::stage(s.wb, o.table, o.sections);
    for (int i = threadIdx.x; i < kMaxXRows; i += blockDim.x) s.amax[i] = 0u;
  }
  __device__ __forceinline__ void operator()(const Smem& s, const int (&sum)[4], int m,
                                             int r) const {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (r + u < o.R) o.store(sum[u], s.xs[m], m, r + u, s.wb);
    }
  }

  // Piece k of this thread: its row n and 16-element chunk ch of the share
  // (-1 past M; the callers skip chunks past C).
  __device__ __forceinline__ int piece(int k, int nk, int M, int& n) const {
    const int it = threadIdx.x + k * gemv_tc::kConsumers;
    n = it / (nk * 8);
    return n < M ? it - n * nk * 8 : -1;
  }

  // Pieces k0 .. k0 + kXItems - 1 of this thread.
  __device__ __forceinline__ void load_x(XRegs& r, int kt0, int nk, int M, int k0 = 0) const {
#pragma unroll
    for (int k = 0; k < kXItems; ++k) {
      int n;
      const int ch = piece(k0 + k, nk, M, n);
      const int col = kt0 * gemv_tc::kKBytes + ch * 16;
      if (ch >= 0 && col < C) {
#pragma unroll
        for (int p = 0; p < 16 / kV; ++p)
          r.v[k][p] = common::ld16(x + (size_t)n * C + col + p * kV);
      }
    }
  }

  __device__ __forceinline__ static void set_scale(Smem& s, int m, float amax) {
    s.xs[m] = row_scale<CT>(amax);
    s.xr[m] = __frcp_rn(s.xs[m]);
  }

  // Pieces k0 .. k0 + kXItems - 1 of this thread, held in `r`, quantized
  // with their rows' scales into their chunks of the s8 tiles at `planes`.
  template <int N>
  __device__ __forceinline__ void store_x(const XRegs& r, const Smem& s, uint32_t planes,
                                          int kt0, int nk, int M, int k0) const {
    constexpr int kK = gemv_tc::kKBytes;
#pragma unroll
    for (int k = 0; k < kXItems; ++k) {
      int n;
      const int ch = piece(k0 + k, nk, M, n);
      if (ch >= 0 && kt0 * kK + ch * 16 < C) {
        const float sc = s.xs[n], rc = s.xr[n];
        const bool fin = isfinite(sc);
        uint32_t b[16];
#pragma unroll
        for (int p = 0; p < 16 / kV; ++p) {
          float e[kV];
          common::Vec<T>::widen(r.v[k][p], e);
#pragma unroll
          for (int j = 0; j < kV; ++j) b[p * kV + j] = q8<CT>(e[j], sc, rc, fin);
        }
        const int i = ch >> 3, c = ch & 7;
        sts128(planes + i * N * kK + n * kK + ((c ^ (n & 7)) << 4),
               make_uint4(pack4(b[0], b[1], b[2], b[3]), pack4(b[4], b[5], b[6], b[7]),
                          pack4(b[8], b[9], b[10], b[11]), pack4(b[12], b[13], b[14], b[15])));
      }
    }
  }

  // Each row's absmax, then each piece quantized into its chunk of the s8
  // tiles at `planes`: the kXItems a thread loaded first thing from the
  // registers, any further ones (a share past kXItems pieces a thread,
  // as the wide linears of a decode step have) loaded kXItems at a time
  // from L2 as they are quantized. A block that holds whole rows in its
  // registers (no cluster) takes the absmax of its pieces (shared-memory
  // atomics on the bits of non-negative floats, whose order they keep, a
  // NaN above all); any other block reads its rows whole, a warp a row,
  // which measured faster on the H100 than exchanging the blocks' partial
  // absmaxes over distributed shared memory behind a cluster barrier.
  // Rows past M and columns past C are left as they are: they meet W's
  // zero fill or give outputs that are not stored.
  template <int N>
  __device__ void quantize_x(const XRegs& r, Smem& s, uint32_t planes, int kt0, int nk,
                             int M) const {
    constexpr int kK = gemv_tc::kKBytes;
    const int tid = threadIdx.x;
    const int pieces = M * nk * 8;
    if (nk * kK >= C && pieces <= gemv_tc::kConsumers * kXItems) {   // whole rows, held
#pragma unroll
      for (int k = 0; k < kXItems; ++k) {
        int n;
        const int ch = piece(k, nk, M, n);
        if (ch >= 0 && ch * 16 < C) {
          float a = 0.0f;
#pragma unroll
          for (int p = 0; p < 16 / kV; ++p) {
            float e[kV];
            common::Vec<T>::widen(r.v[k][p], e);
#pragma unroll
            for (int j = 0; j < kV; ++j) a = max_nan(a, fabsf(e[j]));
          }
          atomicMax(&s.amax[n], __float_as_uint(a));
        }
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(gemv_tc::kConsumers) : "memory");
      if (tid < M) set_scale(s, tid, __uint_as_float(s.amax[tid]));
    } else {
      const int warp = tid / 32, lane = tid % 32;
      for (int m = warp; m < M; m += gemv_tc::kConsumers / 32) {
        const T* xrow = x + (size_t)m * C;
        float a = 0.0f;
#pragma unroll 8
        for (int c = lane * kV; c < C; c += 32 * kV) {
          common::Pack<T, kV> pk;
          pk.load(xrow + c);
#pragma unroll
          for (int j = 0; j < kV; ++j) a = max_nan(a, fabsf(pk[j]));
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) a = max_nan(a, __shfl_xor_sync(0xffffffffu, a, off));
        if (lane == 0) set_scale(s, m, a);
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(gemv_tc::kConsumers) : "memory");
    store_x<N>(r, s, planes, kt0, nk, M, 0);
    for (int k0 = kXItems; k0 * gemv_tc::kConsumers < pieces; k0 += kXItems) {
      XRegs more;
      load_x(more, kt0, nk, M, k0);
      store_x<N>(more, s, planes, kt0, nk, M, k0);
    }
    // x's tiles, written through the generic proxy, are read by wgmma
    // through the async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(gemv_tc::kConsumers) : "memory");
  }
};

template <typename T, typename CT>
int launch_int8_linear(const void* x, const void* w, const Int8Out& o, int M, int C, int n_tile,
                       int cluster, void* stream) {
  const Int8XEpi<T, CT> epi{o, (const T*)x, C};
  return gemv_tc::run<Int8XEpi<T, CT>, kMaxXRows>(x, w, epi, M, C, o.R, n_tile, cluster, stream);
}

}  // namespace

extern "C" {

// x (M, C) and w (R, C) int8; x_scale (M,), w_scale (R,) and bias (R,) or
// null, each f32 (dtype 0) or bf16 (1); out (M, R) in out_dtype (0 f32,
// 1 bf16); act 1 applies the LUT table (sections + 2 rows) to the value
// in out's dtype. n_tile 0 takes the CUDA-core kernel (__dp4a; any C),
// else the tensor-core kernel: C a multiple of 16, x and w 16-byte
// aligned, n_tile the token tile (8, 16, 32, 64, 128 or 256), cluster the
// blocks splitting C (1, 2, 4 or 8, at most the 128-wide K tiles of C).
// Returns a CUDA error code (0 on success).
int gemv_pim_int8(const void* x, const void* x_scale, const void* w, const void* w_scale,
                  const void* bias, const void* table, void* out, int M, int C, int R,
                  int xs_dtype, int ws_dtype, int bias_dtype, int out_dtype, int act, float lo,
                  float inv_step, int sections, int n_tile, int cluster, void* stream) {
  if (act && (table == nullptr || sections < 1 || sections + 2 > lut::kMaxTableRows))
    return (int)cudaErrorInvalidValue;
  const Int8Out o{x_scale, w_scale, bias, (const float*)table, out, R, xs_dtype, ws_dtype,
                  bias_dtype, out_dtype, act, lo, inv_step, sections};
  cudaStream_t s = (cudaStream_t)stream;
  if (n_tile > 0) return gemv_tc::run(x, w, Int8Epi{o}, M, C, R, n_tile, cluster, stream);
  dim3 grid((R + kWarps - 1) / kWarps, (M + kMT - 1) / kMT);
  dim3 block(kWarps * 32);
  // 16-byte loads need every row of x and w to start on a 16-byte boundary.
  if (C % 16 == 0 && common::aligned16(x) && common::aligned16(w)) {
    gemv_int8_kernel<true><<<grid, block, 0, s>>>((const int8_t*)x, (const int8_t*)w, o, M, C);
  } else {
    gemv_int8_kernel<false><<<grid, block, 0, s>>>((const int8_t*)x, (const int8_t*)w, o, M, C);
  }
  return (int)cudaGetLastError();
}

// x (rows, C) contiguous in dtype (0 = float32, 1 = bfloat16), quantized
// in compute (0 = float32, 1 = bfloat16: bf16 x only); q (rows, C) int8
// and scale (rows,) in the compute dtype. chunks (0: a block streams a row;
// 1, 2, 4 or 8 pieces a lane), warps_per_row and rows_per_block are
// quant_plan's; vec asks for 16-byte pieces (x 16-byte aligned, C a
// multiple of 16 bytes of x). The kernel is launched with programmatic
// stream serialization: it may start while the kernel before it runs (it
// lets the one after it do the same), and waits for that kernel before it
// writes its outputs and, unless early is 1 (no kernel in flight writes x:
// a weight), before it reads x. Returns a CUDA error code (0 on success).
int quantize_int8_rows(const void* x, void* q, void* scale, long long rows, int C, int dtype,
                       int compute, int chunks, int warps_per_row, int rows_per_block, int vec,
                       int early, void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  const int wshift = warps_per_row == 1 ? 0 : warps_per_row == 2 ? 1 : warps_per_row == 4 ? 2
                     : warps_per_row == 8 ? 3 : -1;
  if (rows <= 0 || C <= 0 || dtype < 0 || dtype > 1 || compute < 0 || compute > dtype ||
      wshift < 0 || (vec && (!common::aligned16(x) || (C * elem) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const QuantArgs a{x, (int8_t*)q, scale, rows, C, wshift, rows_per_block, vec, early};
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (dtype == 0) rc = launch_quant<float, float>(a, chunks, s);
  else if (compute == 0) rc = launch_quant<__nv_bfloat16, float>(a, chunks, s);
  else rc = launch_quant<__nv_bfloat16, __nv_bfloat16>(a, chunks, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The int8 linear layer in one launch: x (M, C) in dtype (0 f32, 1 bf16),
// quantized per row in compute (0 f32, 1 bf16: bf16 x only) inside the
// kernel, then gemv_pim_int8's product and epilogue with w (R, C) int8,
// w_scale (R,) and bias (R,) or null in their dtypes, out (M, R) in
// out_dtype, act 1 applying the LUT. On the s8 tensor cores only: C a
// multiple of 16, x and w 16-byte aligned, M <= n_tile <= 32 (one token
// tile holds every row), cluster as gemv_pim_int8, and the block's share of
// x at most kMaxXPieces 16-element pieces (M times the block's 128-element
// K tiles at most 256). Returns a CUDA error code (0 on success).
int gemv_pim_int8_linear(const void* x, const void* w, const void* w_scale, const void* bias,
                         const void* table, void* out, int M, int C, int R, int dtype,
                         int compute, int ws_dtype, int bias_dtype, int out_dtype, int act,
                         float lo, float inv_step, int sections, int n_tile, int cluster,
                         void* stream) {
  if (act && (table == nullptr || sections < 1 || sections + 2 > lut::kMaxTableRows))
    return (int)cudaErrorInvalidValue;
  if (cluster < 1 || M < 1 || M > n_tile || n_tile > kMaxXRows)
    return (int)cudaErrorInvalidValue;
  const int per_block = ((C + 127) / 128 + cluster - 1) / cluster;
  if (M * per_block * 8 > kMaxXPieces) return (int)cudaErrorInvalidValue;
  const Int8Out o{nullptr, w_scale, bias, (const float*)table, out, R, 0, ws_dtype,
                  bias_dtype, out_dtype, act, lo, inv_step, sections};
  if (dtype == 0 && compute == 0)
    return launch_int8_linear<float, float>(x, w, o, M, C, n_tile, cluster, stream);
  if (dtype == 1 && compute == 0)
    return launch_int8_linear<__nv_bfloat16, float>(x, w, o, M, C, n_tile, cluster, stream);
  if (dtype == 1 && compute == 1)
    return launch_int8_linear<__nv_bfloat16, __nv_bfloat16>(x, w, o, M, C, n_tile, cluster,
                                                            stream);
  return (int)cudaErrorInvalidValue;
}

// int16 x (M, C) and w (R, C) -> int16 out (M, R); 0 <= shift < 32.
// n_tile 0 takes the CUDA-core kernel (any C), else the tensor-core one
// (C a multiple of 16, x and w 16-byte aligned; n_tile 8, 16, 32 or 64,
// cluster 1, 2, 4 or 8). Returns a CUDA error code (0 on success).
int gemv_pim_fixed(const void* x, const void* w, void* out, int M, int C, int R, int shift,
                   int n_tile, int cluster, void* stream) {
  if (shift < 0 || shift > 31) return (int)cudaErrorInvalidValue;
  const FixedOut o{out, nullptr, nullptr, R, shift, 2, 0, 0, 1.0f, 0.0f, 1.0f, 1};
  return launch_fixed<int16_t>(x, w, o, 1.0f, 1.0f, M, C, n_tile, cluster,
                               (cudaStream_t)stream);
}

// The fixed16 linear layer: x (M, C) and w (R, C) in dtype (0 f32, 1
// bf16), quantized to Q(frac_x) and Q(frac_w) as they load; bias (R,) or
// null in bias_dtype; out (M, R) in x's dtype; act 1 applies the LUT
// table. 0 <= frac_x, frac_w <= 30. n_tile and cluster as gemv_pim_fixed.
// Returns a CUDA error code (0 on success).
int gemv_pim_fixed_linear(const void* x, const void* w, const void* bias, const void* table,
                          void* out, int M, int C, int R, int dtype, int bias_dtype,
                          int frac_x, int frac_w, int act, float lo, float inv_step,
                          int sections, int n_tile, int cluster, void* stream) {
  if (frac_x < 0 || frac_x > 30 || frac_w < 0 || frac_w > 30) return (int)cudaErrorInvalidValue;
  if (act && (table == nullptr || sections < 1 || sections + 2 > lut::kMaxTableRows))
    return (int)cudaErrorInvalidValue;
  const float x_mul = (float)(1 << frac_x), w_mul = (float)(1 << frac_w);
  const FixedOut o{out, bias, (const float*)table, R, frac_w, dtype, bias_dtype, act,
                   1.0f / x_mul, lo, inv_step, sections};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_fixed<float>(x, w, o, x_mul, w_mul, M, C, n_tile, cluster, s);
  if (dtype == 1)
    return launch_fixed<__nv_bfloat16>(x, w, o, x_mul, w_mul, M, C, n_tile, cluster, s);
  return (int)cudaErrorInvalidValue;
}

const char* gemv_pim_quant_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
