// Hopper warpgroup matrix multiply (wgmma) and the shared-memory operand
// descriptors of the tensor-core GEMVs (gemv_tc.cuh: gemv_pim.cu, bf16;
// gemv_pim_quant.cu, s8, and s8/u8 byte planes of int16 values).
//
// mma<N>(d, desc_a, desc_b) issues one wgmma.mma_async with A (64 x K) and
// B (K x N) both K-major in shared memory, and adds into the accumulators
// d[N / 2] (this thread's fragment):
//  * float d: m64nNk16, bf16 A and B, f32 accumulators;
//  * int d:   m64nNk32, s8 A and B, s32 accumulators (K-major is the only
//             layout wgmma takes for 8-bit types).
// mma_i8_rs<N, A, B>(d, a, desc_b) is the integer one with each operand
// signed (s8) or unsigned (u8) bytes, any pairing, and A from registers:
// a[4] is this thread's fragment of the 64 x 32 A tile, four bytes a
// register, a[i + 2 g] holding row 16 (t / 32) + (t % 32) / 4 + 8 i and
// columns 16 g + 4 (t % 4) .. + 3 (the lowest column in the lowest byte).
// No .satfinite: the s32 accumulators wrap modulo 2^32.
// Either way a K step covers 32 bytes of a 128-byte swizzle row (16 bf16
// or 32 int8), so the descriptors advance by 32 bytes a step. The fragment
// of thread t of the warpgroup: d[4c + 2i + j] holds row
// 16 (t / 32) + (t % 32) / 4 + 8 i and column 8 c + 2 (t % 4) + j.
#pragma once

#include <stdint.h>

namespace wgmma {

// A K-major operand tile whose rows are 128 bytes (64 bf16 or 128 int8)
// and land with TMA's 128-byte swizzle: 8-row groups 1024 bytes apart (the
// stride byte offset), layout type 1 (128B swizzle) in bits 62-63. The
// tile must start on a 1024-byte boundary; a K step advances the start by
// 32 bytes inside the swizzle atom.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t smem_addr) {
  uint64_t d = 0;
  d |= (uint64_t)((smem_addr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;                 // leading byte offset (unused here)
  d |= (uint64_t)(1024 >> 4) << 32;       // stride byte offset
  d |= (uint64_t)1 << 62;                 // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int N> __device__ void mma(float* d, uint64_t a, uint64_t b);
template <int N> __device__ void mma(int* d, uint64_t a, uint64_t b);

// The byte types of an integer operand.
enum class I8 { s8, u8 };
template <int N, I8 A, I8 B> __device__ void mma_i8_rs(int* d, const uint32_t* a, uint64_t b);

// The accumulator operands %0 .. %(R - 1) of an instruction with R of them.
#define WGMMA_OPS_4 "%0, %1, %2, %3"
#define WGMMA_OPS_8 WGMMA_OPS_4 ", %4, %5, %6, %7"
#define WGMMA_OPS_16 WGMMA_OPS_8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define WGMMA_OPS_32                                                                  \
  WGMMA_OPS_16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "  \
               "%29, %30, %31"
#define WGMMA_OPS_64                                                                  \
  WGMMA_OPS_32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "  \
               "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, " \
               "%59, %60, %61, %62, %63"
#define WGMMA_OPS_128                                                                  \
  WGMMA_OPS_64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "   \
               "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, " \
               "%91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "  \
               "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, "     \
               "%115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "     \
               "%126, %127"

// Their constraints: C(d[o]) .. C(d[o + R - 1]).
#define WGMMA_D4(C, o) C(d[o]), C(d[o + 1]), C(d[o + 2]), C(d[o + 3])
#define WGMMA_D8(C, o) WGMMA_D4(C, o), WGMMA_D4(C, o + 4)
#define WGMMA_D16(C, o) WGMMA_D8(C, o), WGMMA_D8(C, o + 8)
#define WGMMA_D32(C, o) WGMMA_D16(C, o), WGMMA_D16(C, o + 16)
#define WGMMA_D64(C, o) WGMMA_D32(C, o), WGMMA_D32(C, o + 32)
#define WGMMA_D128(C, o) WGMMA_D64(C, o), WGMMA_D64(C, o + 64)
#define WGMMA_F32(x) "+f"(x)
#define WGMMA_S32(x) "+r"(x)

// mma<N> on both accumulator types: R = N / 2 accumulators, then the A
// and B descriptors (%R, %R+1) and the scale-d flag (%R+2).
#define WGMMA_DEFINE(N, R, A, B, P)                                               \
  template <>                                                                     \
  __device__ __forceinline__ void mma<N>(float* d, uint64_t a, uint64_t b) {      \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                  \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {"     \
                 WGMMA_OPS_##R "}, %" #A ", %" #B ", p, 1, 1, 0, 0;\n}\n"          \
                 : WGMMA_D##R(WGMMA_F32, 0)                                       \
                 : "l"(a), "l"(b), "r"(1));                                       \
  }                                                                               \
  template <>                                                                     \
  __device__ __forceinline__ void mma<N>(int* d, uint64_t a, uint64_t b) {        \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                  \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8 {"         \
                 WGMMA_OPS_##R "}, %" #A ", %" #B ", p;\n}\n"                      \
                 : WGMMA_D##R(WGMMA_S32, 0)                                       \
                 : "l"(a), "l"(b), "r"(1));                                       \
  }

WGMMA_DEFINE(8, 4, 4, 5, 6)
WGMMA_DEFINE(16, 8, 8, 9, 10)
WGMMA_DEFINE(32, 16, 16, 17, 18)
WGMMA_DEFINE(64, 32, 32, 33, 34)
WGMMA_DEFINE(128, 64, 64, 65, 66)
WGMMA_DEFINE(256, 128, 128, 129, 130)

// mma_i8_rs: the A fragment is operands %R .. %R+3, then the B descriptor
// (%R+4) and the scale-d flag (%R+5).
#define WGMMA_DEFINE_I8_RS(N, R, A0, A1, A2, A3, B, P, TA, TB)                     \
  template <>                                                                     \
  __device__ __forceinline__ void mma_i8_rs<N, I8::TA, I8::TB>(                   \
      int* d, const uint32_t* a, uint64_t b) {                                    \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                  \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32." #TA "." #TB " {" \
                 WGMMA_OPS_##R "}, {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #B  \
                 ", p;\n}\n"                                                      \
                 : WGMMA_D##R(WGMMA_S32, 0)                                       \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));   \
  }
#define WGMMA_DEFINE_I8_ALL(N, R, A0, A1, A2, A3, B, P)          \
  WGMMA_DEFINE_I8_RS(N, R, A0, A1, A2, A3, B, P, s8, s8)          \
  WGMMA_DEFINE_I8_RS(N, R, A0, A1, A2, A3, B, P, s8, u8)          \
  WGMMA_DEFINE_I8_RS(N, R, A0, A1, A2, A3, B, P, u8, s8)          \
  WGMMA_DEFINE_I8_RS(N, R, A0, A1, A2, A3, B, P, u8, u8)

WGMMA_DEFINE_I8_ALL(8, 4, 4, 5, 6, 7, 8, 9)
WGMMA_DEFINE_I8_ALL(16, 8, 8, 9, 10, 11, 12, 13)
WGMMA_DEFINE_I8_ALL(32, 16, 16, 17, 18, 19, 20, 21)
WGMMA_DEFINE_I8_ALL(64, 32, 32, 33, 34, 35, 36, 37)

#undef WGMMA_DEFINE_I8_ALL
#undef WGMMA_DEFINE_I8_RS
#undef WGMMA_DEFINE
#undef WGMMA_F32
#undef WGMMA_S32
#undef WGMMA_D128
#undef WGMMA_D64
#undef WGMMA_D32
#undef WGMMA_D16
#undef WGMMA_D8
#undef WGMMA_D4
#undef WGMMA_OPS_128
#undef WGMMA_OPS_64
#undef WGMMA_OPS_32
#undef WGMMA_OPS_16
#undef WGMMA_OPS_8
#undef WGMMA_OPS_4

}  // namespace wgmma
