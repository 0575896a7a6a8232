// Hopper (sm_90a) warpgroup matrix multiply, bf16, fp16 and tf32 operands
// and f32 accumulators in registers, and the asynchronous copies that feed
// it.  bf16 and fp16 share one layout (16-bit elements), so every bf16 tile
// and fragment below holds fp16 the same way.
//
// Shared-memory operands use the 32-byte swizzle: a matrix is stored as
// atoms of 8 rows x 16 bf16 (32 bytes a row, 256 bytes an atom, atoms
// aligned to 256 bytes), and within an atom the 16-byte half of row r sits
// at half ^ ((r >> 2) & 1) (address bit 4 ^= bit 7).  A (rows, cols) tile
// is stored [cols / 16][rows / 8][8][16], so 16 columns of every row are
// one run of rows / 8 atoms:
//   - K-major operand (Q as A, K as B of S = Q K^T): an instruction's k16
//     slice is one run; the stride between 8-row groups (SBO) is 256 bytes
//     and the leading offset is unused; the next k16 slice is the next run.
//   - MN-major operand (V as B of O = P V, read with the transpose bit):
//     the instruction's 16 keys are two 8-row groups (SBO 256 bytes), its
//     N = hd columns are hd / 16 runs (LBO the run's bytes); the next k16
//     slice starts 512 bytes on.
//
// Accumulator fragment of m64nNk16 (f32), thread t of the warpgroup, warp
// w = t / 32, lane l = t % 32, g = l / 4, c = 2 (l % 4): d[4i + 0, 1] hold
// row 16 w + g, columns 8 i + c, c + 1; d[4i + 2, 3] row 16 w + g + 8.  The
// A-from-registers fragment of m64n*k16 (bf16x2 a[0..3]) is the same map
// over a 16-column slice: a[0] row 16 w + g, columns c, c + 1; a[1] row
// + 8; a[2] columns 8 + c, 9 + c; a[3] both.  So two accumulator column
// blocks 2j, 2j + 1 of S, rounded to bf16, are A's k16 slice j of P V.
//
// tf32 (f32 bit patterns whose low 13 bits the tensor core ignores): one
// k8 step is 32 bytes, as a bf16 k16 step is.  tf32 wgmma reads both
// operands K-major from shared memory and has no transpose bit; the
// batched Gram (gram.cu) keeps them in the 128-byte swizzle below.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of bf16 element (r, c) of a (rows, cols) tile in the
// 32-byte-swizzled [cols / 16][rows / 8][8][16] layout; c a multiple of 8
// gives the 16-byte chunk that holds c .. c + 7.
__device__ __forceinline__ uint32_t swz32_offset(int rows, int r, int c) {
  const int half = ((c >> 3) & 1) ^ ((r >> 2) & 1);
  return (c >> 4) * rows * 32 + (r >> 3) * 256 + (r & 7) * 32 + half * 16 +
         (c & 7) * 2;
}

// Byte offset of byte b (< 128) of row r of a K-major tile stored with the
// 128-byte swizzle: rows of 128 bytes (32 tf32), atoms of 8 rows (1,024
// bytes, aligned to 1,024), the 16-byte chunk c of row r at c ^ (r & 7)
// (address bits 4-6 ^= bits 7-9).  A k8 tf32 step is the 32-byte slice
// 32 j of every row: its descriptor starts 32 j bytes into the tile (SBO
// 1,024 bytes, LBO unused).
__device__ __forceinline__ uint32_t swz128_offset(int r, int b) {
  return (r >> 3) * 1024 + (r & 7) * 128 + ((((b >> 4) ^ r) & 7) << 4) +
         (b & 15);
}

// Matrix descriptor: start address, leading and stride byte offsets (each
// >> 4, in bytes, so the same for every element type), and the swizzle in
// bits 62-63: 3 = 32-byte (the default), 1 = 128-byte.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo,
                                              uint64_t swizzle = 3) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers the asynchronous products write: no read or write of them
// moves across this point (the compiler sees only the asm's operands, not
// the hardware's later writes).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 16-byte asynchronous copy global -> shared; n < 16 source bytes are
// read and the rest zero-filled (n = 0: a zero chunk, nothing read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Make this thread's generic-proxy writes of shared memory (cp.async,
// st.shared) visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// x rounded to tf32 (10 stored mantissa bits) to nearest, ties away from
// zero, as cvt.rna.tf32.f32 rounds a finite x: half of the dropped 13 bits'
// weight added to the magnitude's bits (a carry moves into the exponent),
// then those bits cleared.  Two integer operations at the full ALU rate:
// with the cvt instruction the batched Grams ran 7-11 % slower
// (variants.py gram).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// two values rounded to T (bf16 or fp16) in one register, lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  return pack_bf16(lo, hi);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  return pack_f16(lo, hi);
}

// d (64 x 64) += A (64 x 16, K-major, descriptor a) B (16 x 64, K-major,
// descriptor b), T = bf16 or fp16 operands.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b);

#define REPRO_WGMMA_SS_N64(T, TY)                                             \
template <>                                                                   \
__device__ __forceinline__ void wgmma_ss_n64<T>(float (&d)[32], uint64_t a,   \
                                             uint64_t b) {                    \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "          \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "          \
      "%26, %27, %28, %29, %30, %31"                                          \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                      \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
          "+f"(d[30]), "+f"(d[31])                                            \
        : "l"(a), "l"(b), "r"(1));                                            \
}
REPRO_WGMMA_SS_N64(__nv_bfloat16, "bf16")
REPRO_WGMMA_SS_N64(__half, "f16")
#undef REPRO_WGMMA_SS_N64

// d (64 x N) += A (64 x 16, bf16x2 or f16x2 registers) B (16 x N, MN-major,
// descriptor b, transpose bit set), T = bf16 or fp16 operands.
template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);

#define REPRO_WGMMA_RS_16(T, TY)                                              \
template <>                                                                   \
__device__ __forceinline__ void wgmma_rs<16, T>(                              \
    float (&d)[8], const uint32_t (&a)[4], uint64_t b) {                      \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7"                                        \
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"                          \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])                                  \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));        \
}
REPRO_WGMMA_RS_16(__nv_bfloat16, "bf16")
REPRO_WGMMA_RS_16(__half, "f16")
#undef REPRO_WGMMA_RS_16

#define REPRO_WGMMA_RS_32(T, TY)                                              \
template <>                                                                   \
__device__ __forceinline__ void wgmma_rs<32, T>(                              \
    float (&d)[16], const uint32_t (&a)[4], uint64_t b) {                     \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "          \
      "%14, %15"                                                              \
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                        \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
          "+f"(d[15])                                                         \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));        \
}
REPRO_WGMMA_RS_32(__nv_bfloat16, "bf16")
REPRO_WGMMA_RS_32(__half, "f16")
#undef REPRO_WGMMA_RS_32

#define REPRO_WGMMA_RS_48(T, TY)                                              \
template <>                                                                   \
__device__ __forceinline__ void wgmma_rs<48, T>(                              \
    float (&d)[24], const uint32_t (&a)[4], uint64_t b) {                     \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n48k16.f32." TY "." TY " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "          \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23"                      \
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"                        \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])                  \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));        \
}
REPRO_WGMMA_RS_48(__nv_bfloat16, "bf16")
REPRO_WGMMA_RS_48(__half, "f16")
#undef REPRO_WGMMA_RS_48

#define REPRO_WGMMA_RS_64(T, TY)                                              \
template <>                                                                   \
__device__ __forceinline__ void wgmma_rs<64, T>(                              \
    float (&d)[32], const uint32_t (&a)[4], uint64_t b) {                     \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "          \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "          \
      "%26, %27, %28, %29, %30, %31"                                          \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                        \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
          "+f"(d[30]), "+f"(d[31])                                            \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));        \
}
REPRO_WGMMA_RS_64(__nv_bfloat16, "bf16")
REPRO_WGMMA_RS_64(__half, "f16")
#undef REPRO_WGMMA_RS_64

#define REPRO_WGMMA_RS_80(T, TY)                                              \
template <>                                                                   \
__device__ __forceinline__ void wgmma_rs<80, T>(                              \
    float (&d)[40], const uint32_t (&a)[4], uint64_t b) {                     \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n80k16.f32." TY "." TY " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "          \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "          \
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "          \
      "%38, %39"                                                              \
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"                        \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])     \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));        \
}
REPRO_WGMMA_RS_80(__nv_bfloat16, "bf16")
REPRO_WGMMA_RS_80(__half, "f16")
#undef REPRO_WGMMA_RS_80

#define REPRO_WGMMA_RS_96(T, TY)                                              \
template <>                                                                   \
__device__ __forceinline__ void wgmma_rs<96, T>(                              \
    float (&d)[48], const uint32_t (&a)[4], uint64_t b) {                     \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n96k16.f32." TY "." TY " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "          \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "          \
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "          \
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47"                      \
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"                        \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),    \
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47])                               \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));        \
}
REPRO_WGMMA_RS_96(__nv_bfloat16, "bf16")
REPRO_WGMMA_RS_96(__half, "f16")
#undef REPRO_WGMMA_RS_96

#define REPRO_WGMMA_RS_112(T, TY)                                             \
template <>                                                                   \
__device__ __forceinline__ void wgmma_rs<112, T>(                             \
    float (&d)[56], const uint32_t (&a)[4], uint64_t b) {                     \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n112k16.f32." TY "." TY " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "          \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "          \
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "          \
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "          \
      "%50, %51, %52, %53, %54, %55"                                          \
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"                        \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),    \
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),    \
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
          "+f"(d[55])                                                         \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));        \
}
REPRO_WGMMA_RS_112(__nv_bfloat16, "bf16")
REPRO_WGMMA_RS_112(__half, "f16")
#undef REPRO_WGMMA_RS_112

#define REPRO_WGMMA_RS_128(T, TY)                                             \
template <>                                                                   \
__device__ __forceinline__ void wgmma_rs<128, T>(                             \
    float (&d)[64], const uint32_t (&a)[4], uint64_t b) {                     \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "          \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "          \
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "          \
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "          \
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "          \
      "%62, %63"                                                              \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                        \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),    \
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),    \
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),    \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                  \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));        \
}
REPRO_WGMMA_RS_128(__nv_bfloat16, "bf16")
REPRO_WGMMA_RS_128(__half, "f16")
#undef REPRO_WGMMA_RS_128

// d (64 x 128) = A (64 x 8, K-major, descriptor a) B (8 x 128, K-major,
// descriptor b) + (scale_d ? d : 0), tf32 operands, f32 accumulators (the
// same fragment map as the bf16 instructions above).
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
}

}  // namespace repro
