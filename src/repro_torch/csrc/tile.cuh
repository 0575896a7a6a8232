// Shared 64x64 output-tile micro-kernel for the hand-written SIMT kernels.
//
// A block of 256 threads owns one 64x64 output tile.  Thread (ty, tx) of the
// 16x16 grid keeps a 4x4 register sub-tile at rows 4*ty..4*ty+3 and columns
// 4*tx..4*tx+3.  Operands arrive in shared memory as [depth][64] panels
// (row strides a multiple of 4 floats), so each depth step is two float4 loads per
// thread (one broadcast across the row of threads, one contiguous across the
// warp: no bank conflicts) and 16 FFMAs.  Accumulation is plain f32 FFMA:
// no tensor cores, so no TF32 rounding of the operands.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro {

constexpr int kTile = 64;      // output tile edge
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// acc[u][v] += sum_kk xs[kk][4*ty+u] * ys[kk][4*tx+v] over kk < DEPTH.
template <int DEPTH, int XSTRIDE, int YSTRIDE>
__device__ __forceinline__ void tile_fma(const float (*xs)[XSTRIDE],
                                         const float (*ys)[YSTRIDE],
                                         float acc[4][4], int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < DEPTH; ++kk) {
    const float4 x = *reinterpret_cast<const float4*>(&xs[kk][4 * ty]);
    const float4 y = *reinterpret_cast<const float4*>(&ys[kk][4 * tx]);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(xv[u], yv[v], acc[u][v]);
    }
  }
}

// Stage a [DEPTH][64] panel of a row-major (rows, cols) matrix into shared
// memory: panel[kk][c] = m[r0 + kk][c0 + c], zero outside the matrix.
// Consecutive threads read consecutive columns (coalesced).
template <int DEPTH, int STRIDE, typename T>
__device__ __forceinline__ void load_rows_panel(float (*panel)[STRIDE],
                                                const T* __restrict__ m,
                                                int rows, int cols, int r0,
                                                int c0) {
  for (int e = threadIdx.x; e < DEPTH * kTile; e += kThreads) {
    const int kk = e / kTile, c = e % kTile;
    const int r = r0 + kk, col = c0 + c;
    float v = 0.f;
    if (r < rows && col < cols) v = to_f32(m[(long long)r * cols + col]);
    panel[kk][c] = v;
  }
}

}  // namespace repro
