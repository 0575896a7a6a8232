// Batched low-rank inverse-root apply over a packed pool stack:
//   Y[n] = base[n] * G[n] + U[n] diag(c[n]) U[n]^T G[n]
// U (N, d, ell) f32 or int8, c (N, ell), base (N,), G (N, d, m) f32 ->
// Y (N, d, m) f32.  U is f32 under fp32 and bf16 second-moment storage (the
// engine hands over the f32 compute copy) and int8 under int8 storage: the
// fused int8 path (repro/kernels/registry.py _fold_quantized_apply) passes
// the raw int8 eigenvectors with the block scale^2 folded into c, and the
// kernel's upcast in registers is the dequantize.
//
// Replaces repro/kernels/lowrank/kernel.py::batched_lowrank_apply_pallas,
// the Sketchy preconditioner apply (repro/core/fd.py
// fd_apply_inverse_root_batched, run twice per step from
// repro/core/sketchy.py precondition_batched).
//
// What bounds it: f32 FFMA throughput, narrowly over memory.  Per pool block
// it does 4 * d * ell * m flops while reading G and writing Y (8 * d * m
// bytes in f32): ell / 2 = 32 flops per byte at ell = 64, above the card's
// 20 f32 FFMA flops per byte of device memory.  An int8 U reads a quarter of
// the bytes of an f32 one but does the same f32 work.
//
// Design: the Pallas kernel keeps the whole U (d, ell) and a (d, bn) tile of
// G in VMEM.  At d = 1024, ell = 64 that is 256 KB of f32 U alone, more than
// the 227 KB a Hopper block can use, so the apply runs as two passes with a
// small f32 scratch P (N, ell, m) in device memory (ell/d of G's size):
//   pass 1 (proj_kernel):   P = c o (U^T G), one 64x64 tile of P per block,
//                           reducing over all of d inside the block;
//   pass 2 (expand_kernel): Y = base * G + U P, one 64x64 tile of Y per
//                           block, reducing over ell inside the block.
// Both accumulate in f32 FFMA (no TF32).
#include "tile.cuh"

namespace {

using repro::kThreads;
using repro::kTile;

constexpr int kDepth = 16;             // reduction rows staged per step
constexpr int kPadStride = kTile + 4;  // transposed U panel: fewer conflicts

template <typename TU>
__global__ void __launch_bounds__(kThreads)
    proj_kernel(const TU* __restrict__ u, const float* __restrict__ coeffs,
                const float* __restrict__ g, float* __restrict__ p, int d,
                int ell, int m) {
  const int e0 = blockIdx.x * kTile, j0 = blockIdx.y * kTile;
  const long long n = blockIdx.z;
  const TU* un = u + n * (long long)d * ell;
  const float* gn = g + n * (long long)d * m;
  float* pn = p + n * (long long)ell * m;

  __shared__ __align__(16) float su[kDepth][kTile];
  __shared__ __align__(16) float sg[kDepth][kTile];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};

  for (int r0 = 0; r0 < d; r0 += kDepth) {
    repro::load_rows_panel<kDepth, kTile>(su, un, d, ell, r0, e0);
    repro::load_rows_panel<kDepth, kTile>(sg, gn, d, m, r0, j0);
    __syncthreads();
    repro::tile_fma<kDepth, kTile, kTile>(su, sg, acc, ty, tx);
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int e = e0 + 4 * ty + q;
    if (e >= ell) continue;
    const float ce = coeffs[n * ell + e];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = j0 + 4 * tx + v;
      if (j < m) pn[(long long)e * m + j] = ce * acc[q][v];
    }
  }
}

template <typename TU>
__global__ void __launch_bounds__(kThreads)
    expand_kernel(const TU* __restrict__ u, const float* __restrict__ base,
                  const float* __restrict__ g, const float* __restrict__ p,
                  float* __restrict__ y, int d, int ell, int m) {
  const int r0 = blockIdx.x * kTile, j0 = blockIdx.y * kTile;
  const long long n = blockIdx.z;
  const TU* un = u + n * (long long)d * ell;
  const float* gn = g + n * (long long)d * m;
  const float* pn = p + n * (long long)ell * m;
  float* yn = y + n * (long long)d * m;

  __shared__ __align__(16) float su[kDepth][kPadStride];  // su[kk][r] = U[r][e]
  __shared__ __align__(16) float sp[kDepth][kTile];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};

  for (int e0 = 0; e0 < ell; e0 += kDepth) {
    for (int idx = threadIdx.x; idx < kDepth * kTile; idx += kThreads) {
      const int rr = idx / kDepth, kk = idx % kDepth;
      const int r = r0 + rr, e = e0 + kk;
      float v = 0.f;
      if (r < d && e < ell) {
        v = repro::to_f32(un[(long long)r * ell + e]);
      }
      su[kk][rr] = v;
    }
    repro::load_rows_panel<kDepth, kTile>(sp, pn, ell, m, e0, j0);
    __syncthreads();
    repro::tile_fma<kDepth, kPadStride, kTile>(su, sp, acc, ty, tx);
    __syncthreads();
  }

  const float b = base[n];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = r0 + 4 * ty + q;
    if (r >= d) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = j0 + 4 * tx + v;
      if (j < m) {
        const long long at = (long long)r * m + j;
        yn[at] = b * gn[at] + acc[q][v];
      }
    }
  }
}

template <typename TU>
int launch(const TU* u, const float* coeffs, const float* base, const float* g,
           float* p, float* y, int n, int d, int ell, int m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m_tiles = (m + kTile - 1) / kTile;
  proj_kernel<<<dim3((ell + kTile - 1) / kTile, m_tiles, n), kThreads, 0, s>>>(
      u, coeffs, g, p, d, ell, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  expand_kernel<<<dim3((d + kTile - 1) / kTile, m_tiles, n), kThreads, 0, s>>>(
      u, base, g, p, y, d, ell, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u_dtype: 0 = float32, 2 = int8.  p is f32 scratch of (n, ell, m) elements.
// Returns the cudaError_t of the launches.
extern "C" int repro_batched_lowrank_apply(const void* u, int u_dtype,
                                           const float* coeffs,
                                           const float* base, const float* g,
                                           float* p, float* y, int n, int d,
                                           int ell, int m, void* stream) {
  if (u_dtype == 0) {
    return launch(static_cast<const float*>(u), coeffs, base, g, p, y, n, d,
                  ell, m, stream);
  }
  if (u_dtype == 2) {
    return launch(static_cast<const int8_t*>(u), coeffs, base, g, p, y, n, d,
                  ell, m, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
