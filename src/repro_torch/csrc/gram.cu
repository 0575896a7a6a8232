// Batched Gram C[n] = A[n]^T A[n] for a packed pool stack A (N, d, k).
//
// Replaces repro/kernels/gram/kernel.py::batched_gram_pallas, the FD refresh
// Gram of M = [sqrt(beta2) B, G] (repro/core/fd.py fd_update_batched).
//
// What bounds it: f32 FFMA throughput.  A block of the main path does
// d * 64 * 64 multiply-adds on 2 * d * 64 inputs, so the kernel sits far
// above the card's bytes-per-operation line; tensor cores would be faster but
// TF32 rounds the operands and misses the 1e-4 * sqrt(d) f32 tolerance the
// reference holds the Gram to, so the product stays on the FFMA pipes.
//
// Design: one block owns one 64x64 output tile (n, i, j) and loops over all
// of d itself (d <= the block size, 1024 on the main path), so no reduction
// crosses blocks.  The output is symmetric: only tiles with i <= j run, and
// an off-diagonal tile is also written mirrored.  bf16 inputs are upcast in
// registers as they are staged into shared memory; the result is f32.
#include <cstdint>

#include "tile.cuh"

namespace {

using repro::kThreads;
using repro::kTile;

constexpr int kDepth = 16;  // rows of A staged per step

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gram_kernel(const T* __restrict__ a, float* __restrict__ c, int d, int k,
                int tiles) {
  // blockIdx.x enumerates the upper-triangular tiles row by row
  int t = blockIdx.x, ti = 0;
  while (t >= tiles - ti) {
    t -= tiles - ti;
    ++ti;
  }
  const int tj = ti + t;
  const int i0 = ti * kTile, j0 = tj * kTile;
  const long long n = blockIdx.y;
  const T* an = a + n * (long long)d * k;
  float* cn = c + n * (long long)k * k;

  __shared__ __align__(16) float si[kDepth][kTile];
  __shared__ __align__(16) float sj[kDepth][kTile];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};

  for (int r0 = 0; r0 < d; r0 += kDepth) {
    repro::load_rows_panel<kDepth, kTile>(si, an, d, k, r0, i0);
    repro::load_rows_panel<kDepth, kTile>(sj, an, d, k, r0, j0);
    __syncthreads();
    repro::tile_fma<kDepth, kTile, kTile>(si, sj, acc, ty, tx);
    __syncthreads();
  }

#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + 4 * ty + u;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = j0 + 4 * tx + v;
      if (i < k && j < k) {
        cn[(long long)i * k + j] = acc[u][v];
        if (ti != tj) cn[(long long)j * k + i] = acc[u][v];
      }
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int repro_batched_gram(const void* a, void* c, int n, int d, int k,
                                  int dtype, void* stream) {
  const int tiles = (k + kTile - 1) / kTile;
  const dim3 grid(tiles * (tiles + 1) / 2, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    gram_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<float*>(c), d, k, tiles);
  } else if (dtype == 1) {
    gram_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<float*>(c), d, k,
        tiles);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
