// Batched Grams C[n] = M[n]^T M[n] of a packed pool stack, for two kinds of
// M (N, d, k):
//   repro_batched_gram:        M = A, f32 or bf16;
//   repro_batched_gram_mixed:  M = [V, A], V (N, d, ell) int8, A (N, d, r) f32,
//                              k = ell + r.
//
// Replace repro/kernels/gram/kernel.py::batched_gram_pallas, the FD refresh
// Gram of M = [sqrt(beta2) B, G] (repro/core/fd.py fd_update_batched), and
// ::batched_gram_mixed_pallas, the same Gram with the eigenvectors stored in
// int8 (repro/core/fd.py _fd_update_batched_quantized).  The mixed Gram's
// column weights C = C0 o w w^T (block scale x sqrt(beta2 s) on V's columns)
// are applied by the caller on the small (k, k) output, as the reference
// applies them outside its pallas_call.
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
// an off-diagonal tile is also written mirrored.  bf16 and int8 inputs are
// upcast in registers as they are staged into shared memory (the int8 upcast
// is the dequantize: V never exists in f32 in device memory); the result is
// f32.  The mixed stack's loader picks V or A per column, so a 64-wide tile
// may straddle the two (ell = 12 on the 12x768 group), and it reads element
// by element, so V's rows need no alignment (12 bytes there).
#include <cstdint>

#include "tile.cuh"

namespace {

using repro::kThreads;
using repro::kTile;

constexpr int kDepth = 16;  // rows of M staged per step

// M = A: element (row, col) of block n of a row-major (N, d, k) stack.
template <typename T>
struct Dense {
  const T* a;
  int d, k;
  __device__ __forceinline__ float operator()(long long n, int row,
                                              int col) const {
    return repro::to_f32(a[(n * d + row) * k + col]);
  }
};

// M = [V, A]: columns below ell from the int8 V, the rest from the f32 A.
struct Mixed {
  const int8_t* v;
  const float* a;
  int d, ell, r;
  __device__ __forceinline__ float operator()(long long n, int row,
                                              int col) const {
    if (col < ell) return repro::to_f32(v[(n * d + row) * ell + col]);
    return a[(n * d + row) * r + (col - ell)];
  }
};

// panel[kk][c] = M[n][r0 + kk][c0 + c], zero outside the (d, k) matrix.
template <typename Src>
__device__ __forceinline__ void load_panel(float (*panel)[kTile], Src m,
                                           long long n, int d, int k, int r0,
                                           int c0) {
  for (int e = threadIdx.x; e < kDepth * kTile; e += kThreads) {
    const int kk = e / kTile, c = e % kTile;
    const int r = r0 + kk, col = c0 + c;
    panel[kk][c] = (r < d && col < k) ? m(n, r, col) : 0.f;
  }
}

template <typename Src>
__global__ void __launch_bounds__(kThreads)
    gram_kernel(Src m, float* __restrict__ c, int d, int k, int tiles) {
  // blockIdx.x enumerates the upper-triangular tiles row by row
  int t = blockIdx.x, ti = 0;
  while (t >= tiles - ti) {
    t -= tiles - ti;
    ++ti;
  }
  const int tj = ti + t;
  const int i0 = ti * kTile, j0 = tj * kTile;
  const long long n = blockIdx.y;
  float* cn = c + n * (long long)k * k;

  __shared__ __align__(16) float si[kDepth][kTile];
  __shared__ __align__(16) float sj[kDepth][kTile];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};

  for (int r0 = 0; r0 < d; r0 += kDepth) {
    load_panel(si, m, n, d, k, r0, i0);
    load_panel(sj, m, n, d, k, r0, j0);
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

template <typename Src>
int launch(Src m, float* c, int n, int d, int k, void* stream) {
  const int tiles = (k + kTile - 1) / kTile;
  const dim3 grid(tiles * (tiles + 1) / 2, n);
  gram_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      m, c, d, k, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int repro_batched_gram(const void* a, void* c, int n, int d, int k,
                                  int dtype, void* stream) {
  float* out = static_cast<float*>(c);
  if (dtype == 0) {
    return launch(Dense<float>{static_cast<const float*>(a), d, k}, out, n, d,
                  k, stream);
  }
  if (dtype == 1) {
    return launch(
        Dense<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(a), d, k}, out,
        n, d, k, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// C0 (n, ell + r, ell + r) = [V, A]^T [V, A], unweighted.  Returns the
// cudaError_t of the launch.
extern "C" int repro_batched_gram_mixed(const void* v, const void* a, void* c,
                                        int n, int d, int ell, int r,
                                        void* stream) {
  return launch(Mixed{static_cast<const int8_t*>(v),
                      static_cast<const float*>(a), d, ell, r},
                static_cast<float*>(c), n, d, ell + r, stream);
}
