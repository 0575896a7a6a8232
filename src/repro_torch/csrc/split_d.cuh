// Split-d reductions over the rows of one tall matrix: the building blocks
// of the single-block Gram (gram_tall.cu) and low-rank apply
// (lowrank_tall.cu).
//
// On the serving path those operands are one (d, p) matrix with d =
// 25,165,824 rows and p <= 9 columns, not a pool stack.  A kernel that gives
// one block to each output tile (the batched kernels, gram.cu and
// lowrank.cu) would run on one of the 132 SMs there.  So the rows are cut
// into S slabs of consecutive rows; each block reduces one slab into an f32
// partial, written to a scratch (S, p, q), and a second small pass sums the
// S partials in order of s.  No float atomics anywhere: the same inputs
// give the same bits on every run (the gradient monitor compares its
// readings with thresholds, so a reading must not flip between runs).
#pragma once

#include "tile.cuh"

namespace repro {

constexpr int kColTile = 8;  // columns of y a block of cross_partial takes

// partial[s][i][j] = sum over the rows r of slab s of x[r][i] * y[r][j]:
// x (d, p) and y (d, q) row-major, partial (S, p, q) f32, slab s the rows
// [s * slab_rows, min(d, (s + 1) * slab_rows)).
// Grid (ceil(q / JT), ceil(p / kThreads), S).  A block takes `it` <=
// kThreads consecutive columns of x and kThreads / it rows at a time, so
// each step reads a contiguous stretch of x (coalesced); a thread keeps one
// column i of x and the JT columns of y of its block in registers, and the
// block then adds its row groups in order.
template <typename TX, typename TY, int JT>
__global__ void __launch_bounds__(kThreads)
    cross_partial_kernel(const TX* __restrict__ x, int p,
                         const TY* __restrict__ y, int q,
                         float* __restrict__ partial, long long d,
                         long long slab_rows) {
  const int j0 = blockIdx.x * JT, i0 = blockIdx.y * kThreads;
  const int jn = min(JT, q - j0), it = min(kThreads, p - i0);
  const int groups = kThreads / it;  // rows per step
  const int t = threadIdx.x, grp = t / it, i = i0 + t % it;
  const long long s = blockIdx.z;
  const long long r1 = min(d, (s + 1) * slab_rows);

  float acc[JT];
#pragma unroll
  for (int j = 0; j < JT; ++j) acc[j] = 0.f;
  if (grp < groups) {
#pragma unroll 4
    for (long long r = s * slab_rows + grp; r < r1; r += groups) {
      const float xv = to_f32(x[r * p + i]);
      const TY* yr = y + r * q + j0;
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        if (j < jn) acc[j] = fmaf(xv, to_f32(yr[j]), acc[j]);
      }
    }
  }

  __shared__ float sums[kThreads][JT];
#pragma unroll
  for (int j = 0; j < JT; ++j) sums[t][j] = acc[j];
  __syncthreads();
  for (int e = t; e < it * jn; e += kThreads) {
    const int il = e / jn, j = e % jn;
    float total = 0.f;
    for (int g = 0; g < groups; ++g) total += sums[g * it + il][j];
    partial[(s * p + i0 + il) * q + j0 + j] = total;
  }
}

// out[e] = w(e) * sum over s < S of partial[s][e], for e < n, added in
// order of s; w(e) = rowscale[e / q] when rowscale is given, else 1.
__global__ void __launch_bounds__(kThreads)
    reduce_partials_kernel(const float* __restrict__ partial, int slabs,
                           int n, const float* __restrict__ rowscale, int q,
                           float* __restrict__ out) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  float total = 0.f;
#pragma unroll 8
  for (int s = 0; s < slabs; ++s) total += partial[(long long)s * n + e];
  out[e] = rowscale != nullptr ? rowscale[e / q] * total : total;
}

inline cudaError_t reduce_partials(const float* partial, int slabs, int n,
                                   const float* rowscale, int q, float* out,
                                   cudaStream_t stream) {
  reduce_partials_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                           stream>>>(partial, slabs, n, rowscale, q, out);
  return cudaGetLastError();
}

// cross_partial_kernel over the whole (p, q) output; JT = 1 for a single
// column of y (the S-AdaGrad gradient), else kColTile.
template <typename TX, typename TY>
cudaError_t cross_partial(const TX* x, int p, const TY* y, int q,
                          float* partial, long long d, int slabs,
                          long long slab_rows, cudaStream_t stream) {
  const int i_tiles = (p + kThreads - 1) / kThreads;
  if (q == 1) {
    cross_partial_kernel<TX, TY, 1>
        <<<dim3(1, i_tiles, slabs), kThreads, 0, stream>>>(
            x, p, y, q, partial, d, slab_rows);
  } else {
    cross_partial_kernel<TX, TY, kColTile>
        <<<dim3((q + kColTile - 1) / kColTile, i_tiles, slabs), kThreads, 0,
            stream>>>(x, p, y, q, partial, d, slab_rows);
  }
  return cudaGetLastError();
}

}  // namespace repro
