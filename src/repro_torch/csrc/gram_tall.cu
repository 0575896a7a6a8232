// Single-block Gram C = A^T A of one tall matrix A (d, k), f32, bf16 or
// fp16, accumulated in f32 -> C (k, k) f32.
//
// Replaces repro/kernels/gram/kernel.py::gram_pallas, the Gram of the FD
// factor M = [sqrt(beta2) U diag(sqrt s), g] in the single-block
// repro/core/fd.py fd_update.  On the serving path (the gradient monitor,
// and S-AdaGrad's refresh over the flattened lm_head) A is d = 25,165,824
// rows by k = ell + 1 = 9 columns: 906 MB of f32.
//
// What bounds it: device memory.  Reading A once takes 0.270 ms at 3.35
// TB/s; its d k (k + 1) = 2.26 GFLOP of symmetric FFMA work take 0.034 ms.
//
// Design: split over d (split_d.cuh).  A block of the batched Gram
// (gram.cu) owns an output tile and loops over all of d; at N = 1, k = 9
// that is one block streaming 906 MB on one SM.  Here each block reduces a
// slab of consecutive rows into an f32 k x k partial and a second pass sums
// the partials in a fixed order, so the result has the same bits on every
// run.  For k <= kRowsMaxK (the serving shapes) a thread takes whole rows:
// k loads, then the k (k + 1) / 2 products of the upper triangle in
// registers, with k a template parameter so the triangle unrolls; the
// block sums its threads with warp shuffles and then its warps in order.
// A wider A takes the generic split-d cross product (cross_partial_kernel,
// tiles of kThreads columns of A by kColTile columns of A), which computes
// the full square.
#include "split_d.cuh"

namespace {

using repro::kThreads;

constexpr int kRowsMaxK = 16;

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    gram_rows_kernel(const T* __restrict__ a, float* __restrict__ partial,
                     long long d, long long slab_rows) {
  constexpr int kE = K * (K + 1) / 2;   // upper-triangle entries
  constexpr int kU = K <= 8 ? 4 : 2;    // rows in flight per thread
  constexpr int kWarps = kThreads / 32;
  const long long s = blockIdx.x;
  const long long r1 = min(d, (s + 1) * slab_rows);

  float acc[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) acc[e] = 0.f;
  for (long long r = s * slab_rows + threadIdx.x; r < r1;
       r += kU * kThreads) {
    float row[kU][K];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long rr = r + (long long)u * kThreads;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        row[u][c] = rr < r1 ? repro::to_f32(a[rr * K + c]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      int e = 0;
#pragma unroll
      for (int i = 0; i < K; ++i) {
#pragma unroll
        for (int j = i; j < K; ++j) {
          acc[e] = fmaf(row[u][i], row[u][j], acc[e]);
          ++e;
        }
      }
    }
  }

#pragma unroll
  for (int e = 0; e < kE; ++e) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
    }
  }
  __shared__ float warp_sums[kWarps][kE];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
#pragma unroll
    for (int e = 0; e < kE; ++e) warp_sums[warp][e] = acc[e];
  }
  __syncthreads();
  float* out = partial + s * K * K;
  for (int e = threadIdx.x; e < kE; e += kThreads) {
    float total = 0.f;
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w][e];
    int i = 0, rest = e;
    while (rest >= K - i) {
      rest -= K - i;
      ++i;
    }
    const int j = i + rest;
    out[i * K + j] = total;
    out[j * K + i] = total;
  }
}

// gram_rows_kernel<T, k> for the runtime k <= kRowsMaxK.
template <typename T, int K = 1>
void launch_rows(const T* a, float* partial, long long d, int k, int slabs,
                 long long slab_rows, cudaStream_t stream) {
  if constexpr (K <= kRowsMaxK) {
    if (k == K) {
      gram_rows_kernel<T, K>
          <<<slabs, kThreads, 0, stream>>>(a, partial, d, slab_rows);
    } else {
      launch_rows<T, K + 1>(a, partial, d, k, slabs, slab_rows, stream);
    }
  }
}

template <typename T>
int launch(const T* a, float* partial, float* c, long long d, int k,
           int slabs, long long slab_rows, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (k <= kRowsMaxK) {
    launch_rows(a, partial, d, k, slabs, slab_rows, stream);
  } else {
    repro::cross_partial(a, k, a, k, partial, d, slabs, slab_rows, stream);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      repro::reduce_partials(partial, slabs, k * k, nullptr, k, c, stream));
}

}  // namespace

// a (d, k) row-major, dtype 0 = float32, 1 = bfloat16, 2 = float16;
// partial: f32 scratch of slabs * k * k elements; c (k, k) f32.  The caller
// picks slabs and slab_rows with slabs * slab_rows >= d.  Returns the
// cudaError_t of the launches.
extern "C" int repro_gram_tall(const void* a, float* partial, float* c,
                               long long d, int k, int dtype, int slabs,
                               long long slab_rows, void* stream) {
  if (dtype == 0) {
    return launch(static_cast<const float*>(a), partial, c, d, k, slabs,
                  slab_rows, stream);
  }
  if (dtype == 1) {
    return launch(static_cast<const __nv_bfloat16*>(a), partial, c, d, k,
                  slabs, slab_rows, stream);
  }
  if (dtype == 2) {
    return launch(static_cast<const __half*>(a), partial, c, d, k, slabs,
                  slab_rows, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
