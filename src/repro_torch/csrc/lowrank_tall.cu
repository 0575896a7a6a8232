// Single-block low-rank inverse-root apply of one tall factor:
//   Y = base * G + U diag(c) U^T G
// U (d, ell) f32, c (ell,) f32, base a device scalar f32, G (d, n) f32, bf16
// or fp16 -> Y (d, n) in G's dtype, both products accumulated in f32.
//
// Replaces repro/kernels/lowrank/kernel.py::lowrank_apply_pallas, the apply
// of the single-block repro/core/fd.py fd_apply_inverse_root.  On the
// serving path it is S-AdaGrad's precondition step over the flattened
// lm_head: d = 25,165,824, ell = 8, n = 1.
//
// What bounds it: device memory.  One read of U (805 MB) and of G and one
// write of Y, about 1.01 GB, take 0.300 ms at 3.35 TB/s; the 4 d ell n
// flops take 0.012 ms.
//
// Design: the Pallas kernel keeps all of U in VMEM, which holds a
// 1024-row block but not 25M rows, and P = c o U^T G needs the whole of d
// before any row of Y can be written.  So the apply runs in two passes over
// d, and reads U twice (0.54 ms of reads at full bandwidth):
//   pass 1: the split-d cross product U^T G (split_d.cuh) into f32 partials
//           (S, ell, n), then their sum in a fixed order of slabs, scaled by
//           c, into P (ell, n);
//   pass 2 (expand_tall_kernel): elementwise over the rows of d, with P's
//           column tile in shared memory: y[r][j] = base g[r][j] +
//           sum_e u[r][e] P[e][j], summed in order of e.
// The batched apply (lowrank.cu) gives one block to each 64x64 tile of P,
// which at ell = 8, n = 1 is one block on one SM for the whole of pass 1.
//
// Pass 2 holds ell x 8 floats of P in shared memory: above 48 KB (ell >
// 1,536) it asks for up to the card's 227 KB (ell <= 7,264), and a wider U
// (the reference takes any ell) runs pass 2 in chunks of at most 7,264 of
// its columns, in order: the first adds base g, each chunk's sum is added
// to the last one's in an f32 scratch (d, n), and the last rounds to y.
// At ell <= 7,264 that is one launch, the kernel as it was.
#include "split_d.cuh"

namespace {

using repro::kColTile;
using repro::kThreads;

constexpr long long kMaxExpandBlocks = 1024;  // grid-stride over the rows
constexpr int kMaxSmem = 232448;
constexpr int kMaxEll = kMaxSmem / (4 * kColTile);  // pass 2's chunk

// ell: the chunk's columns of U, from column 0 of u (rows ldu apart) and of
// p's rows; ``first``: y = base g + U P, else yacc + U P; ``last``: into y,
// else into yacc (f32, y's layout).
template <typename TG>
__global__ void __launch_bounds__(kThreads)
    expand_tall_kernel(const float* __restrict__ u, int ell,
                       const float* __restrict__ p,
                       const float* __restrict__ base,
                       const TG* __restrict__ g, TG* __restrict__ y,
                       long long d, int n, int ldu, float* __restrict__ yacc,
                       int first, int last) {
  extern __shared__ float sp[];  // [ell][jn]: P's column tile
  const int j0 = blockIdx.y * kColTile, jn = min(kColTile, n - j0);
  for (int e = threadIdx.x; e < ell * jn; e += kThreads) {
    sp[e] = p[(e / jn) * n + j0 + e % jn];
  }
  __syncthreads();
  const int rows = kThreads / jn;  // rows per step
  const int ro = threadIdx.x / jn, j = threadIdx.x % jn;
  if (ro >= rows) return;
  const float b = *base;
  const long long stride = (long long)gridDim.x * rows;
  for (long long r = (long long)blockIdx.x * rows + ro; r < d; r += stride) {
    const float* ur = u + r * ldu;
    float acc = 0.f;
#pragma unroll 8
    for (int e = 0; e < ell; ++e) acc = fmaf(ur[e], sp[e * jn + j], acc);
    const long long at = r * n + j0 + j;
    if (first && last) {
      y[at] = repro::from_f32<TG>(b * repro::to_f32(g[at]) + acc);
      continue;
    }
    const float v = (first ? b * repro::to_f32(g[at]) : yacc[at]) + acc;
    if (last) {
      y[at] = repro::from_f32<TG>(v);
    } else {
      yacc[at] = v;
    }
  }
}

template <typename TG>
int launch(const float* u, const float* coeffs, const float* base,
           const TG* g, float* partial, float* p, TG* y, float* yacc,
           long long d, int ell, int n, int slabs, long long slab_rows,
           void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = repro::cross_partial(u, ell, g, n, partial, d, slabs,
                                         slab_rows, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = repro::reduce_partials(partial, slabs, ell * n, coeffs, n, p, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int col_tiles = (n + kColTile - 1) / kColTile;
  const int jn = n < kColTile ? n : kColTile;
  const long long rows = kThreads / jn;  // rows per block step
  const long long blocks = (d + rows - 1) / rows;
  const int expand_blocks =
      static_cast<int>(blocks < kMaxExpandBlocks ? blocks : kMaxExpandBlocks);
  for (int e0 = 0; e0 < ell; e0 += kMaxEll) {
    const int w = ell - e0 < kMaxEll ? ell - e0 : kMaxEll;
    const size_t smem = sizeof(float) * w * jn;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(expand_tall_kernel<TG>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    expand_tall_kernel<TG>
        <<<dim3(expand_blocks, col_tiles), kThreads, smem, stream>>>(
            u + e0, w, p + static_cast<long long>(e0) * n, base, g, y, d, n,
            ell, yacc, e0 == 0, e0 + w == ell);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// u (d, ell) f32, coeffs (ell,) f32, base: one f32 on the device, g and y
// (d, n) with g_dtype 0 = float32, 1 = bfloat16, 2 = float16; partial: f32
// scratch of slabs * ell * n elements, p: f32 scratch of ell * n, yacc: f32
// scratch of d * n where ell > 7,264 (else unused, may be null).  The
// caller picks slabs and slab_rows with slabs * slab_rows >= d.  Returns
// the cudaError_t of the launches.
extern "C" int repro_lowrank_tall(const float* u, const float* coeffs,
                                  const float* base, const void* g,
                                  int g_dtype, float* partial, float* p,
                                  void* y, float* yacc, long long d, int ell,
                                  int n, int slabs, long long slab_rows,
                                  void* stream) {
  if (g_dtype == 0) {
    return launch(u, coeffs, base, static_cast<const float*>(g), partial, p,
                  static_cast<float*>(y), yacc, d, ell, n, slabs, slab_rows,
                  stream);
  }
  if (g_dtype == 1) {
    return launch(u, coeffs, base, static_cast<const __nv_bfloat16*>(g),
                  partial, p, static_cast<__nv_bfloat16*>(y), yacc, d, ell,
                  n, slabs, slab_rows, stream);
  }
  if (g_dtype == 2) {
    return launch(u, coeffs, base, static_cast<const __half*>(g), partial, p,
                  static_cast<__half*>(y), yacc, d, ell, n, slabs, slab_rows,
                  stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
