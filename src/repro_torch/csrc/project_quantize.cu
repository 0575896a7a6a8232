// Fused FD write-back for int8 eigenvector storage:
//   U_new[n] = f32(V[n]) W_top[n] + A[n] W_bot[n]
//   scale[n] = absmax(U_new[n]) / 127 (1 when the absmax is 0)
//   values[n] = clamp(round_half_even(U_new[n] / scale[n]), -127, 127)
// V (N, d, k) int8, W_top (N, k, e), A (N, d, r), W_bot (N, r, e) f32 ->
// values (N, d, e) int8, scale (N,) f32.
//
// Replaces repro/kernels/lowrank/kernel.py::batched_project_quantize_pallas,
// the eigenvector write-back of the int8 FD refresh (repro/core/fd.py
// _fd_update_batched_quantized).  The caller folds the block scale and the
// sqrt(beta2 s) ladder weights into W_top.
//
// What bounds it: f32 FFMA throughput.  A block of the main path does
// d * e * (k + r) multiply-adds (up to 1024 * 64 * 1088) on d * (k + 4 r)
// bytes of input, far above the card's bytes-per-operation line.
//
// Design: the Pallas kernel holds a whole (d, e) block in VMEM and takes its
// absmax there.  At d = 1024, e = 64 that is 256 KB of f32, more than the
// 227 KB a Hopper block can use, so the kernel runs as two passes:
//   pass 1 (project_kernel):  one 64x64 tile of U_new per block, reducing
//       over the k + r rows of [W_top; W_bot] inside the block, written to
//       an f32 scratch (N, d, e); the tile's absmax goes into the block's
//       slot with atomicMax on the float's bit pattern (non-negative floats
//       order as their bits do, so the result does not depend on the order
//       the blocks finish in);
//   pass 2 (quantize_kernel): divide, round and clamp elementwise into int8,
//       with IEEE division (no fast math) and rintf (half to even), exactly
//       as the reference's quantize_stack, so the same U_new gives the same
//       bits.
// The int8 upcast of V happens in registers as it is staged.
#include <cstdint>

#include "tile.cuh"

namespace {

using repro::kThreads;
using repro::kTile;

constexpr int kDepth = 16;             // reduction rows staged per step
constexpr int kPadStride = kTile + 4;  // transposed M panel: fewer conflicts

__global__ void __launch_bounds__(kThreads)
    project_kernel(const int8_t* __restrict__ v,
                   const float* __restrict__ w_top,
                   const float* __restrict__ a,
                   const float* __restrict__ w_bot, float* __restrict__ un,
                   unsigned int* __restrict__ absmax, int d, int k, int r,
                   int e) {
  const int r0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const long long n = blockIdx.z;
  const int kr = k + r;

  // sm[kk][row] = [V, A][r0 + row][k0 + kk]; sw[kk][c] = [W_top; W_bot]
  __shared__ __align__(16) float sm[kDepth][kPadStride];
  __shared__ __align__(16) float sw[kDepth][kTile];
  __shared__ float warp_max[kThreads / 32];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < kr; k0 += kDepth) {
    for (int idx = threadIdx.x; idx < kDepth * kTile; idx += kThreads) {
      const int rr = idx / kDepth, kk = idx % kDepth;
      const int row = r0 + rr, col = k0 + kk;
      float x = 0.f;
      if (row < d && col < kr) {
        x = col < k ? repro::to_f32(v[(n * d + row) * k + col])
                    : a[(n * d + row) * r + (col - k)];
      }
      sm[kk][rr] = x;
    }
    for (int idx = threadIdx.x; idx < kDepth * kTile; idx += kThreads) {
      const int kk = idx / kTile, c = idx % kTile;
      const int row = k0 + kk, col = c0 + c;
      float x = 0.f;
      if (row < kr && col < e) {
        x = row < k ? w_top[(n * k + row) * e + col]
                    : w_bot[(n * r + (row - k)) * e + col];
      }
      sw[kk][c] = x;
    }
    __syncthreads();
    repro::tile_fma<kDepth, kPadStride, kTile>(sm, sw, acc, ty, tx);
    __syncthreads();
  }

  float local = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = r0 + 4 * ty + q;
    if (row >= d) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = c0 + 4 * tx + c;
      if (col < e) {
        un[(n * d + row) * e + col] = acc[q][c];
        local = fmaxf(local, fabsf(acc[q][c]));
      }
    }
  }
  for (int off = 16; off > 0; off /= 2) {
    local = fmaxf(local, __shfl_xor_sync(0xffffffffu, local, off));
  }
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    atomicMax(&absmax[n], __float_as_uint(m));
  }
}

__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const float* __restrict__ un,
                    const unsigned int* __restrict__ absmax,
                    int8_t* __restrict__ values, float* __restrict__ scale,
                    long long size) {
  const long long n = blockIdx.y;
  const float amax = __uint_as_float(absmax[n]);
  const float s = amax > 0.f ? amax / 127.f : 1.f;
  if (blockIdx.x == 0 && threadIdx.x == 0) scale[n] = s;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < size;
       i += (long long)gridDim.x * kThreads) {
    const float q = rintf(un[n * size + i] / s);
    values[n * size + i] = static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
  }
}

}  // namespace

// un: f32 scratch of (n, d, e) elements; absmax: n zeroed 32-bit words.
// Returns the cudaError_t of the launches.
extern "C" int repro_batched_project_quantize(
    const void* v, const void* w_top, const void* a, const void* w_bot,
    void* un, void* absmax, void* values, void* scale, int n, int d, int k,
    int r, int e, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scratch = static_cast<float*>(un);
  unsigned int* amax = static_cast<unsigned int*>(absmax);
  const dim3 grid1((d + kTile - 1) / kTile, (e + kTile - 1) / kTile, n);
  project_kernel<<<grid1, kThreads, 0, s>>>(
      static_cast<const int8_t*>(v), static_cast<const float*>(w_top),
      static_cast<const float*>(a), static_cast<const float*>(w_bot), scratch,
      amax, d, k, r, e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long size = (long long)d * e;
  const int blocks = (int)((size + kThreads - 1) / kThreads);
  quantize_kernel<<<dim3(blocks, n), kThreads, 0, s>>>(
      scratch, amax, static_cast<int8_t*>(values), static_cast<float*>(scale),
      size);
  return static_cast<int>(cudaGetLastError());
}
