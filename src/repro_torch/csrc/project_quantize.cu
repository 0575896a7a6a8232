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
// What bounds it: f32 FFMA throughput, 67 TFLOP/s.  A block of the main
// path does d * e * (k + r) multiply-adds (up to 1024 * 64 * 1088) on
// d * (k + 4 r) bytes of input, far above the card's bytes-per-operation
// line.  FFMA, not TF32 tensor cores: the write-back's check (a scale within
// rtol 1e-5, an int8 value off by one only within 1e-3 of a step from a .5
// boundary) needs f32 products.
//
// Passes: the Pallas kernel holds a whole (d, e) block in VMEM and takes its
// absmax there.  At d = 1024, e = 64 that is 256 KB of f32, more than the
// 227 KB a Hopper block can use, so U_new goes through an f32 scratch:
//   pass 1 (project_kernel): 128 x 64 tiles of U_new, each reduced over
//       panels of the k + r rows of [W_top; W_bot].  The work is split
//       stream-K style: the tiles' panels in a row, cut evenly among a fixed
//       number of blocks (as many as fit on the card at once), so no block
//       waits on a last partial wave (a refresh's largest group has 544
//       tiles for 396 resident blocks: two full waves' time for 1.4 waves of
//       work when one block takes one tile).  A block that covers a whole
//       tile writes it and puts the tile's absmax into its block n's slot
//       with atomicMax on the float's bit pattern (non-negative floats order
//       as their bits do, so the result does not depend on the order the
//       blocks finish in); a part of a tile goes to a partial slot;
//   pass 1b (fixup_kernel): each tile left in parts gets U_new = its parts
//       added in block order (the same bits every run, no float atomics),
//       and the absmax as in pass 1;
//   pass 2 (quantize_kernel): divide, round and clamp elementwise into int8,
//       with IEEE division (no fast math) and rintf (half to even), exactly
//       as the reference's quantize_stack, so the same U_new gives the same
//       bits; four values a thread where the widths allow.
// kernels/lowrank/kernel.py ``project_plan`` sets the number of blocks and
// mirrors the partition (tested on the CPU).
//
// Design of pass 1, against the FFMA bound: a block of 128 threads owns
// 128 rows of d across 64 output columns (all of e <= 64, so a W panel is
// read once per 128 rows).  Thread (ty, tx) of the 16 x 8 grid keeps an
// 8 x 8 register tile at rows ty + 16 u (u < 8) and columns 4 tx + {0..3,
// 32..35}.  The reduction runs over panels 32 deep: first ceil(k / 32) of
// V, then ceil(r / 32) of A, each zero past its end (int8 and f32 columns
// never share a panel).  The [V | A] panel is kept row-major, [128][32 + 4]
// f32, so every 4 reduction steps a thread reads one float4 per row (8)
// and two per W row (8): 16 FMAs per float4 shared load.  The 4-float pad
// puts the four rows a warp reads at once (ty = 0..3) on distinct banks,
// and the W reads are 128 contiguous bytes, broadcast across ty.  Panels are
// double buffered, one __syncthreads each, the next in flight while this one
// computes: A's rows and W's panel by 16-byte cp.async straight into shared
// memory (zero-filled past the edges), consecutive threads on consecutive
// chunks of a row so that a warp reads whole 128-byte lines; V's int8 rows
// as 16-byte loads held in registers and upcast to f32 as they are stored
// after the compute.  Widths that are no multiple of the vector (k % 16,
// r % 4, e % 4) or unaligned bases take masked scalar loads instead
// (``vector`` flags).  The launch bound holds a block to 168 registers so
// three fit an SM (the plan's 396 blocks); unbounded, ptxas takes 255 and
// two fit.  Larger register tiles (16 x 8, 12 x 8), which need fewer shared
// loads per FMA, spilled or ran slower on the H100.
#include <algorithm>
#include <cstdint>

#include "hopper.cuh"
#include "tile.cuh"

namespace {

using repro::kThreads;

constexpr int kRows = 128;      // rows of d a block owns
constexpr int kCols = 64;       // output columns a block owns
constexpr int kDepth = 32;      // reduction rows a panel holds
constexpr int kMStride = kDepth + 4;  // padded row of the [V | A] panel
constexpr int kPThreads = 128;  // 16 x 8 threads, 8 x 8 outputs each
// sm[2][kRows][kMStride] and sw[2][kDepth][kCols], f32; the plan's number
constexpr size_t kProjectSmem =
    sizeof(float) * 2 * (kRows * kMStride + kDepth * kCols);

struct Vec {  // which operands take 16-byte accesses
  bool v, a, w, un;
};

struct Panel {  // reduction columns c0 .. c0 + 31 of V (in_v) or of A
  bool in_v;
  int c0;
};

__device__ __forceinline__ Panel panel_of(int p, int nv) {
  return p < nv ? Panel{true, kDepth * p} : Panel{false, kDepth * (p - nv)};
}

// Row-major panel m (rows, cols) columns c0 .. c0 + 31 of row ``row`` into
// the shared row ``dst`` (32 floats), zero past the matrix, with scalar
// loads: the unaligned or ragged widths.
template <typename T>
__device__ __forceinline__ void row_scalar(float* dst, const T* __restrict__ m,
                                           long long row, bool in_rows,
                                           int cols, int c0) {
#pragma unroll 4
  for (int j = 0; j < kDepth; ++j) {
    dst[j] = in_rows && c0 + j < cols
                 ? static_cast<float>(m[row * cols + c0 + j])
                 : 0.f;
  }
}

// Rows c0 .. c0 + 31 (zero from ``rows`` on) and columns e0 .. e0 + 63 of
// the row-major (rows, e) matrix w into the panel sw[kDepth][kCols].
__device__ __forceinline__ void load_w(float* sw, const float* __restrict__ w,
                                       int rows, int e, int c0, int e0,
                                       bool vec) {
  if (vec) {  // one 16-byte cp.async per 4 columns, zero-filled outside
    for (int f = threadIdx.x; f < kDepth * kCols / 4; f += kPThreads) {
      const int kk = f / (kCols / 4), col = 4 * (f % (kCols / 4));
      const bool in = c0 + kk < rows && e0 + col < e;
      repro::cp_async16(repro::smem_addr(sw + kk * kCols + col),
                        in ? w + (long long)(c0 + kk) * e + e0 + col : w,
                        in ? 16 : 0);
    }
  } else {
    for (int f = threadIdx.x; f < kDepth * kCols; f += kPThreads) {
      const int kk = f / kCols, col = f % kCols;
      const bool in = c0 + kk < rows && e0 + col < e;
      sw[kk * kCols + col] = in ? w[(long long)(c0 + kk) * e + e0 + col] : 0.f;
    }
  }
}

// Sixteen int8 values of a V row, upcast to f32 into dst[0..15].
__device__ __forceinline__ void store_int8x16(float* dst, int4 x) {
  const int words[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int g = 0; g < 4; ++g) {  // bytes of word g, sign-extended
    const unsigned w = static_cast<unsigned>(words[g]);
    *reinterpret_cast<float4*>(dst + 4 * g) = make_float4(
        static_cast<float>(static_cast<int>(w << 24) >> 24),
        static_cast<float>(static_cast<int>(w << 16) >> 24),
        static_cast<float>(static_cast<int>(w << 8) >> 24),
        static_cast<float>(static_cast<int>(w) >> 24));
  }
}

// The stream-K partition of pass 1: unit u = tile * np + panel, tile =
// (n * gy + by) * gx + bx over gx = ceil(d / 128) row blocks and gy =
// ceil(e / 64) column blocks; block c takes units [lo(c), lo(c + 1)).
struct Work {
  long long units;
  int blocks, np, gx, gy;

  __device__ __forceinline__ long long lo(int c) const {
    return c * units / blocks;
  }
  __device__ __forceinline__ int block_of(long long u) const {
    int c = static_cast<int>(u * blocks / units);
    while (c + 1 < blocks && lo(c + 1) <= u) ++c;
    while (lo(c) > u) --c;
    return c;
  }
};

constexpr int kTileElems = kRows * kCols;

// Grid (blocks): block c reduces its units, a run of panels of one tile at
// a time.  A run that is a whole tile writes U_new and the tile's absmax;
// a part of a tile goes to the block's partial slot: 0 for a run that
// starts inside its tile (the block's first), 1 for a run that starts the
// tile and ends inside it (the block's last).  fixup_kernel adds the parts.
__global__ void __launch_bounds__(kPThreads, 3)
    project_kernel(const int8_t* __restrict__ v,
                   const float* __restrict__ w_top,
                   const float* __restrict__ a,
                   const float* __restrict__ w_bot, float* __restrict__ un,
                   float* __restrict__ partial,
                   unsigned int* __restrict__ absmax, int d, int k, int r,
                   int e, Work work, Vec vec) {
  extern __shared__ __align__(16) float panels[];
  float* sm = panels;                           // [2][kRows][kMStride]
  float* sw = panels + 2 * kRows * kMStride;    // [2][kDepth][kCols]
  __shared__ float warp_max[kPThreads / 32];
  const int t = threadIdx.x, tx = t % 8, ty = t / 8;
  const int nv = (k + kDepth - 1) / kDepth, np = work.np;
  const int c = blockIdx.x;
  const long long hi = work.lo(c + 1);

  for (long long u = work.lo(c); u < hi;) {
    const long long tile = u / np;
    const int pa = static_cast<int>(u % np);
    const int pb =
        static_cast<int>(min(static_cast<long long>(np), pa + (hi - u)));
    u += pb - pa;
    const int r0 = static_cast<int>(tile % work.gx) * kRows;
    const int e0 = static_cast<int>(tile / work.gx % work.gy) * kCols;
    const long long n = tile / (static_cast<long long>(work.gx) * work.gy);
    const float* wt = w_top + n * k * e;
    const float* wb = w_bot + n * r * e;
    const long long row = n * d + r0 + t;  // the row a scalar load stages
    const bool in_rows = r0 + t < d;

    // Vector staging, coalesced: 16-byte chunk f = t + 128 i of the panel
    // is A's row f / 8, columns 4 (f % 8) .. + 3 (a warp reads 4 whole
    // 128-byte row pieces), or V's row f / 2, columns 16 (f % 2) .. + 15.
    int4 held[2];
    // Start panel p into buffer buf: W and A by cp.async (scalar loads
    // store at once); V's chunks into ``held``.
    auto stage = [&](int p, int buf) {
      const Panel pn = panel_of(p, nv);
      load_w(sw + buf * kDepth * kCols, pn.in_v ? wt : wb, pn.in_v ? k : r,
             e, pn.c0, e0, vec.w);
      float* panel = sm + buf * kRows * kMStride;
      if (pn.in_v && vec.v) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int f = t + kPThreads * i, rr = f / 2;
          const int col = pn.c0 + 16 * (f % 2);
          held[i] = r0 + rr < d && col < k
                        ? *reinterpret_cast<const int4*>(
                              v + (n * d + r0 + rr) * k + col)
                        : make_int4(0, 0, 0, 0);
        }
      } else if (pn.in_v) {
        row_scalar(panel + t * kMStride, v, row, in_rows, k, pn.c0);
      } else if (vec.a) {
#pragma unroll
        for (int i = 0; i < kDepth / 4; ++i) {
          const int f = t + kPThreads * i, rr = f / 8, col = 4 * (f % 8);
          const bool in = r0 + rr < d && pn.c0 + col < r;
          repro::cp_async16(repro::smem_addr(panel + rr * kMStride + col),
                            in ? a + (n * d + r0 + rr) * r + pn.c0 + col : a,
                            in ? 16 : 0);
        }
      } else {
        row_scalar(panel + t * kMStride, a, row, in_rows, r, pn.c0);
      }
      repro::cp_async_commit();
    };
    auto finish = [&](int p, int buf) {  // V's held chunks into buffer buf
      if (panel_of(p, nv).in_v && vec.v) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int f = t + kPThreads * i;
          store_int8x16(sm + (buf * kRows + f / 2) * kMStride + 16 * (f % 2),
                        held[i]);
        }
      }
    };

    float acc[8][8] = {};
    stage(pa, 0);
    finish(pa, 0);
    repro::cp_async_wait<0>();
    __syncthreads();
    for (int p = pa; p < pb; ++p) {
      const int buf = (p - pa) & 1;
      if (p + 1 < pb) stage(p + 1, buf ^ 1);  // in flight while p computes
      const float* xs = sm + buf * kRows * kMStride;
      const float* ys = sw + buf * kDepth * kCols;
#pragma unroll 2
      for (int kq = 0; kq < kDepth / 4; ++kq) {
        float4 x[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          x[i] = *reinterpret_cast<const float4*>(
              xs + (ty + 16 * i) * kMStride + 4 * kq);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* yr = ys + (4 * kq + j) * kCols;
          const float4 y0 = *reinterpret_cast<const float4*>(yr + 4 * tx);
          const float4 y1 =
              *reinterpret_cast<const float4*>(yr + 32 + 4 * tx);
          const float yv[8] = {y0.x, y0.y, y0.z, y0.w,
                               y1.x, y1.y, y1.z, y1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float xv = j == 0 ? x[i].x : j == 1 ? x[i].y
                                             : j == 2 ? x[i].z : x[i].w;
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[i][q] = fmaf(xv, yv[q], acc[i][q]);
          }
        }
      }
      if (p + 1 < pb) finish(p + 1, buf ^ 1);
      repro::cp_async_wait<0>();
      __syncthreads();
    }

    if (pa > 0 || pb < np) {  // a part: the whole 128 x 64 tile, unmasked
      float* slot = partial + (2ll * c + (pa > 0 ? 0 : 1)) * kTileElems;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = 4 * half;
          *reinterpret_cast<float4*>(slot + (ty + 16 * i) * kCols + 32 * half +
                                     4 * tx) =
              make_float4(acc[i][q], acc[i][q + 1], acc[i][q + 2],
                          acc[i][q + 3]);
        }
      }
      continue;
    }
    float* dst = un + n * d * e + e0;
    float local = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int rr = r0 + ty + 16 * i;
      if (rr >= d) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = 32 * half + 4 * tx, q = 4 * half;
        float* o = dst + (long long)rr * e + col;
        if (vec.un && e0 + col < e) {
          *reinterpret_cast<float4*>(o) = make_float4(
              acc[i][q], acc[i][q + 1], acc[i][q + 2], acc[i][q + 3]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (e0 + col + j < e) {
            if (!vec.un) o[j] = acc[i][q + j];
            local = fmaxf(local, fabsf(acc[i][q + j]));
          }
        }
      }
    }
    for (int off = 16; off > 0; off /= 2) {
      local = fmaxf(local, __shfl_xor_sync(0xffffffffu, local, off));
    }
    if (t % 32 == 0) warp_max[t / 32] = local;
    __syncthreads();
    if (t == 0) {
      float m = warp_max[0];
      for (int w = 1; w < kPThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
      atomicMax(&absmax[n], __float_as_uint(m));
    }
  }
}

// Grid (tiles): a tile that pass 1 left in parts gets U_new = its parts
// added in block order (the first block's slot 1, then slot 0 of each later
// block: the same bits every run, no float atomics) and its absmax.
__global__ void __launch_bounds__(kThreads)
    fixup_kernel(const float* __restrict__ partial, float* __restrict__ un,
                 unsigned int* __restrict__ absmax, int d, int e, Work work) {
  __shared__ float warp_max[kThreads / 32];
  const long long tile = blockIdx.x, u0 = tile * work.np;
  const int c0 = work.block_of(u0), c1 = work.block_of(u0 + work.np - 1);
  if (c0 == c1) return;  // pass 1 wrote it whole
  const int r0 = static_cast<int>(tile % work.gx) * kRows;
  const int e0 = static_cast<int>(tile / work.gx % work.gy) * kCols;
  const long long n = tile / (static_cast<long long>(work.gx) * work.gy);
  float local = 0.f;
  for (int i = threadIdx.x; i < kTileElems; i += kThreads) {
    const int rr = r0 + i / kCols, col = e0 + i % kCols;
    if (rr >= d || col >= e) continue;
    float s = partial[(2ll * c0 + 1) * kTileElems + i];
    for (int c = c0 + 1; c <= c1; ++c) s += partial[2ll * c * kTileElems + i];
    un[(n * d + rr) * e + col] = s;
    local = fmaxf(local, fabsf(s));
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

__device__ __forceinline__ int8_t quantize_one(float x, float s) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(x / s), -127.f), 127.f));
}

// Grid (N xblocks): xblocks blocks for each of the N blocks, n after n;
// VEC4: four values a thread (size % 4 == 0, both bases aligned), a float4
// load and one 4-byte store.
template <bool VEC4>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const float* __restrict__ un,
                    const unsigned int* __restrict__ absmax,
                    int8_t* __restrict__ values, float* __restrict__ scale,
                    long long size, int xblocks) {
  const long long n = blockIdx.x / xblocks;
  const int bx = static_cast<int>(blockIdx.x % xblocks);
  const float amax = __uint_as_float(absmax[n]);
  const float s = amax > 0.f ? amax / 127.f : 1.f;
  if (bx == 0 && threadIdx.x == 0) scale[n] = s;
  const long long step = (long long)xblocks * kThreads;
  if (VEC4) {
    const float4* src = reinterpret_cast<const float4*>(un + n * size);
    char4* dst = reinterpret_cast<char4*>(values + n * size);
    for (long long i = bx * (long long)kThreads + threadIdx.x;
         i < size / 4; i += step) {
      const float4 x = src[i];
      dst[i] = make_char4(quantize_one(x.x, s), quantize_one(x.y, s),
                          quantize_one(x.z, s), quantize_one(x.w, s));
    }
  } else {
    for (long long i = bx * (long long)kThreads + threadIdx.x;
         i < size; i += step) {
      values[n * size + i] = quantize_one(un[n * size + i], s);
    }
  }
}

}  // namespace

// scratch: f32, 2 * blocks * 128 * 64 elements of partial sums, then U_new
// (n * d * e), then n 32-bit absmax words (zeroed here); blocks: pass 1's
// blocks (at most ceil(d / 128) * ceil(e / 64) * n * panels); vector: which
// operands pass 1 moves in 16-byte accesses (bit 0 V, 1 A, 2 W_top and
// W_bot, 3 U_new); kernels/lowrank/kernel.py ``project_plan`` computes
// blocks, the scratch's size and the flags.  Returns the cudaError_t of
// the launches.
extern "C" int repro_batched_project_quantize(
    const void* v, const void* w_top, const void* a, const void* w_bot,
    void* scratch, void* values, void* scale, int n, int d, int k, int r,
    int e, int blocks, int vector, void* stream) {
  const int gx = (d + kRows - 1) / kRows, gy = (e + kCols - 1) / kCols;
  const int np = (k + kDepth - 1) / kDepth + (r + kDepth - 1) / kDepth;
  const long long tiles = (long long)gx * gy * n;
  const Work work{tiles * np, blocks, np, gx, gy};
  if (blocks < 1 || blocks > work.units) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long size = (long long)d * e;
  float* partial = static_cast<float*>(scratch);
  float* un = partial + 2ll * blocks * kTileElems;
  unsigned int* amax = reinterpret_cast<unsigned int*>(un + n * size);
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned int) * n, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Vec vec{(vector & 1) != 0, (vector & 2) != 0, (vector & 4) != 0,
                (vector & 8) != 0};
  err = cudaFuncSetAttribute(project_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kProjectSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  project_kernel<<<blocks, kPThreads, kProjectSmem, s>>>(
      static_cast<const int8_t*>(v), static_cast<const float*>(w_top),
      static_cast<const float*>(a), static_cast<const float*>(w_bot), un,
      partial, amax, d, k, r, e, work, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 fixup_grid(static_cast<unsigned>(tiles));
  fixup_kernel<<<fixup_grid, kThreads, 0, s>>>(partial, un, amax, d, e, work);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int8_t* out = static_cast<int8_t*>(values);
  const bool vec4 = size % 4 == 0 && vec.un &&
                    reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const long long per_thread = vec4 ? 4 : 1;
  // blocks for each of the n: enough for one pass, at most 1,024, and at
  // most 2^31 - 1 in all
  const int xblocks = static_cast<int>(std::max<long long>(
      1, std::min<long long>(
             {(size + per_thread * kThreads - 1) / (per_thread * kThreads),
              1024, 0x7fffffffLL / n})));
  const dim3 qgrid(static_cast<unsigned>(static_cast<long long>(xblocks) * n));
  if (vec4) {
    quantize_kernel<true><<<qgrid, kThreads, 0, s>>>(
        un, amax, out, static_cast<float*>(scale), size, xblocks);
  } else {
    quantize_kernel<false><<<qgrid, kThreads, 0, s>>>(
        un, amax, out, static_cast<float*>(scale), size, xblocks);
  }
  return static_cast<int>(cudaGetLastError());
}
