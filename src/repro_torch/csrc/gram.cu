// Batched Grams C[n] = M[n]^T M[n] of a packed pool stack, for two kinds of
// M (N, d, k):
//   repro_batched_gram:        M = A, f32, bf16 or fp16;
//   repro_batched_gram_mixed:  M = [V, A], V (N, d, ell) int8, A (N, d, r) f32,
//                              k = ell + r, and the result weighted
//                              C = C0 o w w^T, w = [colw, 1].
//
// Replace repro/kernels/gram/kernel.py::batched_gram_pallas, the FD refresh
// Gram of M = [sqrt(beta2) B, G] (repro/core/fd.py fd_update_batched), and
// ::batched_gram_mixed_pallas, the same Gram with the eigenvectors stored in
// int8 (repro/core/fd.py _fd_update_batched_quantized), whose column weights
// (block scale x sqrt(beta2 s) on V's columns) this kernel applies in its
// epilogue, in the reference's order: C[i, j] = (C0[i, j] w_i) w_j.
//
// What bounds it: the multiply-adds.  A block of the main path does
// d * 128 * 128 of them on 2 * d * 128 inputs, far above the card's
// bytes-per-operation line.  f32 FFMA (67 TFLOP/s) is too slow, and one
// TF32 product on the tensor cores keeps ~11 bits and misses the
// 1e-4 * sqrt(d) tolerance the reference holds the Gram to.  So the
// products run as error-compensated 3xTF32 on Hopper's warpgroup
// tensor-core instruction (wgmma, hopper.cuh): each f32 value is split as
// x = hi + lo, hi = tf32_rna(x), lo = tf32_rna(x - hi) (both rounded to
// nearest, since the tensor core ignores the low 13 bits), and
// hi.lo + lo.hi + hi.hi is accumulated in f32, smallest first, which keeps
// ~22 bits.  The tensor core's own additions lose bits of their own (with
// no promotion an H100 read 1.4x the tolerance at d = 1024 on data of
// mean 3; variants.py gram), so each 32-row depth chunk starts a fresh
// accumulator, which is then added into a separate register sum with
// FADD: the error then does not grow with d (0.24x on the same data).
// bf16, fp16 and int8 values are exact in tf32 (lo = 0): the bf16 and
// fp16 Grams run one product and stage no lo panels; the mixed Gram's V
// columns store lo = 0, which changes no bit.  The bound is the operations
// at the tf32 rate over three products (494.7 / 3 TFLOP/s) for f32
// columns; the mixed Gram's exact int8 columns need two against an f32
// column and none of the tf32 rate against each other (int8 tensor cores;
// chip_smoke.py counts each block of columns).
//
// Design: one block of two warpgroups owns one 128 x 128 upper-triangular
// output tile (n, ti, tj), the diagonal included, and loops over all of d
// itself (d <= the block size, 1024 on the main path): no split over d and
// no atomics, so the same bits on every run.  Warpgroup g holds rows
// 64 g .. 64 g + 63 of the tile as m64n128k8 products, also over the
// zero rows and columns of a ragged last tile: a branch around them (an
// n64 product for a 64-wide last column tile, none for a warpgroup past k)
// made ptxas serialize the wgmma pipeline in this kernel's first builds
// (its warning C7518).  tf32 wgmma reads both operands K-major from
// shared memory and has no transpose bit, while M is row-major (d rows of
// k contiguous columns), so the tile must be transposed on its way in; a
// TMA copy cannot transpose or split, so the staging goes through
// registers.  Each thread owns a 4 x 4 unit of each operand per chunk: 4
// rows of M and 4 columns (16 bytes a row of f32, 8 of bf16 or fp16, 4 of
// int8); a warp covers 4 rows of 128 columns, each one contiguous 512 /
// 256 / 128-byte run.  (8 rows of 16 columns a warp, which needs no
// permutation below, touches twice the cache lines an instruction and ran
// 17-26 % slower; variants.py gram.)  It converts, splits and stores the
// unit transposed: one 16-byte store per column, holding 4 consecutive
// depths, into the 128-byte-swizzled K-major panels.  Lanes permute the
// order of their 4 columns (XOR with bits 1-2 of the lane) so that the 8
// lanes of each quarter-warp hit 8 distinct 16-byte bank groups.  Two
// stages: the chunk's asynchronous products run on one while the threads
// split and store the next chunk (loaded from device memory one iteration
// earlier) into the other.  Columns past k and
// rows past d are zero.  The epilogue stages the tile through shared memory
// (XOR-swizzled, no padding) so that both the direct store and the mirrored
// store of an off-diagonal tile are coalesced.
//
// Loaders: the Dense stack reads 4-column groups with one vector load a row
// when k is a multiple of 4 and the base is aligned; the Mixed loader picks
// V or A per 4-column group (ell and r multiples of 4 and aligned bases:
// no group straddles ell, V's rows may be 12 bytes); anything else reads
// element by element.
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"
#include "tile.cuh"

namespace {

constexpr int kTile = 128;     // output tile edge
constexpr int kThreads = 256;  // two warpgroups, 64 tile rows each
constexpr int kDepth = 32;     // rows of M per chunk: 4 k8 steps
constexpr uint32_t kPanelBytes = kTile * kDepth * 4;  // 128 rows of 128 B

// How a thread reads its 4 x 4 unit of one operand (fixed per block).
enum Kind : int { kZero, kF32, kBF16, kI8, kScalar };

// Where a thread's 4 columns of one operand live: row 0's first byte and
// the bytes between rows (vector kinds), and the kind.
struct Cursor {
  const char* p;
  long long stride;
  int kind;
};

// Raw bits of a unit: rows 0..3, each 16 bytes of f32, 8 of bf16 or 4 of
// int8 as loaded, or 4 f32 values for kScalar.
struct Unit {
  uint4 row[4];
};

// M = A: a row-major (N, d, k) stack.  vec: k a multiple of 4 and the base
// aligned, so every 4-column group is one aligned vector a row.  An fp16
// stack loads as a bf16 one (kBF16: 8 bytes a row) and unpacks as fp16.
template <typename T>
struct Dense {
  static constexpr bool kWeighted = false;
  static constexpr bool kHalf = std::is_same<T, __half>::value;
  const T* a;
  int d, k, vec;

  __device__ __forceinline__ Cursor cursor(long long n, int c0) const {
    const int kind = c0 >= k ? kZero : !vec ? kScalar
                                            : sizeof(T) == 4 ? kF32 : kBF16;
    return {reinterpret_cast<const char*>(a + n * d * k + c0),
            static_cast<long long>(sizeof(T)) * k, kind};
  }
  // row ``row`` of columns c0 .. c0 + 3 as f32, 0 past k
  __device__ __forceinline__ uint4 scalar_row(long long n, int row,
                                              int c0) const {
    const T* p = a + (n * d + row) * k;
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = c0 + e < k ? repro::to_f32(p[c0 + e]) : 0.f;
    }
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                      __float_as_uint(x[2]), __float_as_uint(x[3]));
  }
};

// M = [V, A]: columns below ell from the int8 V (N, d, ell), the rest from
// the f32 A (N, d, r); weight w_i = colw[n, i] below ell, 1 above.  vec: ell
// and r multiples of 4 and the bases aligned.
struct Mixed {
  static constexpr bool kWeighted = true;
  static constexpr bool kHalf = false;
  const int8_t* v;
  const float* a;
  const float* colw;
  int d, ell, r, vec;

  __device__ __forceinline__ Cursor cursor(long long n, int c0) const {
    if (c0 >= ell + r) return {nullptr, 0, kZero};
    if (!vec) return {nullptr, 0, kScalar};
    if (c0 < ell) {
      return {reinterpret_cast<const char*>(v + n * d * ell + c0), ell, kI8};
    }
    return {reinterpret_cast<const char*>(a + n * d * r + (c0 - ell)),
            static_cast<long long>(r) * 4, kF32};
  }
  // row ``row`` of columns c0 .. c0 + 3 as f32, 0 past ell + r
  __device__ __forceinline__ uint4 scalar_row(long long n, int row,
                                              int c0) const {
    const long long nr = n * d + row;
    const int8_t* vp = v + nr * ell;
    const float* ap = a + nr * r;
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + e;
      x[e] = c < ell ? repro::to_f32(vp[c]) : c < ell + r ? ap[c - ell] : 0.f;
    }
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                      __float_as_uint(x[2]), __float_as_uint(x[3]));
  }
  __device__ __forceinline__ float weight(long long n, int i) const {
    return i < ell ? __ldg(colw + n * ell + i) : 1.f;
  }
};

// Rows r0 .. r0 + 3 of a thread's 4 columns c0 .. c0 + 3 (zero past d).
template <typename Src>
__device__ __forceinline__ void load_unit(const Src& m, const Cursor& cur,
                                          Unit& u, long long n, int r0,
                                          int c0, int d) {
#pragma unroll
  for (int q = 0; q < 4; ++q) u.row[q] = make_uint4(0u, 0u, 0u, 0u);
  switch (cur.kind) {
    case kF32:
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (r0 + q < d) {
          u.row[q] = __ldg(reinterpret_cast<const uint4*>(
              cur.p + (r0 + q) * cur.stride));
        }
      }
      break;
    case kBF16:
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (r0 + q < d) {
          const uint2 y = __ldg(reinterpret_cast<const uint2*>(
              cur.p + (r0 + q) * cur.stride));
          u.row[q].x = y.x;
          u.row[q].y = y.y;
        }
      }
      break;
    case kI8:
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (r0 + q < d) {
          u.row[q].x = __ldg(reinterpret_cast<const uint32_t*>(
              cur.p + (r0 + q) * cur.stride));
        }
      }
      break;
    case kScalar:
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (r0 + q < d) u.row[q] = m.scalar_row(n, r0 + q, c0);
      }
      break;
    default:  // kZero
      break;
  }
}

// x[q][e] = element (row q, column e) of the unit as f32; with HALF a
// kBF16 unit holds fp16 values.
template <bool HALF>
__device__ __forceinline__ void unpack(const Unit& u, int kind,
                                       float (&x)[4][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 w = u.row[q];
    if (HALF && kind == kBF16) {
      x[q][0] = __half2float(__ushort_as_half(w.x & 0xffffu));
      x[q][1] = __half2float(__ushort_as_half(w.x >> 16));
      x[q][2] = __half2float(__ushort_as_half(w.y & 0xffffu));
      x[q][3] = __half2float(__ushort_as_half(w.y >> 16));
    } else if (kind == kBF16) {
      x[q][0] = __uint_as_float(w.x << 16);
      x[q][1] = __uint_as_float(w.x & 0xffff0000u);
      x[q][2] = __uint_as_float(w.y << 16);
      x[q][3] = __uint_as_float(w.y & 0xffff0000u);
    } else if (kind == kI8) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[q][e] = static_cast<float>(static_cast<int>(w.x << (24 - 8 * e)) >>
                                     24);
      }
    } else {  // kF32, kScalar, kZero (all bits 0)
      x[q][0] = __uint_as_float(w.x);
      x[q][1] = __uint_as_float(w.y);
      x[q][2] = __uint_as_float(w.z);
      x[q][3] = __uint_as_float(w.w);
    }
  }
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr,
                                             const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

// Store a unit transposed: column e ^ rot's 4 depths as one 16-byte chunk
// at off[e] of the hi panel and, with SPLIT, of the lo panel.
template <bool SPLIT, bool HALF>
__device__ __forceinline__ void store_unit(const Unit& u, int kind,
                                           uint32_t hi, uint32_t lo,
                                           const uint32_t (&off)[4], int rot) {
  float x[4][4];
  unpack<HALF>(u, kind, x);
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // x[q][e] <- x[q][e ^ rot]
    float t0 = x[q][0], t1 = x[q][1], t2 = x[q][2], t3 = x[q][3];
    if (rot & 1) {
      const float s0 = t0, s2 = t2;
      t0 = t1, t1 = s0, t2 = t3, t3 = s2;
    }
    if (rot & 2) {
      const float s0 = t0, s1 = t1;
      t0 = t2, t1 = t3, t2 = s0, t3 = s1;
    }
    x[q][0] = t0, x[q][1] = t1, x[q][2] = t2, x[q][3] = t3;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t h[4], l[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      h[q] = repro::tf32_rna(x[q][e]);
      l[q] = repro::tf32_rna(x[q][e] - __uint_as_float(h[q]));
    }
    st_shared_v4(hi + off[e], h);
    if (SPLIT) st_shared_v4(lo + off[e], l);
  }
}

__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return repro::smem_desc(addr, 0, 1024, 1);
}

// One chunk's products for one warpgroup's 64 x 128 outputs: with SPLIT
// hi.lo, lo.hi, then hi.hi (k8 step j of a panel starts 32 j bytes on),
// the first into a fresh accumulator.
template <bool SPLIT>
__device__ __forceinline__ void issue(float (&acc)[64], uint32_t a_hi,
                                      uint32_t a_lo, uint32_t b_hi,
                                      uint32_t b_lo) {
  if (SPLIT) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      repro::wgmma_ss_tf32(acc, desc(a_hi + 32 * j), desc(b_lo + 32 * j),
                           j > 0);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      repro::wgmma_ss_tf32(acc, desc(a_lo + 32 * j), desc(b_hi + 32 * j), 1);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    repro::wgmma_ss_tf32(acc, desc(a_hi + 32 * j), desc(b_hi + 32 * j),
                         SPLIT || j > 0);
  }
}

// Column of tile row r where the epilogue's staging tile keeps column q:
// r's 5 low bits, permuted, XOR q.  Conflict-free for the accumulator
// fragments' writes (8 rows x 4 even columns a warp), the direct store's
// reads (one row) and the mirror's reads (32 rows of one column).
__device__ __forceinline__ int stage_col(int r, int q) {
  return q ^ ((r & 1) | ((r & 6) << 2) | ((r >> 2) & 6));
}

// Shared memory: two stages of (A hi, B hi[, A lo, B lo]) panels and 1,024
// bytes to align the base to a swizzle atom; the epilogue's 128 x 128 f32
// tile and the 2 x 128 weights reuse it.
constexpr int smem_bytes(bool split) {
  const int stages = 2 * (split ? 4 : 2) * static_cast<int>(kPanelBytes);
  const int epilogue = (kTile + 2) * kTile * 4;
  return (stages > epilogue ? stages : epilogue) + 1024;
}

// Grid (N tiles (tiles + 1) / 2): blockIdx.x enumerates block n's
// upper-triangular tiles row by row, n after n (the order of a 2-D grid of
// tiles by N, without its limit of 65,535 on N).
template <typename Src, bool SPLIT>
__global__ void __launch_bounds__(kThreads, 1)
    gram_kernel(Src m, float* __restrict__ c, int d, int k, int tiles) {
  const int tri = tiles * (tiles + 1) / 2;
  int t = static_cast<int>(blockIdx.x % tri), ti = 0;
  while (t >= tiles - ti) {
    t -= tiles - ti;
    ++ti;
  }
  const int tj = ti + t;
  const int i0 = ti * kTile, j0 = tj * kTile;
  const bool diag = ti == tj;
  const long long n = blockIdx.x / tri;

  extern __shared__ unsigned char gram_smem[];
  const uint32_t raw = repro::smem_addr(gram_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  constexpr uint32_t kStage = (SPLIT ? 4 : 2) * kPanelBytes;
  // panels of a stage: A hi, B hi, A lo, B lo; a diagonal tile's B is A

  // Thread (warp w, lane l) owns, in each chunk, depths 4 w .. 4 w + 3 of
  // panel rows (tile columns) 4 l .. 4 l + 3: a warp's loads cover 512
  // contiguous bytes of each of its 4 rows, and it stores its columns in
  // the order e ^ rot, so that under the swizzle the 8 lanes of a
  // quarter-warp hit 8 distinct bank groups.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = threadIdx.x / 128;
  const int quad = warp;
  const int col = 4 * lane;
  const int rot = (lane >> 1) & 3;
  uint32_t off[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    off[e] = repro::swz128_offset(col + (e ^ rot), 16 * quad);
  }
  const Cursor ca = m.cursor(n, i0 + col), cb = m.cursor(n, j0 + col);
  const int chunks = (d + kDepth - 1) / kDepth;

  Unit ua, ub;
  load_unit(m, ca, ua, n, 4 * quad, i0 + col, d);
  if (!diag) load_unit(m, cb, ub, n, 4 * quad, j0 + col, d);
  store_unit<SPLIT, Src::kHalf>(ua, ca.kind, base, base + 2 * kPanelBytes,
                                off, rot);
  if (!diag) {
    store_unit<SPLIT, Src::kHalf>(ub, cb.kind, base + kPanelBytes,
                      base + 3 * kPanelBytes, off, rot);
  }
  load_unit(m, ca, ua, n, kDepth + 4 * quad, i0 + col, d);
  if (!diag) load_unit(m, cb, ub, n, kDepth + 4 * quad, j0 + col, d);
  repro::fence_proxy_async();
  __syncthreads();

  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.f;

  for (int ch = 0; ch < chunks; ++ch) {
    const uint32_t cur = base + (ch & 1) * kStage;
    const uint32_t nxt = base + ((ch + 1) & 1) * kStage;
    const uint32_t a_hi = cur + wg * 64 * 128, a_lo = a_hi + 2 * kPanelBytes;
    const uint32_t b_hi = cur + (diag ? 0 : kPanelBytes);
    const uint32_t b_lo = b_hi + 2 * kPanelBytes;
    repro::wgmma_fence();
    issue<SPLIT>(acc, a_hi, a_lo, b_hi, b_lo);
    repro::wgmma_commit();
    // while the products run: the next chunk into the other stage (its
    // readers finished before the last barrier), and the one after that
    // from device memory into registers
    if (ch + 1 < chunks) {
      store_unit<SPLIT, Src::kHalf>(ua, ca.kind, nxt, nxt + 2 * kPanelBytes,
                                    off, rot);
      if (!diag) {
        store_unit<SPLIT, Src::kHalf>(ub, cb.kind, nxt + kPanelBytes,
                          nxt + 3 * kPanelBytes, off, rot);
      }
      const int r0 = (ch + 2) * kDepth + 4 * quad;
      load_unit(m, ca, ua, n, r0, i0 + col, d);
      if (!diag) load_unit(m, cb, ub, n, r0, j0 + col, d);
    }
    // promotion: this chunk's products into the f32 register sum
    repro::wgmma_wait_all();
    repro::fence_regs(acc);
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] += acc[i];
    repro::fence_proxy_async();
    __syncthreads();
  }

  // Epilogue: the warpgroups' fragments into the staging tile (every
  // product is done, so the panels' space is free), beside it the weights
  // of the tile's rows and columns ...
  float* tile = reinterpret_cast<float*>(gram_smem + (base - raw));
  float* w_row = tile + kTile * kTile;
  float* w_col = w_row + kTile;
  {
    const int r0 = 64 * wg + 16 * (warp % 4) + lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 8 * (e >> 1), q = 8 * i + c0 + (e & 1);
        tile[r * kTile + stage_col(r, q)] = sum[4 * i + e];
      }
    }
    if constexpr (Src::kWeighted) {
      const int t = threadIdx.x % kTile;
      if (threadIdx.x < kTile) {
        w_row[t] = m.weight(n, i0 + t);
      } else {
        w_col[t] = m.weight(n, j0 + t);
      }
    }
  }
  __syncthreads();
  // ... then stored row by row, and an off-diagonal tile again mirrored,
  // consecutive threads on consecutive addresses in both; each thread keeps
  // one column (direct) or one row (mirror) of the tile
  float* cn = c + n * static_cast<long long>(k) * k;
  const int fixed = threadIdx.x % kTile, step = kThreads / kTile;
  {
    const int q = fixed, j = j0 + q;
    const float wj = Src::kWeighted ? w_col[q] : 1.f;
    for (int r = threadIdx.x / kTile; r < kTile && i0 + r < k && j < k;
         r += step) {
      float x = tile[r * kTile + stage_col(r, q)];
      if (Src::kWeighted) x = x * w_row[r] * wj;
      cn[static_cast<long long>(i0 + r) * k + j] = x;
    }
  }
  if (!diag) {
    const int r = fixed, i = i0 + r;
    const float wi = Src::kWeighted ? w_row[r] : 1.f;
    for (int q = threadIdx.x / kTile; q < kTile && j0 + q < k && i < k;
         q += step) {
      float x = tile[r * kTile + stage_col(r, q)];
      if (Src::kWeighted) x = x * w_col[q] * wi;
      cn[static_cast<long long>(j0 + q) * k + i] = x;
    }
  }
}

template <bool SPLIT, typename Src>
int launch(Src m, float* c, int n, int d, int k, void* stream) {
  constexpr int smem = smem_bytes(SPLIT);
  cudaError_t err = cudaFuncSetAttribute(
      gram_kernel<Src, SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (k + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(tiles) * (tiles + 1) / 2 * n;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  gram_kernel<Src, SPLIT>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(m, c, d,
                                                                   k, tiles);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// dtype: 0 = float32 (3xTF32), 1 = bfloat16, 2 = float16 (one tf32
// product: exact operands).  Returns the cudaError_t of the launch.
extern "C" int repro_batched_gram(const void* a, void* c, int n, int d, int k,
                                  int dtype, void* stream) {
  float* out = static_cast<float*>(c);
  if (dtype == 0) {
    const int vec = k % 4 == 0 && aligned(a, 16);
    return launch<true>(
        Dense<float>{static_cast<const float*>(a), d, k, vec}, out, n, d, k,
        stream);
  }
  if (dtype == 1) {
    const int vec = k % 4 == 0 && aligned(a, 8);
    return launch<false>(
        Dense<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(a), d, k, vec},
        out, n, d, k, stream);
  }
  if (dtype == 2) {
    const int vec = k % 4 == 0 && aligned(a, 8);
    return launch<false>(
        Dense<__half>{static_cast<const __half*>(a), d, k, vec}, out, n, d, k,
        stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// C (n, ell + r, ell + r) = ([V, A]^T [V, A]) o w w^T, w = [colw, 1], colw
// (n, ell) f32.  Returns the cudaError_t of the launch.
extern "C" int repro_batched_gram_mixed(const void* v, const void* a,
                                        const void* colw, void* c, int n,
                                        int d, int ell, int r, void* stream) {
  const int vec = ell % 4 == 0 && r % 4 == 0 && aligned(v, 4) &&
                  aligned(a, 16);
  return launch<true>(Mixed{static_cast<const int8_t*>(v),
                            static_cast<const float*>(a),
                            static_cast<const float*>(colw), d, ell, r, vec},
                      static_cast<float*>(c), n, d, ell + r, stream);
}
