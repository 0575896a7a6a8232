// Batched low-rank inverse-root apply over a packed pool stack:
//   Y[n] = base[n] * G[n] + U[n] diag(c[n]) U[n]^T G[n]
// U (N, d, ell) f32 or int8, c (N, ell), base (N,), G (N, d, m) f32 ->
// Y (N, d, m) f32.  U is f32 under fp32 and bf16 second-moment storage (the
// engine hands over the f32 compute copy) and int8 under int8 storage: the
// fused int8 path (repro/kernels/registry.py _fold_quantized_apply) passes
// the raw int8 eigenvectors with the block scale^2 folded into c.
//
// Replaces repro/kernels/lowrank/kernel.py::batched_lowrank_apply_pallas,
// the Sketchy preconditioner apply (repro/core/fd.py
// fd_apply_inverse_root_batched, run twice per step from
// repro/core/sketchy.py precondition_batched).
//
// What bounds it: the bytes.  Per pool block it reads G and writes Y (8 d m
// bytes) for 4 d ell m flops: 32 flops a byte at ell = 64, above f32 FFMA's
// 20 a byte of device memory but far below the tensor cores'.  One TF32
// product on the tensor cores misses the 1e-4 sqrt(d) tolerance; three
// (3xTF32, below) hold it and take less time than the bytes.
//
// Design: one pass, no scratch in device memory.  A block of eight warps
// owns one n and a column tile j0 .. j0 + bn of G (bn = 64, or narrower
// where P's rows would not fit beside the stages), two blocks an SM (106 KB of
// shared memory at ell = 64 with an f32 U, 80 KB with an int8 one, and at
// most 128 registers a thread).  Work goes in units, each copied into one
// of two shared-memory stages with cp.async while the other's products run:
//   - First product, P = c o (U^T G_tile) (ell x bn) over all of d: units of
//     32 rows of U (64 columns of ell, a group) and of G's column tile.  P
//     stays in shared memory, already split into its tf32 hi and lo parts.
//   - Second product, Y_tile = base G_tile + U P: units of 64 rows of U
//     (again, from L2: U[n] is at most 256 KB at d 1024) and of G's column
//     tile, the chunks from the last, whose rows of G the first product
//     read last.
// So G is read twice: the first time from device memory, the second meant
// to hit L2.  Keeping the (d, bn) tile of G in shared memory instead, which
// reads it once, leaves room at d 768 and 1024 for bn 32 and one block an
// SM: on an H100 that build (`python3 variants.py apply`, "G staged once")
// took 1.8x this one's time over a training step's calls, and the second
// read costs what its copies cost in issue slots, not its bytes (sent to
// a copy of G that L2 cannot hold, the step took 0.2-1.4 % longer; left
// out, 6-8 % less; PERF.md).  ell runs in groups of 64 columns and d in
// units, so only P's ell x bn is bounded by shared memory (bn 8 takes ell
// up to 1984).  A wider U (the reference takes any ell) runs in chunks of
// 256 of its columns, one launch each, in order: the first writes Y = base
// G + U_0 P_0 as above, each later one Y += U_c P_c with P_c = c_c o U_c^T
// G (Y read back where it was written, by the thread that wrote it).  256
// columns keep the widest column tile, 64: every block reads all of its
// chunk of U, so a tile of 8 would read U n / 8 times (at ell 4,096, n
// 1,024 in chunks of 1,408 that took 24.6 ms, 9x the plain version; NVIDIA
// H100 80GB HBM3, 700.00 W, PERF.md).  At ell <= 1984 that is one launch,
// the kernel as it was.  No split over d, no atomics: the same bits on
// every run.
//
// Products: mma.sync.m16n8k8 on tf32 operands from registers (the split
// never doubles shared memory), f32 accumulators.  Each f32 operand is split
// x = hi + lo, hi = tf32_rna(x), lo = tf32_rna(x - hi) (both rounded to
// nearest, hopper.cuh), and hi.lo + lo.hi + hi.hi is summed in that order,
// smallest first.  An int8 U is exact in tf32, so its products take two
// terms, U.lo + U.hi.  The tensor core's own additions lose bits, so each
// 32-deep slice of a reduction (of d in the first product, of ell in the
// second) starts a fresh accumulator that is then added into an f32
// register sum.  Ragged d, ell and m are zero-filled in shared memory and
// masked on the store.
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // eight warps
constexpr int kEll = 64;       // columns of ell a unit holds (a group)
constexpr int kRows1 = 32;     // rows of d a unit of the first product holds
constexpr int kRows2 = 64;     // rows of d a unit of the second holds
constexpr int kStages = 2;     // units in shared memory: one in flight
constexpr size_t kMaxSmem = 232448;

// Row strides (elements): G's rows pad to bn + 8 floats (8 at bn = 8), U's
// to 64 + 8 floats or 64 + 16 bytes, so that the fragments' loads hit
// distinct banks.
__host__ __device__ constexpr int g_stride(int bn) {
  return bn == 8 ? 8 : bn + 8;
}
template <typename TU>
__host__ __device__ constexpr int u_stride() {
  return sizeof(TU) == 4 ? kEll + 8 : kEll + 16;
}

// A stage holds the larger of a first-product unit (32 rows of U and of G)
// and a second-product unit (64 rows of U and of G).
__host__ __device__ constexpr int stage_bytes(int bn, int usize) {
  const int first = kRows1 * (usize == 4 ? kEll + 8 : kEll + 16) * usize +
                    kRows1 * g_stride(bn) * 4;
  const int second = kRows2 * (usize == 4 ? kEll + 8 : kEll + 16) * usize +
                     kRows2 * g_stride(bn) * 4;
  return first > second ? first : second;
}

// P's rows go in pairs (2q, 2q + 1) of an element each column: [ell / 2]
// [bn + 4][2], so that a B fragment's two rows are one 8-byte load.
__host__ __device__ constexpr int p_stride(int bn) { return bn + 4; }

// the stages, then P's tf32 hi and lo parts
size_t smem_bytes(int ell, int bn, int usize) {
  const int cols = (ell + kEll - 1) / kEll * kEll;
  return 1ull * kStages * stage_bytes(bn, usize) +
         2ull * 4 * cols * p_stride(bn);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int K>
__device__ __forceinline__ void split(const float (&x)[K], uint32_t (&hi)[K],
                                      uint32_t (&lo)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    hi[i] = repro::tf32_rna(x[i]);
    lo[i] = repro::tf32_rna(x[i] - __uint_as_float(hi[i]));
  }
}

// U's elements p[0] and p[1] as f32, one load: an int8 through the bits of
// 1.5 * 2^23 + v (one integer add and one float add at full rate; the
// conversion instruction runs at a quarter of it), an f32 as it is.
__device__ __forceinline__ void u_pair(const int8_t* p, float& x, float& y) {
  const int w = *reinterpret_cast<const short*>(p);
  const int lo = static_cast<int>(static_cast<unsigned>(w) << 24) >> 24;
  x = __int_as_float(0x4B400000 + lo) - 12582912.f;
  y = __int_as_float(0x4B400000 + (w >> 8)) - 12582912.f;
}
__device__ __forceinline__ void u_pair(const float* p, float& x, float& y) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  x = v.x, y = v.y;
}

// An A fragment from U, split into tf32 hi and lo (lo unused for an int8 U,
// which is exact in tf32).
template <bool EXACT>
__device__ __forceinline__ void a_frag(const float (&x)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  if (EXACT) {
#pragma unroll
    for (int i = 0; i < 4; ++i) hi[i] = __float_as_uint(x[i]), lo[i] = 0u;
  } else {
    split(x, hi, lo);
  }
}

// acc += a b for one k8 step: hi.lo, lo.hi, hi.hi (smallest first); an
// exact a (int8 U) takes the two products a.lo + a.hi.
template <bool EXACT>
__device__ __forceinline__ void products(float (&acc)[4],
                                         const uint32_t (&a_hi)[4],
                                         const uint32_t (&a_lo)[4],
                                         const uint32_t (&b_hi)[2],
                                         const uint32_t (&b_lo)[2]) {
  mma_tf32(acc, a_hi, b_lo);
  if (!EXACT) mma_tf32(acc, a_lo, b_hi);
  mma_tf32(acc, a_hi, b_hi);
}

// Fragments of mma.m16n8k8.tf32, lane l, g = l / 4, t = l % 4: a[0] (row g,
// column t), a[1] row g + 8, a[2] column t + 4, a[3] both; b[0] (row t,
// column g), b[1] row t + 4; acc[0, 1] row g, columns 2t, 2t + 1, acc[2, 3]
// row g + 8.  The products permute rows and reductions so that a lane's
// two values of U or P are neighbours in memory, one load: in the first,
// row g (g + 8) of row tile rt is ell index 16 rt + 2g (+ 1), so a[0] and
// a[1] are U[r][16 rt + 2g, + 1]; in the second, the k-step's column t
// (t + 4) is ell index e + 2t (+ 1), so a[0] and a[2] are U[row][e + 2t,
// + 1], and b[0] and b[1] one pair of P's rows.
//
// Grid (column tiles of bn, N).  Units, in order: the first product's
// (group, 32-row chunk) pairs, group-major, each with its 32 rows of U and
// of G's column tile; then the second's (64-row chunk, group) pairs, the
// chunks from the last, whose rows of G were read last, each with its 64
// rows of U (and, in its last group, of G).  Unit k uses stage
// k % kStages; its copy is issued while unit k - 1 computes.  In the first
// product warp w holds the 2 x NTW fragment tiles of row tiles 2 (w % 2),
// + 1 and n-tiles (w / 2) NTW .. + NTW - 1 of P's group (64 x bn); in the
// second the 1 x NT2 tiles of row tile w % 4 and n-tiles (w / 4) NT2 .. +
// NT2 - 1 of the unit's rows of Y (64 x bn).
//
// ell is the chunk's columns of U, from column 0 of u and coeffs, whose
// rows are ldu apart (U's whole width); ``add``: Y += U P, Y = base G + U P
// otherwise.
template <typename TU, int NT>
__global__ void __launch_bounds__(kThreads, 2)
    apply_kernel(const TU* __restrict__ u, const float* __restrict__ coeffs,
                 const float* __restrict__ base, const float* __restrict__ g,
                 float* __restrict__ y, int n_blocks, int d, int ell, int m,
                 int vec_u, int vec_g, int ldu, int add) {
  constexpr int BN = 8 * NT, GS = g_stride(BN), US = u_stride<TU>();
  constexpr int PS = p_stride(BN);
  constexpr int NTW = NT >= 4 ? NT / 4 : 1;  // first product: 2 x NTW tiles
  constexpr int NT2 = NT >= 2 ? NT / 2 : 1;  // second product: 1 x NT2
  constexpr bool kExact = sizeof(TU) == 1;
  constexpr int kUVec = 16 / sizeof(TU);
  constexpr int kStage = stage_bytes(BN, sizeof(TU));
  // grid (ceil(m / BN), min(N, 65,535), ceil(N / 65,535)): n from the y
  // and z indices, special registers the compiler reads again where it
  // needs n, as a 2-D grid's blockIdx.y (a flat index would hold n in
  // registers: 12 B of spills at NT 8)
  const int j0 = blockIdx.x * BN;
  const long long n =
      static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y;
  if (n >= n_blocks) return;  // the last z slice's tail
  const TU* un = u + n * d * ldu;
  const float* gn = g + n * d * m;
  float* yn = y + n * d * m;
  const int chunks1 = (d + kRows1 - 1) / kRows1;
  const int chunks2 = (d + kRows2 - 1) / kRows2;
  const int groups = (ell + kEll - 1) / kEll;
  const int first = groups * chunks1, units = first + chunks2 * groups;

  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* ph = reinterpret_cast<uint32_t*>(smem + kStages * kStage);
  uint32_t* pl = ph + groups * kEll * PS;  // P's hi and lo, [ell / 2][PS][2]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t = lane % 4;
  const int rt0 = 2 * (warp % 2), nt0 = (warp / 2) * NTW;  // first product
  const int rt = warp % 4, nb = (warp / 4) * NT2;            // second

  // rows [r0, r0 + rows) x columns [e0, e0 + 64) of U into st
  auto copy_u = [&](TU* st, int r0, int rows, int e0) {
    if (vec_u) {
      constexpr int per = kEll / kUVec;
      for (int i = tid; i < rows * per; i += kThreads) {
        const int r = i / per, c = i % per * kUVec;
        const int row = r0 + r, col = e0 + c;
        const int left = row < d ? min(kUVec, ell - col) : 0;
        const int bytes = left > 0 ? left * static_cast<int>(sizeof(TU)) : 0;
        repro::cp_async16(repro::smem_addr(st + r * US + c),
                          bytes ? un + static_cast<long long>(row) * ldu + col
                                : un,
                          bytes);
      }
    } else {
      for (int i = tid; i < rows * kEll; i += kThreads) {
        const int r = i / kEll, c = i % kEll;
        const int row = r0 + r, col = e0 + c;
        st[r * US + c] = row < d && col < ell
                             ? un[static_cast<long long>(row) * ldu + col]
                             : TU(0);
      }
    }
  };
  // rows [r0, r0 + rows) x G's column tile into sg
  auto copy_g = [&](float* sg, int r0, int rows) {
    if (vec_g) {
      constexpr int per = BN / 4;
      for (int i = tid; i < rows * per; i += kThreads) {
        const int r = i / per, c = i % per * 4;
        const int row = r0 + r, col = j0 + c;
        const int left = row < d ? min(4, m - col) : 0;
        const int bytes = left > 0 ? left * 4 : 0;
        repro::cp_async16(repro::smem_addr(sg + r * GS + c),
                          bytes ? gn + static_cast<long long>(row) * m + col
                                : gn,
                          bytes);
      }
    } else {
      for (int i = tid; i < rows * BN; i += kThreads) {
        const int r = i / BN, c = i % BN;
        const int row = r0 + r, col = j0 + c;
        sg[r * GS + c] =
            row < d && col < m ? gn[static_cast<long long>(row) * m + col]
                               : 0.f;
      }
    }
  };
  auto issue = [&](int k) {
    unsigned char* sk = smem + (k % kStages) * kStage;
    TU* st = reinterpret_cast<TU*>(sk);
    if (k < first) {
      const int gi = k / chunks1, ch = k % chunks1;
      copy_u(st, ch * kRows1, kRows1, gi * kEll);
      copy_g(reinterpret_cast<float*>(sk + kRows1 * US * sizeof(TU)),
             ch * kRows1, kRows1);
    } else {
      const int ch = chunks2 - 1 - (k - first) / groups;
      const int gi = (k - first) % groups;
      copy_u(st, ch * kRows2, kRows2, gi * kEll);
      if (gi == groups - 1) {  // the epilogue's G, read a second time
        copy_g(reinterpret_cast<float*>(sk + kRows2 * US * sizeof(TU)),
               ch * kRows2, kRows2);
      }
    }
  };

  float sum[2 * NTW][4];  // tile i NTW + jn (first), jn (second product)
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < units) issue(k);
    repro::cp_async_commit();
  }
  for (int k = 0; k < units; ++k) {
    repro::cp_async_wait<kStages - 2>();  // this thread's copies of unit k
    __syncthreads();  // everyone's copies landed; unit k - 1's readers done
    if (k + kStages - 1 < units) issue(k + kStages - 1);
    repro::cp_async_commit();
    const unsigned char* sk = smem + (k % kStages) * kStage;
    const TU* st = reinterpret_cast<const TU*>(sk);
    if (k < first) {
      if (nt0 >= NT) continue;  // bn < 32: warps past its n-tiles idle
      // P[group] += U[rows, group]^T G[rows] over the unit's 32 rows
      const int gi = k / chunks1, ch = k % chunks1;
      const float* sg =
          reinterpret_cast<const float*>(sk + kRows1 * US * sizeof(TU));
      if (ch == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int jn = 0; jn < NTW; ++jn) {
#pragma unroll
            for (int v = 0; v < 4; ++v) sum[i * NTW + jn][v] = 0.f;
          }
        }
      }
      float acc[2][NTW][4] = {};
#pragma unroll
      for (int j = 0; j < kRows1 / 8; ++j) {
        const int r = 8 * j;  // the k-step's first row
        uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const TU* ap = st + (r + t) * US + 16 * (rt0 + i) + 2 * gr;
          float a[4];
          u_pair(ap, a[0], a[1]);
          u_pair(ap + 4 * US, a[2], a[3]);
          a_frag<kExact>(a, a_hi[i], a_lo[i]);
        }
#pragma unroll
        for (int jn = 0; jn < NTW; ++jn) {
          const float* bp = sg + (r + t) * GS + 8 * (nt0 + jn) + gr;
          const float b[2] = {bp[0], bp[4 * GS]};
          uint32_t b_hi[2], b_lo[2];
          split(b, b_hi, b_lo);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            products<kExact>(acc[i][jn], a_hi[i], a_lo[i], b_hi, b_lo);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int jn = 0; jn < NTW; ++jn) {
#pragma unroll
          for (int v = 0; v < 4; ++v) sum[i * NTW + jn][v] += acc[i][jn][v];
        }
      }
      if (ch == chunks1 - 1) {  // P = c o sum, split; rows past ell 0
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = gi * kEll + 16 * (rt0 + i) + 2 * gr;  // and e + 1
          const float c0 = e < ell ? coeffs[n * ldu + e] : 0.f;
          const float c1 = e + 1 < ell ? coeffs[n * ldu + e + 1] : 0.f;
#pragma unroll
          for (int jn = 0; jn < NTW; ++jn) {
            // columns j, j + 1 of rows e, e + 1: one 16-byte store each
            const float* q = sum[i * NTW + jn];
            const float p[4] = {c0 * q[0], c1 * q[2], c0 * q[1], c1 * q[3]};
            uint32_t p_hi[4], p_lo[4];
            split(p, p_hi, p_lo);
            const int at = (e / 2 * PS + 8 * (nt0 + jn) + 2 * t) * 2;
            *reinterpret_cast<uint4*>(ph + at) =
                make_uint4(p_hi[0], p_hi[1], p_hi[2], p_hi[3]);
            *reinterpret_cast<uint4*>(pl + at) =
                make_uint4(p_lo[0], p_lo[1], p_lo[2], p_lo[3]);
          }
        }
      }
    } else {
      // Y[rows] += U[rows, group] P[group] over the group's 64 columns
      const int ch = chunks2 - 1 - (k - first) / groups;
      const int gi = (k - first) % groups;
      if (nb >= NT) continue;
      if (gi == 0) {
#pragma unroll
        for (int jn = 0; jn < NT2; ++jn) {
#pragma unroll
          for (int v = 0; v < 4; ++v) sum[jn][v] = 0.f;
        }
      }
      const int row0 = ch * kRows2 + 16 * rt + gr;
      const bool last = gi == groups - 1;
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // 32 columns, then promote
        if (gi * kEll + 32 * half >= ell) break;
        float acc[NT2][4] = {};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = 32 * half + 8 * j;  // the k-step's first column
          const TU* ap = st + (16 * rt + gr) * US + e + 2 * t;
          float a[4];
          u_pair(ap, a[0], a[2]);
          u_pair(ap + 8 * US, a[1], a[3]);
          uint32_t a_hi[4], a_lo[4];
          a_frag<kExact>(a, a_hi, a_lo);
#pragma unroll
          for (int jn = 0; jn < NT2; ++jn) {
            const int at =
                (((gi * kEll + e) / 2 + t) * PS + 8 * (nb + jn) + gr) * 2;
            const uint2 h2 = *reinterpret_cast<const uint2*>(ph + at);
            const uint2 l2 = *reinterpret_cast<const uint2*>(pl + at);
            const uint32_t b_hi[2] = {h2.x, h2.y};
            const uint32_t b_lo[2] = {l2.x, l2.y};
            products<kExact>(acc[jn], a_hi, a_lo, b_hi, b_lo);
          }
        }
#pragma unroll
        for (int jn = 0; jn < NT2; ++jn) {
#pragma unroll
          for (int v = 0; v < 4; ++v) sum[jn][v] += acc[jn][v];
        }
      }
      if (last && add) {  // Y += sum
#pragma unroll
        for (int jn = 0; jn < NT2; ++jn) {
          const int j = j0 + 8 * (nb + jn) + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + 8 * h;
            if (row >= d || j >= m) continue;
            float* yp = yn + static_cast<long long>(row) * m + j;
            yp[0] += sum[jn][2 * h];
            if (j + 1 < m) yp[1] += sum[jn][2 * h + 1];
          }
        }
      } else if (last) {  // Y = base G + sum, G from the unit's stage
        const float bn_ = base[n];
        const float* sg =
            reinterpret_cast<const float*>(sk + kRows2 * US * sizeof(TU));
#pragma unroll
        for (int jn = 0; jn < NT2; ++jn) {
          const int col = 8 * (nb + jn) + 2 * t, j = j0 + col;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + 8 * h;
            if (row >= d || j >= m) continue;
            float* yp = yn + static_cast<long long>(row) * m + j;
            const float* gp = sg + (row - ch * kRows2) * GS + col;
            const float y0 = bn_ * gp[0] + sum[jn][2 * h];
            const float y1 = bn_ * gp[1] + sum[jn][2 * h + 1];
            if (j + 1 < m && m % 2 == 0) {
              *reinterpret_cast<float2*>(yp) = make_float2(y0, y1);
            } else {
              yp[0] = y0;
              if (j + 1 < m) yp[1] = y1;
            }
          }
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename TU, int NT>
int launch_nt(const TU* u, const float* coeffs, const float* base,
              const float* g, float* y, int n, int d, int ell, int m, int ldu,
              int add, cudaStream_t stream) {
  const size_t smem = smem_bytes(ell, 8 * NT, sizeof(TU));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      apply_kernel<TU, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_u = ldu * sizeof(TU) % 16 == 0 && aligned16(u);
  const int vec_g = m % 4 == 0 && aligned16(g);
  const int slice = n < 65535 ? (n > 0 ? n : 1) : 65535;
  const dim3 grid((m + 8 * NT - 1) / (8 * NT), slice,
                  (n + slice - 1) / slice);
  apply_kernel<TU, NT><<<grid, kThreads, smem, stream>>>(
      u, coeffs, base, g, y, n, d, ell, m, vec_u, vec_g, ldu, add);
  return static_cast<int>(cudaGetLastError());
}

// The columns of U a launch takes: all of them up to kMaxEll, else chunks
// of kChunkEll (kernels/lowrank/kernel.py ``apply_chunks``).
constexpr int kMaxEll = 1984;   // P's rows at bn 8 beside the stages
constexpr int kChunkEll = 256;  // P's rows at bn 64
int chunk_cols(int ell) { return ell <= kMaxEll ? ell : kChunkEll; }

// One chunk of ell columns of U (row stride ldu).
template <typename TU>
int launch_chunk(const TU* u, const float* coeffs, const float* base,
                 const float* g, float* y, int n, int d, int ell, int m,
                 int ldu, int add, int col_tile, cudaStream_t s) {
  if (col_tile == 0) {
    // the widest column tile whose shared memory fits (64 up to ell 256)
    col_tile = smem_bytes(ell, 64, sizeof(TU)) <= kMaxSmem   ? 64
               : smem_bytes(ell, 32, sizeof(TU)) <= kMaxSmem ? 32
               : smem_bytes(ell, 16, sizeof(TU)) <= kMaxSmem ? 16
                                                              : 8;
  }
  switch (col_tile) {
    case 64:
      return launch_nt<TU, 8>(u, coeffs, base, g, y, n, d, ell, m, ldu, add,
                              s);
    case 32:
      return launch_nt<TU, 4>(u, coeffs, base, g, y, n, d, ell, m, ldu, add,
                              s);
    case 16:
      return launch_nt<TU, 2>(u, coeffs, base, g, y, n, d, ell, m, ldu, add,
                              s);
    case 8:
      return launch_nt<TU, 1>(u, coeffs, base, g, y, n, d, ell, m, ldu, add,
                              s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TU>
int launch(const TU* u, const float* coeffs, const float* base, const float* g,
           float* y, int n, int d, int ell, int m, int col_tile,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cols = chunk_cols(ell);
  for (int e0 = 0; e0 < ell; e0 += cols) {
    const int w = ell - e0 < cols ? ell - e0 : cols;
    const int err = launch_chunk(u + e0, coeffs + e0, base, g, y, n, d, w, m,
                                 ell, e0 > 0, col_tile, s);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

// u_dtype: 0 = float32, 2 = int8.  Any ell, past 1984 in chunks of 256
// columns.  col_tile: the columns of G a block takes, 8, 16, 32 or 64
// (kernels/autotune.py), or 0 for the widest whose shared memory fits each
// chunk.  Returns the cudaError_t of the launches (cudaErrorInvalidValue
// for another col_tile, or where a chunk is too wide for P to fit shared
// memory at that tile).
extern "C" int repro_batched_lowrank_apply(const void* u, int u_dtype,
                                           const float* coeffs,
                                           const float* base, const float* g,
                                           float* y, int n, int d, int ell,
                                           int m, int col_tile,
                                           void* stream) {
  if (u_dtype == 0) {
    return launch(static_cast<const float*>(u), coeffs, base, g, y, n, d, ell,
                  m, col_tile, stream);
  }
  if (u_dtype == 2) {
    return launch(static_cast<const int8_t*>(u), coeffs, base, g, y, n, d,
                  ell, m, col_tile, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
