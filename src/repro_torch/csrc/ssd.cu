// Mamba2 SSD chunk scan with one B/C group (n_groups = 1):
//   within a chunk of Q positions, A = cumsum(dlog) per head and
//   y[q] = sum_{s <= q} (C[q] . B[s]) exp(A[q] - A[s]) u[s]      (intra)
//        + exp(A[q]) C[q] S_c^T                                  (inter)
//   S_{c+1} = exp(A[Q-1]) S_c + sum_s exp(A[Q-1] - A[s]) u[s] B[s]^T
// with S_0 = 0, the (P, N) state of each head.  u (B, S, H, P) f32, bf16
// or fp16, dlog (B, S, H) f32, B and C (B, S, N) in u's dtype, all
// contiguous -> y (B, S, H, P) in u's dtype.  Any P and any N.
//
// Replaces repro/kernels/ssd/kernel.py::ssd_pallas (_ssd_kernel).  On the
// port's main path it is the scan of every Mamba2 mixer (models/ssm.py
// ssd): zamba2-7b's 81 layers in the serving feedback gradient (B 4, S 16,
// H 112, P 64, N 64, one chunk of 16).
//
// What bounds it: in bf16 (and fp16) the bytes.  Per chunk and batch row
// the scores C B^T take Q (Q + 1) / 2 N multiply-adds, and each head
// Q (Q + 1) / 2 P (intra), Q N P (inter) and Q N P (state): on the bf16
// tensor cores that is below the time to read u, dlog, B, C and write y
// (chip_smoke.py prints both).  The f32 instantiation multiplies in f32
// FFMA, where the operations bound it.
//
// Design: the Pallas kernel walks the chunks in order with the state in
// VMEM.  Here the chunks run in parallel, in three phases (Mamba-2's own
// SSD decomposition: chunk states, state passing, chunk outputs), each a
// launch on the caller's stream:
//   1. chunk_state_kernel, grid (chunks - 1, H, B): the state a chunk adds,
//      dS_c = sum_s exp(A_end - A_s) u_s B_s^T, into an f32 scratch
//      (B, chunks - 1, H, P, N), and exp(A_end) into (B, chunks - 1, H).
//      The last chunk's state is never read, so it is not computed.
//   2. state_pass_kernel, one thread per 4 state elements of a (b, h): in
//      chunk order, S_{c+1} = exp(A_end,c) S_c + dS_c in place, so slot c
//      ends holding the state that enters chunk c + 1.  Elementwise: bytes.
//   3. chunk_out_kernel, grid (chunks x query blocks, head tiles, B): the
//      intra term over the key tiles up to the diagonal (the ones above it
//      are skipped) plus, after the first chunk, the inter term against
//      slot c - 1.
// With one chunk (the main path, S <= chunk) only phase 3 runs, with no
// inter term.  A = cumsum(dlog) is a warp-parallel scan in each block that
// needs it (per lane a run of positions, then a shuffle scan of the lanes'
// sums), recomputed rather than kept.  Query blocks are the chunk's own
// size where Q < 64: 16 rows at Q <= 16, 32 at Q <= 32, else 64, so Q = 16
// computes no zero rows; key tiles are the query block's size.
//
// Products: mma.sync.m16n8k16 (bf16 in, f32 accumulate; fp16 with the
// .f16 form, and the notes below say bf16 for both) for every shape:
// warp-sized tiles fit Q = 16 directly, and at Q = 256 the products take
// 15 us at the bf16 rate (zamba2-7b at S 4096; chip_smoke.py prints it), a
// small part of the kernel's time, so wgmma was not tried.  C B^T is exact;
// the decayed scores (scores o L), the carried state and the decayed u are
// rounded to bf16 as mamba_ssm's kernels round them, and every sum is f32.
// The scores C B^T are shared by the heads; each head tile recomputes them
// from its staged C and B rows (a third of its products at P = N = 64 and
// two heads a block), rather than staging them once per chunk in an f32
// scratch (4 MB at S 4096), which was not built.  The f32 instantiation
// runs the same three phases with the same fragment layout, its product
// emulated in f32 FFMA (operands gathered across the warp by shuffles, k
// summed in order): it has no main path, and meets 5e-6 S absolute against
// the plain version (chip_smoke.py).
//
// Any P and N (the reference takes any).  P in {16, 32, 64} with N <= 128
// (every config of the repo) runs the kernels above as they were.  Any
// other P and N run their WIDE instantiations (P 64, 64-row query blocks):
// y[..., p] depends only on u[..., p] and the state's row p, so P runs as
// independent 64-wide slices, the columns past P zero in shared memory and
// not stored (u and y are read and written through the head stride P, so
// no copy is made).  Only phase 3 sums over N (in C B^T and C S_c^T):
// phases 1 and 2 run on each 128-column chunk of N in place, and phase 3
// runs once a chunk, its partial y summed in f32 in a scratch (B, S, H, P),
// chunk after chunk, the last adding its own and rounding to y.  One WIDE
// form a phase (not one per slice width and query block) keeps the build's
// time: a P of 8 then computes 64 columns for its 8.
//
// Determinism: no atomics; every sum runs in a fixed order, so two runs
// give the same bits.  Positions past S and heads past H read as zeros and
// are not written, so S and H need not be multiples of the chunk or the
// head tile.
#include <algorithm>
#include <cstdint>

#include "hopper.cuh"
#include "tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int kThreads = 128;   // four warps a block in every phase
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 128;      // state columns a launch takes (an N chunk)
constexpr int kKeys = 64;       // phase 1's key tile
constexpr size_t kMaxSmem = 232448;

// ---- one register of an mma.m16n8k16 operand fragment: two values --------

template <typename T>
struct Frag {
  uint32_t v;  // bf16x2 or f16x2, the lower column in the low half
};
template <>
struct Frag<float> {
  float x, y;
};

template <typename T>
__device__ __forceinline__ Frag<T> make_frag(float lo, float hi) {
  return {repro::pack2<T>(lo, hi)};
}
template <>
__device__ __forceinline__ Frag<float> make_frag<float>(float lo, float hi) {
  return {lo, hi};
}

// the elements at p and q of a shared-memory tile
template <typename T>
__device__ __forceinline__ Frag<T> load_frag(const T* p, const T* q) {
  const uint32_t lo = *reinterpret_cast<const unsigned short*>(p);
  const uint32_t hi = *reinterpret_cast<const unsigned short*>(q);
  return {lo | (hi << 16)};
}
__device__ __forceinline__ Frag<float> load_frag(const float* p,
                                                 const float* q) {
  return {*p, *q};
}
// two consecutive elements at p (p even)
template <typename T>
__device__ __forceinline__ Frag<T> load_frag2(const T* p) {
  return {*reinterpret_cast<const uint32_t*>(p)};
}
__device__ __forceinline__ Frag<float> load_frag2(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return {v.x, v.y};
}

// d (16 x 8, f32) += a (16 x 16) b (16 x 8).  Fragments of lane l, g = l / 4,
// t = l % 4: a[0] row g, columns 2t, 2t + 1; a[1] row g + 8; a[2] columns
// 2t + 8, 2t + 9; a[3] both; b[0] rows 2t, 2t + 1 of column g, b[1] rows
// 2t + 8, 2t + 9; d[0, 1] row g, columns 2t, 2t + 1, d[2, 3] row g + 8.
__device__ __forceinline__ void mma(float (&d)[4], const Frag<bf16> (&a)[4],
                                    const Frag<bf16> (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0].v), "r"(a[1].v), "r"(a[2].v), "r"(a[3].v), "r"(b[0].v),
        "r"(b[1].v));
}
__device__ __forceinline__ void mma(float (&d)[4], const Frag<f16> (&a)[4],
                                    const Frag<f16> (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0].v), "r"(a[1].v), "r"(a[2].v), "r"(a[3].v), "r"(b[0].v),
        "r"(b[1].v));
}

// The same product in f32 FFMA: lane (g, t) gathers rows g and g + 8 of a
// from lanes 4g .. 4g + 3 and columns 2t, 2t + 1 of b from lanes 8t ..
// 8t + 7, then sums k = 0 .. 15 in order.  Every lane of the warp must call.
__device__ __forceinline__ void mma(float (&d)[4], const Frag<float> (&a)[4],
                                    const Frag<float> (&b)[2]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {      // k = 8 h + 2 tk + e
#pragma unroll
    for (int tk = 0; tk < 4; ++tk) {
      const int la = 4 * g + tk, lb0 = 8 * t + tk, lb1 = lb0 + 4;
      const float r0x = __shfl_sync(~0u, a[2 * h].x, la);
      const float r0y = __shfl_sync(~0u, a[2 * h].y, la);
      const float r1x = __shfl_sync(~0u, a[2 * h + 1].x, la);
      const float r1y = __shfl_sync(~0u, a[2 * h + 1].y, la);
      const float c0x = __shfl_sync(~0u, b[h].x, lb0);
      const float c0y = __shfl_sync(~0u, b[h].y, lb0);
      const float c1x = __shfl_sync(~0u, b[h].x, lb1);
      const float c1y = __shfl_sync(~0u, b[h].y, lb1);
      d[0] = fmaf(r0y, c0y, fmaf(r0x, c0x, d[0]));
      d[1] = fmaf(r0y, c1y, fmaf(r0x, c1x, d[1]));
      d[2] = fmaf(r1y, c0y, fmaf(r1x, c0x, d[2]));
      d[3] = fmaf(r1y, c1y, fmaf(r1x, c1x, d[3]));
    }
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = repro::pack2<T>(lo, hi);
}
__device__ __forceinline__ void store2(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

struct One {
  __device__ __forceinline__ float operator()(int) const { return 1.f; }
};

// Rows [0, nrows) of a row-major matrix (row r at m + r * stride) into
// tile[r * ts + c] as TD, each row times scale(r): columns [0, n), zeros in
// [n, nk) and in rows >= valid.  nk is a multiple of 16; vec: 16-byte loads
// (m and stride * sizeof(TS) 16-byte aligned).
template <typename TD, typename TS, typename Scale>
__device__ __forceinline__ void stage(TD* tile, int ts, const TS* m,
                                      long long stride, int nrows, int valid,
                                      int n, int nk, bool vec, Scale scale) {
  constexpr int kVec = 16 / sizeof(TS);
  const int per_row = nk / kVec;
  for (int e = threadIdx.x; e < nrows * per_row; e += kThreads) {
    const int r = e / per_row, c = e % per_row * kVec;
    const TS* src = m + r * stride + c;
    float x[kVec];
    if (r < valid && vec && c + kVec <= n) {
      union {
        uint4 raw;
        TS v[kVec];
      } in;
      in.raw = __ldg(reinterpret_cast<const uint4*>(src));
#pragma unroll
      for (int i = 0; i < kVec; ++i) x[i] = repro::to_f32(in.v[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        x[i] = r < valid && c + i < n ? repro::to_f32(src[i]) : 0.f;
      }
    }
    const float s = r < valid ? scale(r) : 0.f;
    TD* dst = tile + r * ts + c;
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[i] = repro::from_f32<TD>(x[i] * s);
  }
}

// a[r * HT + hh] = sum_{i <= r} dlog[i * H + h0 + hh] (0 for heads past
// H) for r < rows: warp w scans heads w, w + 4, ...; each lane sums a run
// of positions, a shuffle scan adds the earlier lanes' sums.
template <int HT>
__device__ __forceinline__ void cumsum(float* a, const float* dlog, int H,
                                       int h0, int rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per = (rows + 31) / 32;
  for (int hh = warp; hh < HT; hh += kWarps) {
    const int h = h0 + hh;
    float run = 0.f;
    for (int i = 0; i < per; ++i) {
      const int r = lane * per + i;
      if (r < rows) {
        run += h < H ? dlog[static_cast<long long>(r) * H + h] : 0.f;
        a[r * HT + hh] = run;
      }
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(~0u, incl, o);
      if (lane >= o) incl += v;
    }
    float before = __shfl_up_sync(~0u, incl, 1);
    if (lane == 0) before = 0.f;
    for (int i = 0; i < per; ++i) {
      const int r = lane * per + i;
      if (r < rows) a[r * HT + hh] += before;
    }
  }
}

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// ---- phase 1: the state each chunk but the last adds ----------------------

size_t state_smem(int P, int N, int Q, size_t esize) {
  return sizeof(float) * ((Q + 3) / 4 * 4) +
         esize * kKeys * (round16(N) + 8 + P + 8);
}

// Grid (chunks - 1, H, B).  Warp w holds the 16 state rows p of row tile
// w % (P / 16) and every (4 / (P / 16))-th n-tile of 8 columns from w /
// (P / 16): out[p][n] = sum_s du[s][p] B[s][n], du = u exp(A_end - A).
// WIDE: P is the slice's width, u's columns 0 .. pv - 1 from u (head
// stride ldp; u starts at the slice), the rest zero; N the chunk's width,
// B's columns from bm (row stride ldn; bm starts at the chunk).  The state
// of (slot, head) starts sld floats after the last (states starts at the
// slice's first row and the chunk's first column), its rows ldn apart.
// Otherwise ldp, pv, ldn and sld are unread: P and N are u's and B's.
template <typename T, int P, bool WIDE>
__global__ void __launch_bounds__(kThreads)
    chunk_state_kernel(const T* __restrict__ u, const float* __restrict__ dlog,
                       const T* __restrict__ bm, float* __restrict__ states,
                       float* __restrict__ keep, int S, int H, int N, int Q,
                       int chunks, int vec_b, int vec_u, int ldp, int pv,
                       int ldn, long long sld) {
  constexpr int RT = P / 16, WPR = kWarps / RT, MT = 16 / WPR, PS = P + 8;
  const int NT = (N + 7) / 8, NK = round16(N), NS = NK + 8;
  // grid (B H (chunks - 1)): chunk after chunk of head h of batch row b,
  // the order of a (chunks - 1, H, B) grid without its limit on B
  const int c = static_cast<int>(blockIdx.x % (chunks - 1));
  const long long bh = blockIdx.x / (chunks - 1);
  const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
  const long long pos0 = static_cast<long long>(b) * S +
                         static_cast<long long>(c) * Q;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sa = reinterpret_cast<float*>(smem);                // [Q]
  T* sb = reinterpret_cast<T*>(sa + (Q + 3) / 4 * 4);        // [kKeys][NS]
  T* su = sb + kKeys * NS;                                   // [kKeys][PS]

  cumsum<1>(sa, dlog + pos0 * H, H, h, Q);
  __syncthreads();
  const float a_end = sa[Q - 1];
  const long long slot = (static_cast<long long>(b) * (chunks - 1) + c) * H +
                         h;
  if (threadIdx.x == 0) keep[slot] = expf(a_end);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rt = warp % RT, n0 = warp / RT;
  float acc[MT][4] = {};
  for (int s0 = 0; s0 < Q; s0 += kKeys) {
    const int kn = min(kKeys, Q - s0);
    __syncthreads();  // the last key tile's readers are done
    if constexpr (WIDE) {
      stage(sb, NS, bm + (pos0 + s0) * ldn, ldn, kKeys, kn, N, NK, vec_b,
            One{});
      stage(su, PS,
            u + (pos0 + s0) * H * ldp + static_cast<long long>(h) * ldp,
            static_cast<long long>(H) * ldp, kKeys, kn, pv, P, vec_u,
            [&](int r) { return expf(a_end - sa[s0 + r]); });
    } else {
      stage(sb, NS, bm + (pos0 + s0) * N, N, kKeys, kn, N, NK, vec_b,
            One{});
      stage(su, PS, u + (pos0 + s0) * H * P + static_cast<long long>(h) * P,
            static_cast<long long>(H) * P, kKeys, kn, P, P, vec_u,
            [&](int r) { return expf(a_end - sa[s0 + r]); });
    }
    __syncthreads();
    for (int ks = 0; ks < kn; ks += 16) {
      const T* ua = su + (ks + 2 * t) * PS + 16 * rt + g;
      const Frag<T> a[4] = {load_frag(ua, ua + PS),
                            load_frag(ua + 8, ua + PS + 8),
                            load_frag(ua + 8 * PS, ua + 9 * PS),
                            load_frag(ua + 8 * PS + 8, ua + 9 * PS + 8)};
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int nt = n0 + WPR * i;
        if (nt >= NT) break;
        const T* bp = sb + (ks + 2 * t) * NS + 8 * nt + g;
        const Frag<T> bf[2] = {load_frag(bp, bp + NS),
                               load_frag(bp + 8 * NS, bp + 9 * NS)};
        mma(acc[i], a, bf);
      }
    }
  }

  const int ld = WIDE ? ldn : N;  // the state's row stride
  float* out = states + (WIDE ? slot * sld : slot * P * N);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int nt = n0 + WPR * i;
    if (nt >= NT) break;
    const int n = 8 * nt + 2 * t, p = 16 * rt + g;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (n + e < N) {
        out[p * ld + n + e] = acc[i][e];
        out[(p + 8) * ld + n + e] = acc[i][2 + e];
      }
    }
  }
}

// ---- phase 2: the states in chunk order -----------------------------------

// One thread per 4 consecutive elements of one (b, h)'s (P, N) state.
__global__ void __launch_bounds__(256)
    state_pass_kernel(float* __restrict__ states,
                      const float* __restrict__ keep, int B, int H, int PN,
                      int chunks) {
  const int per = PN / 4;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(B) * H * per) return;
  const long long bh = i / per;  // b * H + h
  const int e = static_cast<int>(i % per);
  const long long b = bh / H, h = bh % H;
  const int slots = chunks - 1;
  float4* s0 = reinterpret_cast<float4*>(states) +
               ((b * slots) * H + h) * per + e;
  float4 s = *s0;
  for (int c = 1; c < slots; ++c) {
    const long long at = (b * slots + c) * H + h;
    const float k = keep[at];
    float4* p = reinterpret_cast<float4*>(states) + at * per + e;
    const float4 ds = *p;
    s = make_float4(fmaf(k, s.x, ds.x), fmaf(k, s.y, ds.y),
                    fmaf(k, s.z, ds.z), fmaf(k, s.w, ds.w));
    *p = s;
  }
}

// ---- phase 3: the outputs -------------------------------------------------

// Query blocks of QB = 16 QT rows and HT = (4 / QT) HW heads; warp w holds
// query rows 16 (w % QT) .. + 15 of the block for heads (w / QT) HW .. + HW
// - 1 of the tile.
size_t out_smem(int P, int N, int Q, int QT, int HW, bool inter,
                size_t esize) {
  const int QB = 16 * QT, HT = (4 / QT) * HW, NS = round16(N) + 8;
  const int qrows = (Q + QB - 1) / QB * QB;
  return sizeof(float) * qrows * HT +
         esize * (2ull * QB * NS + QB * (HT * P + 8) +
                  (inter ? static_cast<size_t>(HT) * P * NS : 0));
}

// WIDE: P, pv, ldp, N, ldn and sld as in phase 1 (u, y, yacc and states
// start at the slice, bm, cm and states at the chunk); ``first``: this is
// N's first chunk; ``last``: its last, which stores y in T; the others
// store the sum so far in yacc (f32, y's layout), which the next one adds
// to its own.  Otherwise those are unread.
template <typename T, int P, int QT, int HW, bool WIDE>
__global__ void __launch_bounds__(kThreads)
    chunk_out_kernel(const T* __restrict__ u, const float* __restrict__ dlog,
                     const T* __restrict__ bm, const T* __restrict__ cm,
                     const float* __restrict__ states, T* __restrict__ y,
                     float* __restrict__ yacc, int S, int H, int N, int Q,
                     int qblocks, int chunks, int vec_b, int vec_u, int ldp,
                     int pv, int ldn, long long sld, int first, int last) {
  constexpr int QB = 16 * QT, HT = (4 / QT) * HW, NTP = P / 8;
  constexpr int US = HT * P + 8;
  const int NK = round16(N), NS = NK + 8;
  // grid (B ceil(H / HT) chunks qblocks): the order of a (chunks qblocks,
  // ceil(H / HT), B) grid without its limit on B
  const int cq = chunks * qblocks, hts = (H + HT - 1) / HT;
  const int cqi = static_cast<int>(blockIdx.x % cq);
  const long long bht = blockIdx.x / cq;
  const int c = cqi / qblocks, qb = cqi % qblocks;
  const int c0 = c * Q, valid = min(Q, S - c0), q0 = qb * QB;
  if (q0 >= valid) return;  // past S in a ragged last chunk
  const int rows = min(valid, q0 + QB);  // positions of the chunk it reads
  const int h0 = static_cast<int>(bht % hts) * HT;
  const int b = static_cast<int>(bht / hts);
  const int heads = min(HT, H - h0);
  const long long pos0 = static_cast<long long>(b) * S + c0;
  const bool inter = c > 0;

  extern __shared__ __align__(16) unsigned char smem[];
  float* sa = reinterpret_cast<float*>(smem);                  // [rows][HT]
  T* sc = reinterpret_cast<T*>(sa + (Q + QB - 1) / QB * QB * HT);
  T* sb = sc + QB * NS;                                        // [QB][NS]
  T* su = sb + QB * NS;                                        // [QB][US]
  T* ss = su + QB * US;                                        // [HT][P][NS]

  cumsum<HT>(sa, dlog + pos0 * H, H, h0, rows);
  if constexpr (WIDE) {
    stage(sc, NS, cm + (pos0 + q0) * ldn, ldn, QB, rows - q0, N, NK, vec_b,
          One{});
    if (inter) {  // a head's rows of a state sld apart, its rows ldn
      const float* st = states +
          ((static_cast<long long>(b) * (chunks - 1) + c - 1) * H + h0) * sld;
      for (int hh = 0; hh < HT; ++hh) {
        stage(ss + hh * P * NS, NS, st + hh * sld, ldn, P,
              hh < heads ? P : 0, N, NK, ldn % 4 == 0, One{});
      }
    }
  } else {
    stage(sc, NS, cm + (pos0 + q0) * N, N, QB, rows - q0, N, NK, vec_b,
          One{});
    if (inter) {
      const float* st = states +
          ((static_cast<long long>(b) * (chunks - 1) + c - 1) * H + h0) * P *
              N;
      stage(ss, NS, st, N, HT * P, heads * P, N, NK, N % 4 == 0, One{});
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wq = warp % QT, hw0 = (warp / QT) * HW;
  const int qr = q0 + 16 * wq;  // the warp's first query row
  const T* cr = sc + (16 * wq + g) * NS + 2 * t;
  float acc[HW][NTP][4] = {};

  if (inter) {  // exp(A[q]) C[q] S_c^T
    for (int kk = 0; kk < NK; kk += 16) {
      const Frag<T> a[4] = {load_frag2(cr + kk), load_frag2(cr + 8 * NS + kk),
                            load_frag2(cr + kk + 8),
                            load_frag2(cr + 8 * NS + kk + 8)};
#pragma unroll
      for (int i = 0; i < HW; ++i) {
#pragma unroll
        for (int nt = 0; nt < NTP; ++nt) {
          const T* sp = ss + ((hw0 + i) * P + 8 * nt + g) * NS + kk + 2 * t;
          const Frag<T> bf[2] = {load_frag2(sp), load_frag2(sp + 8)};
          mma(acc[i][nt], a, bf);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < HW; ++i) {
      const int hh = hw0 + i;
      const float e0 = qr + g < rows ? expf(sa[(qr + g) * HT + hh]) : 0.f;
      const float e1 = qr + g + 8 < rows ? expf(sa[(qr + g + 8) * HT + hh])
                                         : 0.f;
#pragma unroll
      for (int nt = 0; nt < NTP; ++nt) {
        acc[i][nt][0] *= e0, acc[i][nt][1] *= e0;
        acc[i][nt][2] *= e1, acc[i][nt][3] *= e1;
      }
    }
  }

  for (int kt = 0; kt <= qb; ++kt) {  // key tiles up to the diagonal
    const int s0 = kt * QB;
    __syncthreads();  // the last key tile's readers are done
    if constexpr (WIDE) {  // a head's pv columns of u ldp apart
      stage(sb, NS, bm + (pos0 + s0) * ldn, ldn, QB, rows - s0, N, NK,
            vec_b, One{});
      const T* us =
          u + (pos0 + s0) * H * ldp + static_cast<long long>(h0) * ldp;
      for (int hh = 0; hh < HT; ++hh) {
        stage(su + hh * P, US, us + hh * ldp,
              static_cast<long long>(H) * ldp, QB,
              hh < heads ? rows - s0 : 0, pv, P, vec_u, One{});
      }
    } else {
      stage(sb, NS, bm + (pos0 + s0) * N, N, QB, rows - s0, N, NK, vec_b,
            One{});
      stage(su, US, u + (pos0 + s0) * H * P + static_cast<long long>(h0) * P,
            static_cast<long long>(H) * P, QB, rows - s0, heads * P, HT * P,
            vec_u, One{});
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      const int ks = s0 + 16 * j;  // the key subtile's first key
      if (ks > qr + 15 || ks >= rows) continue;
      float sg[2][4] = {};  // C B^T: rows qr + g (+ 8), keys ks + 8 jn + 2t
      for (int kk = 0; kk < NK; kk += 16) {
        const Frag<T> a[4] = {
            load_frag2(cr + kk), load_frag2(cr + 8 * NS + kk),
            load_frag2(cr + kk + 8), load_frag2(cr + 8 * NS + kk + 8)};
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
          const T* bp = sb + (16 * j + 8 * jn + g) * NS + kk + 2 * t;
          const Frag<T> bf[2] = {load_frag2(bp), load_frag2(bp + 8)};
          mma(sg[jn], a, bf);
        }
      }
#pragma unroll
      for (int i = 0; i < HW; ++i) {
        const int hh = hw0 + i;
        const int q[2] = {qr + g, qr + g + 8};
        const float aq[2] = {sa[q[0] * HT + hh], sa[q[1] * HT + hh]};
        float w[2][4];  // the decayed scores, as sg
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int s = ks + 8 * jn + 2 * t + e;
            const float as = sa[s * HT + hh];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              w[jn][2 * r + e] = s <= q[r] && q[r] < rows
                                     ? sg[jn][2 * r + e] * expf(aq[r] - as)
                                     : 0.f;
            }
          }
        }
        const Frag<T> a[4] = {
            make_frag<T>(w[0][0], w[0][1]), make_frag<T>(w[0][2], w[0][3]),
            make_frag<T>(w[1][0], w[1][1]), make_frag<T>(w[1][2], w[1][3])};
        const T* up = su + (16 * j + 2 * t) * US + hh * P + g;
#pragma unroll
        for (int nt = 0; nt < NTP; ++nt) {
          const T* bp = up + 8 * nt;
          const Frag<T> bf[2] = {load_frag(bp, bp + US),
                                 load_frag(bp + 8 * US, bp + 9 * US)};
          mma(acc[i][nt], a, bf);
        }
      }
    }
  }

  if constexpr (!WIDE) {
#pragma unroll
    for (int i = 0; i < HW; ++i) {
      const int h = h0 + hw0 + i;
      if (h >= H) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = qr + g + 8 * r;
        if (q >= rows) continue;
        T* yr = y + ((pos0 + q) * H + h) * P + 2 * t;
#pragma unroll
        for (int nt = 0; nt < NTP; ++nt) {
          store2(yr + 8 * nt, acc[i][nt][2 * r], acc[i][nt][2 * r + 1]);
        }
      }
    }
    return;
  }
  // WIDE: pairs of columns in one store where every pair is aligned (an
  // even head stride) and whole; else column by column up to pv
  const bool pairs = ldp % 2 == 0;
#pragma unroll
  for (int i = 0; i < HW; ++i) {
    const int h = h0 + hw0 + i;
    if (h >= H) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = qr + g + 8 * r;
      if (q >= rows) continue;
      const long long at = ((pos0 + q) * H + h) * ldp + 2 * t;
#pragma unroll
      for (int nt = 0; nt < NTP; ++nt) {
        const int col = 2 * t + 8 * nt;
        float lo = acc[i][nt][2 * r], hi = acc[i][nt][2 * r + 1];
        if (!first) {  // the earlier chunks' sum
          if (col < pv) lo += yacc[at + 8 * nt];
          if (col + 1 < pv) hi += yacc[at + 8 * nt + 1];
        }
        if (!last) {
          if (col < pv) yacc[at + 8 * nt] = lo;
          if (col + 1 < pv) yacc[at + 8 * nt + 1] = hi;
        } else if (pairs && col + 1 < pv) {
          store2(y + at + 8 * nt, lo, hi);
        } else {
          if (col < pv) y[at + 8 * nt] = repro::from_f32<T>(lo);
          if (col + 1 < pv) y[at + 8 * nt + 1] = repro::from_f32<T>(hi);
        }
      }
    }
  }
}

// ---- launches -------------------------------------------------------------

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// The shapes of one launch: the slice's width, valid columns and head
// stride, the N chunk's width and row stride, the state's (slot, head)
// stride, the vector flags, and which chunk of N it is.
struct Part {
  int pv, ldp, N, ldn;
  long long sld;
  int vec_b, vec_u, first, last;
};

template <typename T, int P, int QT, int HW, bool WIDE>
int launch_out(const T* u, const float* dlog, const T* bm, const T* cm,
               const float* states, T* y, float* yacc, int B, int S, int H,
               int Q, int chunks, const Part& pt, cudaStream_t stream) {
  const int N = pt.N;
  constexpr int QB = 16 * QT, HT = (4 / QT) * HW;
  const size_t smem = out_smem(P, N, Q, QT, HW, chunks > 1, sizeof(T));
  int err = allow_smem(chunk_out_kernel<T, P, QT, HW, WIDE>, smem);
  if (err != 0) return err;
  const int qblocks = (Q + QB - 1) / QB;
  const long long blocks = static_cast<long long>(chunks) * qblocks *
                           ((H + HT - 1) / HT) * B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  chunk_out_kernel<T, P, QT, HW, WIDE><<<grid, kThreads, smem, stream>>>(
      u, dlog, bm, cm, states, y, yacc, S, H, N, Q, qblocks, chunks, pt.vec_b,
      pt.vec_u, pt.ldp, pt.pv, pt.ldn, pt.sld, pt.first, pt.last);
  return static_cast<int>(cudaGetLastError());
}

// Phase 1 of one slice and N chunk (more than one chunk of Q).
template <typename T, int P, bool WIDE>
int launch_state(const T* u, const float* dlog, const T* bm, float* states,
                 float* keep, int B, int S, int H, int Q, int chunks,
                 const Part& pt, cudaStream_t stream) {
  const size_t smem = state_smem(P, pt.N, Q, sizeof(T));
  int err = allow_smem(chunk_state_kernel<T, P, WIDE>, smem);
  if (err != 0) return err;
  const long long blocks = static_cast<long long>(chunks - 1) * H * B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  chunk_state_kernel<T, P, WIDE><<<static_cast<unsigned>(blocks), kThreads,
                                   smem, stream>>>(
      u, dlog, bm, states, keep, S, H, pt.N, Q, chunks, pt.vec_b, pt.vec_u,
      pt.ldp, pt.pv, pt.ldn, pt.sld);
  return static_cast<int>(cudaGetLastError());
}

// Phase 3 of one slice and N chunk: query blocks of the chunk's own size.
template <typename T, int P>
int launch_chunk_out(const T* u, const float* dlog, const T* bm, const T* cm,
                     const float* states, T* y, float* yacc, int B, int S,
                     int H, int Q, int chunks, const Part& pt,
                     cudaStream_t stream) {
  if (Q <= 16) {
    return launch_out<T, P, 1, 1, false>(u, dlog, bm, cm, states, y, yacc, B,
                                         S, H, Q, chunks, pt, stream);
  }
  if (Q <= 32) {
    return launch_out<T, P, 2, 1, false>(u, dlog, bm, cm, states, y, yacc, B,
                                         S, H, Q, chunks, pt, stream);
  }
  return launch_out<T, P, 4, 2, false>(u, dlog, bm, cm, states, y, yacc, B, S,
                                       H, Q, chunks, pt, stream);
}

// One phase (``state``: 1, else 3) of a whole P of 16, 32 or 64 with N <=
// 128 (``w`` = P), or (``w`` 0) of a 64-wide slice and an N chunk on the
// WIDE forms.
template <typename T>
int launch_phase(int w, bool state, const T* u, const float* dlog,
                 const T* bm, const T* cm, float* states, float* keep, T* y,
                 float* yacc, int B, int S, int H, int Q, int chunks,
                 const Part& pt, cudaStream_t stream) {
  switch (w) {
    case 16:
      return state ? launch_state<T, 16, false>(u, dlog, bm, states, keep, B,
                                                S, H, Q, chunks, pt, stream)
                   : launch_chunk_out<T, 16>(u, dlog, bm, cm, states, y, yacc,
                                             B, S, H, Q, chunks, pt, stream);
    case 32:
      return state ? launch_state<T, 32, false>(u, dlog, bm, states, keep, B,
                                                S, H, Q, chunks, pt, stream)
                   : launch_chunk_out<T, 32>(u, dlog, bm, cm, states, y, yacc,
                                             B, S, H, Q, chunks, pt, stream);
    case 64:
      return state ? launch_state<T, 64, false>(u, dlog, bm, states, keep, B,
                                                S, H, Q, chunks, pt, stream)
                   : launch_chunk_out<T, 64>(u, dlog, bm, cm, states, y, yacc,
                                             B, S, H, Q, chunks, pt, stream);
    case 0:
      return state ? launch_state<T, 64, true>(u, dlog, bm, states, keep, B,
                                               S, H, Q, chunks, pt, stream)
                   : launch_out<T, 64, 4, 2, true>(u, dlog, bm, cm, states, y,
                                                   yacc, B, S, H, Q, chunks,
                                                   pt, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The shapes the kernels above take as they were: P one of 16, 32, 64 and
// N up to 128 (kernels/ssd/kernel.py ``is_whole``).
bool whole(int P, int N) {
  return (P == 16 || P == 32 || P == 64) && N <= kMaxN;
}

// The rows of the state scratch: P, or P rounded up to 64-wide slices.
int state_rows(int P, int N) { return whole(P, N) ? P : (P + 63) / 64 * 64; }

template <typename T>
int launch(const void* u, const float* dlog, const void* bm, const void* cm,
           void* y, float* states, float* keep, float* yacc, int B, int S,
           int H, int P, int N, int Q, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const T* ut = static_cast<const T*>(u);
  const T* bt = static_cast<const T*>(bm);
  const T* ct = static_cast<const T*>(cm);
  T* yt = static_cast<T*>(y);
  const int chunks = (S + Q - 1) / Q;
  const int rows = state_rows(P, N);  // scratch (B, chunks - 1, H, rows, N)
  const long long sld = static_cast<long long>(rows) * N;
  const bool vec_b = N * sizeof(T) % 16 == 0 && aligned16(bm) &&
                     aligned16(cm);
  const bool vec_u = P * sizeof(T) % 16 == 0 && aligned16(u);
  if (whole(P, N)) {  // one launch a phase, the kernels as they were
    const Part pt{P, P, N, N, sld, vec_b, vec_u, 1, 1};
    int err = 0;
    if (chunks > 1) {
      err = launch_phase<T>(P, true, ut, dlog, bt, ct, states, keep, yt, yacc,
                            B, S, H, Q, chunks, pt, stream);
      if (err != 0) return err;
    }
    if (chunks > 2) {
      const long long threads = static_cast<long long>(B) * H * sld / 4;
      state_pass_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256,
                          0, stream>>>(states, keep, B, H,
                                       static_cast<int>(sld), chunks);
      err = static_cast<int>(cudaGetLastError());
      if (err != 0) return err;
    }
    return launch_phase<T>(P, false, ut, dlog, bt, ct, states, keep, yt, yacc,
                           B, S, H, Q, chunks, pt, stream);
  }
  // WIDE: 64-wide slices of P, 128-column chunks of N.  Phase 1 for every
  // slice and chunk, into its rows and columns of the scratch
  const int n_chunks = (N + kMaxN - 1) / kMaxN;
  if (chunks > 1) {
    for (int nc = 0; nc < n_chunks; ++nc) {
      const int n0 = nc * kMaxN;
      for (int p0 = 0; p0 < P; p0 += 64) {
        const Part pt{std::min(64, P - p0), P, std::min(kMaxN, N - n0), N,
                      sld, vec_b, vec_u, 1, 1};
        const int err = launch_phase<T>(
            0, true, ut + p0, dlog, bt + n0, ct, states + p0 * N + n0, keep,
            yt, yacc, B, S, H, Q, chunks, pt, stream);
        if (err != 0) return err;
      }
    }
  }
  if (chunks > 2) {
    const long long threads = static_cast<long long>(B) * H * sld / 4;
    state_pass_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0,
                        stream>>>(states, keep, B, H, static_cast<int>(sld),
                                  chunks);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  // phase 3 for every slice, N's chunks in order
  for (int p0 = 0; p0 < P; p0 += 64) {
    for (int nc = 0; nc < n_chunks; ++nc) {
      const int n0 = nc * kMaxN;
      const Part pt{std::min(64, P - p0), P, std::min(kMaxN, N - n0), N,
                    sld, vec_b, vec_u, nc == 0, nc == n_chunks - 1};
      const int err = launch_phase<T>(
          0, false, ut + p0, dlog, bt + n0, ct + n0, states + p0 * N + n0,
          keep, yt + p0, yacc + p0, B, S, H, Q, chunks, pt, stream);
      if (err != 0) return err;
    }
  }
  return 0;
}

}  // namespace

// u (B, S, H, P), dlog (B, S, H) f32, bm and cm (B, S, N), y like u, all
// contiguous; any P and N; chunks of Q positions.  f32 scratch: states
// (B, chunks - 1, H, R, N) with R = P for the whole shapes and P rounded
// up to 64 otherwise (kernels/ssd/kernel.py ``state_rows``) and keep
// (B, chunks - 1, H),
// unused with one chunk; yacc like y, unused with N <= 128 (either may be
// null where unused).  dtype 0 = f32, 1 = bf16, 2 = fp16 (of u, bm, cm and
// y).  Returns the CUDA error of the launches (cudaErrorInvalidValue for a
// shape it does not take).
extern "C" int repro_ssd_scan(const void* u, const float* dlog,
                              const void* bm, const void* cm, void* y,
                              float* states, float* keep, float* yacc, int B,
                              int S, int H, int P, int N, int Q, int dtype,
                              void* stream) {
  if (N < 1 || P < 1 || Q < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return launch<float>(u, dlog, bm, cm, y, states, keep, yacc, B, S, H, P,
                         N, Q, stream);
  }
  if (dtype == 1) {
    return launch<bf16>(u, dlog, bm, cm, y, states, keep, yacc, B, S, H, P,
                        N, Q, stream);
  }
  if (dtype == 2) {
    return launch<f16>(u, dlog, bm, cm, y, states, keep, yacc, B, S, H, P, N,
                       Q, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
