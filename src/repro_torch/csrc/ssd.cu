// Mamba2 SSD chunk scan with one B/C group (n_groups = 1):
//   within a chunk of Q positions, A = cumsum(dlog) per head and
//   y[q] = sum_{s <= q} (C[q] . B[s]) exp(A[q] - A[s]) u[s]      (intra)
//        + exp(A[q]) C[q] state^T                                (inter)
//   state <- exp(A[Q-1]) state + sum_s exp(A[Q-1] - A[s]) u[s] B[s]^T
// with the (P, N) state of each head carried across the chunks in order.
// u (B, S, H, P) f32 or bf16, dlog (B, S, H) f32, B and C (B, S, N) in u's
// dtype, all contiguous -> y (B, S, H, P) in u's dtype; f32 arithmetic.
//
// Replaces repro/kernels/ssd/kernel.py::ssd_pallas (_ssd_kernel).  On the
// port's main path it is the scan of every Mamba2 mixer (models/ssm.py
// ssd): zamba2-7b's 81 layers in the serving feedback gradient (B 4, S 16,
// H 112, P 64, N 64, one chunk of 16).
//
// What bounds it: at a chunk of 256 the operations.  Per chunk and batch
// the scores C B^T take Q (Q + 1) / 2 N multiply-adds, and each head
// Q (Q + 1) / 2 P (intra), Q N P (inter) and Q N P (state), all f32 FFMA at
// 67 TFLOP/s; the bytes of u, dlog, B, C and y are ~20x fewer than the
// card could move in that time.
//
// Design: the Pallas kernel walks the chunks in order on its grid's last
// axis with the state in VMEM.  Here one block of 256 threads takes one
// batch row and a tile of HT heads (the scores are shared by every head, so
// they are formed once per tile), and loops over the chunks itself with the
// HT (P, N) states in shared memory (16 KB a head at P = N = 64).  The Q x Q
// score matrix does not fit shared memory at Q = 256 (256 KB), so a chunk
// is cut into 64-row query tiles and 64-column key tiles; tiles above the
// diagonal are skipped.  Thread (ty, tx) of the 16 x 16 grid owns score
// rows 4 ty .. 4 ty + 3 at columns tx + 16 j and, of y, those rows at
// columns tx + 16 j of each head; in the state update it owns state rows
// PJ ty .. PJ ty + PJ - 1 at columns tx + 16 j.  HT is the largest of 4, 2
// and 1 whose shared memory fits (4 at N = 64, 2 at N = 128).  Positions
// past S and heads past H read as zeros and are not written, so S and H
// need not be multiples of the chunk or the head tile.  The grid is (H /
// HT, B): at B = 1 and H = 112 that is 28 blocks for 132 SMs.
#include "tile.cuh"

namespace {

using repro::kThreads;
using repro::kTile;

constexpr int kMaxN = 128;        // the state update keeps N / 16 columns
constexpr int kMaxNJ = kMaxN / 16;
constexpr size_t kMaxSmem = 232448;

size_t smem_bytes(int P, int N, int Q, int HT) {
  // C and B tiles [64][N + 1], the weighted score tile [64][65], one head's
  // u tile [64][P], the chunk's cumulative decay [Q][HT], the states
  // [HT][P][N + 1]
  return sizeof(float) *
         (2ull * kTile * (N + 1) + kTile * (kTile + 1) + kTile * P +
          static_cast<size_t>(Q) * HT + static_cast<size_t>(HT) * P * (N + 1));
}

// rows [r0, r0 + 64) of a (rows, n) matrix into a [64][ns] tile as f32, zero
// past `valid` rows
template <typename T>
__device__ __forceinline__ void load_rows(float* tile, const T* m, int r0,
                                          int valid, int n, int ns) {
  for (int e = threadIdx.x; e < kTile * n; e += kThreads) {
    const int r = e / n, c = e % n;
    tile[r * ns + c] =
        r < valid ? repro::to_f32(m[static_cast<long long>(r0 + r) * n + c])
                  : 0.f;
  }
}

// Grid (ceil(H / HT), B); P = 16 PJ.
template <typename T, int PJ, int HT>
__global__ void __launch_bounds__(kThreads)
    ssd_kernel(const T* __restrict__ u, const float* __restrict__ dlog,
               const T* __restrict__ bm, const T* __restrict__ cm,
               T* __restrict__ y, int S, int H, int N, int Q) {
  constexpr int P = 16 * PJ;
  constexpr int WS = kTile + 1;
  const int NS = N + 1;  // padded rows: column reads hit distinct banks
  extern __shared__ float smem[];
  float* sc = smem;                 // [64][NS]   C rows of the query tile
  float* sb = sc + kTile * NS;      // [64][NS]   B rows of the key tile
  float* sw = sb + kTile * NS;      // [64][WS]   scores times one decay
  float* su = sw + kTile * WS;      // [64][P]    one head's u rows
  float* sa = su + kTile * P;       // [Q][HT]    A = cumsum(dlog)
  float* sst = sa + Q * HT;         // [HT][P][NS] the carried states
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int h0 = blockIdx.x * HT, b = blockIdx.y;
  const long long pos_stride = static_cast<long long>(H) * P;
  const T* ub = u + b * S * pos_stride;
  T* yb = y + b * S * pos_stride;
  const float* db = dlog + static_cast<long long>(b) * S * H;
  const T* bb = bm + static_cast<long long>(b) * S * N;
  const T* cb = cm + static_cast<long long>(b) * S * N;

  for (int e = tid; e < HT * P * NS; e += kThreads) sst[e] = 0.f;
  const int tiles = (Q + kTile - 1) / kTile;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int valid = min(Q, S - c0);  // positions of this chunk below S
    __syncthreads();  // the previous chunk's readers of sa are done
    for (int e = tid; e < Q * HT; e += kThreads) {
      const int qq = e / HT, hh = e % HT, h = h0 + hh;
      sa[e] = (qq < valid && h < H)
                  ? db[static_cast<long long>(c0 + qq) * H + h] : 0.f;
    }
    __syncthreads();
    if (tid < HT) {  // cumulative sums, one thread per head, in order
      float a = 0.f;
      for (int qq = 0; qq < Q; ++qq) {
        a += sa[qq * HT + tid];
        sa[qq * HT + tid] = a;
      }
    }

    for (int qt = 0; qt < tiles; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // sa is complete; the last tile's readers of sc done
      load_rows(sc, cb, c0 + q0, min(kTile, valid - q0), N, NS);
      __syncthreads();

      // inter-chunk term: exp(A[q]) sum_n C[q][n] state[h][p][n]
      float acc[HT][4][PJ];
#pragma unroll
      for (int hh = 0; hh < HT; ++hh) {
        float dot[4][PJ] = {};
        const float* st = sst + hh * P * NS;
        for (int n = 0; n < N; ++n) {
          float cv[4], sv[PJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = sc[(4 * ty + i) * NS + n];
#pragma unroll
          for (int jj = 0; jj < PJ; ++jj) sv[jj] = st[(tx + 16 * jj) * NS + n];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int jj = 0; jj < PJ; ++jj) {
              dot[i][jj] = fmaf(cv[i], sv[jj], dot[i][jj]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qq = q0 + 4 * ty + i;
          const float decay = qq < Q ? expf(sa[qq * HT + hh]) : 0.f;
#pragma unroll
          for (int jj = 0; jj < PJ; ++jj) acc[hh][i][jj] = decay * dot[i][jj];
        }
      }

      // intra-chunk term over the key tiles up to the diagonal
      for (int kt = 0; kt <= qt; ++kt) {
        const int s0 = kt * kTile;
        __syncthreads();  // the last key tile's readers of sb, sw, su done
        load_rows(sb, bb, c0 + s0, min(kTile, valid - s0), N, NS);
        __syncthreads();
        float g[4][4] = {};
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = sc[(4 * ty + i) * NS + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = sb[(tx + 16 * j) * NS + n];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
          }
        }
#pragma unroll
        for (int hh = 0; hh < HT; ++hh) {
          const int h = h0 + hh;
          if (hh > 0) __syncthreads();  // the last head's readers done
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int qq = q0 + 4 * ty + i;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int ss = s0 + tx + 16 * j;
              float w = 0.f;
              if (qq < Q && qq >= ss) {
                w = g[i][j] * expf(sa[qq * HT + hh] - sa[ss * HT + hh]);
              }
              sw[(4 * ty + i) * WS + tx + 16 * j] = w;
            }
          }
          for (int e = tid; e < kTile * P; e += kThreads) {
            const int r = e / P, p = e % P;
            su[e] = (s0 + r < valid && h < H)
                        ? repro::to_f32(
                              ub[(c0 + s0 + r) * pos_stride + h * P + p])
                        : 0.f;
          }
          __syncthreads();
#pragma unroll 4
          for (int ss = 0; ss < kTile; ++ss) {
            float wv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) wv[i] = sw[(4 * ty + i) * WS + ss];
#pragma unroll
            for (int jj = 0; jj < PJ; ++jj) {
              const float uv = su[ss * P + tx + 16 * jj];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                acc[hh][i][jj] = fmaf(wv[i], uv, acc[hh][i][jj]);
              }
            }
          }
        }
      }

#pragma unroll
      for (int hh = 0; hh < HT; ++hh) {
        const int h = h0 + hh;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qq = q0 + 4 * ty + i;
          if (qq >= valid || h >= H) continue;
#pragma unroll
          for (int jj = 0; jj < PJ; ++jj) {
            yb[(c0 + qq) * pos_stride + h * P + tx + 16 * jj] =
                repro::from_f32<T>(acc[hh][i][jj]);
          }
        }
      }
    }

    // state update, head by head, over the key tiles of the chunk
    for (int hh = 0; hh < HT; ++hh) {
      const int h = h0 + hh;
      float upd[PJ][kMaxNJ] = {};
      for (int kt = 0; kt < tiles; ++kt) {
        const int s0 = kt * kTile;
        __syncthreads();  // the last readers of sb and su are done
        load_rows(sb, bb, c0 + s0, min(kTile, valid - s0), N, NS);
        const float a_end = sa[(Q - 1) * HT + hh];
        for (int e = tid; e < kTile * P; e += kThreads) {
          const int r = e / P, p = e % P;
          su[e] = (s0 + r < valid && h < H)
                      ? repro::to_f32(
                            ub[(c0 + s0 + r) * pos_stride + h * P + p]) *
                            expf(a_end - sa[(s0 + r) * HT + hh])
                      : 0.f;
        }
        __syncthreads();
#pragma unroll 2
        for (int ss = 0; ss < kTile; ++ss) {
          float uv[PJ];
#pragma unroll
          for (int i = 0; i < PJ; ++i) uv[i] = su[ss * P + PJ * ty + i];
#pragma unroll
          for (int j = 0; j < kMaxNJ; ++j) {
            const int n = tx + 16 * j;
            if (n < N) {
              const float bv = sb[ss * NS + n];
#pragma unroll
              for (int i = 0; i < PJ; ++i) upd[i][j] = fmaf(uv[i], bv, upd[i][j]);
            }
          }
        }
      }
      const float keep = expf(sa[(Q - 1) * HT + hh]);
      float* st = sst + hh * P * NS;
#pragma unroll
      for (int i = 0; i < PJ; ++i) {
#pragma unroll
        for (int j = 0; j < kMaxNJ; ++j) {
          const int n = tx + 16 * j;
          if (n < N) {
            float* at = st + (PJ * ty + i) * NS + n;
            *at = keep * *at + upd[i][j];
          }
        }
      }
    }
  }
}

template <typename T, int PJ, int HT>
int launch_tile(const T* u, const float* dlog, const T* bm, const T* cm,
                T* y, int B, int S, int H, int N, int Q, size_t smem,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, PJ, HT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H + HT - 1) / HT, B);
  ssd_kernel<T, PJ, HT><<<grid, kThreads, smem, stream>>>(u, dlog, bm, cm, y,
                                                          S, H, N, Q);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int PJ>
int launch_p(const T* u, const float* dlog, const T* bm, const T* cm, T* y,
             int B, int S, int H, int N, int Q, cudaStream_t stream) {
  const int P = 16 * PJ;
  if (smem_bytes(P, N, Q, 4) <= kMaxSmem) {
    return launch_tile<T, PJ, 4>(u, dlog, bm, cm, y, B, S, H, N, Q,
                                 smem_bytes(P, N, Q, 4), stream);
  }
  if (smem_bytes(P, N, Q, 2) <= kMaxSmem) {
    return launch_tile<T, PJ, 2>(u, dlog, bm, cm, y, B, S, H, N, Q,
                                 smem_bytes(P, N, Q, 2), stream);
  }
  if (smem_bytes(P, N, Q, 1) <= kMaxSmem) {
    return launch_tile<T, PJ, 1>(u, dlog, bm, cm, y, B, S, H, N, Q,
                                 smem_bytes(P, N, Q, 1), stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch(const void* u, const float* dlog, const void* bm, const void* cm,
           void* y, int B, int S, int H, int P, int N, int Q,
           void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const T* ut = static_cast<const T*>(u);
  const T* bt = static_cast<const T*>(bm);
  const T* ct = static_cast<const T*>(cm);
  T* yt = static_cast<T*>(y);
  switch (P) {
    case 16:
      return launch_p<T, 1>(ut, dlog, bt, ct, yt, B, S, H, N, Q, stream);
    case 32:
      return launch_p<T, 2>(ut, dlog, bt, ct, yt, B, S, H, N, Q, stream);
    case 64:
      return launch_p<T, 4>(ut, dlog, bt, ct, yt, B, S, H, N, Q, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// u (B, S, H, P), dlog (B, S, H) f32, bm and cm (B, S, N), y like u, all
// contiguous; P one of 16, 32, 64; N at most 128; chunks of Q positions.
// dtype 0 = f32, 1 = bf16 (of u, bm, cm and y).  Returns the CUDA error of
// the launch (cudaErrorInvalidValue for a shape it does not take).
extern "C" int repro_ssd_scan(const void* u, const float* dlog,
                              const void* bm, const void* cm, void* y, int B,
                              int S, int H, int P, int N, int Q, int dtype,
                              void* stream) {
  if (N < 1 || N > kMaxN || Q < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return launch<float>(u, dlog, bm, cm, y, B, S, H, P, N, Q, stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(u, dlog, bm, cm, y, B, S, H, P, N, Q,
                                 stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
