// Flash attention forward, causal or not, with grouped KV heads:
//   O[b, i, h] = sum_j softmax_j(Q[b, i, h] . K[b, j, h / G] / sqrt(hd))
//                V[b, j, h / G]
// Q (B, S, Hq, hd), K and V (B, Sk, Hkv, hd), G = Hq / Hkv, f32 or bf16, read
// through their strides (the last dim contiguous) -> O in Q's dtype.  The
// logits, the running max and normalizer and the output accumulator are
// f32; the probabilities are rounded to V's dtype before the product with V.
//
// Replaces repro/kernels/flash/kernel.py::flash_attention_pallas (the
// online softmax of _flash_kernel).  On the port's main paths it is every
// full-sequence attention of the model (models/attention.py
// causal_attention): paper-lm-100m training (B 8, H 12, S 128, hd 64) and
// zamba2-7b's shared attention block in the serving feedback gradient (B 4,
// H 32, S 16, hd 112).
//
// What bounds it: the operations.  Each kept (query, key) pair costs 2 hd
// multiply-adds (Q K^T and P V), in f32 FFMA at 67 TFLOP/s; at S = 4096 the
// bytes of Q, K, V and O are 100x fewer than the card could move in that
// time.  FFMA, not TF32 tensor cores: TF32 misses the f32 tolerance of the
// reference's test (2e-5).
//
// Design: one block of 256 threads per (batch, query head, 64-row query
// tile), looping over 64-key tiles with Q, K and V staged in dynamic shared
// memory as f32 (at hd 112 the three tiles take 86 KB, over the 48 KB of
// static shared memory).  Thread (ty, tx) of the 16 x 16 grid owns query
// rows 4 ty .. 4 ty + 3: its 4 x 4 logits at key columns tx + 16 j, the
// rows' running max and normalizer (reduced across the 16 threads of a row
// by warp shuffles) and the output columns tx + 16 j of those rows.  Key
// tiles wholly above the diagonal are skipped; masked logits are -1e30 (not
// -inf: exp of a difference of two stays finite).  KV head h / G is read in
// place, never repeated in memory.
#include "tile.cuh"

namespace {

using repro::kThreads;
using repro::kTile;

constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, s, h;  // elements; the head dim is contiguous
};

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return repro::to_f32(repro::from_f32<T>(x));
}

__device__ __forceinline__ float row_max(float x) {  // over 16 lanes of tx
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

constexpr size_t smem_bytes(int hd) {
  // Q and K tiles [64][hd + 1], V tile [64][hd], P tile [64][65]
  return sizeof(float) *
         (2 * kTile * (hd + 1) + kTile * hd + kTile * (kTile + 1));
}

// Grid (ceil(S / 64), Hq, B); head dim 16 NJ.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, Strides sq,
                     Strides sk, Strides sv, Strides so, int S, int Sk,
                     int group, int causal, float scale) {
  constexpr int HD = 16 * NJ;
  constexpr int QS = HD + 1;       // padded rows: column reads hit 16 banks
  constexpr int PS = kTile + 1;
  extern __shared__ float smem[];
  float* sq_ = smem;               // [64][QS]
  float* sk_ = sq_ + kTile * QS;   // [64][QS]
  float* sv_ = sk_ + kTile * QS;   // [64][HD]
  float* sp_ = sv_ + kTile * HD;   // [64][PS]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  for (int e = tid; e < kTile * HD; e += kThreads) {
    const int r = e / HD, c = e % HD, row = q0 + r;
    sq_[r * QS + c] = row < S ? repro::to_f32(qb[row * sq.s + c]) : 0.f;
  }
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }
  int tiles = (Sk + kTile - 1) / kTile;
  if (causal) tiles = min(tiles, (q0 + kTile - 1) / kTile + 1);

  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's readers of K, V and P are done
    for (int e = tid; e < kTile * HD; e += kThreads) {
      const int r = e / HD, c = e % HD, col = k0 + r;
      const bool in = col < Sk;
      sk_[r * QS + c] = in ? repro::to_f32(kb[col * sk.s + c]) : 0.f;
      sv_[r * HD + c] = in ? repro::to_f32(vb[col * sv.s + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sq_[(4 * ty + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sk_[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

    // online softmax over this tile, row by row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (col >= Sk || (causal && row < col)) x = kNegInf;
        s[i][j] = x;
        mc = fmaxf(mc, x);
      }
      const float mn = fmaxf(m[i], row_max(mc));
      const float alpha = expf(m[i] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        ps += p;
        sp_[(4 * ty + i) * PS + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = alpha * l[i] + row_sum(ps);
      m[i] = mn;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sp_[(4 * ty + i) * PS + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float vv = sv_[c * HD + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      ob[row * so.s + tx + 16 * jj] = repro::from_f32<T>(acc[i][jj] * inv);
    }
  }
}

template <typename T, int NJ>
int launch_hd(const T* q, const T* k, const T* v, T* o, Strides sq,
              Strides sk, Strides sv, Strides so, int B, int Hq, int Hkv,
              int S, int Sk, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes(16 * NJ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kTile - 1) / kTile, Hq, B);
  const float scale = 1.f / sqrtf(static_cast<float>(16 * NJ));
  flash_fwd_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, sq, sk, sv, so, S, Sk, Hq / Hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, Strides sq,
           Strides sk, Strides sv, Strides so, int B, int Hq, int Hkv, int S,
           int Sk, int hd, int causal, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
#define REPRO_FLASH_HD(NJ)                                                  \
  case NJ:                                                                  \
    return launch_hd<T, NJ>(qt, kt, vt, ot, sq, sk, sv, so, B, Hq, Hkv, S, \
                            Sk, causal, stream);
  switch (hd / 16) {
    REPRO_FLASH_HD(1)
    REPRO_FLASH_HD(2)
    REPRO_FLASH_HD(3)
    REPRO_FLASH_HD(4)
    REPRO_FLASH_HD(5)
    REPRO_FLASH_HD(6)
    REPRO_FLASH_HD(7)
    REPRO_FLASH_HD(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_HD
}

}  // namespace

// q (B, S, Hq, hd), k and v (B, Sk, Hkv, hd), o like q, each given by its
// batch, sequence and head strides in elements.  hd a multiple of 16 up to
// 128; dtype 0 = f32, 1 = bf16.  Returns the CUDA error of the launch.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh, int B, int Hq, int Hkv,
    int S, int Sk, int hd, int causal, int dtype, void* stream) {
  if (hd % 16 != 0 || hd < 16 || hd > 128 || Hkv <= 0 || Hq % Hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides sq{qsb, qss, qsh}, sk{ksb, kss, ksh}, sv{vsb, vss, vsh},
      so{osb, oss, osh};
  if (dtype == 0) {
    return launch<float>(q, k, v, o, sq, sk, sv, so, B, Hq, Hkv, S, Sk, hd,
                         causal, stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, o, sq, sk, sv, so, B, Hq, Hkv, S,
                                 Sk, hd, causal, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
