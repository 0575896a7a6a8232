// Flash attention forward, causal or not, with grouped KV heads:
//   O[b, i, h] = sum_j softmax_j(Q[b, i, h] . K[b, j, h / G] / sqrt(hd))
//                V[b, j, h / G]
// Q (B, S, Hq, hd), K and V (B, Sk, Hkv, hd), G = Hq / Hkv, f32, bf16 or
// fp16, read through their strides (the last dim contiguous) -> O in Q's
// dtype.  The
// logits, the running max and normalizer and the output accumulator are
// f32; the probabilities are rounded to V's dtype before the product with V,
// and the normalizer sums them unrounded.  The causal mask is aligned at the
// end, as attention_ref's tril(k = Sk - S): query i sees key j <= i + Sk -
// S.  Masked logits are -1e30 (not -inf: exp of a difference of two stays
// finite).  A row that sees no key (S > Sk) keeps its running max at
// -1e30: each of its probabilities is 1, the slots past Sk too (V is zero
// there), so it divides its sum of V by Sk and is the uniform mean of V
// over the Sk keys, as attention_ref gives it.  Any hd from 1 to 256
// runs on the instantiated width HD above it (16, 32, .., 128, then 256):
// Q, K and V are zero past hd in shared memory, the scale is 1 / sqrt(hd)
// of the true hd, and only hd columns of O are stored.  A wider head (the
// reference takes any) runs on flash_wide_kernel below, in every dtype.
// KV head h / G is read in place, never repeated in memory.
//
// Replaces repro/kernels/flash/kernel.py::flash_attention_pallas (the
// online softmax of _flash_kernel).  On the port's main paths it is every
// full-sequence attention of the model (models/attention.py
// causal_attention), in bf16: paper-lm-100m training (B 8, H 12, S 128,
// hd 64), zamba2-7b's shared attention block in the serving feedback
// gradient (B 4, H 32, S 16, hd 112), deepseek-moe-16b's (B 4, H 16, S 16,
// hd 128) and gemma-2b's (hd 256, one KV head).  The wrapper
// (kernels/flash/kernel.py ``plan``) picks the kernel by dtype and head
// dim: up to hd 256 each dtype has exactly one, instantiated for every
// width it takes (bf16 and fp16 share one template), above it the wide
// kernel.
//
// bf16 and fp16: flash_wgmma_kernel (fp16 with the .f16 form of the same
// instructions; the notes below say bf16 for both).  Bound: the
// operations, 4 hd multiply-adds per kept (query, key) pair at the tensor
// cores' 989 TFLOP/s in bf16 and fp16, the type the reference multiplies
// in (dot_general on bf16 with an f32 result); at S 4096 the bytes of Q,
// K, V and O take a tenth of that time.  Design: both products on
// Hopper's warpgroup tensor-core instruction (wgmma, hopper.cuh) with f32
// accumulators in registers.  A CTA of one or two
// warpgroups owns 64 or 128 query rows (64 when S <= 64, so a short
// sequence wastes no warpgroup) of one (batch, head); each warpgroup owns 64
// rows.  Per 64-key tile: S = Q K^T as hd / 16 m64n64k16 steps with Q (A)
// and K (B) K-major in shared memory; the scale, the mask (only on tiles
// that cross the diagonal or the end of the keys) and the online softmax on
// the accumulator fragments, each row's max and sum reduced by shuffles
// over the four lanes that hold it; P rounded to bf16 in registers, which
// is exactly wgmma's A-from-registers fragment, so O += P V runs as four
// m64n{hd}k16 steps with V (B) in its natural (key, hd) layout, MN-major,
// read with the transpose bit.  At hd 256 (gemma-2b) O is held as two
// 128-wide halves, each its own m64n128k16 steps on its half of V's columns
// (128 f32 accumulator registers a thread in all; Q's 64 or 128 rows and
// two stages of K and V take 160 or 192 KB, so one CTA a SM, of two
// warpgroups).  Shared tiles use the 32-byte swizzle:
// 16-element atoms, so every hd that is a multiple of 16 (112 = 7 x 16)
// fits with no padding.  Copies: Q once, K and V through a two-stage ring
// filled by 16-byte cp.async with zero fill past the sequence, the next tile
// in flight while this one computes.  cp.async and not TMA: Q, K, V are
// strided (B, S, H, hd) views with any batch, sequence and head stride, which
// a per-thread 16-byte copy reads in place with no tensor map per call; the
// wrapper raises unless base and strides are 16-byte aligned.  Causal query
// tiles run longest first (grid y counts down from the last tile; x is
// batch x head), so the short tiles fill the card's tail.  Key tiles wholly
// above a warpgroup's rows are skipped.
//
// f32: flash_simt_kernel.  Bound: the operations in f32 FFMA at 67 TFLOP/s;
// TF32 tensor cores would miss the reference's f32 tolerance (2e-5).
// Design: one block of 256 threads per (batch, query head, 64-row query
// tile), looping over 64-key tiles with Q, K and V staged in dynamic shared
// memory (at hd 112 the three tiles take 86 KB).  Thread (ty, tx) of the
// 16 x 16 grid owns query rows 4 ty .. 4 ty + 3: its 4 x 4 logits at key
// columns tx + 16 j, the rows' running max and normalizer (reduced across
// the 16 threads of a row by warp shuffles) and the output columns
// tx + 16 j of those rows.  Key tiles wholly above the diagonal are skipped.
// No main path runs attention in f32.  At hd 256 its tiles take 214 KB.
//
// hd > 256, any dtype: flash_wide_kernel.  No config of the repo has such a
// head; the kernel is the SIMT kernel's arithmetic in a form whose shared
// memory does not grow with hd, right first and not fast (its bound is the
// f32 FFMA rate; PERF.md has its time).  A block owns 64 query rows and 128
// columns of O (ceil(hd / 128) blocks a query tile, each recomputing Q K^T
// over the whole hd): per 64-key tile it sums Q K^T over 64-deep chunks of
// Q and K staged in shared memory, then runs the online softmax and adds P
// V for its 128 columns of V.  82 KB of shared memory whatever hd.  P is
// rounded to V's dtype before its product, the normalizer sums it
// unrounded, as in the other kernels.
#include "tile.cuh"
#include "hopper.cuh"

namespace {

using repro::kThreads;
using repro::kTile;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;  // elements; the head dim is contiguous
};

// What a row of the query tile sees under the causal mask: key j for
// j <= row + off (off = Sk - S).  The key tiles a tile of rows q0 .. q0 +
// rows - 1 reads: up to the last row's last key, or all of them when its
// first row sees none (a row that sees no key is the uniform mean of V over
// all Sk keys).
__device__ __forceinline__ int causal_tiles(int tiles, int q0, int rows,
                                            int off) {
  if (q0 + off < 0) return tiles;
  return min(tiles, (q0 + rows - 1 + off) / 64 + 1);
}

// ---- f32: SIMT FFMA -------------------------------------------------------

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

constexpr size_t simt_smem_bytes(int hd) {
  // Q and K tiles [64][hd + 1], V tile [64][hd], P tile [64][65]
  return sizeof(float) *
         (2 * kTile * (hd + 1) + kTile * hd + kTile * (kTile + 1));
}

// Grid (ceil(S / 64), Hq, B); head dim 16 NJ.
template <int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_simt_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      Strides sq, Strides sk, Strides sv, Strides so, int S,
                      int Sk, int hd, int group, int causal, float scale) {
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
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;

  for (int e = tid; e < kTile * HD; e += kThreads) {
    const int r = e / HD, c = e % HD, row = q0 + r;
    sq_[r * QS + c] = row < S && c < hd ? qb[row * sq.s + c] : 0.f;
  }
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }
  const int off = Sk - S;
  int tiles = (Sk + kTile - 1) / kTile;
  if (causal) tiles = causal_tiles(tiles, q0, kTile, off);

  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's readers of K, V and P are done
    for (int e = tid; e < kTile * HD; e += kThreads) {
      const int r = e / HD, c = e % HD, col = k0 + r;
      const bool in = col < Sk && c < hd;
      sk_[r * QS + c] = in ? kb[col * sk.s + c] : 0.f;
      sv_[r * HD + c] = in ? vb[col * sv.s + c] : 0.f;
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
        if (col >= Sk || (causal && col > row + off)) x = kNegInf;
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
        sp_[(4 * ty + i) * PS + tx + 16 * j] = p;
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

  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const float inv = 1.f / (m[i] == kNegInf ? static_cast<float>(Sk)
                             : l[i] == 0.f    ? 1.f
                                              : l[i]);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      if (tx + 16 * jj < hd) ob[row * so.s + tx + 16 * jj] = acc[i][jj] * inv;
    }
  }
}

template <int NJ>
int launch_simt(const float* q, const float* k, const float* v, float* o,
                Strides sq, Strides sk, Strides sv, Strides so, int B,
                int Hq, int Hkv, int S, int Sk, int hd, int causal,
                cudaStream_t stream) {
  const size_t smem = simt_smem_bytes(16 * NJ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_simt_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kTile - 1) / kTile, Hq, B);
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  flash_simt_kernel<NJ><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, sq, sk, sv, so, S, Sk, hd, Hq / Hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 and fp16: wgmma tensor cores ------------------------------------

using bf16 = __nv_bfloat16;
using f16 = __half;
constexpr int kKeys = 64;  // keys per K/V tile

// Q (64 WG rows) + two stages of K and V (64 keys each), bf16, and 256
// bytes to align the base to a swizzle atom.  kernels/flash/kernel.py
// ``plan`` computes the same number.
constexpr size_t wgmma_smem_bytes(int hd, int wg) {
  return 2 * (64 * wg * hd + 4 * kKeys * hd) + 256;
}

__device__ __forceinline__ unsigned short bits16(bf16 x) {
  return __bfloat16_as_ushort(x);
}
__device__ __forceinline__ unsigned short bits16(f16 x) {
  return __half_as_ushort(x);
}

__device__ __forceinline__ void st_shared_b16(uint32_t addr,
                                              unsigned short x) {
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(addr), "h"(x) : "memory");
}

// The element-by-element staging of ``load_tile``, out of line: the
// model's tensors never take it, and inlined its loop took registers of
// the kernel's main loop.
template <typename T, int ROWS, int HD, int NT>
__device__ __noinline__ void load_tile_by_element(
    uint32_t dst, const T* __restrict__ src, long long stride, int row0,
    int limit, int hd) {
  for (int e = threadIdx.x; e < ROWS * HD; e += NT) {
    const int r = e / HD, c = e % HD, row = row0 + r;
    st_shared_b16(dst + repro::swz32_offset(ROWS, r, c),
                  row < limit && c < hd ? bits16(src[row * stride + c]) : 0);
  }
}

// Stage rows row0 .. row0 + ROWS - 1 (zero past ``limit``) and columns 0 ..
// hd - 1 (zero up to HD) of a strided (row, hd) bf16 matrix into the
// swizzled tile at ``dst``.  ``chunked`` (hd a multiple of 8, base and
// strides 16-byte aligned): one 16-byte cp.async per 8 columns,
// consecutive threads on consecutive chunks of a row.  Otherwise one
// element a thread through registers (rows that are no 16-byte multiple).
template <typename T, int ROWS, int HD, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const T* __restrict__ src,
                                          long long stride, int row0,
                                          int limit, int hd, bool chunked) {
  if (!chunked) {
    load_tile_by_element<T, ROWS, HD, NT>(dst, src, stride, row0, limit, hd);
    return;
  }
  constexpr int CH = HD / 8;
  for (int c = threadIdx.x; c < ROWS * CH; c += NT) {
    const int r = c / CH, cc = c % CH, row = row0 + r;
    const bool in = row < limit && cc * 8 < hd;
    repro::cp_async16(dst + repro::swz32_offset(ROWS, r, cc * 8),
                      in ? src + row * stride + cc * 8 : src, in ? 16 : 0);
  }
}

// Grid (B * Hq, ceil(S / (64 WG))); 128 WG threads; head dim 16 NJ; T
// bf16 or fp16.
template <typename T, int NJ, int WG>
__global__ void __launch_bounds__(128 * WG)
    flash_wgmma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       Strides sq, Strides sk, Strides sv, Strides so, int S,
                       int Sk, int hd, int Hq, int group, int causal,
                       int chunked, float scale) {
  constexpr int HD = 16 * NJ, BM = 64 * WG, NT = 128 * WG;
  constexpr uint32_t kQBytes = BM * HD * 2, kKVBytes = kKeys * HD * 2;
  extern __shared__ unsigned char tiles_smem[];
  const uint32_t sq_ = (repro::smem_addr(tiles_smem) + 255u) & ~255u;
  const uint32_t sk_ = sq_ + kQBytes;        // [2 stages]
  const uint32_t sv_ = sk_ + 2 * kKVBytes;   // [2 stages]

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq, kvh = h / group;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BM, w0 = q0 + 64 * wg;  // this warpgroup's first row
  const int row_a = w0 + 16 * warp + lane / 4, row_b = row_a + 8;
  const int col_t = 2 * (lane % 4);
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;
  const float scale2 = scale * kLog2e;       // logits in log2 units

  const int off = Sk - S;
  const bool cq = chunked & 1, ck = chunked & 2, cv = chunked & 4;
  int tiles = (Sk + kKeys - 1) / kKeys;
  if (causal) tiles = causal_tiles(tiles, q0, BM, off);

  load_tile<T, BM, HD, NT>(sq_, qb, sq.s, q0, S, hd, cq);
  load_tile<T, kKeys, HD, NT>(sk_, kb, sk.s, 0, Sk, hd, ck);
  load_tile<T, kKeys, HD, NT>(sv_, vb, sv.s, 0, Sk, hd, cv);
  repro::cp_async_commit();

  // O in NH column halves of HW (one when hd <= 128)
  constexpr int NH = HD > 128 ? 2 : 1, HW = HD / NH;
  float acc[NH][HW / 2];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
#pragma unroll
    for (int i = 0; i < HW / 2; ++i) acc[hh][i] = 0.f;
  }
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  for (int t = 0; t < tiles; ++t) {
    const int st = t & 1, k0 = t * kKeys;
    if (t + 1 < tiles) {  // the next tile into the other stage
      load_tile<T, kKeys, HD, NT>(sk_ + (st ^ 1) * kKVBytes, kb, sk.s,
                                  k0 + kKeys, Sk, hd, ck);
      load_tile<T, kKeys, HD, NT>(sv_ + (st ^ 1) * kKVBytes, vb, sv.s,
                                  k0 + kKeys, Sk, hd, cv);
    }
    repro::cp_async_commit();
    repro::cp_async_wait<1>();  // this tile (and Q) have landed
    repro::fence_proxy_async();
    __syncthreads();

    // uniform over the warpgroup: a key tile it sees, or every tile when
    // its first row sees no key
    if (!causal || w0 + off < 0 || k0 <= w0 + 63 + off) {
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      repro::wgmma_fence();
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        repro::wgmma_ss_n64<T>(
            s, repro::smem_desc(sq_ + 64 * wg * 32 + j * BM * 32, 0, 256),
            repro::smem_desc(sk_ + st * kKVBytes + j * kKeys * 32, 0, 256));
      }
      repro::wgmma_commit();
      repro::wgmma_wait_all();
      repro::fence_regs(s);

      // scale and mask; s[4i + e]: row e < 2 ? row_a : row_b, column
      // k0 + 8 i + col_t + (e & 1)
      const bool edge =
          k0 + kKeys > Sk || (causal && k0 + kKeys - 1 > w0 + off);
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = s[i] * scale2;
        if (edge) {
          const int col = k0 + 8 * (i / 4) + col_t + (i & 1);
          const int row = (i & 2) ? row_b : row_a;
          if (col >= Sk || (causal && col > row + off)) x = kNegInf;
        }
        s[i] = x;
        if (i & 2) {
          mx_b = fmaxf(mx_b, x);
        } else {
          mx_a = fmaxf(mx_a, x);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the row's four lanes
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float alpha_a = exp2f(m_a - mn_a), alpha_b = exp2f(m_b - mn_b);
      float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float p = exp2f(s[i] - ((i & 2) ? mn_b : mn_a));
        s[i] = p;
        if (i & 2) {
          ps_b += p;
        } else {
          ps_a += p;
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        ps_a += __shfl_xor_sync(0xffffffffu, ps_a, off);
        ps_b += __shfl_xor_sync(0xffffffffu, ps_b, off);
      }
      l_a = alpha_a * l_a + ps_a;
      l_b = alpha_b * l_b + ps_b;
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) {
#pragma unroll
        for (int i = 0; i < HW / 2; ++i) {
          acc[hh][i] *= (i & 2) ? alpha_b : alpha_a;
        }
      }

      // P in T as wgmma's A fragments: k16 slice j is S's column blocks
      // 2j and 2j + 1
      uint32_t pa[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          pa[j][x] = repro::pack2<T>(s[8 * j + 2 * x], s[8 * j + 2 * x + 1]);
        }
      }
      repro::wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int hh = 0; hh < NH; ++hh) {  // V's columns hh HW .. + HW - 1
          repro::wgmma_rs<HW, T>(
              acc[hh], pa[j],
              repro::smem_desc(sv_ + st * kKVBytes + hh * HW * kKeys * 2 +
                                   j * 512,
                               kKeys * 32, 256));
        }
      }
      repro::wgmma_commit();
      repro::wgmma_wait_all();
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) repro::fence_regs(acc[hh]);
    }
    __syncthreads();  // every reader of this stage is done before refill
  }

  T* ob = o + b * so.b + h * so.h;
  // a row that saw no key: the sum of V over the Sk keys, over Sk
  const float inv_a = 1.f / (m_a == kNegInf ? static_cast<float>(Sk)
                             : l_a == 0.f   ? 1.f
                                            : l_a);
  const float inv_b = 1.f / (m_b == kNegInf ? static_cast<float>(Sk)
                             : l_b == 0.f   ? 1.f
                                            : l_b);
  // an even hd: column pairs as 4-byte stores (O is contiguous, so every
  // pair is aligned); an odd hd: one element at a time
  const bool pairs = (hd & 1) == 0;
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
#pragma unroll
    for (int i = 0; i < HW / 8; ++i) {
      const int col = hh * HW + 8 * i + col_t;
      const float* a = acc[hh] + 4 * i;
      if (col >= hd) continue;
      if (pairs) {
        if (row_a < S) {
          *reinterpret_cast<uint32_t*>(ob + row_a * so.s + col) =
              repro::pack2<T>(a[0] * inv_a, a[1] * inv_a);
        }
        if (row_b < S) {
          *reinterpret_cast<uint32_t*>(ob + row_b * so.s + col) =
              repro::pack2<T>(a[2] * inv_b, a[3] * inv_b);
        }
        continue;
      }
      const bool two = col + 1 < hd;
      if (row_a < S) {
        ob[row_a * so.s + col] = repro::from_f32<T>(a[0] * inv_a);
        if (two) ob[row_a * so.s + col + 1] = repro::from_f32<T>(a[1] * inv_a);
      }
      if (row_b < S) {
        ob[row_b * so.s + col] = repro::from_f32<T>(a[2] * inv_b);
        if (two) ob[row_b * so.s + col + 1] = repro::from_f32<T>(a[3] * inv_b);
      }
    }
  }
}

template <typename T, int NJ, int WG>
int launch_wgmma(const T* q, const T* k, const T* v, T* o, Strides sq,
                 Strides sk, Strides sv, Strides so, int B, int Hq, int Hkv,
                 int S, int Sk, int hd, int causal, int chunked,
                 cudaStream_t stream) {
  const size_t smem = wgmma_smem_bytes(16 * NJ, WG);
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<T, NJ, WG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * Hq, (S + 64 * WG - 1) / (64 * WG));
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  flash_wgmma_kernel<T, NJ, WG><<<grid, 128 * WG, smem, stream>>>(
      q, k, v, o, sq, sk, sv, so, S, Sk, hd, Hq, Hq / Hkv, causal, chunked,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NJ>
int launch_16bit(const void* q, const void* k, const void* v, void* o,
                 Strides sq, Strides sk, Strides sv, Strides so, int B,
                 int Hq, int Hkv, int S, int Sk, int hd, int causal,
                 int block_m, int chunked, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  if (block_m == 64) {
    return launch_wgmma<T, NJ, 1>(qt, kt, vt, ot, sq, sk, sv, so, B, Hq, Hkv,
                                  S, Sk, hd, causal, chunked, stream);
  }
  return launch_wgmma<T, NJ, 2>(qt, kt, vt, ot, sq, sk, sv, so, B, Hq, Hkv, S,
                                Sk, hd, causal, chunked, stream);
}

template <int NJ>
int launch_hd(const void* q, const void* k, const void* v, void* o,
              Strides sq, Strides sk, Strides sv, Strides so, int B, int Hq,
              int Hkv, int S, int Sk, int hd, int causal, int dtype,
              int block_m, int chunked, cudaStream_t stream) {
  if (dtype == 0) {
    return launch_simt<NJ>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), sq, sk, sv, so,
        B, Hq, Hkv, S, Sk, hd, causal, stream);
  }
  if (dtype == 1) {
    return launch_16bit<bf16, NJ>(q, k, v, o, sq, sk, sv, so, B, Hq, Hkv, S,
                                  Sk, hd, causal, block_m, chunked, stream);
  }
  return launch_16bit<f16, NJ>(q, k, v, o, sq, sk, sv, so, B, Hq, Hkv, S, Sk,
                               hd, causal, block_m, chunked, stream);
}

// ---- hd > 256, any dtype: SIMT, Q K^T over depth chunks -------------------

constexpr int kDepth = 64;     // columns of Q and K a chunk of Q K^T stages
constexpr int kOutCols = 128;  // columns of O a block owns

constexpr size_t wide_smem_bytes() {
  // Q and K depth chunks and P [64][65], V's column slice [64][128]
  return sizeof(float) * (3 * kTile * (kDepth + 1) + kTile * kOutCols);
}

// Grid (ceil(S / 64) * slices, Hq, B), slices = ceil(hd / 128); block x
// owns query tile x / slices and columns 128 (x % slices) .. + 127 of O.
// The thread map of flash_simt_kernel: thread (ty, tx) of the 16 x 16 grid
// holds query rows 4 ty .. 4 ty + 3, their logits at key columns tx + 16 j
// and their outputs at columns tx + 16 jj of the block's slice.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, Strides sq,
                      Strides sk, Strides sv, Strides so, int S, int Sk,
                      int hd, int group, int causal, float scale,
                      int slices) {
  constexpr int DS = kDepth + 1, PS = kTile + 1, NJ = kOutCols / 16;
  extern __shared__ float smem[];
  float* sq_ = smem;               // [64][DS]
  float* sk_ = sq_ + kTile * DS;   // [64][DS]
  float* sp_ = sk_ + kTile * DS;   // [64][PS]
  float* sv_ = sp_ + kTile * PS;   // [64][kOutCols]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = static_cast<int>(blockIdx.x / slices) * kTile;
  const int c0 = static_cast<int>(blockIdx.x % slices) * kOutCols;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }
  const int off = Sk - S;
  int tiles = (Sk + kTile - 1) / kTile;
  if (causal) tiles = causal_tiles(tiles, q0, kTile, off);

  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kTile;
    float s[4][4] = {};
    for (int d0 = 0; d0 < hd; d0 += kDepth) {
      __syncthreads();  // the last chunk's (and tile's) readers are done
      for (int e = tid; e < kTile * kDepth; e += kThreads) {
        const int r = e / kDepth, c = e % kDepth, dc = d0 + c;
        sq_[r * DS + c] = q0 + r < S && dc < hd
                              ? repro::to_f32(qb[(q0 + r) * sq.s + dc])
                              : 0.f;
        sk_[r * DS + c] = k0 + r < Sk && dc < hd
                              ? repro::to_f32(kb[(k0 + r) * sk.s + dc])
                              : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int dd = 0; dd < kDepth; ++dd) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = sq_[(4 * ty + i) * DS + dd];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = sk_[(tx + 16 * j) * DS + dd];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }
      }
    }

    // online softmax over this tile, row by row; P rounded to T for its
    // product with V, the normalizer summed unrounded
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (col >= Sk || (causal && col > row + off)) x = kNegInf;
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
        sp_[(4 * ty + i) * PS + tx + 16 * j] =
            repro::to_f32(repro::from_f32<T>(p));
      }
      l[i] = alpha * l[i] + row_sum(ps);
      m[i] = mn;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
    }
    for (int e = tid; e < kTile * kOutCols; e += kThreads) {
      const int r = e / kOutCols, c = e % kOutCols, col = c0 + c;
      sv_[r * kOutCols + c] = k0 + r < Sk && col < hd
                                  ? repro::to_f32(vb[(k0 + r) * sv.s + col])
                                  : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sp_[(4 * ty + i) * PS + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float vv = sv_[c * kOutCols + tx + 16 * jj];
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
    const float inv = 1.f / (m[i] == kNegInf ? static_cast<float>(Sk)
                             : l[i] == 0.f    ? 1.f
                                              : l[i]);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int col = c0 + tx + 16 * jj;
      if (col < hd) {
        ob[row * so.s + col] = repro::from_f32<T>(acc[i][jj] * inv);
      }
    }
  }
}

template <typename T>
int launch_wide(const void* q, const void* k, const void* v, void* o,
                Strides sq, Strides sk, Strides sv, Strides so, int B, int Hq,
                int Hkv, int S, int Sk, int hd, int causal,
                cudaStream_t stream) {
  const size_t smem = wide_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slices = (hd + kOutCols - 1) / kOutCols;
  const long long x = static_cast<long long>((S + kTile - 1) / kTile) * slices;
  if (x > 0x7fffffffLL || Hq > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(x), Hq, B);
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  flash_wide_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, sv, so, S, Sk, hd,
      Hq / Hkv, causal, scale, slices);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, S, Hq, hd), k and v (B, Sk, Hkv, hd), o like q (contiguous), each
// given by its batch, sequence and head strides in elements.  dtype 0 =
// f32, 1 = bf16, 2 = fp16.  hd from 1 to 256 runs on the width above it
// (16, 32, .., 128, 256): f32 on the SIMT kernel, bf16 and fp16 on the
// wgmma kernel (block_m query rows per CTA: 64 or 128; chunked: bit 0, 1,
// 2 for q, k, v copied in 16-byte chunks, which needs hd a multiple of 8
// and base and strides 16-byte aligned).  A wider hd runs on the wide
// kernel in every dtype (block_m and chunked unread).  Returns the CUDA
// error of the launch.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh, int B, int Hq, int Hkv,
    int S, int Sk, int hd, int causal, int dtype, int block_m, int chunked,
    void* stream) {
  if (hd < 1 || Hkv <= 0 || Hq % Hkv != 0 || dtype < 0 || dtype > 2 ||
      (dtype != 0 && hd <= 256 && block_m != 64 && block_m != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides sq{qsb, qss, qsh}, sk{ksb, kss, ksh}, sv{vsb, vss, vsh},
      so{osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd > 256) {
    if (dtype == 0) {
      return launch_wide<float>(q, k, v, o, sq, sk, sv, so, B, Hq, Hkv, S, Sk,
                                hd, causal, s);
    }
    if (dtype == 1) {
      return launch_wide<bf16>(q, k, v, o, sq, sk, sv, so, B, Hq, Hkv, S, Sk,
                               hd, causal, s);
    }
    return launch_wide<f16>(q, k, v, o, sq, sk, sv, so, B, Hq, Hkv, S, Sk, hd,
                            causal, s);
  }
#define REPRO_FLASH_HD(NJ)                                                  \
  case NJ:                                                                  \
    return launch_hd<NJ>(q, k, v, o, sq, sk, sv, so, B, Hq, Hkv, S, Sk, hd, \
                         causal, dtype, block_m, chunked, s);
  // the instantiated width: hd up to 128 rounded up to 16, else 256
  switch (hd > 128 ? 16 : (hd + 15) / 16) {
    REPRO_FLASH_HD(1)
    REPRO_FLASH_HD(2)
    REPRO_FLASH_HD(3)
    REPRO_FLASH_HD(4)
    REPRO_FLASH_HD(5)
    REPRO_FLASH_HD(6)
    REPRO_FLASH_HD(7)
    REPRO_FLASH_HD(8)
    REPRO_FLASH_HD(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_HD
}
