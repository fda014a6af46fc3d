// K3, flash attention (forward) for Hopper: online-softmax attention with
// causal and sliding-window masks and grouped-query heads.
//
// Replaces repro/kernels/flash_attention.py::flash_attention, the Pallas TPU
// kernel (body _fa_kernel), which the LM prefill reaches through
// models/attention.py with impl="pallas".
//
// What it computes.  q (B, H, Sq, D); k, v (B, Hkv, Skv, D); out (B, H, Sq, D)
// in q's dtype.  Query head h reads KV head h / (H / Hkv) by index; the
// expansion is never materialised.  Query rows sit at the end of the kv
// axis (row i has position i + Skv - Sq).  Scores are the f32 dot of the
// upcast rows, times the scale (applied after the dot, as the TPU kernel
// does); key k is visible to query q when k < Skv, and k <= q if causal, and
// k > q - window if a window is given.  The running max, the denominator,
// the accumulator and P are f32; the result is acc / l with l == 0 → 1.
//
// Tiles and the sentinel: the TPU kernel's semantics with bq = bkv = 64
// (its default is 128 x 128).  Query tiles of min(64, Sq) rows and kv tiles
// of min(64, Skv) keys; a kv tile runs for a
// query tile unless the whole tile pair is unreachable (causal: the tile's
// first key is past its last query; window: its last key is at or before
// the first query minus the window).  Inside a tile that runs, a masked
// score is the finite -1e30, never -inf, so a query row that sees no key in
// any tile that ran ends as the mean of V over those tiles (zero rows of
// the kv tail padding included), as the TPU kernel ends at 64 x 64; a row
// whose every tile is skipped ends as zeros.  No caller of the system
// reaches such a row (prefill has Sq == Skv).
//
// What bounds it.  At the LM main path (tinyllama prefill, B 4, H 32, Hkv 4,
// S 2048, D 64, causal) one launch does 4·B·H·D·S(S+1)/2 ≈ 6.9e10 flops and
// ≈ 2.7e8 exponentials on ≈ 75 MB of q, k, v and out: bound by operations
// (tensor-core bf16 rate and the SFU's exp rate are of the same order,
// ~0.07 ms each), far above memory.
//
// What the design does about it (a right and simple first kernel).  One CTA
// of 256 threads per (batch·head, 64-row query tile) walks the kv tiles in a
// loop inside the block — the TPU grid's sequential third axis — skipping
// the unreachable ones, so a causal prefill does about half the rectangle.
// Q^T, K^T, V and P^T tiles live in shared memory as f32; each thread owns a
// 4x4 block of the 64x64 score tile (four rows, four adjacent keys) and a
// 4 x D/16 block of the accumulator, so each shared-memory value it reads
// feeds four FMAs.  Rows are reduced across the 16 threads that share them
// with warp shuffles; m, l and the accumulator stay in registers.  Query
// tiles are issued heaviest first (last tile first) to even out the causal
// triangle across the card.  Everything runs as f32 FMA on the CUDA cores:
// the bf16 tensor cores (mma.sync / wgmma on bf16 Q K^T, bf16 P), TMA
// staging and warp specialisation are later work.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() after the launch (or -1 for a dtype or head dim it does
// not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BKV = 64;       // keys per kv tile
constexpr int THREADS = 256;  // 16 x 16 threads: ty owns 4 rows, tx 4 keys
constexpr int PAD = 4;        // row padding of the transposed tiles (floats)
constexpr int QS = BQ + PAD;  // stride of Q^T and P^T rows
constexpr int KS = BKV + PAD; // stride of K^T rows
constexpr float NEG = -1e30f; // the TPU kernel's mask sentinel

enum DType { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

template <int HD>
constexpr int smem_floats() {
  return HD * QS + HD * KS + BKV * HD + BKV * QS;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_attention_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                           const T* __restrict__ V, T* __restrict__ O, int BH,
                           int H, int Hkv, int sq, int skv, int nq,
                           int causal, int has_window, int window,
                           float scale) {
  constexpr int DJ = HD / 16;  // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;               // [HD][QS]  Q^T
  float* kt = qt + HD * QS;       // [HD][KS]  K^T
  float* vs = kt + HD * KS;       // [BKV][HD] V
  float* pt = vs + BKV * HD;      // [BKV][QS] P^T

  // heaviest query tiles first: all (b, h) of the last tile, then the one
  // before it, ...
  const int bh = blockIdx.x % BH;
  const int qi = nq - 1 - blockIdx.x / BH;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / Hkv);
  const T* q = Q + ((size_t)bh * sq + (size_t)qi * BQ) * HD;
  const T* k = K + (size_t)(b * Hkv + kvh) * skv * HD;
  const T* v = V + (size_t)(b * Hkv + kvh) * skv * HD;
  T* o = O + ((size_t)bh * sq + (size_t)qi * BQ) * HD;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int rows = min(BQ, sq - qi * BQ);      // real rows of this tile
  const int bkv = min(BKV, skv);               // the kv block
  const int skv_p = (skv + bkv - 1) / bkv * bkv;  // its padded kv length
  const int q_start = qi * BQ + (skv - sq);    // position of the tile's row 0
  const int q_last = q_start + min(BQ, sq) - 1;
  const int nkv = skv_p / bkv;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    qt[d * QS + r] = r < rows ? to_f32(q[(size_t)r * HD + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int j = 0; j < nkv; ++j) {
    const int k_start = j * bkv;
    if (causal && k_start > q_last) continue;
    if (has_window && k_start + bkv - 1 <= q_start - window) continue;

    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BKV * HD; i += THREADS) {
      const int c = i / HD, d = i % HD;
      const bool in = k_start + c < skv;
      const size_t off = (size_t)(k_start + c) * HD + d;
      kt[d * KS + c] = in ? to_f32(k[off]) : 0.f;
      vs[c * HD + d] = in ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[d * QS + ty * 4]);
      const float4 bb = *reinterpret_cast<const float4*>(&kt[d * KS + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(av[i], bv[c], s[i][c]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_start + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k_start + tx * 4 + c;
        float x = s[i][c] * scale;
        if (kpos >= skv_p) {
          x = -INFINITY;  // past the TPU kernel's padded block: not a key
        } else {
          bool ok = kpos < skv;
          if (causal) ok = ok && kpos <= qpos;
          if (has_window) ok = ok && kpos > qpos - window;
          if (!ok) x = NEG;
        }
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_cur = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_cur);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[i][c] = expf(s[i][c] - m_cur);
        sum += p[i][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_cur;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(&pt[(tx * 4 + c) * QS + ty * 4]) =
          make_float4(p[0][c], p[1][c], p[2][c], p[3][c]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&pt[c * QS + ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const float vv = vs[c * HD + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(av[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];  // every tile skipped → zeros
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      o[(size_t)r * HD + tx + 16 * jj] = from_f32<T>(acc[i][jj] / li);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int sq, int skv, int causal, int has_window, int window,
           float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, HD>;
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nq = (sq + BQ - 1) / BQ;
  const int bh = B * H;
  kernel<<<dim3((unsigned)(bh * nq)), dim3(THREADS), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), bh, H, Hkv, sq, skv, nq,
      causal, has_window, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int head_dim, const void* q, const void* k, const void* v,
              void* o, int B, int H, int Hkv, int sq, int skv, int causal,
              int has_window, int window, float scale, cudaStream_t s) {
#define FA_CASE(HD)                                                         \
  case HD:                                                                  \
    return launch<T, HD>(q, k, v, o, B, H, Hkv, sq, skv, causal, has_window, \
                         window, scale, s);
  switch (head_dim) {
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(80)
    FA_CASE(128)
    default:
      return -1;
  }
#undef FA_CASE
}

}  // namespace

extern "C" int simd2_flash_attention(int dtype, int head_dim, const void* q,
                                     const void* k, const void* v, void* o,
                                     int B, int H, int Hkv, int sq, int skv,
                                     int causal, int has_window, int window,
                                     float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    return launch_hd<float>(head_dim, q, k, v, o, B, H, Hkv, sq, skv, causal,
                            has_window, window, scale, s);
  if (dtype == BF16)
    return launch_hd<__nv_bfloat16>(head_dim, q, k, v, o, B, H, Hkv, sq, skv,
                                    causal, has_window, window, scale, s);
  return -1;
}
