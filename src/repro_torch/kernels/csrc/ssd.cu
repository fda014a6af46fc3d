// K4, the Mamba2 SSD intra-chunk term for Hopper: the masked, decayed
// (+, ×) contraction that the SSD chunked scan computes inside each chunk.
//
// Replaces repro/kernels/ssd.py::ssd_intra_chunk, the Pallas TPU kernel
// (body _kernel), which the port's models/ssm.py::ssd_chunked reaches with
// impl="pallas" in place of its intra-chunk einsums.
//
// What it computes.  For every (z, h) = (batch·chunk, head) and query row q
// of a chunk of Q rows:
//
//   Y[q, :] = Σ_{k ≤ q} ((C_q · B_k) · exp(cum_q − cum_k) · dt_k) X[k, :]
//
// c, b (BZ, G, Q, N) and x (BZ, H, Q, P), dt, cum (BZ, H, Q) in f32 or bf16,
// widened to f32 at the load; y (BZ, H, Q, P) is f32.  Head h reads C and B
// of group h / (H / G) by index (G == H is the TPU kernel's per-head call),
// so the group expansion is never materialised.  Every tensor comes with
// its element strides over (z, head, q); C, B, X and Y have unit stride on
// their last axis.  So the caller's (B, nc, Q, H, ·) layout is read and
// written in place, with no transposed copies.  The weight of a pair is
// formed in the TPU kernel's order, (scores · decay) · dt; above the
// diagonal it is a select to 0, never a product with a 0 mask: there
// cum_q − cum_k ≥ 0 and exp may overflow to +inf, and inf · 0 is NaN.
//
// What bounds it.  At the mamba2-780m prefill (BZ 4·8, H 48, G 1, Q 256,
// N 128, P 64, f32) the causal work per (q, k ≤ q) pair is 2·N flops for
// the score, once per group (the group's 48 heads share C Bᵀ), and 2·P
// flops per head: 6.7e9 flops, 0.10 ms at the card's f32 CUDA-core rate;
// the bytes (C and B once per group, X, dt, cum and Y once per head:
// 213 MB) take 0.064 ms and the 5.1e7 exps 0.012 ms.  Bound by operations.
// This kernel, like the TPU kernel, forms the score once per head:
// 2·(N + P) flops per pair and head, 1.94e10 (0.29 ms at that rate).
//
// What the design does about it (a right and simple first kernel).  The
// TPU kernel holds a whole (Q, Q) score tile in VMEM; at Q = 256 its f32
// scores alone are 256 KB, past a CTA's 227 KB.  So one CTA of 256 threads
// owns (z, h, 64-row query tile) and loops over the 64-key tiles at or
// below the diagonal (the causal half of the rectangle plus the diagonal
// tiles); heaviest query tiles are issued first.  C_q^T stays in shared
// memory for the whole loop; per key tile B_k^T, X_k, cum_k and dt_k are
// staged, each thread forms a 4×4 block of S = C_q B_k^T (four rows, four
// keys: each shared value read feeds four FMAs), turns it into the weights
// W = S · L · dt_k in registers, writes W^T to shared memory, and adds
// W X_k into its 4 × P/16 block of the accumulator, held in registers
// across the loop.  No softmax, so no rescaling.  At N 128, P 64 the CTA
// takes 104 KB of shared memory: two CTAs per SM.  Everything is f32 FMA
// on the CUDA cores; TF32 or bf16 tensor cores (mma.sync / wgmma), TMA
// staging and a larger register tile are later work.
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
constexpr int BK = 64;        // keys per key tile
constexpr int THREADS = 256;  // 16 x 16 threads: ty owns 4 rows, tx 4 keys
constexpr int PAD = 4;        // row padding of the transposed tiles (floats)
constexpr int QS = BQ + PAD;  // stride of C^T and W^T rows
constexpr int KS = BK + PAD;  // stride of B^T rows

enum DType { F32 = 0, BF16 = 1 };

// element strides over (z, head or group, q) of one operand
struct Stride3 {
  long long z, h, q;
};
struct Strides {
  Stride3 c, b, x, dt, cum, y;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int P>
__host__ __device__ constexpr int smem_floats(int n) {
  return n * QS + n * KS + BK * P + BK * QS + BQ + 2 * BK;
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS)
    ssd_intra_chunk_kernel(const T* __restrict__ C, const T* __restrict__ B,
                           const T* __restrict__ X, const T* __restrict__ DT,
                           const T* __restrict__ CUM, float* __restrict__ Y,
                           int ZH, int H, int G, int Q, int N, int nq,
                           Strides st) {
  constexpr int DJ = (P + 15) / 16;  // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;              // [N][QS]  C_q^T
  float* bt = ct + N * QS;       // [N][KS]  B_k^T
  float* xs = bt + N * KS;       // [BK][P]  X_k
  float* wt = xs + BK * P;       // [BK][QS] W^T
  float* cq = wt + BK * QS;      // [BQ]     cum of the query rows
  float* ck = cq + BQ;           // [BK]     cum of the keys
  float* dk = ck + BK;           // [BK]     dt of the keys

  // heaviest query tiles first: every (z, h) of the last tile, then the one
  // before it, ...
  const int zh = blockIdx.x % ZH;
  const int qi = nq - 1 - blockIdx.x / ZH;
  const int z = zh / H;
  const int h = zh % H;
  const int g = h / (H / G);
  const T* c = C + z * st.c.z + g * st.c.h;
  const T* b = B + z * st.b.z + g * st.b.h;
  const T* x = X + z * st.x.z + h * st.x.h;
  const T* dt = DT + z * st.dt.z + h * st.dt.h;
  const T* cum = CUM + z * st.cum.z + h * st.cum.h;
  float* y = Y + z * st.y.z + h * st.y.h;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = qi * BQ;
  const int rows = min(BQ, Q - q0);  // real rows of this tile

  for (int i = tid; i < BQ * N; i += THREADS) {
    const int r = i / N, n = i % N;
    ct[n * QS + r] = r < rows ? to_f32(c[(q0 + r) * st.c.q + n]) : 0.f;
  }
  for (int r = tid; r < BQ; r += THREADS)
    cq[r] = r < rows ? to_f32(cum[(q0 + r) * st.cum.q]) : 0.f;

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int kj = 0; kj <= qi; ++kj) {
    const int k0 = kj * BK;
    const int keys = min(BK, Q - k0);

    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * N; i += THREADS) {
      const int r = i / N, n = i % N;
      bt[n * KS + r] = r < keys ? to_f32(b[(k0 + r) * st.b.q + n]) : 0.f;
    }
    for (int i = tid; i < BK * P; i += THREADS) {
      const int r = i / P, p = i % P;
      xs[i] = r < keys ? to_f32(x[(k0 + r) * st.x.q + p]) : 0.f;
    }
    for (int r = tid; r < BK; r += THREADS) {
      ck[r] = r < keys ? to_f32(cum[(k0 + r) * st.cum.q]) : 0.f;
      dk[r] = r < keys ? to_f32(dt[(k0 + r) * st.dt.q]) : 0.f;
    }
    __syncthreads();

    // S = C_q B_k^T: a 4x4 block per thread
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) s[i][k] = 0.f;
#pragma unroll 8
    for (int n = 0; n < N; ++n) {
      const float4 a = *reinterpret_cast<const float4*>(&ct[n * QS + ty * 4]);
      const float4 bb = *reinterpret_cast<const float4*>(&bt[n * KS + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) s[i][k] = fmaf(av[i], bv[k], s[i][k]);
    }

    // W = (S · L) · dt_k, selected to 0 above the diagonal (only the
    // diagonal tile has such pairs; keys past Q sit above every real row)
    const bool diag = kj == qi;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int kk = tx * 4 + k;
        const float w = s[i][k] * expf(cq[r] - ck[kk]) * dk[kk];
        s[i][k] = (!diag || kk <= r) ? w : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      *reinterpret_cast<float4*>(&wt[(tx * 4 + k) * QS + ty * 4]) =
          make_float4(s[0][k], s[1][k], s[2][k], s[3][k]);
    __syncthreads();

    // Y_q += W X_k
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&wt[k * QS + ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const int p = tx + 16 * jj;
        const float xv = (P % 16 == 0 || p < P) ? xs[k * P + p] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(av[i], xv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int p = tx + 16 * jj;
      if (P % 16 == 0 || p < P) y[(q0 + r) * st.y.q + p] = acc[i][jj];
    }
  }
}

template <typename T, int P>
int launch(const void* c, const void* b, const void* x, const void* dt,
           const void* cum, void* y, int BZ, int H, int G, int Q, int N,
           const Strides& st, cudaStream_t stream) {
  auto kernel = ssd_intra_chunk_kernel<T, P>;
  const int smem = smem_floats<P>(N) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nq = (Q + BQ - 1) / BQ;
  const int zh = BZ * H;
  kernel<<<dim3((unsigned)(zh * nq)), dim3(THREADS), smem, stream>>>(
      static_cast<const T*>(c), static_cast<const T*>(b),
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(cum), static_cast<float*>(y), zh, H, G, Q, N, nq,
      st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_p(int P, const void* c, const void* b, const void* x,
             const void* dt, const void* cum, void* y, int BZ, int H, int G,
             int Q, int N, const Strides& st, cudaStream_t s) {
#define SSD_CASE(PD)                                                    \
  case PD:                                                             \
    return launch<T, PD>(c, b, x, dt, cum, y, BZ, H, G, Q, N, st, s);
  switch (P) {
    SSD_CASE(8)
    SSD_CASE(16)
    SSD_CASE(32)
    SSD_CASE(64)
    SSD_CASE(128)
    default:
      return -1;
  }
#undef SSD_CASE
}

}  // namespace

// strides: 18 element strides, (z, head, q) of c, b, x, dt, cum and y in
// that order (c and b over groups).
extern "C" int simd2_ssd_intra_chunk(int dtype, int head_dim, const void* c,
                                     const void* b, const void* x,
                                     const void* dt, const void* cum, void* y,
                                     int BZ, int H, int G, int Q, int N,
                                     const long long* strides, void* stream) {
  Strides st;
  Stride3* dst[6] = {&st.c, &st.b, &st.x, &st.dt, &st.cum, &st.y};
  for (int i = 0; i < 6; ++i) {
    dst[i]->z = strides[3 * i];
    dst[i]->h = strides[3 * i + 1];
    dst[i]->q = strides[3 * i + 2];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    return launch_p<float>(head_dim, c, b, x, dt, cum, y, BZ, H, G, Q, N, st,
                           s);
  if (dtype == BF16)
    return launch_p<__nv_bfloat16>(head_dim, c, b, x, dt, cum, y, BZ, H, G, Q,
                                   N, st, s);
  return -1;
}
