// The SIMD² unit for Hopper: D = C ⊕ (A ⊗ B) for all nine SIMD² rings.
//
// Replaces repro/kernels/semiring_mmo.py::semiring_mmo, the Pallas TPU
// kernel (batched over requests by repro/kernels/ops.py::semiring_mmo).
//
// What bounds it.  The min/max rings (minplus, maxplus, minmul, maxmul,
// minmax, maxmin) have no tensor-core form: every (i, j, k) term costs one
// ⊗ and one ⊕ instruction on the CUDA cores, about 2·M·N·K instructions per
// call, against only (MK + KN + 2MN) elements of memory traffic.  At the
// main path's shapes (n = 256 … 4096) the kernel is bound by CUDA-core
// instruction issue, not by device memory.  mma and addnorm run here as f32
// FMA on the same cores (tensor cores are later work); orand runs as
// (max, min) over {0,1}.
//
// What the design does about it.  One CTA per (request, 64-row tile,
// 64-column tile), request on blockIdx.z.  A 64x16 slab of A and a 16x64
// slab of B are staged in shared memory per K step; each of the 256 threads
// keeps a 4x4 register tile of accumulators, so every shared-memory value it
// reads feeds four ⊗⊕ pairs and the inner loop is almost all ring
// instructions.  The K loop runs ceil(k_valid[r] / 16) times — the GPU form
// of the TPU kernel's pl.when skip of dead K blocks — and lanes at or past K
// or k_valid load the ring's contraction pads, whose ⊗ is the ⊕-identity,
// so they contribute nothing.  C is folded in the epilogue.
//
// Numerics.  Values are widened to f32 on load; ⊗ and ⊕ run in f32 and the
// result is rounded once at the store.  For the min/max rings with bf16 in
// and bf16 out that is bit-identical to rounding each ⊗ then taking the
// min/max in bf16, because rounding is monotone.  min/max propagate NaN
// (min.NaN / max.NaN), as jnp.minimum / torch.minimum do, so a NaN edge
// weight stays visible to the closure's convergence compare.
//
// addnorm is the ring's own ⊗: Σ(a−b)², accumulated directly.  The
// reference's ‖a‖²−2ab+‖b‖² rewrite cancels catastrophically when the
// coordinates are large (about 1e6 in f32), which is why the reference's
// large-coordinate KNN test fails; this kernel does not copy that rewrite.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() after the launch (or -1 for an op/dtype pair it does
// not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);
constexpr int AS_STRIDE = BM + 4;  // breaks bank conflicts on the A store

// Ring codes follow repro_torch.core.semiring.ALL_OPS order.
enum Op {
  MMA = 0, MINPLUS = 1, MAXPLUS = 2, MINMUL = 3, MAXMUL = 4,
  MINMAX = 5, MAXMIN = 6, ORAND = 7, ADDNORM = 8
};
enum DType { F32 = 0, BF16 = 1, U8 = 2 };

__device__ __forceinline__ float fmin_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float fmax_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float pinf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float ninf() { return __int_as_float(0xff800000); }

template <int OP>
struct Ring;

// identity: ⊕-identity.  pad_a/pad_b: K-lane pads with ⊗(pad_a, pad_b) equal
// to the identity (repro_torch.core.semiring._CONTRACTION_PADS).
// step(acc, a, b) = acc ⊕ (a ⊗ b).
#define SIMD2_RING(OPC, ID, PA, PB, OPLUS, STEP)                            \
  template <>                                                               \
  struct Ring<OPC> {                                                        \
    static __device__ __forceinline__ float identity() { return ID; }       \
    static __device__ __forceinline__ float pad_a() { return PA; }          \
    static __device__ __forceinline__ float pad_b() { return PB; }          \
    static __device__ __forceinline__ float oplus(float x, float y) {       \
      return OPLUS;                                                         \
    }                                                                       \
    static __device__ __forceinline__ float step(float acc, float a,        \
                                                 float b) {                 \
      return STEP;                                                          \
    }                                                                       \
  };

SIMD2_RING(MMA, 0.f, 0.f, 0.f, x + y, fmaf(a, b, acc))
SIMD2_RING(MINPLUS, pinf(), pinf(), pinf(), fmin_nan(x, y),
           fmin_nan(acc, a + b))
SIMD2_RING(MAXPLUS, ninf(), ninf(), ninf(), fmax_nan(x, y),
           fmax_nan(acc, a + b))
SIMD2_RING(MINMUL, pinf(), pinf(), pinf(), fmin_nan(x, y),
           fmin_nan(acc, a * b))
SIMD2_RING(MAXMUL, ninf(), ninf(), pinf(), fmax_nan(x, y),
           fmax_nan(acc, a * b))
SIMD2_RING(MINMAX, pinf(), pinf(), pinf(), fmin_nan(x, y),
           fmin_nan(acc, fmax_nan(a, b)))
SIMD2_RING(MAXMIN, ninf(), ninf(), ninf(), fmax_nan(x, y),
           fmax_nan(acc, fmin_nan(a, b)))
SIMD2_RING(ORAND, 0.f, 0.f, 0.f, fmaxf(x, y), fmaxf(acc, fminf(a, b)))
SIMD2_RING(ADDNORM, 0.f, 0.f, 0.f, x + y, fmaf(a - b, a - b, acc))

#undef SIMD2_RING

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(uint8_t x) { return x ? 1.f : 0.f; }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(uint8_t* p, float v) {
  *p = v > 0.5f ? 1 : 0;
}

template <int OP, typename TIn, typename TOut>
__global__ void __launch_bounds__(THREADS)
    semiring_mmo_kernel(const TIn* __restrict__ A, const TIn* __restrict__ B,
                        const TOut* __restrict__ C,
                        const int* __restrict__ KV, TOut* __restrict__ D,
                        int M, int K, int N) {
  using R = Ring<OP>;
  __shared__ __align__(16) float As[BK][AS_STRIDE];  // A slab, K-major
  __shared__ __align__(16) float Bs[BK][BN];

  const size_t r = blockIdx.z;
  A += r * (size_t)M * K;
  B += r * (size_t)K * N;
  D += r * (size_t)M * N;
  if (C != nullptr) C += r * (size_t)M * N;
  int kv = K;
  if (KV != nullptr) {
    kv = KV[r];
    kv = kv < 0 ? 0 : (kv > K ? K : kv);
  }

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = R::identity();

  for (int k0 = 0; k0 < kv; k0 += BK) {
    // consecutive threads walk K within a row of A and N within a row of B,
    // so both global reads are contiguous runs
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int mm = i / BK, kk = i % BK;
      const int gm = row0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < kv) ? to_f(A[(size_t)gm * K + gk])
                                       : R::pad_a();
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int kk = i / BN, nn = i % BN;
      const int gk = k0 + kk, gn = col0 + nn;
      Bs[kk][nn] = (gk < kv && gn < N) ? to_f(B[(size_t)gk * N + gn])
                                       : R::pad_b();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float a[TM] = {av.x, av.y, av.z, av.w};
      const float b[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = R::step(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + tx * TN + j;
      if (gn >= N) continue;
      const size_t at = (size_t)gm * N + gn;
      float v = acc[i][j];
      if (C != nullptr) v = R::oplus(v, to_f(C[at]));
      store(&D[at], v);
    }
  }
}

template <int OP, typename TIn, typename TOut>
int launch(const void* a, const void* b, const void* c, const void* kv,
           void* d, int R, int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, R);
  semiring_mmo_kernel<OP, TIn, TOut><<<grid, THREADS, 0, stream>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b),
      static_cast<const TOut*>(c), static_cast<const int*>(kv),
      static_cast<TOut*>(d), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

// Float rings: f32 in → f32 out; bf16 in → bf16 out for the min/max rings
// (they keep the input dtype) and f32 out for mma / addnorm (they widen).
template <int OP>
int launch_float_ring(int dtype, const void* a, const void* b, const void* c,
                      const void* kv, void* d, int R, int M, int K, int N,
                      cudaStream_t stream) {
  if (dtype == F32)
    return launch<OP, float, float>(a, b, c, kv, d, R, M, K, N, stream);
  if (dtype == BF16) {
    if constexpr (OP == MMA || OP == ADDNORM)
      return launch<OP, __nv_bfloat16, float>(a, b, c, kv, d, R, M, K, N,
                                              stream);
    else
      return launch<OP, __nv_bfloat16, __nv_bfloat16>(a, b, c, kv, d, R, M,
                                                      K, N, stream);
  }
  return -1;
}

}  // namespace

extern "C" int simd2_semiring_mmo(int op, int dtype, const void* a,
                                  const void* b, const void* c,
                                  const void* k_valid, void* d, int R, int M,
                                  int K, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case MMA:
      return launch_float_ring<MMA>(dtype, a, b, c, k_valid, d, R, M, K, N, s);
    case MINPLUS:
      return launch_float_ring<MINPLUS>(dtype, a, b, c, k_valid, d, R, M, K,
                                        N, s);
    case MAXPLUS:
      return launch_float_ring<MAXPLUS>(dtype, a, b, c, k_valid, d, R, M, K,
                                        N, s);
    case MINMUL:
      return launch_float_ring<MINMUL>(dtype, a, b, c, k_valid, d, R, M, K,
                                       N, s);
    case MAXMUL:
      return launch_float_ring<MAXMUL>(dtype, a, b, c, k_valid, d, R, M, K,
                                       N, s);
    case MINMAX:
      return launch_float_ring<MINMAX>(dtype, a, b, c, k_valid, d, R, M, K,
                                       N, s);
    case MAXMIN:
      return launch_float_ring<MAXMIN>(dtype, a, b, c, k_valid, d, R, M, K,
                                       N, s);
    case ADDNORM:
      return launch_float_ring<ADDNORM>(dtype, a, b, c, k_valid, d, R, M, K,
                                        N, s);
    case ORAND:
      if (dtype == U8)
        return launch<ORAND, uint8_t, uint8_t>(a, b, c, k_valid, d, R, M, K,
                                               N, s);
      return -1;
    default:
      return -1;
  }
}
