// Ring traits and the per-tile contraction loop shared by the SIMD² unit
// (semiring_mmo.cu, K1) and the fused closure fixpoint (closure_megakernel.cu,
// K2).
//
// Both kernels contract a 64x64 output tile with this one routine, so a
// closure step computes the same bits whichever kernel runs it: mma sums its
// K terms with one fmaf per term in increasing k, in both.  That is what
// makes the port's per-iteration (K1) and fused (K2) closure paths
// bit-identical on every ring, mma included.
//
// Tile: 256 threads, each holding a 4x4 register tile of accumulators; per K
// step a 64x16 slab of A and a 16x64 slab of B are staged in shared memory.
// Lanes at or past K or kv load the ring's contraction pads, whose ⊗ is the
// ⊕-identity, and the K loop stops at ceil(kv / 16) steps.  Values are
// widened to f32 on load; min/max propagate NaN (min.NaN / max.NaN), as
// torch.minimum does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace simd2 {

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

// Rounds v once to the stored type and returns the stored value, widened.
__device__ __forceinline__ float store(float* p, float v) {
  *p = v;
  return v;
}
__device__ __forceinline__ float store(__nv_bfloat16* p, float v) {
  const __nv_bfloat16 s = __float2bfloat16_rn(v);
  *p = s;
  return __bfloat162float(s);
}
__device__ __forceinline__ float store(uint8_t* p, float v) {
  const uint8_t s = v > 0.5f ? 1 : 0;
  *p = s;
  return s ? 1.f : 0.f;
}

// acc[i][j] = ⊕_{k < kv} A[row0 + ty*TM + i, k] ⊗ B[k, col0 + tx*TN + j] for
// row-major A (M x K) and B (K x N); tx/ty are this thread's column and row
// in the 16x16 thread grid.  Every thread of the block must call it (it
// synchronises the block).  As/Bs may be reused once it returns.
template <int OP, typename TIn>
__device__ __forceinline__ void contract_tile(
    const TIn* A, const TIn* B, int M, int K, int N, int kv, int row0,
    int col0, float (&As)[BK][AS_STRIDE], float (&Bs)[BK][BN],
    float (&acc)[TM][TN]) {
  using R = Ring<OP>;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
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
}

}  // namespace simd2
