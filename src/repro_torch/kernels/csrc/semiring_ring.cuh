// Ring traits and the two tile contractions shared by the SIMD² unit
// (semiring_mmo.cu, K1) and the fused closure fixpoint (closure_megakernel.cu,
// K2).
//
// Both kernels contract their output tiles with these routines, so a closure
// step computes the same bits whichever kernel runs it.  The contract is per
// output element: the same instruction for each term (or 8-deep k group), the
// same k order and the same split of each operand.  The tile shape is free
// wherever an element's bits cannot depend on it.
//
// contract_cc — the CUDA-core tile, for the eight rings other than mma.
//   256 threads own a (16·TM)² output tile, a TM×TM register tile each
//   (TM = 8: 128×128; TM = 4: 64×64).  K runs in slabs of BK = 16, double
//   buffered: slab s+1 is copied with 16-byte cp.async while slab s
//   computes.  Operands are staged raw (f32, bf16 or {0,1} bytes) as they
//   lie in device memory — A's slab M×BK, B's BK×N — and each value is
//   widened once, when a fragment is read into registers (4 k values of A
//   per row, 4 columns of B per read).  Each element is the fold
//   acc ← step(acc, a_k, b_k) over k = 0 … ceil(kv/16)·16 − 1 in increasing
//   order from the ⊕-identity, one step per term, so its bits do not depend
//   on TM.  Lanes at or past kv (and rows or columns past the edge) hold
//   the ring's contraction pads, whose ⊗ is the ⊕-identity: the ±inf pads
//   are not zeros, so such edge slabs are filled by the threads and only
//   interior slabs of 16-byte aligned operands go through cp.async.
//
// contract_tc — mma on the tensor cores, 3×TF32.
//   Each f32 operand value x is split into big = tf32_rna(x) and small =
//   tf32_rna(x − big) (small = 0 where big is not finite), and each 8-deep k
//   group takes three TF32 products in this order: A_small·B_big,
//   A_big·B_small, A_big·B_big.  That keeps f32-level accuracy.  bf16 values
//   widen exactly into TF32 (their 8-bit significand fits), so bf16 inputs
//   take the A_big·B_big product alone.  TF32 wgmma reads both operands
//   K-major from shared memory, so a split pass (tc_split_strip) first
//   writes A's parts and B's, transposed, to a workspace in device memory,
//   with zeros at k ≥ kv.  Then two warpgroups own a 128×128 output tile,
//   64×128 each (wgmma.m64n128k8): 32-deep slabs of the four parts arrive by
//   TMA in the 128-byte swizzle, three stages deep, each completing on its
//   own mbarrier; the last warp done with a stage loads the next slab into
//   it, so no CTA barrier ties the warpgroups per slab.  Each slab's
//   products start a fresh wgmma sum, which is then added in f32 to
//   the element's total with Kahan's compensation: the tensor cores' own
//   accumulation is not round-to-nearest, and 4096 terms of it would drift
//   past f32 accuracy.  Every element takes the same 3·4 products per slab
//   over ceil(kv/32) slabs.
//   Non-finite inputs: a product with one ±inf factor and a finite other is
//   ±inf in f32, but the split's cross terms multiply the inf by the other
//   factor's small part, which is 0 (or of the other sign) for many finite
//   values, and give NaN.  So the split pass records which rows of A and
//   columns of B hold a value that is not finite, and each element in such
//   a row or column takes the f32 terms' pattern instead: NaN if some term
//   is NaN or there are +inf and −inf terms, else the inf's sign.
//
// min/max propagate NaN (min.NaN / max.NaN), as torch.minimum does.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace simd2 {

using namespace hopper;

constexpr int THREADS = 256;

// CTAs of Kernel (THREADS threads, smem bytes of dynamic shared memory) the
// current card holds at once.  Asked of the runtime once per device and
// kept: the shape rule and K2's grid ask it on every launch.
template <auto Kernel>
cudaError_t resident_ctas(int smem, int* out) {
  constexpr int MAX_DEVICES = 64;
  static std::atomic<int> known[MAX_DEVICES];  // 0: not asked yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && (*out = known[dev].load()) > 0) return e;
  int sms = 0, per_sm = 0;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel,
                                                      THREADS, smem);
  *out = per_sm * sms;
  if (e == cudaSuccess && dev < MAX_DEVICES) known[dev].store(*out);
  return e;
}

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
__device__ __forceinline__ float qnan() { return __int_as_float(0x7fffffff); }
__device__ __forceinline__ bool finite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) != 0x7f800000u;
}

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

// -- loads and stores -------------------------------------------------------

// Device-memory reads go through L2 only (ld.global.cg): K2 reads in one step
// what other CTAs wrote in the last, after a grid barrier.
__device__ __forceinline__ float ld_raw(const float* p) { return __ldcg(p); }
__device__ __forceinline__ __nv_bfloat16 ld_raw(const __nv_bfloat16* p) {
  return __ldcg(p);
}
__device__ __forceinline__ uint8_t ld_raw(const uint8_t* p) {
  return __ldcg(p);
}
__device__ __forceinline__ int ld_raw(const int* p) { return __ldcg(p); }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(uint8_t x) { return x ? 1.f : 0.f; }

template <typename T>
__device__ __forceinline__ float ld_f(const T* p) {
  return to_f(ld_raw(p));
}

// A ring's pad in the stored type (bf16 holds ±inf; orand's pads are 0).
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ uint8_t from_f<uint8_t>(float v) {
  return v > 0.5f ? 1 : 0;
}

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

// Four consecutive stored values in shared memory, widened (16, 8 or 4
// bytes, aligned to their size).
__device__ __forceinline__ void ld4(const float* s, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(s);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* s, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(s);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}
__device__ __forceinline__ void ld4(const uint8_t* s, float (&v)[4]) {
  const uint32_t t = *reinterpret_cast<const uint32_t*>(s);
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = ((t >> (8 * q)) & 0xffu) ? 1.f : 0.f;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this thread's writes to device memory, made visible to TMA reads (the
// async proxy) that follow a barrier
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// -- the CUDA-core tile -----------------------------------------------------

template <int TM>
struct CcTile {
  static_assert(TM == 4 || TM == 8, "register tile");
  static constexpr int BM = 16 * TM;  // = BN
  static constexpr int BK = 16;
  // elements of one stage: A's BM×BK slab and B's BK×BM slab
  static constexpr int STAGE = 2 * BM * BK;
  // Row (or column) of a thread's i-th register row (column) within the
  // tile: blocks of 4 consecutive rows, TM/4 of them 64 apart, so a warp's
  // 16 column threads read 16 consecutive 4-wide chunks of B's row.
  static __device__ __forceinline__ int off(int i, int t) {
    return (i / 4) * 64 + t * 4 + (i % 4);
  }
};

// Lanes that 16-byte cp.async may copy: rows of A (K) and of B (N) are whole
// 16-byte chunks and both bases are 16-byte aligned.
template <typename T>
__device__ __forceinline__ bool cc_vec(const T* A, const T* B, int K, int N) {
  return aligned16(A) && aligned16(B) &&
         (static_cast<size_t>(K) * sizeof(T)) % 16 == 0 &&
         (static_cast<size_t>(N) * sizeof(T)) % 16 == 0;
}

// One slab (k0 … k0+15) of A (rows row0 …) and B (columns col0 …) into a
// stage: cp.async where the slab is interior and vec, else by the threads
// with the ring's pads past M, N and kv.
template <int OP, typename T, int TM>
__device__ __forceinline__ void cc_fill(const T* A, const T* B, int M, int K,
                                        int N, int kv, int row0, int col0,
                                        int k0, bool vec, T* st) {
  using R = Ring<OP>;
  using Tl = CcTile<TM>;
  constexpr int BM = Tl::BM, BK = Tl::BK;
  constexpr int PER = 16 / static_cast<int>(sizeof(T));  // values per chunk
  T* As = st;             // [BM][BK]
  T* Bs = st + BM * BK;   // [BK][BM]
  const int tid = threadIdx.x;
  if (vec && row0 + BM <= M && col0 + BM <= N && k0 + BK <= kv) {
    constexpr int A_CPR = BK / PER, B_CPR = BM / PER;  // chunks per row
#pragma unroll
    for (int c = tid; c < BM * A_CPR; c += THREADS) {
      const int row = c / A_CPR, part = c % A_CPR;
      cp_async16(As + row * BK + part * PER,
                 A + static_cast<size_t>(row0 + row) * K + k0 + part * PER);
    }
#pragma unroll
    for (int c = tid; c < BK * B_CPR; c += THREADS) {
      const int kk = c / B_CPR, part = c % B_CPR;
      cp_async16(Bs + kk * BM + part * PER,
                 B + static_cast<size_t>(k0 + kk) * N + col0 + part * PER);
    }
  } else {
    const T pa = from_f<T>(R::pad_a()), pb = from_f<T>(R::pad_b());
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int row = e / BK, kk = e % BK;
      const int gm = row0 + row, gk = k0 + kk;
      As[e] = (gm < M && gk < kv)
                  ? ld_raw(A + static_cast<size_t>(gm) * K + gk)
                  : pa;
    }
    for (int e = tid; e < BK * BM; e += THREADS) {
      const int kk = e / BM, nn = e % BM;
      const int gk = k0 + kk, gn = col0 + nn;
      Bs[e] = (gk < kv && gn < N)
                  ? ld_raw(B + static_cast<size_t>(gk) * N + gn)
                  : pb;
    }
  }
}

// acc[i][j] = ⊕_{k < kv} A[row0 + off(i, ty), k] ⊗ B[k, col0 + off(j, tx)]
// for row-major A (M×K) and B (K×N), tx = tid % 16, ty = tid / 16.  Every
// thread of the block must call it (it synchronises the block); smem holds
// two stages (2 · CcTile<TM>::STAGE values), 16-byte aligned, and may be
// reused once it returns.
template <int OP, typename T, int TM>
__device__ __forceinline__ void contract_cc(const T* A, const T* B, int M,
                                            int K, int N, int kv, int row0,
                                            int col0, bool vec, T* smem,
                                            float (&acc)[TM][TM]) {
  using R = Ring<OP>;
  using Tl = CcTile<TM>;
  constexpr int BM = Tl::BM, BK = Tl::BK;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = R::identity();

  const int slabs = (kv + BK - 1) / BK;
  if (slabs > 0)
    cc_fill<OP, T, TM>(A, B, M, K, N, kv, row0, col0, 0, vec, smem);
  cp_async_commit();
  for (int s = 0; s < slabs; ++s) {
    if (s + 1 < slabs) {
      cc_fill<OP, T, TM>(A, B, M, K, N, kv, row0, col0, (s + 1) * BK, vec,
                         smem + ((s + 1) & 1) * Tl::STAGE);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* As = smem + (s & 1) * Tl::STAGE;
    const T* Bs = As + BM * BK;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float a[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) ld4(As + Tl::off(i, ty) * BK + k4, a[i]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[TM];
#pragma unroll
        for (int j4 = 0; j4 < TM / 4; ++j4) {
          float v[4];
          ld4(Bs + (k4 + kk) * BM + j4 * 64 + tx * 4, v);
#pragma unroll
          for (int q = 0; q < 4; ++q) b[j4 * 4 + q] = v[q];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TM; ++j)
            acc[i][j] = R::step(acc[i][j], a[i][kk], b[j]);
      }
    }
    __syncthreads();
  }
}

// -- the tensor-core tile (mma, 3×TF32) -------------------------------------

constexpr int TC_BM = 128;  // two warpgroups of 64 rows
constexpr int TC_BN = 128;
constexpr int TC_BK = 32;   // one 128-byte row of TF32: four 8-deep k groups
constexpr int TC_STAGES = 3;
// One stage: A big and small, then B big and small, each 128 rows × 128 B,
// K-major with the 128-byte swizzle.
constexpr int TC_A_BYTES = TC_BM * 128;
constexpr int TC_B_BYTES = TC_BN * 128;
constexpr int TC_STAGE = 2 * TC_A_BYTES + 2 * TC_B_BYTES;
// The stages start at the first 1024-byte boundary, as the swizzle requires
// (+1024), and are followed by one mbarrier and one counter per stage.
constexpr int TC_SMEM_BYTES = TC_STAGES * TC_STAGE + 1024 + 16 * TC_STAGES;

// Rows of the split operands are padded to whole slabs.
__host__ __device__ __forceinline__ int tc_kpad(int k) {
  return (k + TC_BK - 1) / TC_BK * TC_BK;
}

// The split operands of one contraction, in device memory (the caller's
// workspace, tc_workspace_bytes): A's big and small parts (M × Kp,
// row-major), B's transposed (N × Kp, row-major: K-major), both 0 at k ≥ kv;
// and whether each row of A / column of B holds a value that is not finite.
struct TcSplit {
  float *a_big, *a_small, *b_big, *b_small;
  int *a_bad, *b_bad;
};

__host__ __device__ __forceinline__ size_t tc_workspace_bytes(int m, int n,
                                                              int k) {
  return (2 * (size_t)m * tc_kpad(k) + 2 * (size_t)n * tc_kpad(k)) * 4 +
         ((size_t)m + n) * 4;
}

// The layout of request r's split operands in a workspace of R requests.
__host__ __device__ __forceinline__ TcSplit tc_split_at(void* ws, int R, int r,
                                                        int m, int n, int k) {
  const size_t kp = tc_kpad(k);
  float* f = static_cast<float*>(ws);
  TcSplit t;
  t.a_big = f + (size_t)r * m * kp;
  t.a_small = f + ((size_t)R + r) * m * kp;
  f += 2 * (size_t)R * m * kp;
  t.b_big = f + (size_t)r * n * kp;
  t.b_small = f + ((size_t)R + r) * n * kp;
  f += 2 * (size_t)R * n * kp;
  int* b = reinterpret_cast<int*>(f);
  t.a_bad = b + (size_t)r * m;
  t.b_bad = b + (size_t)R * m + (size_t)r * n;
  return t;
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// x = big + small (+ a residue below 2⁻²² |x|); small = 0 where big is not
// finite.  bf16 values are TF32 values already: their small part is 0.
template <typename T>
__device__ __forceinline__ void tc_split_value(float x, float& big,
                                               float& small) {
  big = tf32_rna(x);
  small = (sizeof(T) == 4 && finite(big)) ? tf32_rna(x - big) : 0.f;
}

// The split pass, one work item: strip i (of tc_split_items) of request r.
// Strips 0 … ⌈M/32⌉−1 are 32 rows of A, written row-major; the rest are 32
// columns of B, transposed through shared memory 128 k at a time (16 loads
// in flight per thread).  Every thread of the block must call it.
template <typename T>
__device__ void tc_split_strip(const T* A, const T* B, int M, int K, int N,
                               int kv, TcSplit t, int strip) {
  constexpr bool SPLIT = sizeof(T) == 4;
  constexpr int KT = 128;  // k per transposed tile
  __shared__ float tile[KT][33];
  __shared__ int col_bad[32];
  const int kp = tc_kpad(K);
  const int a_strips = (M + 31) / 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (strip < a_strips) {
    // each warp splits its 4 rows side by side, 4 values per lane and row
    // (one 16-byte store each), so 4 rows' loads are in flight at once
    const bool vec = K % 4 == 0 &&
        reinterpret_cast<uintptr_t>(A) % (4 * sizeof(T)) == 0;
    const int m0 = strip * 32 + warp * 4;
    bool bad[4] = {false, false, false, false};
    for (int k = 4 * lane; k < kp; k += 128) {
      float x[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const T* row = A + (size_t)(m0 + i) * K;
        if (m0 + i >= M) {
#pragma unroll
          for (int q = 0; q < 4; ++q) x[i][q] = 0.f;
        } else if (vec && k + 4 <= kv) {
          if constexpr (sizeof(T) == 4) {
            const float4 v = __ldcg(reinterpret_cast<const float4*>(row + k));
            x[i][0] = v.x; x[i][1] = v.y; x[i][2] = v.z; x[i][3] = v.w;
          } else {
            const uint2 v = __ldcg(reinterpret_cast<const uint2*>(row + k));
            const float2 lo = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&v.x));
            const float2 hi = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&v.y));
            x[i][0] = lo.x; x[i][1] = lo.y; x[i][2] = hi.x; x[i][3] = hi.y;
          }
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            x[i][q] = k + q < kv ? ld_f(row + k + q) : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (m0 + i >= M) continue;
        float big[4], small[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          bad[i] |= !finite(x[i][q]);
          tc_split_value<T>(x[i][q], big[q], small[q]);
        }
        const size_t at = (size_t)(m0 + i) * kp + k;
        *reinterpret_cast<float4*>(t.a_big + at) =
            make_float4(big[0], big[1], big[2], big[3]);
        if (SPLIT)
          *reinterpret_cast<float4*>(t.a_small + at) =
              make_float4(small[0], small[1], small[2], small[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool any = __any_sync(0xffffffffu, bad[i]);
      if (lane == 0 && m0 + i < M) t.a_bad[m0 + i] = any;
    }
    fence_async_global();
    return;
  }
  const int n0 = (strip - a_strips) * 32;
  if (threadIdx.x < 32) col_bad[threadIdx.x] = 0;
  bool bad = false;
  for (int k0 = 0; k0 < kp; k0 += KT) {
    __syncthreads();  // col_bad is cleared; the last tile has been read
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      const int k = k0 + warp + 8 * j, n = n0 + lane;
      const float x =
          (k < kv && n < N) ? ld_f(B + (size_t)k * N + n) : 0.f;
      bad |= !finite(x);
      tile[warp + 8 * j][lane] = x;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + warp + 8 * j;
      if (n >= N) continue;
#pragma unroll
      for (int q = 0; q < KT / 32; ++q) {
        const int k = k0 + 32 * q + lane;
        if (k >= kp) break;
        float big, small;
        tc_split_value<T>(tile[32 * q + lane][warp + 8 * j], big, small);
        t.b_big[(size_t)n * kp + k] = big;
        if (SPLIT) t.b_small[(size_t)n * kp + k] = small;
      }
    }
  }
  if (bad) atomicOr(&col_bad[lane], 1);
  __syncthreads();
  if (threadIdx.x < 32 && n0 + threadIdx.x < N)
    t.b_bad[n0 + threadIdx.x] = col_bad[threadIdx.x];
  fence_async_global();
  __syncthreads();  // tile and col_bad may be reused
}

__host__ __device__ __forceinline__ int tc_split_items(int m, int n) {
  return (m + 31) / 32 + (n + 31) / 32;
}

// d = A·B (+ d unless scale_d is 0) for one 8-deep k group: A 64×8 and B
// (K-major) 128×8 TF32 from shared memory.
__device__ __forceinline__ void wgmma_tf32_m64n128k8(float (&d)[64],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d)
      : "memory");
}

// Accumulator element e (0 … 63) of thread t in its warpgroup: row and
// column within the warpgroup's 64×128 tile (wgmma's f32 layout: warp w,
// lane l hold rows 16w + l/4 (+8) and columns 8n + 2(l%4) (+1)).
__device__ __forceinline__ int tc_row(int e) {
  const int t = threadIdx.x % 128;
  return 16 * (t / 32) + (t % 32) / 4 + 8 * ((e % 4) / 2);
}
__device__ __forceinline__ int tc_col(int e) {
  const int t = threadIdx.x % 128;
  return 8 * (e / 4) + 2 * (t % 4) + (e % 2);
}

// TMA tensor maps over a workspace's four split parts, each 2-D: kp
// columns × R·rows rows (requests stacked), read in boxes of 32 columns ×
// 128 rows with the 128-byte swizzle.  Built on the host (tc_make_maps) and
// passed to the kernel as a __grid_constant__ parameter.
struct TcMaps {
  CUtensorMap a_big, a_small, b_big, b_small;
};

inline int tc_make_map(CUtensorMap* map, float* base, long long rows,
                       int kp) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return NO_TENSOR_MAPS;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kp),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kp) * 4};
  const cuuint32_t box[2] = {TC_BK, TC_BM};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, base, dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TENSOR_MAP_FAILED + static_cast<int>(r);
}

// The maps of a workspace of R requests of M × K by K × N.
inline int tc_make_maps(TcMaps* maps, void* ws, int R, int m, int n, int k) {
  const TcSplit t = tc_split_at(ws, R, 0, m, n, k);
  const int kp = tc_kpad(k);
  const long long rows_a = (long long)R * m, rows_b = (long long)R * n;
  int rc = tc_make_map(&maps->a_big, t.a_big, rows_a, kp);
  if (rc == 0) rc = tc_make_map(&maps->a_small, t.a_small, rows_a, kp);
  if (rc == 0) rc = tc_make_map(&maps->b_big, t.b_big, rows_b, kp);
  if (rc == 0) rc = tc_make_map(&maps->b_small, t.b_small, rows_b, kp);
  return rc;
}

// TMA: one box (column c0, row c1) of a 2-D map into shared memory,
// completing on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// One 32-deep slab of the split parts into a stage by TMA (rows a_row … of
// A's parts and b_row … of Bᵀ's), completing on the stage's barrier.
template <bool SPLIT>
__device__ __forceinline__ void tc_issue(const TcMaps& maps, uint32_t st,
                                         uint32_t bar, int a_row, int b_row,
                                         int k0) {
  mbar_expect_tx(bar, SPLIT ? TC_STAGE : TC_STAGE / 2);
  tma_load_2d(st, &maps.a_big, bar, k0, a_row);
  tma_load_2d(st + 2 * TC_A_BYTES, &maps.b_big, bar, k0, b_row);
  if (SPLIT) {
    tma_load_2d(st + TC_A_BYTES, &maps.a_small, bar, k0, a_row);
    tma_load_2d(st + 2 * TC_A_BYTES + TC_B_BYTES, &maps.b_small, bar, k0,
                b_row);
  }
}

// acc (wgmma layout, tc_row/tc_col) = Σ_{k < kv} A[row0 + 64·wg + row, k] ·
// B[k, col0 + col], wg the thread's warpgroup, from the split operands of
// tc_split_strip (SPLIT: f32 inputs, three products per k group; else bf16
// inputs, one), read by TMA through maps whose rows a_row … and b_row … are
// the tile's.  A and B are the unsplit operands (row-major M×K and K×N),
// read only where a row of A or a column of B holds a value that is not
// finite.  Every thread of the 256 must call it (it synchronises the
// block); smem holds TC_SMEM_BYTES and is the CTA's for as long as it calls
// this routine: `ring` counts the slabs the CTA has taken through its
// stages (0 before the first call, which sets up the barriers).
template <bool SPLIT, typename T>
__device__ __forceinline__ void contract_tc(const T* A, const T* B,
                                            const TcSplit& t,
                                            const TcMaps& maps, int M, int K,
                                            int N, int kv, int row0,
                                            int col0, int a_row, int b_row,
                                            unsigned char* smem,
                                            uint32_t& ring,
                                            float (&acc)[64]) {
  const int wg = threadIdx.x / 128;
  const uint32_t raw = smem_addr(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  // stage st's barrier completes when its slab has landed; its counter
  // counts the warps done with it
  const uint32_t bars = base + TC_STAGES * TC_STAGE;
  int* done = reinterpret_cast<int*>(smem + (bars - raw) + 8 * TC_STAGES);
  if (ring == 0) {
    if (threadIdx.x == 0) {
      for (int st = 0; st < TC_STAGES; ++st) {
        mbar_init(bars + 8 * st, 1);
        done[st] = 0;
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // part holds one slab's tensor-core sum; acc and carry (Kahan) take it in
  float part[64], carry[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = carry[e] = part[e] = 0.f;
  const int slabs = (kv + TC_BK - 1) / TC_BK;
  if (threadIdx.x == 0)
    for (int s = 0; s < TC_STAGES && s < slabs; ++s) {
      const int st = (ring + s) % TC_STAGES;
      tc_issue<SPLIT>(maps, base + st * TC_STAGE, bars + 8 * st, a_row, b_row,
                      s * TC_BK);
    }
  for (int s = 0; s < slabs; ++s) {
    const uint32_t g = ring + s;
    const int st = g % TC_STAGES;
    mbar_wait(bars + 8 * st, (g / TC_STAGES) & 1);
    const uint32_t a_big = base + st * TC_STAGE + wg * 64 * 128;
    const uint32_t b_big = base + st * TC_STAGE + 2 * TC_A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int grp = 0; grp < TC_BK / 8; ++grp) {
      // k group grp is 32 bytes into each 128-byte row
      const uint64_t da =
          make_desc(a_big + 32 * grp, 16, 1024) | SWIZZLE_128B;
      const uint64_t db =
          make_desc(b_big + 32 * grp, 16, 1024) | SWIZZLE_128B;
      // the slab's first product starts the sum afresh (scale_d = 0)
      if constexpr (SPLIT) {
        wgmma_tf32_m64n128k8(
            part, da + (TC_A_BYTES >> 4), db, grp > 0);     // A_small·B_big
        wgmma_tf32_m64n128k8(
            part, da, db + (TC_B_BYTES >> 4), 1);           // A_big·B_small
        wgmma_tf32_m64n128k8(part, da, db, 1);              // A_big·B_big
      } else {
        wgmma_tf32_m64n128k8(part, da, db, grp > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
    // The last of the 8 warps done with the stage loads slab s + STAGES
    // into it, so the warpgroups wait on no CTA barrier per slab.
    __syncwarp();
    if (threadIdx.x % 32 == 0 && atomicAdd(&done[st], 1) == 7) {
      atomicExch(&done[st], 0);
      if (s + TC_STAGES < slabs)
        tc_issue<SPLIT>(maps, base + st * TC_STAGE, bars + 8 * st, a_row,
                        b_row, (s + TC_STAGES) * TC_BK);
    }
    // The tensor cores' f32 sums need not round to nearest (NVIDIA's have
    // truncated), and over 4096 terms a truncating sum drifts far past f32
    // accuracy; so each slab's 12 products are summed there and the slabs
    // in f32 with Kahan's compensation.
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      const float y = part[e] - carry[e];
      const float sum = acc[e] + y;
      carry[e] = (sum - acc[e]) - y;
      acc[e] = sum;
    }
  }
  ring += slabs;
  __syncthreads();  // every warp is done with the stages
  // the f32 inf/NaN pattern where a row of A or a column of B is not finite
  // (unrolled: acc must stay in registers)
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const int gm = row0 + wg * 64 + tc_row(e), gn = col0 + tc_col(e);
    if (gm >= M || gn >= N || !(ld_raw(t.a_bad + gm) | ld_raw(t.b_bad + gn)))
      continue;
    bool nan = false, pos = false, neg = false;
#pragma unroll 1
    for (int k = 0; k < kv; ++k) {
      const float x = ld_f(A + static_cast<size_t>(gm) * K + k) *
                      ld_f(B + static_cast<size_t>(k) * N + gn);
      nan |= x != x;
      pos |= x == pinf();
      neg |= x == ninf();
    }
    if (nan || (pos && neg))
      acc[e] = qnan();
    else if (pos)
      acc[e] = pinf();
    else if (neg)
      acc[e] = ninf();
  }
}

}  // namespace simd2
