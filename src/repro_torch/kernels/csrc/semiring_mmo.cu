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
// The ring traits and the tile contraction live in semiring_ring.cuh, shared
// with the fused closure kernel (closure_megakernel.cu).
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() after the launch (or -1 for an op/dtype pair it does
// not take).

#include "semiring_ring.cuh"

namespace {

using namespace simd2;

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

  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
  contract_tile<OP>(A, B, M, K, N, kv, row0, col0, As, Bs, acc);

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
