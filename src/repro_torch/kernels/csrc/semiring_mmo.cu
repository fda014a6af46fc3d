// The SIMD² unit for Hopper: D = C ⊕ (A ⊗ B) for all nine SIMD² rings.
//
// Replaces repro/kernels/semiring_mmo.py::semiring_mmo, the Pallas TPU
// kernel (batched over requests by repro/kernels/ops.py::semiring_mmo).
//
// What bounds it.  The min/max rings (minplus, maxplus, minmul, maxmul,
// minmax, maxmin), addnorm and orand have no tensor-core form here: every
// (i, j, k) term costs two instructions on the CUDA cores (an ⊗ and an ⊕;
// Hopper has no fused f32 add-min), about 2·M·N·K instructions per call
// against only (MK + KN + 2MN) elements of memory traffic, so at the main
// path's shapes (n = 256 … 4096) they are bound by instruction issue, not
// by device memory.  mma runs on the tensor cores at TF32 rate, three
// products per term for f32 accuracy (3×TF32): 3·2·M·N·K operations.
//
// What the design does about it.  The two tile routines of
// semiring_ring.cuh, shared with the fused closure kernel:
//   - mma: a split pass writes A's and B's big and small TF32 parts (B
//     transposed, K-major) to a workspace, one CTA per 32-row or 32-column
//     strip; then one CTA of two warpgroups per (request, 128×128 tile)
//     takes 32-deep slabs of them by TMA into the 128-byte swizzle, three
//     stages deep (the last warp done with a stage loads the next slab into
//     it: no CTA barrier per slab), and each warpgroup issues
//     wgmma.m64n128k8 TF32 on its 64×128 half (contract_tc).  Splitting
//     inside the tile loop, by the threads of each CTA, took most of the
//     kernel's time (PERF.md);
//   - the other rings: one CTA of 256 threads per (request, 128×128 tile)
//     with an 8×8 register tile per thread, K slabs double-buffered with
//     cp.async (contract_cc).  Where 128×128 tiles would cover fewer than
//     two waves of the card's resident CTAs (the ragged 8×256 bucket, GTC
//     1024), the 64×64 instance of the same routine (4×4 per thread) runs
//     instead; the bits are the same.
// The request is blockIdx.z.  The K loop runs ceil(k_valid[r] / BK) slabs —
// the GPU form of the TPU kernel's pl.when skip of dead K blocks — and
// lanes at or past K or k_valid hold the ring's contraction pads (0 for
// mma), so they contribute nothing.  C is folded in the epilogue.
//
// Numerics.  Values are widened to f32; ⊗ and ⊕ run in f32 and the result
// is rounded once at the store.  For the min/max rings with bf16 in and
// bf16 out that is bit-identical to rounding each ⊗ then taking the
// min/max in bf16, because rounding is monotone.  float16 comes to this
// kernel widened to f32 by the wrapper, which rounds the result once: for
// + and × that equals f16 arithmetic, as f32's 24 bits are at least
// 2·11 + 2.  int32 runs the min/max rings in int32 instances, ⊗ wrapping
// in two's complement; mma and addnorm take it widened to f32.  min/max propagate NaN
// (min.NaN / max.NaN), as jnp.minimum / torch.minimum do, so a NaN edge
// weight stays visible to the closure's convergence compare.  mma in f32
// holds to about f32 accuracy (3×TF32; non-finite inputs give the f32
// product's inf/NaN pattern); bf16 mma inputs are exact in TF32 and take
// one product per k group.
//
// addnorm is the ring's own ⊗: Σ(a−b)², accumulated directly.  The
// reference's ‖a‖²−2ab+‖b‖² rewrite cancels catastrophically when the
// coordinates are large (about 1e6 in f32), which is why the reference's
// large-coordinate KNN test fails; this kernel does not copy that rewrite.
//
// Interface: plain C functions, loaded with ctypes.  simd2_semiring_mmo
// launches on the given stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError() after the launch (or -1 for an op/dtype
// pair it does not take).  mma needs a workspace for its split operands,
// simd2_semiring_mmo_workspace bytes (none for the other rings).
// simd2_semiring_mmo_tile reports the output tile a launch of that shape
// takes.

#include <type_traits>

#include "semiring_ring.cuh"

namespace {

using namespace simd2;

template <int OP, typename TIn, typename TOut, int TM>
__global__ void __launch_bounds__(THREADS)
    semiring_mmo_kernel(const TIn* __restrict__ A, const TIn* __restrict__ B,
                        const TOut* __restrict__ C,
                        const int* __restrict__ KV, TOut* __restrict__ D,
                        int M, int K, int N) {
  using V = val_t<TIn>;
  using R = Ring<OP, V>;
  using Tl = CcTile<TM>;
  __shared__ __align__(16) TIn smem[2 * Tl::STAGE];

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
  const int row0 = blockIdx.y * Tl::BM;
  const int col0 = blockIdx.x * Tl::BM;

  V acc[TM][TM];
  contract_cc<OP, TIn, TM>(A, B, M, K, N, kv, row0, col0,
                           cc_vec(A, B, K, N), smem, acc);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  // f32 rows of whole 16-byte chunks: each thread's 4 consecutive columns
  // go out (and C comes in) as one 16-byte access
  constexpr bool F32_OUT = std::is_same_v<TOut, float>;
  const bool vec = F32_OUT && N % 4 == 0 && aligned16(D) &&
                   (C == nullptr || aligned16(C));
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + Tl::off(i, ty);
    if (gm >= M) continue;
#pragma unroll
    for (int j4 = 0; j4 < TM; j4 += 4) {
      const int gn = col0 + Tl::off(j4, tx);
      const size_t at = (size_t)gm * N + gn;
      if constexpr (F32_OUT) {
        if (vec && gn + 3 < N) {
          float4 v = make_float4(acc[i][j4], acc[i][j4 + 1], acc[i][j4 + 2],
                                 acc[i][j4 + 3]);
          if (C != nullptr) {
            const float4 c = *reinterpret_cast<const float4*>(C + at);
            v = make_float4(R::oplus(v.x, c.x), R::oplus(v.y, c.y),
                            R::oplus(v.z, c.z), R::oplus(v.w, c.w));
          }
          *reinterpret_cast<float4*>(D + at) = v;
          continue;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (gn + q >= N) continue;
        V v = acc[i][j4 + q];
        if (C != nullptr) v = R::oplus(v, to_v(C[at + q]));
        store(&D[at + q], v);
      }
    }
  }
}

// mma, the split pass: A and B into big and small TF32 parts, B transposed
// (tc_split_strip), one 32-row or 32-column strip per CTA.
template <typename TIn>
__global__ void __launch_bounds__(THREADS)
    semiring_mma_split_kernel(const TIn* __restrict__ A,
                              const TIn* __restrict__ B,
                              const int* __restrict__ KV, void* ws, int R,
                              int M, int K, int N) {
  const int r = blockIdx.y;
  int kv = K;
  if (KV != nullptr) {
    kv = KV[r];
    kv = kv < 0 ? 0 : (kv > K ? K : kv);
  }
  tc_split_strip<TIn>(A + (size_t)r * M * K, B + (size_t)r * K * N, M, K, N,
                      kv, tc_split_at(ws, R, r, M, N, K), blockIdx.x);
}

// mma on the tensor cores, from the split operands; f32 out whatever the
// input type.
template <typename TIn>
__global__ void __launch_bounds__(THREADS)
    semiring_mma_tc_kernel(const __grid_constant__ TcMaps maps,
                           const TIn* __restrict__ A,
                           const TIn* __restrict__ B,
                           const float* __restrict__ C,
                           const int* __restrict__ KV, void* ws,
                           float* __restrict__ D, int R, int M, int K,
                           int N) {
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const size_t r = blockIdx.z;
  int kv = K;
  if (KV != nullptr) {
    kv = KV[r];
    kv = kv < 0 ? 0 : (kv > K ? K : kv);
  }
  A += r * (size_t)M * K;
  B += r * (size_t)K * N;
  D += r * (size_t)M * N;
  if (C != nullptr) C += r * (size_t)M * N;
  const int row0 = blockIdx.y * TC_BM;
  const int col0 = blockIdx.x * TC_BN;

  float acc[64];
  uint32_t ring = 0;
  contract_tc<sizeof(TIn) == 4>(A, B, tc_split_at(ws, R, (int)r, M, N, K),
                                maps, M, K, N, kv, row0, col0,
                                (int)r * M + row0, (int)r * N + col0,
                                tc_smem, ring, acc);

  const int wg = threadIdx.x / 128;
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const int gm = row0 + wg * 64 + tc_row(e), gn = col0 + tc_col(e);
    if (gm >= M || gn >= N) continue;
    const size_t at = (size_t)gm * N + gn;
    D[at] = C != nullptr ? Ring<MMA>::oplus(acc[e], C[at]) : acc[e];
  }
}

template <int OP>
using OpC = std::integral_constant<int, OP>;
template <typename T>
struct Tag {
  using type = T;
};

// Calls f(OpC<op>, Tag<TIn>, Tag<TOut>) for the instance that takes
// (op, dtype): f32 in → f32 out; bf16 in → bf16 out for the min/max rings
// (they keep the input dtype) and f32 out for mma and addnorm (they widen);
// int32 in → int32 out for the min/max rings; {0,1} bytes for orand.  -1
// for a pair no instance takes (float16, and int32 for mma and addnorm,
// arrive widened to f32).
template <typename F>
int dispatch(int op, int dtype, F&& f) {
  using bf16 = __nv_bfloat16;
#define SIMD2_WIDE_RING(OPC)                                                \
  case OPC:                                                                 \
    if (dtype == F32) return f(OpC<OPC>{}, Tag<float>{}, Tag<float>{});     \
    if (dtype == BF16) return f(OpC<OPC>{}, Tag<bf16>{}, Tag<float>{});     \
    return -1;
#define SIMD2_MINMAX_RING(OPC)                                              \
  case OPC:                                                                 \
    if (dtype == F32) return f(OpC<OPC>{}, Tag<float>{}, Tag<float>{});     \
    if (dtype == BF16) return f(OpC<OPC>{}, Tag<bf16>{}, Tag<bf16>{});      \
    if (dtype == I32) return f(OpC<OPC>{}, Tag<int>{}, Tag<int>{});         \
    return -1;
  switch (op) {
    SIMD2_WIDE_RING(MMA)
    SIMD2_MINMAX_RING(MINPLUS)
    SIMD2_MINMAX_RING(MAXPLUS)
    SIMD2_MINMAX_RING(MINMUL)
    SIMD2_MINMAX_RING(MAXMUL)
    SIMD2_MINMAX_RING(MINMAX)
    SIMD2_MINMAX_RING(MAXMIN)
    SIMD2_WIDE_RING(ADDNORM)
    case ORAND:
      if (dtype == U8) return f(OpC<ORAND>{}, Tag<uint8_t>{}, Tag<uint8_t>{});
      return -1;
    default:
      return -1;
  }
#undef SIMD2_WIDE_RING
#undef SIMD2_MINMAX_RING
}

// The register tile of a CUDA-core launch: 8 (128×128) where R·⌈M/128⌉·
// ⌈N/128⌉ tiles cover at least two waves of resident CTAs, else 4 (64×64).
template <int OP, typename TIn, typename TOut>
cudaError_t cc_tm(int R, int M, int N, int* tm) {
  int resident = 0;
  const cudaError_t e =
      resident_ctas<semiring_mmo_kernel<OP, TIn, TOut, 8>>(0, &resident);
  const long long tiles =
      (long long)R * ((M + 127) / 128) * ((N + 127) / 128);
  *tm = tiles >= 2LL * resident ? 8 : 4;
  return e;
}

template <int OP, typename TIn, typename TOut, int TM>
int launch_cc(const void* a, const void* b, const void* c, const void* kv,
              void* d, int R, int M, int K, int N, cudaStream_t stream) {
  constexpr int BM = CcTile<TM>::BM;
  const dim3 grid((N + BM - 1) / BM, (M + BM - 1) / BM, R);
  semiring_mmo_kernel<OP, TIn, TOut, TM><<<grid, THREADS, 0, stream>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b),
      static_cast<const TOut*>(c), static_cast<const int*>(kv),
      static_cast<TOut*>(d), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename TIn>
int launch_tc(const void* a, const void* b, const void* c, const void* kv,
              void* d, void* ws, int R, int M, int K, int N,
              cudaStream_t stream) {
  auto kernel = semiring_mma_tc_kernel<TIn>;
  int resident = 0;  // sets the kernel's shared-memory limit, once
  const cudaError_t e =
      resident_ctas<semiring_mma_tc_kernel<TIn>>(TC_SMEM_BYTES, &resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  TcMaps maps;
  const int rc = tc_make_maps(&maps, ws, R, M, N, K);
  if (rc != 0) return rc;
  semiring_mma_split_kernel<TIn>
      <<<dim3(tc_split_items(M, N), R), THREADS, 0, stream>>>(
          static_cast<const TIn*>(a), static_cast<const TIn*>(b),
          static_cast<const int*>(kv), ws, R, M, K, N);
  const dim3 grid((N + TC_BN - 1) / TC_BN, (M + TC_BM - 1) / TC_BM, R);
  kernel<<<grid, THREADS, TC_SMEM_BYTES, stream>>>(
      maps, static_cast<const TIn*>(a), static_cast<const TIn*>(b),
      static_cast<const float*>(c), static_cast<const int*>(kv), ws,
      static_cast<float*>(d), R, M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int simd2_semiring_mmo(int op, int dtype, const void* a,
                                  const void* b, const void* c,
                                  const void* k_valid, void* d,
                                  void* workspace, int R, int M, int K, int N,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(op, dtype, [&](auto opc, auto tin, auto tout) -> int {
    constexpr int OP = decltype(opc)::value;
    using TIn = typename decltype(tin)::type;
    using TOut = typename decltype(tout)::type;
    if constexpr (OP == MMA) {
      if (workspace == nullptr) return -1;
      return launch_tc<TIn>(a, b, c, k_valid, d, workspace, R, M, K, N, s);
    } else {
      int tm = 4;
      const cudaError_t e = cc_tm<OP, TIn, TOut>(R, M, N, &tm);
      if (e != cudaSuccess) return static_cast<int>(e);
      return tm == 8
                 ? launch_cc<OP, TIn, TOut, 8>(a, b, c, k_valid, d, R, M, K,
                                               N, s)
                 : launch_cc<OP, TIn, TOut, 4>(a, b, c, k_valid, d, R, M, K,
                                               N, s);
    }
  });
}

// tile[0], tile[1] = the output tile (rows, columns) that a launch of
// (op, dtype) at R × M × N takes.
extern "C" int simd2_semiring_mmo_tile(int op, int dtype, int R, int M, int N,
                                       int* tile) {
  return dispatch(op, dtype, [&](auto opc, auto tin, auto tout) -> int {
    constexpr int OP = decltype(opc)::value;
    using TIn = typename decltype(tin)::type;
    using TOut = typename decltype(tout)::type;
    if constexpr (OP == MMA) {
      tile[0] = TC_BM;
      tile[1] = TC_BN;
      return 0;
    } else {
      int tm = 4;
      const cudaError_t e = cc_tm<OP, TIn, TOut>(R, M, N, &tm);
      tile[0] = tile[1] = 16 * tm;
      return static_cast<int>(e);
    }
  });
}

// Bytes of workspace a launch of op at R × M × K × N needs.
extern "C" long long simd2_semiring_mmo_workspace(int op, int R, int M, int K,
                                                  int N) {
  return op == MMA ? (long long)R * (long long)tc_workspace_bytes(M, N, K)
                   : 0;
}
