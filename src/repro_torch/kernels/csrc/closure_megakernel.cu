// The fused closure fixpoint for Hopper: up to g_steps iterations of
// C ← C ⊕ (C ⊗ C) (Leyzorek) or D ← D ⊕ (D ⊗ A) (Bellman-Ford) per launch,
// over an (R, n, n) stack of requests, with the per-request convergence test
// on the card.
//
// Replaces repro/kernels/closure_megakernel.py::_chunk_call (the Pallas TPU
// kernel behind fixpoint_chunk and megakernel_fixpoint).
//
// What bounds it.  Each iteration is one full contraction per live request:
// 2·n²·kv ring operations on the CUDA cores (no tensor-core form for the
// min/max rings) against 3·n² elements of traffic, so at the served sizes
// (n = 200 … 4096) it is bound by instruction issue, like K1.  What the TPU
// kernel fused away — one host round trip per iteration to learn whether any
// request still changes — is the part this kernel removes: the host waits
// once per launch, not once per iteration.
//
// What the design does about it.  One cooperative, persistent launch: the
// grid is as many 256-thread CTAs as the card holds at once (occupancy × SM
// count, cudaLaunchCooperativeKernel), and in each iteration they
// grid-stride over the (request, 64×64 output tile) pairs of the requests
// that are live, act[r] != 0 and step < glim[r].  A tile is contracted by
// the same routine K1 uses (semiring_ring.cuh), with K bounded by kv[r], so
// each step computes K1's bits — mma included.  A tile reads the current
// buffer and writes the other one (a tile of step s+1 reads every row of
// step s, so an in-place update would be wrong), and ORs whether any of its
// elements changed into a per-request flag, with the NaN-aware compare of
// core.closure._same.  Then grid.sync(); block 0 advances it[r] and sets
// act[r] for the requests that were live, clears the flags and decides
// whether any request is live for the next step; grid.sync() again.  A
// request that is not live writes nothing, so its iterate stays in the
// buffer of its last step; after the loop each request's final iterate is
// copied into out when it lies elsewhere.  Keeping the iterate in shared
// memory or in a thread-block cluster is later speed work.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// given stream, allocates nothing (the caller passes out, scratch and an
// int32 workspace of 2·R + 1), does not synchronise, and returns the
// cooperative launch's error code (or -1 for a ring/dtype pair it does not
// take, -2 when no CTA fits on an SM).

#include <cooperative_groups.h>

#include "semiring_ring.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace simd2;

__device__ __forceinline__ bool live(const int* act, const int* glim, int r,
                                     int step) {
  return reinterpret_cast<const volatile int*>(act)[r] != 0 &&
         step < glim[r];
}

// Block 0, after a grid.sync(): for every request live at `step`, count the
// step and set its active flag from the step's changed flag; then publish
// whether any request is live at `next`.
__device__ void advance(int* act, int* it, const int* glim, int* changed,
                        int* steps, int* any_live, int R, int step,
                        int next) {
  int any = 0;
  for (int r = threadIdx.x; r < R; r += THREADS) {
    if (step >= 0 && act[r] != 0 && step < glim[r]) {
      act[r] = changed[r] != 0 ? 1 : 0;
      it[r] += 1;
      steps[r] += 1;
    }
    changed[r] = 0;
    any |= (act[r] != 0 && next < glim[r]) ? 1 : 0;
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) *any_live = any;
}

// Buffers are not __restrict__: the iterate written in one step is read by
// other CTAs in the next, after a grid.sync(), so no read may go through the
// non-coherent read-only path.
template <int OP, typename T>
__global__ void __launch_bounds__(THREADS)
    fixpoint_kernel(const T* src, const T* adj, T* out, T* scratch,
                    const int* __restrict__ kv, int* act, int* it,
                    const int* __restrict__ glim, int* work, int R, int n,
                    int g_steps) {
  using Rg = Ring<OP>;
  __shared__ __align__(16) float As[BK][AS_STRIDE];
  __shared__ __align__(16) float Bs[BK][BN];
  cg::grid_group grid = cg::this_grid();
  int* changed = work;
  int* steps = work + R;
  int* any_live = work + 2 * R;
  const int tiles_n = (n + BN - 1) / BN;
  const long long tiles = (long long)tiles_n * tiles_n;
  const long long items = (long long)R * tiles;
  const size_t nn = (size_t)n * n;
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);

  if (blockIdx.x == 0) {
    for (int r = threadIdx.x; r < R; r += THREADS) steps[r] = 0;
    advance(act, it, glim, changed, steps, any_live, R, -1, 0);
  }
  grid.sync();

  for (int s = 0; s < g_steps; ++s) {
    if (*reinterpret_cast<volatile int*>(any_live) == 0) break;
    // step s reads src (s = 0) or the buffer step s-1 wrote, and writes the
    // other one: scratch for even s, out for odd s
    const T* cur = s == 0 ? src : ((s & 1) ? scratch : out);
    T* nxt = (s & 1) ? out : scratch;
    for (long long item = blockIdx.x; item < items; item += gridDim.x) {
      const int r = (int)(item / tiles);
      if (!live(act, glim, r, s)) continue;  // uniform across the block
      const int t = (int)(item % tiles);
      const int row0 = (t / tiles_n) * BM;
      const int col0 = (t % tiles_n) * BN;
      int k = kv[r];
      k = k < 0 ? 0 : (k > n ? n : k);
      const T* c_r = cur + (size_t)r * nn;
      const T* b_r = (adj != nullptr ? adj : cur) + (size_t)r * nn;
      T* d_r = nxt + (size_t)r * nn;
      float acc[TM][TN];
      contract_tile<OP>(c_r, b_r, n, n, n, k, row0, col0, As, Bs, acc);
      int diff = 0;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int gm = row0 + ty * TM + i;
        if (gm >= n) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int gn = col0 + tx * TN + j;
          if (gn >= n) continue;
          const size_t at = (size_t)gm * n + gn;
          const float old = to_f(c_r[at]);
          const float nv = store(&d_r[at], Rg::oplus(acc[i][j], old));
          // ±inf equal to itself, NaN staying NaN: unchanged (_same)
          diff |= !(nv == old || (nv != nv && old != old));
        }
      }
      if (__syncthreads_or(diff) && threadIdx.x == 0)
        atomicOr(&changed[r], 1);
    }
    grid.sync();
    if (blockIdx.x == 0)
      advance(act, it, glim, changed, steps, any_live, R, s, s + 1);
    grid.sync();
  }

  // A request that ran `st` steps holds its iterate in src (st = 0), in
  // scratch (st odd) or already in out (st even, > 0).
  const size_t gtid = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const size_t gsize = (size_t)gridDim.x * THREADS;
  for (int r = 0; r < R; ++r) {
    const int st = reinterpret_cast<const volatile int*>(steps)[r];
    const T* from = st == 0 ? src : ((st & 1) ? scratch : nullptr);
    if (from == nullptr || from == out) continue;
    const size_t base = (size_t)r * nn;
    for (size_t e = gtid; e < nn; e += gsize) out[base + e] = from[base + e];
  }
}

template <int OP, typename T>
int launch(const void* src, const void* adj, void* out, void* scratch,
           const void* kv, void* act, void* it, const void* glim, void* work,
           int R, int n, int g_steps, cudaStream_t stream) {
  auto kernel = fixpoint_kernel<OP, T>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return -2;
  const long long tiles_n = (n + BN - 1) / BN;
  long long items = (long long)R * tiles_n * tiles_n;
  long long grid = (long long)per_sm * sms;
  if (items < grid) grid = items < 1 ? 1 : items;

  const T* src_t = static_cast<const T*>(src);
  const T* adj_t = static_cast<const T*>(adj);
  T* out_t = static_cast<T*>(out);
  T* scratch_t = static_cast<T*>(scratch);
  const int* kv_t = static_cast<const int*>(kv);
  int* act_t = static_cast<int*>(act);
  int* it_t = static_cast<int*>(it);
  const int* glim_t = static_cast<const int*>(glim);
  int* work_t = static_cast<int*>(work);
  void* args[] = {&src_t, &adj_t, &out_t, &scratch_t, &kv_t, &act_t,
                  &it_t,  &glim_t, &work_t, &R,    &n,    &g_steps};
  e = cudaLaunchCooperativeKernel((const void*)kernel,
                                  dim3((unsigned)grid), dim3(THREADS), args,
                                  0, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// f32 for every ring with a ⊗-identity; bf16 for the min/max rings (mma's
// iterate is f32 whatever its input); {0,1} bytes for orand.
template <int OP>
int launch_ring(int dtype, const void* src, const void* adj, void* out,
                void* scratch, const void* kv, void* act, void* it,
                const void* glim, void* work, int R, int n, int g_steps,
                cudaStream_t s) {
  if constexpr (OP == ORAND) {
    if (dtype == U8)
      return launch<OP, uint8_t>(src, adj, out, scratch, kv, act, it, glim,
                                 work, R, n, g_steps, s);
  } else {
    if (dtype == F32)
      return launch<OP, float>(src, adj, out, scratch, kv, act, it, glim,
                               work, R, n, g_steps, s);
    if constexpr (OP != MMA) {
      if (dtype == BF16)
        return launch<OP, __nv_bfloat16>(src, adj, out, scratch, kv, act, it,
                                         glim, work, R, n, g_steps, s);
    }
  }
  return -1;
}

}  // namespace

extern "C" int simd2_closure_fixpoint(int op, int dtype, const void* src,
                                      const void* adj, void* out,
                                      void* scratch, const void* kv,
                                      void* act, void* it, const void* glim,
                                      void* work, int R, int n, int g_steps,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SIMD2_CASE(OPC)                                                      \
  case OPC:                                                                  \
    return launch_ring<OPC>(dtype, src, adj, out, scratch, kv, act, it,      \
                            glim, work, R, n, g_steps, s);
  switch (op) {
    SIMD2_CASE(MMA)
    SIMD2_CASE(MINPLUS)
    SIMD2_CASE(MAXPLUS)
    SIMD2_CASE(MINMUL)
    SIMD2_CASE(MAXMUL)
    SIMD2_CASE(MINMAX)
    SIMD2_CASE(MAXMIN)
    SIMD2_CASE(ORAND)
    default:
      return -1;  // addnorm has no ⊗-identity: no closure
  }
#undef SIMD2_CASE
}
