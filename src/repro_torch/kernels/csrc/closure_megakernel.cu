// The fused closure fixpoint for Hopper: up to g_steps iterations of
// C ← C ⊕ (C ⊗ C) (Leyzorek) or D ← D ⊕ (D ⊗ A) (Bellman-Ford) per launch,
// over an (R, n, n) stack of requests, with the per-request convergence test
// on the card.
//
// Replaces repro/kernels/closure_megakernel.py::_chunk_call (the Pallas TPU
// kernel behind fixpoint_chunk and megakernel_fixpoint).
//
// What bounds it.  Each iteration is one full contraction per live request:
// 2·n²·kv ring terms, two CUDA-core instructions each for the min/max rings
// and orand (3·2·n²·kv TF32 operations on the tensor cores for mma), against
// 3·n² elements of traffic, so at the served sizes (n = 200 … 4096) it is
// bound by instruction issue, like K1.  What the TPU
// kernel fused away — one host round trip per iteration to learn whether any
// request still changes — is the part this kernel removes: the host waits
// once per launch, not once per iteration.
//
// What the design does about it.  One cooperative, persistent launch: the
// grid is as many 256-thread CTAs as the card holds at once (occupancy × SM
// count, cudaLaunchCooperativeKernel), and in each iteration they
// grid-stride over the (request, output tile) pairs of the requests that
// are live, act[r] != 0 and step < glim[r].  A tile is contracted by the
// routines K1 uses (semiring_ring.cuh), with K bounded by kv[r], so each
// step computes K1's bits — mma included: an mma step first splits the
// live requests' operands as K1 does (tc_split_strip, behind a third grid
// barrier), then its tiles are 128×128 on the tensor cores (contract_tc,
// 3×TF32); the other rings' tiles are 128×128 or 64×64 on the CUDA cores
// (contract_cc), chosen each step by K1's rule applied to the live tiles
// (128×128 where they cover at least two waves of the grid's CTAs).  A tile
// reads the current buffer and writes the other one (a tile of step s+1
// reads every row of step s, so an in-place update would be wrong), and ORs
// whether any of its elements changed into a per-request flag, with the
// NaN-aware compare of core.closure._same.  Then grid.sync(); block 0
// advances it[r] and sets act[r] for the requests that were live, clears
// the flags and counts the requests live for the next step; grid.sync()
// again.  A request that is not live writes nothing, so
// its iterate stays in the buffer of its last step; after the loop each
// request's final iterate is copied into out when it lies elsewhere.
// Keeping the iterate in shared memory or in a thread-block cluster is
// later speed work.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// given stream, allocates nothing (the caller passes out, scratch and an
// int32 workspace of 2·R + 2 and, for mma, the tensor-core workspace of
// simd2_closure_fixpoint_workspace bytes), does not synchronise, returns the
// cooperative launch's error code (or -1 for a ring/dtype pair it does not
// take, -2 when no CTA fits on an SM).  simd2_closure_fixpoint_tile reports
// the output tile a step with a given number of live requests takes.

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
// how many requests are live at `next`.
__device__ void advance(int* act, int* it, const int* glim, int* changed,
                        int* steps, int* n_live, int R, int step, int next) {
  __shared__ int total;
  if (threadIdx.x == 0) total = 0;
  __syncthreads();
  int count = 0;
  for (int r = threadIdx.x; r < R; r += THREADS) {
    if (step >= 0 && act[r] != 0 && step < glim[r]) {
      act[r] = changed[r] != 0 ? 1 : 0;
      it[r] += 1;
      steps[r] += 1;
    }
    changed[r] = 0;
    count += (act[r] != 0 && next < glim[r]) ? 1 : 0;
  }
  if (count > 0) atomicAdd(&total, count);
  __syncthreads();
  if (threadIdx.x == 0) *n_live = total;
}

// The NaN-aware compare of core.closure._same: ±inf equal to itself, NaN
// staying NaN, count as unchanged.
__device__ __forceinline__ bool moved(float nv, float old) {
  return !(nv == old || (nv != nv && old != old));
}

// One step's tiles of the CUDA-core rings at register tile TM: every
// (live request, (16·TM)² tile) pair this CTA's stride reaches.
template <int OP, typename T, int TM>
__device__ void cc_step(const T* cur, const T* adj, T* nxt, const int* kv,
                        const int* act, const int* glim, int* changed, int R,
                        int n, int s, T* smem) {
  using Rg = Ring<OP>;
  using Tl = CcTile<TM>;
  const int tiles_n = (n + Tl::BM - 1) / Tl::BM;
  const long long tiles = (long long)tiles_n * tiles_n;
  const long long items = (long long)R * tiles;
  const size_t nn = (size_t)n * n;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int r = (int)(item / tiles);
    if (!live(act, glim, r, s)) continue;  // uniform across the block
    const int t = (int)(item % tiles);
    const int row0 = (t / tiles_n) * Tl::BM;
    const int col0 = (t % tiles_n) * Tl::BM;
    int k = kv[r];
    k = k < 0 ? 0 : (k > n ? n : k);
    const T* c_r = cur + (size_t)r * nn;
    const T* b_r = (adj != nullptr ? adj : cur) + (size_t)r * nn;
    T* d_r = nxt + (size_t)r * nn;
    float acc[TM][TM];
    contract_cc<OP, T, TM>(c_r, b_r, n, n, n, k, row0, col0,
                           cc_vec(c_r, b_r, n, n), smem, acc);
    // f32 rows of whole 16-byte chunks: each thread's 4 consecutive
    // columns come in and go out as one 16-byte access
    const bool vec = sizeof(T) == 4 && n % 4 == 0 && aligned16(c_r) &&
                     aligned16(d_r);
    int diff = 0;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = row0 + Tl::off(i, ty);
      if (gm >= n) continue;
#pragma unroll
      for (int j4 = 0; j4 < TM; j4 += 4) {
        const int gn = col0 + Tl::off(j4, tx);
        const size_t at = (size_t)gm * n + gn;
        if constexpr (sizeof(T) == 4) {
          if (vec && gn + 3 < n) {
            const float4 o = __ldcg(reinterpret_cast<const float4*>(c_r + at));
            const float4 v = make_float4(
                Rg::oplus(acc[i][j4], o.x), Rg::oplus(acc[i][j4 + 1], o.y),
                Rg::oplus(acc[i][j4 + 2], o.z), Rg::oplus(acc[i][j4 + 3], o.w));
            *reinterpret_cast<float4*>(d_r + at) = v;
            diff |= moved(v.x, o.x) | moved(v.y, o.y) | moved(v.z, o.z) |
                    moved(v.w, o.w);
            continue;
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (gn + q >= n) continue;
          const float old = ld_f(c_r + at + q);
          diff |= moved(store(&d_r[at + q], Rg::oplus(acc[i][j4 + q], old)),
                        old);
        }
      }
    }
    if (__syncthreads_or(diff) && threadIdx.x == 0) atomicOr(&changed[r], 1);
  }
}

// One step of mma: the split pass over the live requests' strips (their
// iterate as A, adj or the iterate as B), a grid barrier, then every (live
// request, 128×128 tile) pair this CTA's stride reaches, on the tensor cores.
__device__ void tc_step(const float* cur, const float* adj, float* nxt,
                        const int* kv, const int* act, const int* glim,
                        int* changed, void* ws, const TcMaps& maps, int R,
                        int n, int s, unsigned char* smem, uint32_t& ring,
                        cg::grid_group& grid) {
  const size_t nn = (size_t)n * n;
  const int strips = tc_split_items(n, n);
  for (long long w = blockIdx.x; w < (long long)R * strips; w += gridDim.x) {
    const int r = (int)(w / strips);
    if (!live(act, glim, r, s)) continue;  // uniform across the block
    int k = kv[r];
    k = k < 0 ? 0 : (k > n ? n : k);
    tc_split_strip<float>(cur + (size_t)r * nn,
                          (adj != nullptr ? adj : cur) + (size_t)r * nn, n, n,
                          n, k, tc_split_at(ws, R, r, n, n, n),
                          (int)(w % strips));
  }
  grid.sync();
  const int tiles_m = (n + TC_BM - 1) / TC_BM;
  const int tiles_n = (n + TC_BN - 1) / TC_BN;
  const long long tiles = (long long)tiles_m * tiles_n;
  const long long items = (long long)R * tiles;
  const int wg = threadIdx.x / 128;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int r = (int)(item / tiles);
    if (!live(act, glim, r, s)) continue;  // uniform across the block
    const int t = (int)(item % tiles);
    const int row0 = (t / tiles_n) * TC_BM;
    const int col0 = (t % tiles_n) * TC_BN;
    int k = kv[r];
    k = k < 0 ? 0 : (k > n ? n : k);
    const float* c_r = cur + (size_t)r * nn;
    const float* b_r = (adj != nullptr ? adj : cur) + (size_t)r * nn;
    float* d_r = nxt + (size_t)r * nn;
    float acc[64];
    contract_tc<true>(c_r, b_r, tc_split_at(ws, R, r, n, n, n), maps, n, n,
                      n, k, row0, col0, r * n + row0, r * n + col0, smem,
                      ring, acc);
    int diff = 0;
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      const int gm = row0 + wg * 64 + tc_row(e), gn = col0 + tc_col(e);
      if (gm >= n || gn >= n) continue;
      const size_t at = (size_t)gm * n + gn;
      const float old = ld_f(c_r + at);
      const float nv = Ring<MMA>::oplus(acc[e], old);
      d_r[at] = nv;
      diff |= moved(nv, old);
    }
    if (__syncthreads_or(diff) && threadIdx.x == 0) atomicOr(&changed[r], 1);
  }
}

// Dynamic shared memory of one CTA: mma's TF32 stages; the CUDA-core
// instances' two stages are static.
template <int OP>
constexpr int fixpoint_smem() {
  return OP == MMA ? TC_SMEM_BYTES : 0;
}

// The register tile of a step with `live` requests of size n on a grid of
// `resident` CTAs: 8 (128×128) where the live tiles cover at least two waves
// of the grid, else 4 (64×64) — K1's rule.
__host__ __device__ __forceinline__ int step_tm(int live, int n, int resident) {
  const long long side = (n + 127) / 128;
  const long long tiles = (long long)live * side * side;
  return tiles >= 2LL * resident ? 8 : 4;
}

// Buffers are not __restrict__: the iterate written in one step is read by
// other CTAs in the next, after a grid.sync(); their reads go through L2
// (ld.global.cg, cp.async.cg), never the non-coherent read-only path.
// MAXTM is the largest register tile of the CUDA-core rings' steps: an
// instance with 8 holds both tile routines and so needs as many registers
// as the 128×128 one, which halves the CTAs a small stack could use; the
// host launches it only where a step with every request live takes 128×128
// tiles, and the MAXTM = 4 instance (64×64 only) otherwise.
template <int OP, typename T, int MAXTM>
__global__ void __launch_bounds__(THREADS)
    fixpoint_kernel(const __grid_constant__ TcMaps maps, const T* src,
                    const T* adj, T* out, T* scratch,
                    const int* __restrict__ kv, int* act, int* it,
                    const int* __restrict__ glim, int* work, void* tc_ws,
                    int R, int n, int g_steps) {
  extern __shared__ __align__(1024) unsigned char dyn_smem[];
  __shared__ __align__(16) T
      cc_smem[OP == MMA ? 1 : 2 * CcTile<MAXTM>::STAGE];
  cg::grid_group grid = cg::this_grid();
  int* changed = work;
  int* steps = work + R;
  int* n_live = work + 2 * R;
  const size_t nn = (size_t)n * n;
  uint32_t ring = 0;  // slabs this CTA has taken through its TMA stages

  if (blockIdx.x == 0) {
    for (int r = threadIdx.x; r < R; r += THREADS) steps[r] = 0;
    advance(act, it, glim, changed, steps, n_live, R, -1, 0);
  }
  grid.sync();

  for (int s = 0; s < g_steps; ++s) {
    const int live_now = *reinterpret_cast<volatile int*>(n_live);
    if (live_now == 0) break;
    // step s reads src (s = 0) or the buffer step s-1 wrote, and writes the
    // other one: scratch for even s, out for odd s
    const T* cur = s == 0 ? src : ((s & 1) ? scratch : out);
    T* nxt = (s & 1) ? out : scratch;
    if constexpr (OP == MMA) {
      tc_step(cur, adj, nxt, kv, act, glim, changed, tc_ws, maps, R, n, s,
              dyn_smem, ring, grid);
    } else if constexpr (MAXTM == 8) {
      if (step_tm(live_now, n, gridDim.x) == 8)
        cc_step<OP, T, 8>(cur, adj, nxt, kv, act, glim, changed, R, n, s,
                          cc_smem);
      else
        cc_step<OP, T, 4>(cur, adj, nxt, kv, act, glim, changed, R, n, s,
                          cc_smem);
    } else {
      cc_step<OP, T, 4>(cur, adj, nxt, kv, act, glim, changed, R, n, s,
                        cc_smem);
    }
    grid.sync();
    if (blockIdx.x == 0)
      advance(act, it, glim, changed, steps, n_live, R, s, s + 1);
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
    for (size_t e = gtid; e < nn; e += gsize)
      out[base + e] = ld_raw(from + base + e);
  }
}

// CTAs of the cooperative grid of an instance: as many as the card holds at
// once, and no more than the largest step's tiles.
template <int OP, typename T, int MAXTM>
cudaError_t grid_ctas(int R, int n, int* resident, int* grid) {
  const cudaError_t e = resident_ctas<fixpoint_kernel<OP, T, MAXTM>>(
      fixpoint_smem<OP>(), resident);
  const long long items =
      OP == MMA ? (long long)R * ((n + TC_BM - 1) / TC_BM) *
                      ((n + TC_BN - 1) / TC_BN)
                : (long long)R * ((n + 63) / 64) * ((n + 63) / 64);
  *grid = (int)(items < *resident ? (items < 1 ? 1 : items) : *resident);
  return e;
}

// The instance a launch takes: mma's one, or the CUDA-core ring's with 128×128
// tiles where a step with all R requests live takes them.
template <int OP, typename T>
cudaError_t pick_maxtm(int R, int n, int* maxtm) {
  *maxtm = 4;
  if constexpr (OP == MMA) {
    return cudaSuccess;
  } else {
    int resident = 0, grid = 0;
    const cudaError_t e = grid_ctas<OP, T, 8>(R, n, &resident, &grid);
    if (step_tm(R, n, grid) == 8) *maxtm = 8;
    return e;
  }
}

template <int OP, typename T, int MAXTM>
int launch(const void* src, const void* adj, void* out, void* scratch,
           const void* kv, void* act, void* it, const void* glim, void* work,
           void* tc_ws, int R, int n, int g_steps, cudaStream_t stream) {
  if (OP == MMA && tc_ws == nullptr) return -1;
  auto kernel = fixpoint_kernel<OP, T, MAXTM>;
  int resident = 0, grid = 0;
  cudaError_t e = grid_ctas<OP, T, MAXTM>(R, n, &resident, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (resident < 1) return -2;
  TcMaps maps = {};
  if (OP == MMA) {
    const int rc = tc_make_maps(&maps, tc_ws, R, n, n, n);
    if (rc != 0) return rc;
  }
  const T* src_t = static_cast<const T*>(src);
  const T* adj_t = static_cast<const T*>(adj);
  T* out_t = static_cast<T*>(out);
  T* scratch_t = static_cast<T*>(scratch);
  const int* kv_t = static_cast<const int*>(kv);
  int* act_t = static_cast<int*>(act);
  int* it_t = static_cast<int*>(it);
  const int* glim_t = static_cast<const int*>(glim);
  int* work_t = static_cast<int*>(work);
  void* args[] = {&maps,  &src_t, &adj_t,  &out_t, &scratch_t,
                  &kv_t,  &act_t, &it_t,   &glim_t, &work_t,
                  &tc_ws, &R,     &n,      &g_steps};
  e = cudaLaunchCooperativeKernel((const void*)kernel,
                                  dim3((unsigned)grid), dim3(THREADS), args,
                                  fixpoint_smem<OP>(), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Calls f.template operator()<OP, T>() for the instance that takes
// (op, dtype): f32 for every ring with a ⊗-identity; bf16 for the min/max
// rings (mma's iterate is f32 whatever its input); {0,1} bytes for orand.
// -1 for a pair no instance takes (addnorm has no ⊗-identity: no closure).
template <typename F>
int dispatch(int op, int dtype, F&& f) {
#define SIMD2_MINMAX_RING(OPC)                                   \
  case OPC:                                                      \
    if (dtype == F32) return f.template run<OPC, float>();      \
    if (dtype == BF16) return f.template run<OPC, __nv_bfloat16>(); \
    return -1;
  switch (op) {
    case MMA:
      return dtype == F32 ? f.template run<MMA, float>() : -1;
    SIMD2_MINMAX_RING(MINPLUS)
    SIMD2_MINMAX_RING(MAXPLUS)
    SIMD2_MINMAX_RING(MINMUL)
    SIMD2_MINMAX_RING(MAXMUL)
    SIMD2_MINMAX_RING(MINMAX)
    SIMD2_MINMAX_RING(MAXMIN)
    case ORAND:
      return dtype == U8 ? f.template run<ORAND, uint8_t>() : -1;
    default:
      return -1;
  }
#undef SIMD2_MINMAX_RING
}

struct Launch {
  const void *src, *adj;
  void *out, *scratch;
  const void* kv;
  void *act, *it;
  const void* glim;
  void *work, *tc_ws;
  int R, n, g_steps;
  cudaStream_t stream;
  template <int OP, typename T>
  int run() const {
    int maxtm = 4;
    const cudaError_t e = pick_maxtm<OP, T>(R, n, &maxtm);
    if (e != cudaSuccess) return static_cast<int>(e);
    if constexpr (OP != MMA) {
      if (maxtm == 8)
        return launch<OP, T, 8>(src, adj, out, scratch, kv, act, it, glim,
                                work, tc_ws, R, n, g_steps, stream);
    }
    return launch<OP, T, 4>(src, adj, out, scratch, kv, act, it, glim, work,
                            tc_ws, R, n, g_steps, stream);
  }
};

struct Tile {
  int live, n;
  int* tile;
  template <int OP, typename T>
  int run() const {
    if (OP == MMA) {
      tile[0] = TC_BM;
      tile[1] = TC_BN;
      return 0;
    }
    int maxtm = 4;
    const cudaError_t e = pick_maxtm<OP, T>(live, n, &maxtm);
    tile[0] = tile[1] = 16 * maxtm;
    return static_cast<int>(e);
  }
};

}  // namespace

extern "C" int simd2_closure_fixpoint(int op, int dtype, const void* src,
                                      const void* adj, void* out,
                                      void* scratch, const void* kv,
                                      void* act, void* it, const void* glim,
                                      void* work, void* tc_workspace, int R,
                                      int n, int g_steps, void* stream) {
  return dispatch(op, dtype,
                  Launch{src, adj, out, scratch, kv, act, it, glim, work,
                         tc_workspace, R, n, g_steps,
                         static_cast<cudaStream_t>(stream)});
}

// Bytes of tensor-core workspace a launch of op on an (R, n, n) stack needs.
extern "C" long long simd2_closure_fixpoint_workspace(int op, int R, int n) {
  return op == MMA ? (long long)R * (long long)tc_workspace_bytes(n, n, n)
                   : 0;
}

// tile[0], tile[1] = the output tile (rows, columns) of a step of a stack
// of R requests of size n, all of them live.
extern "C" int simd2_closure_fixpoint_tile(int op, int dtype, int R, int n,
                                           int* tile) {
  return dispatch(op, dtype, Tile{R, n, tile});
}
