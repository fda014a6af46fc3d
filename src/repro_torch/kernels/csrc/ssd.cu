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
// widened to f32 when staged; y (BZ, H, Q, P) is f32.  Head h reads C and B
// of group h / (H / G) (G == H is the TPU kernel's per-head call), so the
// group expansion is never materialised.  Every tensor comes with its
// element strides over (z, head, q); C, B, X and Y have unit stride on their
// last axis, so the caller's (B, nc, Q, H, ·) layout is read and written in
// place.  The weight of a pair is formed in the TPU kernel's order,
// (score · decay) · dt; above the diagonal it is a select to 0, never a
// product with a 0 mask: there cum_q − cum_k ≥ 0 and exp may overflow to
// +inf, and inf · 0 is NaN.
//
// What bounds it.  At the mamba2-780m prefill (BZ 4·8, H 48, G 1, Q 256,
// N 128, P 64, f32) the causal work per (q, k ≤ q) pair is 2·N flops for
// the score, once per group (the group's 48 heads share C Bᵀ), and 2·P
// flops per head: 6.74e9 flops.  At f32 accuracy on the tensor cores each
// product is three TF32 products (below), 0.041 ms at the 495e12 TF32 rate;
// the 5.05e7 exps take 0.012 ms at the SFU rate; the bytes (C and B once per
// group; X, dt, cum and the f32 Y once per head: 212.9 MB) take 0.0635 ms at
// 3.35 TB/s.  So the bound is set by bytes; at the f32 CUDA-core rate the
// products alone would take 0.1006 ms.  The kernel before this design formed
// C Bᵀ once per head on the CUDA cores: 2·(N + P) f32 FMA flops per pair and
// head, 1.94e10, and ran at 1.18 ms.
//
// What the design does about it.
// 1. The score once per (z, group, query tile).  A CTA owns (z, g, a 64-row
//    query tile, a block of the group's heads).  It forms the score rows
//    S = C_q B_kᵀ for every key at or below the tile's diagonal, at most 256
//    keys per pass (64 × 256 f32 = 64 KB of shared memory; a longer chunk
//    takes more passes, each adding to Y), and reuses them for every head
//    of its block: per head it reads that head's dt and cum, forms
//    W = (S · exp(cum_q − cum_k)) · dt_k in registers with the select, and
//    adds W X_h to the head's accumulator.  The head block is sized on the
//    host so that the grid covers about two waves of the card's resident
//    CTAs (chip_smoke.py reports the block); blocks run z by z, a head
//    block's query tiles side by side (they read the same X), heaviest
//    first.  At G == H the block is one head.
// 2. Both products on the tensor cores at f32 accuracy: mma.sync.m16n8k8
//    TF32, 3×TF32 as K1's mma (semiring_ring.cuh): each f32 operand x is
//    split in registers into big (x truncated to TF32) and small (the rest,
//    rounded to TF32), and each 8-deep group takes small·big, big·small,
//    big·big.  Four compute warps own 16 query rows each.  The score's
//    accumulator fragment (rows g, g+8; keys 2t, 2t+1 of an 8-key group) is
//    taken as W's A fragment with the group's keys in the order
//    0,2,4,6,1,3,5,7, and X's B fragment is read in the same order, so W
//    never leaves the registers; S sits in shared memory in that fragment
//    order (one 16-byte read per thread and 8 keys).  bf16 inputs widen
//    exactly into TF32: C Bᵀ takes one product, W X two (X's small part is
//    0).  The tensor cores' own f32 sums need not round to nearest, so each
//    16-deep slice of N and each 32-key stage sums apart and is added to
//    the total in f32.  The inner loops have no branches (a branch per
//    8-key group serialises each group's three dependent products, and a
//    select written as a conditional became a branch around each exp): a
//    warp skips whole stages above its rows, and a bit mask zeroes the
//    weights above the diagonal.  mma.sync, not wgmma: it
//    keeps W in registers with the splits done there; wgmma's RS form is
//    later work.
// 3. Staging: two more warps issue every copy into a four-stage cp.async
//    ring, C and B slices for the score and then, head after head, 32-key
//    tiles of X with their dt and cum; one CTA barrier per stage hands the
//    stages over.  16-byte copies where a row's four values are aligned and
//    in range, 4-byte copies for the strided dt and cum; bf16 and unaligned
//    rows are widened by the threads.
//
// What holds it back on an H100 (PERF.md §6): the copies.  With the
// products taken out the kernel keeps most of its time: the SM takes in
// its copies at a rate set by how many warps issue them, not by the stages
// in flight or by where the data sits (X is read once per query tile at
// or after its keys, 2.5 times in all, and C once per 64-key tile of S).
// Copies by the copy engine (TMA) were faster alone, but their addressing
// cost the compute warps registers and the kernel ran slower.  The
// products add on top.

// Non-finite inputs.  A split product turns inf · x into NaN where x's
// small part is 0, so a score or an output element that comes out of the
// tensor cores not finite is recomputed as a plain f32 sum of its terms
// (keys at or below the diagonal), which gives the f32 inf/NaN pattern.
// One more case follows the plain version: a query row whose C holds a
// value that is not finite has a non-finite score with every key, and the
// plain version's 0 mask turns the later keys' scores into NaN, so that row
// is NaN wherever a later key exists in the chunk.  A value that is not
// finite in C, B or X at position k never reaches an earlier row (ROADMAP's
// declared difference; the plain version carries it to the whole chunk).
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() after the launch (or -1 for a dtype or head dim it does
// not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int WARPS = 4;      // compute warps: warp w owns rows 16w … 16w+15
constexpr int COPY_THREADS = 64;  // two more warps issue the copies
constexpr int THREADS = 32 * WARPS + COPY_THREADS;
constexpr int BQ = 64;        // query rows per CTA
constexpr int KSB = 256;      // keys whose scores one pass keeps
constexpr int NC = 16;        // state columns of C and B per score stage
constexpr int CS = NC + 4;    // row stride of a score stage (floats)
constexpr int KT = 32;        // keys per X stage
constexpr int NS = 4;         // ring stages
constexpr int WAVES = 2;      // grid size sought, in resident CTAs
// scores of one pass: [warp][8-key group][lane][4], fragment order
constexpr int S_FLOATS = WARPS * (KSB / 8) * 32 * 4;

enum DType { F32 = 0, BF16 = 1 };

// element strides over (z, head or group, q) of one operand
struct Stride3 {
  long long z, h, q;
};
struct Strides {
  Stride3 c, b, x, dt, cum, y;
};

// A ring stage holds a score stage (C_q's and B_k's 64 × NC slices) or an X
// stage (KT keys of X, their dt and cum, and the query rows' cum).
template <int P>
struct Layout {
  static constexpr int XS = P + 4;  // X row stride: conflict-free B fragments
  static constexpr int DT = KT * XS;
  static constexpr int CUM = DT + KT;
  static constexpr int CQ = CUM + KT;
  static constexpr int X_STAGE = CQ + BQ;
  static constexpr int S_STAGE = 2 * BQ * CS;
  static constexpr int STAGE =
      ((X_STAGE > S_STAGE ? X_STAGE : S_STAGE) + 3) / 4 * 4;
  static constexpr int SMEM_BYTES = (S_FLOATS + NS * STAGE) * 4;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ bool finite_f(float x) {
  return (__float_as_uint(x) & 0x7f800000u) != 0x7f800000u;
}

// x = big + small with big = x truncated to TF32 (its 13 low bits cleared)
// and small = the rest rounded to TF32, to nearest with ties away from zero
// (add half of the dropped range to the magnitude, then clear): 4
// instructions, |x − big − small| ≤ 2⁻²¹|x|.  A non-finite x keeps a
// non-finite big, so its products come out non-finite and the epilogues
// recompute them.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;
}

// e^x to about 2 ulp: 2^(x·log₂e) with the product's rounding error
// carried into a first-order correction (x·log₂e = hi + lo).  Not finite
// for x = ±inf (a result that the epilogue recomputes with expf).
__device__ __forceinline__ float exp_f32(float x) {
  constexpr float L2E = 1.44269502f, L2E_LO = 1.92596303e-8f;
  constexpr float LN2 = 0.693147181f;
  const float hi = x * L2E;
  const float lo = fmaf(x, L2E_LO, fmaf(x, L2E, -hi));
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(hi));
  return fmaf(r, lo * LN2, r);
}

// d += a · b, one 16×8×8 TF32 product with f32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(float* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
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

// rows × width (a multiple of 4) values from src (row stride ss elements)
// into dst (row stride ds floats), widened to f32, zeros past valid_rows
// and valid_cols; by the copying warps' threads (t of COPY_THREADS)
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ds, const T* src,
                                           long long ss, int rows, int width,
                                           int valid_rows, int valid_cols,
                                           int t) {
  const int cpr = width / 4;
  for (int i = t; i < rows * cpr; i += COPY_THREADS) {
    const int r = i / cpr, c = (i % cpr) * 4;
    float* d = dst + r * ds + c;
    if (r >= valid_rows || c >= valid_cols) {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const T* s = src + r * ss + c;
    if constexpr (sizeof(T) == 4) {
      if (c + 4 <= valid_cols && (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
        cp_async16(d, s);
        continue;
      }
    }
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = c + e < valid_cols ? to_f32(s[e]) : 0.f;
    *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// n values src[i · ss] into dst, widened, zeros past valid; by the copying
// warps' threads
template <typename T>
__device__ __forceinline__ void stage_vec(float* dst, const T* src,
                                          long long ss, int n, int valid,
                                          int t) {
  for (int i = t; i < n; i += COPY_THREADS) {
    if (i < valid) {
      if constexpr (sizeof(T) == 4)
        cp_async4(dst + i, src + i * ss);
      else
        dst[i] = to_f32(src[i * ss]);
    } else {
      dst[i] = 0.f;
    }
  }
}

// The epilogues for results that come out of the tensor cores not finite
// (rare: only inputs or scores that are not finite, or an exp that
// overflows at or below the diagonal, give one).  One call site each, out
// of line, so the main loops stay short.

// The score C_q · B_k as a plain f32 sum.
template <typename T>
__device__ __noinline__ float score_f32(const T* c, const T* b, int n) {
  float s = 0.f;
  for (int i = 0; i < n; ++i) s += to_f32(c[i]) * to_f32(b[i]);
  return s;
}

// This thread's scores of one 64-key tile (first key k0) in the warp's
// score rows sw: each one at or below the diagonal that is not finite is
// recomputed as a plain f32 sum.
template <typename T>
__device__ __noinline__ void fix_scores(float* sw, int kb, int k0, int rA,
                                        int Q, int N, const T* c,
                                        long long cq, const T* b,
                                        long long bq) {
  const int lane = threadIdx.x & 31, tq = lane & 3;
#pragma unroll 1
  for (int e = 0; e < 32; ++e) {
    const int nt = e / 4, i = e % 4;
    const int row = rA + (i < 2 ? 0 : 8);
    const int key = k0 + 8 * nt + 2 * tq + (i & 1);
    float& v = sw[(((k0 - kb) / 8 + nt) * 32 + lane) * 4 + i];
    if (!finite_f(v) && row < Q && key <= row)
      v = score_f32(c + row * cq, b + key * bq, N);
  }
}

// This thread's stored outputs of one head (P columns, rows rA and rA + 8)
// that are not finite, recomputed as the plain f32 sum over keys
// 0 … min(q, kend − 1): scores of this pass (keys ≥ kb) from sw, earlier
// ones from C and B.  A row whose C holds a value that is not finite has a
// non-finite score with every key, and the plain version's 0 mask turns the
// later keys' ones into NaN: that row is NaN wherever a later key exists.
template <typename T, int P>
__device__ __noinline__ void fix_outputs(
    float* y, long long yq, const float* sw, int row0, int rA, float cqA,
    float cqB, int kb, int kend, int Q, int N, const T* c, long long cq,
    const T* b, long long bq, const T* x, long long xq, const T* dt,
    long long dtq, const T* cum, long long cumq) {
  const int tq = threadIdx.x & 3;
#pragma unroll 1
  for (int e = 0; e < 4 * (P / 8); ++e) {
    const int i = e % 4;
    const int q = rA + (i < 2 ? 0 : 8);
    const int p = 8 * (e / 4) + 2 * tq + (i & 1);
    if (q >= Q || finite_f(y[q * yq + p])) continue;
    const T* c_row = c + q * cq;
    bool c_bad = false;
    for (int n = 0; n < N; ++n) c_bad |= !finite_f(to_f32(c_row[n]));
    float out = __int_as_float(0x7fffffff);
    if (!c_bad || q == Q - 1) {
      const float cum_q = i < 2 ? cqA : cqB;
      const int r = q - row0;
      out = 0.f;
      for (int k = 0; k <= q && k < kend; ++k) {
        float s;
        if (k >= kb) {
          const int kk = k - kb;
          s = sw[((kk / 8) * 32 + 4 * (r % 8) + (kk % 8) / 2) * 4 +
                 (r >= 8 ? 2 : 0) + (kk & 1)];
        } else {
          s = score_f32(c_row, b + k * bq, N);
        }
        const float w =
            s * expf(cum_q - to_f32(cum[k * cumq])) * to_f32(dt[k * dtq]);
        out += w * to_f32(x[k * xq + p]);
      }
    }
    y[q * yq + p] = out;
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS)
    ssd_intra_chunk_kernel(const T* __restrict__ C, const T* __restrict__ B,
                           const T* __restrict__ X, const T* __restrict__ DT,
                           const T* __restrict__ CUM, float* __restrict__ Y,
                           int H, int G, int Q, int N, int nq, int hb_size,
                           int nhb, Strides st) {
  using L = Layout<P>;
  constexpr bool SPLIT = sizeof(T) == 4;  // bf16 values are TF32 already
  constexpr int NT = P / 8;               // 8-column tiles of Y
  extern __shared__ __align__(16) float smem[];
  float* ring = smem + S_FLOATS;

  // z-major, then group and head block, then the query tiles, heaviest
  // first: the CTAs that read one head block's X run side by side
  const int per_z = G * nhb * nq;
  const int z = blockIdx.x / per_z;
  const int rem = blockIdx.x % per_z;
  const int g = rem / (nhb * nq);
  const int hb = rem / nq % nhb;
  const int qi = nq - 1 - rem % nq;
  const int hpg = H / G;
  const int h0 = g * hpg + hb * hb_size;
  const int nh = min(hb_size, hpg - hb * hb_size);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool copier = warp >= WARPS;
  const int ct = threadIdx.x - 32 * WARPS;  // index among the copying threads
  const int gq = lane >> 2, tq = lane & 3;  // fragment row and column group
  const int q0 = qi * BQ;
  const int row0 = q0 + 16 * warp;
  const int rA = row0 + gq, rB = rA + 8;  // this thread's two rows
  const bool live = !copier && row0 < Q;  // computes rows of the chunk
  const int qend = min(q0 + BQ, Q);  // keys past the tile's last row: none
  const T* c = C + z * st.c.z + g * st.c.h;
  const T* b = B + z * st.b.z + g * st.b.h;
  const int nchunks = (N + NC - 1) / NC;
  float* sw = smem + warp * (KSB / 8) * 128;  // this warp's scores

  float acc[NT][4];
  float cqA = 0.f, cqB = 0.f;

  for (int kb = 0; kb < qend; kb += KSB) {
    const int kend = min(qend, kb + KSB);
    const int n1 = (kend - kb + 63) / 64 * nchunks;  // score stages
    const int nkt = (kend - kb + KT - 1) / KT;       // X stages per head
    const int total = n1 + nh * nkt;

    // by the copying warps: item it's copies into its stage
    auto issue = [&](int it) {
      float* s = ring + (it % NS) * L::STAGE;
      if (it < n1) {
        const int k0 = kb + 64 * (it / nchunks);
        const int n0 = NC * (it % nchunks);
        stage_rows(s, CS, c + q0 * st.c.q + n0, st.c.q, BQ, NC, Q - q0,
                   N - n0, ct);
        stage_rows(s + BQ * CS, CS, b + k0 * st.b.q + n0, st.b.q, 64, NC,
                   kend - k0, N - n0, ct);
      } else {
        const int j = (it - n1) / nkt, kt = (it - n1) % nkt;
        const int h = h0 + j;
        const int k0 = kb + kt * KT;
        const int valid = min(KT, kend - k0);
        stage_rows(s, L::XS, X + z * st.x.z + h * st.x.h + k0 * st.x.q,
                   st.x.q, KT, P, valid, P, ct);
        stage_vec(s + L::DT, DT + z * st.dt.z + h * st.dt.h + k0 * st.dt.q,
                  st.dt.q, KT, valid, ct);
        const T* cum = CUM + z * st.cum.z + h * st.cum.h;
        stage_vec(s + L::CUM, cum + k0 * st.cum.q, st.cum.q, KT, valid, ct);
        if (kt == 0)
          stage_vec(s + L::CQ, cum + q0 * st.cum.q, st.cum.q, BQ, Q - q0,
                    ct);
      }
    };

    // The copying warps issue every copy, so the compute warps never stall
    // on the copies' issue; one CTA barrier per stage hands stages over.
    if (copier) {
#pragma unroll 1
      for (int i = 0; i < NS - 1; ++i) {
        if (i < total) issue(i);
        cp_async_commit();
      }
    }
    // stage it: its copies landed, and the stage of it − 1 is free for
    // it + NS − 1
    auto advance = [&](int it) {
      if (copier) cp_async_wait<NS - 2>();
      __syncthreads();
      if (copier) {
        if (it + NS - 1 < total) issue(it + NS - 1);
        cp_async_commit();
      }
      return ring + (it % NS) * L::STAGE;
    };

    // ---- the scores: S[rows of warp, 64 keys] += C slice · B sliceᵀ, all
    // eight 8-key groups (no branch in the products; groups above the
    // diagonal are never read)
    float sacc[8][4];
#pragma unroll 1
    for (int it = 0; it < n1; ++it) {
      const float* s = advance(it);
      const int kj = it / nchunks, ch = it % nchunks;
      const int k0 = kb + 64 * kj;
      if (ch == 0) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) sacc[nt][i] = 0.f;
      }
      if (!live) continue;
      float part[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[nt][i] = 0.f;
      const float* cs = s + (16 * warp + gq) * CS + tq;
      const float* bs = s + BQ * CS + gq * CS + tq;
#pragma unroll
      for (int ks = 0; ks < NC / 8; ++ks) {
        const float av[4] = {cs[8 * ks], cs[8 * CS + 8 * ks],
                             cs[8 * ks + 4], cs[8 * CS + 8 * ks + 4]};
        uint32_t ab[4], as[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (SPLIT)
            split(av[i], ab[i], as[i]);
          else
            ab[i] = __float_as_uint(av[i]);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float b0 = bs[8 * nt * CS + 8 * ks];
          const float b1 = bs[8 * nt * CS + 8 * ks + 4];
          if constexpr (SPLIT) {
            uint32_t bb0, bs0, bb1, bs1;
            split(b0, bb0, bs0);
            split(b1, bb1, bs1);
            mma(part[nt], as, bb0, bb1);
            mma(part[nt], ab, bs0, bs1);
            mma(part[nt], ab, bb0, bb1);
          } else {
            mma(part[nt], ab, __float_as_uint(b0), __float_as_uint(b1));
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sacc[nt][i] += part[nt][i];
      if (ch < nchunks - 1) continue;
      float probe = 0.f;  // NaN if any score is not finite
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) probe = fmaf(sacc[nt][i], 0.f, probe);
        *reinterpret_cast<float4*>(
            sw + ((((k0 - kb) / 8 + nt) * 32) + lane) * 4) =
            make_float4(sacc[nt][0], sacc[nt][1], sacc[nt][2], sacc[nt][3]);
      }
      if (!finite_f(probe))
        fix_scores(sw, kb, k0, rA, Q, N, c, st.c.q, b, st.b.q);
    }

    // ---- head by head, 32-key X stages: acc += W X, W from the scores
#pragma unroll 1
    for (int it = n1; it < total; ++it) {
      const float* s = advance(it);
      const int j = (it - n1) / nkt, kt = (it - n1) % nkt;
      const int h = h0 + j;
      float* y = Y + z * st.y.z + h * st.y.h;
      if (kt == 0 && live) {
        cqA = s[L::CQ + 16 * warp + gq];
        cqB = s[L::CQ + 16 * warp + gq + 8];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int p = 8 * nt + 2 * tq;
          // a later pass adds to the earlier passes' sums (stored by this
          // thread)
          const bool more = kb > 0;
          acc[nt][0] = more && rA < Q ? y[rA * st.y.q + p] : 0.f;
          acc[nt][1] = more && rA < Q ? y[rA * st.y.q + p + 1] : 0.f;
          acc[nt][2] = more && rB < Q ? y[rB * st.y.q + p] : 0.f;
          acc[nt][3] = more && rB < Q ? y[rB * st.y.q + p + 1] : 0.f;
        }
      }
      if (!live) continue;
      const int kk0 = kt * KT;  // first key of the stage, from kb
      // a stage wholly above this warp's rows adds nothing (warp-uniform);
      // inside a stage every group runs, the select zeroes what is above
      // the diagonal
      if (kb + kk0 <= row0 + 15) {
        float part[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[nt][i] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KT / 8; ++ks) {
          const float4 sc = *reinterpret_cast<const float4*>(
              sw + (((kk0 + 8 * ks) / 8) * 32 + lane) * 4);
          const int ka = 8 * ks + 2 * tq;  // this thread's keys ka, ka + 1
          const int keyA = kb + kk0 + ka;
          const float2 ck = *reinterpret_cast<const float2*>(s + L::CUM + ka);
          const float2 dk = *reinterpret_cast<const float2*>(s + L::DT + ka);
          // W fragment: rows (gq, gq + 8) × keys (2tq, 2tq + 1) taken as
          // k columns (tq, tq + 4)
          // every weight is formed, then the select clears those above
          // the diagonal (a mask, not a branch: the four exps overlap)
          const float w[4] = {sc.x * exp_f32(cqA - ck.x) * dk.x,
                              sc.z * exp_f32(cqB - ck.x) * dk.x,
                              sc.y * exp_f32(cqA - ck.y) * dk.y,
                              sc.w * exp_f32(cqB - ck.y) * dk.y};
          const uint32_t keep[4] = {keyA <= rA ? ~0u : 0u,
                                    keyA <= rB ? ~0u : 0u,
                                    keyA + 1 <= rA ? ~0u : 0u,
                                    keyA + 1 <= rB ? ~0u : 0u};
          uint32_t wb[4], ws[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split(__uint_as_float(__float_as_uint(w[i]) & keep[i]), wb[i],
                  ws[i]);
          const float* xs = s + ka * L::XS + gq;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const float x0 = xs[8 * nt], x1 = xs[L::XS + 8 * nt];
            if constexpr (SPLIT) {
              uint32_t xb0, xs0, xb1, xs1;
              split(x0, xb0, xs0);
              split(x1, xb1, xs1);
              mma(part[nt], ws, xb0, xb1);
              mma(part[nt], wb, xs0, xs1);
              mma(part[nt], wb, xb0, xb1);
            } else {
              mma(part[nt], ws, __float_as_uint(x0), __float_as_uint(x1));
              mma(part[nt], wb, __float_as_uint(x0), __float_as_uint(x1));
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[nt][i] += part[nt][i];
      }

      if (kt == nkt - 1) {
        // the head is done for this pass: store, then recompute what is
        // not finite
        float probe = 0.f;
        // two columns per store where y's rows are 8-byte aligned
        const bool pairs = ((reinterpret_cast<uintptr_t>(y) |
                             static_cast<uintptr_t>(st.y.q) * 4) & 7) == 0;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int p = 8 * nt + 2 * tq;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = half ? rB : rA;
            if (row >= Q) continue;
            const float v0 = acc[nt][2 * half], v1 = acc[nt][2 * half + 1];
            float* dst = y + row * st.y.q + p;
            if (pairs) {
              *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
            } else {
              dst[0] = v0;
              dst[1] = v1;
            }
            probe = fmaf(v0, 0.f, fmaf(v1, 0.f, probe));
          }
        }
        if (!finite_f(probe))
          fix_outputs<T, P>(y, st.y.q, sw, row0, rA, cqA, cqB, kb, kend, Q,
                            N, c, st.c.q, b, st.b.q,
                            X + z * st.x.z + h * st.x.h, st.x.q,
                            DT + z * st.dt.z + h * st.dt.h, st.dt.q,
                            CUM + z * st.cum.z + h * st.cum.h, st.cum.q);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring and the scores are free for the next pass
  }
}

// CTAs of one instance the current card holds at once, asked once per
// device
template <typename T, int P>
cudaError_t resident_ctas(int* out) {
  constexpr int MAX_DEVICES = 64;
  static std::atomic<int> known[MAX_DEVICES];  // 0: not asked yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && (*out = known[dev].load()) > 0) return e;
  auto kernel = ssd_intra_chunk_kernel<T, P>;
  const int smem = Layout<P>::SMEM_BYTES;
  int sms = 0, per_sm = 0;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  *out = per_sm * sms;
  if (e == cudaSuccess && dev < MAX_DEVICES) known[dev].store(*out);
  return e;
}

// The head block: heads of one group per CTA, enough CTAs for WAVES waves
// of resident CTAs, no more blocks than heads, then the blocks evened out.
template <typename T, int P>
cudaError_t head_block(int BZ, int H, int G, int Q, int* hb_size, int* nhb) {
  int resident = 0;
  cudaError_t e = resident_ctas<T, P>(&resident);
  if (e != cudaSuccess) return e;
  if (resident <= 0) return cudaErrorInvalidConfiguration;
  const long long base =
      static_cast<long long>(BZ) * G * ((Q + BQ - 1) / BQ);
  const int hpg = H / G;
  const long long want = (static_cast<long long>(WAVES) * resident + base - 1)
                         / base;
  const int blocks = static_cast<int>(want < 1 ? 1 : (want > hpg ? hpg : want));
  *hb_size = (hpg + blocks - 1) / blocks;
  *nhb = (hpg + *hb_size - 1) / *hb_size;
  return cudaSuccess;
}

template <typename T, int P>
int launch(const void* c, const void* b, const void* x, const void* dt,
           const void* cum, void* y, int BZ, int H, int G, int Q, int N,
           const Strides& st, cudaStream_t stream) {
  int hb_size = 0, nhb = 0;
  const cudaError_t e = head_block<T, P>(BZ, H, G, Q, &hb_size, &nhb);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nq = (Q + BQ - 1) / BQ;
  const unsigned grid = static_cast<unsigned>(BZ) * G * nq * nhb;
  ssd_intra_chunk_kernel<T, P><<<dim3(grid), dim3(THREADS),
                                 Layout<P>::SMEM_BYTES, stream>>>(
      static_cast<const T*>(c), static_cast<const T*>(b),
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(cum), static_cast<float*>(y), H, G, Q, N, nq,
      hb_size, nhb, st);
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

// The number of heads one CTA takes for this call shape (the head block), or
// a negative value for a dtype or head dim the kernel does not take.
extern "C" int simd2_ssd_head_block(int dtype, int head_dim, int BZ, int H,
                                    int G, int Q) {
  int hb_size = -1, nhb = 0;
  cudaError_t e = cudaErrorInvalidValue;
#define SSD_HB(T, PD)                                               \
  if (head_dim == PD) e = head_block<T, PD>(BZ, H, G, Q, &hb_size, &nhb);
  if (dtype == F32) {
    SSD_HB(float, 8) SSD_HB(float, 16) SSD_HB(float, 32) SSD_HB(float, 64)
    SSD_HB(float, 128)
  } else if (dtype == BF16) {
    SSD_HB(__nv_bfloat16, 8) SSD_HB(__nv_bfloat16, 16)
    SSD_HB(__nv_bfloat16, 32) SSD_HB(__nv_bfloat16, 64)
    SSD_HB(__nv_bfloat16, 128)
  }
#undef SSD_HB
  return e == cudaSuccess ? hb_size : -1;
}
