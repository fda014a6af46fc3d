// K3, flash attention (forward) for Hopper: online-softmax attention with
// causal and sliding-window masks and grouped-query heads.
//
// Replaces repro/kernels/flash_attention.py::flash_attention, the Pallas TPU
// kernel (body _fa_kernel), which the LM prefill reaches through
// models/attention.py with impl="pallas".
//
// What it computes.  q (B, H, Sq, D); k, v (B, Hkv, Skv, D); out (B, H, Sq, D)
// in q's dtype.  Each operand is any strided view with a unit stride on D
// (the model hands in transposed views of its (B, S, H, D) buffers and an
// output view of one).  Query head h reads KV head h / (H / Hkv) by index;
// the expansion is never materialised.  Query rows sit at the end of the kv
// axis (row i has position i + Skv - Sq).  Scores are the f32 dot of q and k
// times the scale (applied after the dot, as the TPU kernel does); key k is
// visible to query q when k < Skv, and k <= q if causal, and k > q - window
// if a window is given.  The running max, the denominator and the
// accumulator are f32; the result is acc / l with l == 0 → 1.
//
// Tiles and the sentinel: the TPU kernel's semantics with bq = bkv = 64
// (its default is 128 x 128).  Query tiles of min(64, Sq) rows and kv tiles
// of min(64, Skv) keys; a kv tile runs for a query tile unless the whole
// tile pair is unreachable (causal: the tile's first key is past its last
// query; window: its last key is at or before the first query minus the
// window).  Inside a tile that runs, a masked score is the finite -1e30,
// never -inf, so a query row that sees no key in any tile that ran ends as
// the mean of V over those tiles (zero rows of the kv tail padding
// included), as the TPU kernel ends at 64 x 64; a row whose every tile is
// skipped ends as zeros.  No caller of the system reaches such a row
// (prefill has Sq == Skv).
//
// What bounds it.  At the LM main path (tinyllama prefill, bf16, B 4, H 32,
// Hkv 4, S 2048, D 64, causal) one launch does 4·B·H·D·S(S+1)/2 ≈ 6.9e10
// flops and ≈ 2.7e8 exponentials on ≈ 75 MB of q, k, v and out: bound by
// operations (the bf16 tensor-core rate and the SFU's exp rate give ~0.07
// ms each), far above memory.
//
// What the design does about it.  Two instances:
//
// bf16 — the tensor cores (wgmma).  A CTA of two consumer warpgroups owns
// 128 query rows of one (batch, head): warpgroup w owns the 64-row query
// tile 2c + w, so the 64 x 64 skip rule holds per warpgroup for free
// (wgmma's M is 64).  Both products are warpgroup MMAs with f32
// accumulators: S = Q Kᵀ (m64n64k16, Q and K read from shared memory as
// bf16, K-major), and O += P V (m64nDk16, P as the A operand from
// registers, V read from shared memory MN-major).  The S accumulator's
// fragment is exactly the A fragment of the second product, so P is
// rounded to bf16 and packed in place, without shuffles or shared memory.
// TMA loads Q once and the K and V tiles through a four-stage ring in
// shared memory; an mbarrier per stage says when its tile has landed, and
// the last of the eight warps to be done with a tile (a counter in shared
// memory) loads the tile four ahead into its stage, so no thread waits for
// a free stage and no CTA-wide barrier runs in the loop.
// Tiles of head dims 64 and 128 use the 128-byte swizzle (conflict-free
// wgmma reads); 16, 32, 80 and 112 use unswizzled 8-column boxes.  Each step
// issues S of tile u behind P V of tile u - 1, without a branch (a
// warpgroup that skips a tile masks all of it), so the softmax overlaps the
// second product.  The softmax runs in registers in the log2 domain (the
// scale·log2e folded into the exponent's FMA, ex2 on the SFU), each row
// reduced across the four threads that hold it; the running max moves
// only when a tile's max passes it by 8, so O is seldom rescaled.  Masks
// are applied, by selects, only on tiles that cross the kv end, the
// diagonal or the window's edge; the tile ranges come in closed form.
// CTAs are issued heaviest query tiles first to even out the causal
// triangle.
//
// f32 — the CUDA cores, as first ported: one CTA of 256 threads per (batch·
// head, 64-row query tile), Q^T, K^T, V and P^T staged in shared memory as
// f32, 4x4 register tiles of FMAs.  TF32 tensor cores could not meet the f32
// tolerance, and no main path serves in f32.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() after the launch (or -1 for a dtype or head dim it does
// not take, 1999 or 2000 + the CUresult when a TMA tensor map cannot be
// made).  cuTensorMapEncodeTiled is reached through
// cudaGetDriverEntryPoint, so the library links against nothing more.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG = -1e30f;  // the TPU kernel's mask sentinel

enum DType { F32 = 0, BF16 = 1 };

// Element strides of q, k, v and out over (batch, head, row); D has stride 1.
struct Strides {
  long long b, h, s;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides sq_, sk, sv, so;
  int BH, H, Hkv, sq, skv, causal, has_window, window;
  float scale;
};

// ---------------------------------------------------------------------------
// f32: the CUDA-core instance.

constexpr int BQ = 64;        // query rows per CTA
constexpr int BKV = 64;       // keys per kv tile
constexpr int THREADS = 256;  // 16 x 16 threads: ty owns 4 rows, tx 4 keys
constexpr int PAD = 4;        // row padding of the transposed tiles (floats)
constexpr int QS = BQ + PAD;  // stride of Q^T and P^T rows
constexpr int KS = BKV + PAD; // stride of K^T rows

template <int HD>
constexpr int smem_floats() {
  return HD * QS + HD * KS + BKV * HD + BKV * QS;
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
    flash_attention_f32_kernel(const Args a, int nq) {
  constexpr int DJ = HD / 16;  // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;               // [HD][QS]  Q^T
  float* kt = qt + HD * QS;       // [HD][KS]  K^T
  float* vs = kt + HD * KS;       // [BKV][HD] V
  float* pt = vs + BKV * HD;      // [BKV][QS] P^T

  const int sq = a.sq, skv = a.skv, causal = a.causal;
  const int has_window = a.has_window, window = a.window;
  const float scale = a.scale;
  // heaviest query tiles first: all (b, h) of the last tile, then the one
  // before it, ...
  const int bh = blockIdx.x % a.BH;
  const int qi = nq - 1 - blockIdx.x / a.BH;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int kvh = h / (a.H / a.Hkv);
  const float* q = static_cast<const float*>(a.q) + b * a.sq_.b +
                   h * a.sq_.h + (long long)qi * BQ * a.sq_.s;
  const float* k = static_cast<const float*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const float* v = static_cast<const float*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  float* o = static_cast<float*>(a.o) + b * a.so.b + h * a.so.h +
             (long long)qi * BQ * a.so.s;

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
    qt[d * QS + r] = r < rows ? q[r * a.sq_.s + d] : 0.f;
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
      const long long row = k_start + c;
      kt[d * KS + c] = in ? k[row * a.sk.s + d] : 0.f;
      vs[c * HD + d] = in ? v[row * a.sv.s + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a4 = *reinterpret_cast<const float4*>(&qt[d * QS + ty * 4]);
      const float4 bb = *reinterpret_cast<const float4*>(&kt[d * KS + tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
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
      const float4 a4 = *reinterpret_cast<const float4*>(&pt[c * QS + ty * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
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
      o[r * a.so.s + tx + 16 * jj] = acc[i][jj] / li;
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core instance.

constexpr int WG_ROWS = 64;             // query rows per warpgroup (wgmma M)
constexpr int TC_THREADS = 256;         // two consumer warpgroups
constexpr int CTA_ROWS = 2 * WG_ROWS;   // query rows per CTA
constexpr int KV_ROWS = 64;             // keys per kv tile (the skip tile)
constexpr int STAGES = 4;               // K/V ring depth
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
constexpr int tc_smem_bytes() {
  // Q (two 64-row tiles), STAGES x (K, V), then the mbarriers and the
  // stages' counters
  return (2 + 2 * STAGES) * KV_ROWS * HD * 2 + 128;
}

// One operand's TMA tensor map over (D, and its row, head and batch axes in
// the order of their strides), and where each of those axes sits in it.
struct TmaOperand {
  CUtensorMap map;
  int pos_row, pos_head, pos_batch;
};

struct TcArgs {
  TmaOperand q, k, v;
  Args a;
};

// 2^x on the SFU; results below 2^-126 flush to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// TMA: one box of a 4-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, const int (&c)[4]) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c[0]), "r"(c[1]), "r"(c[2]),
      "r"(c[3]), "r"(bar)
      : "memory");
}
// keeps an A fragment in flight from being overwritten before its wgmma
// has read it
using hopper::fence_regs;
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(r[i][k])::"memory");
}

// How a 64-row x HD bf16 tile (Q, K or V) lies in shared memory, as TMA
// writes it box by box, and the wgmma descriptors that read it.
//
// HD a multiple of 64: boxes of 64 columns, each 64 rows of 128 bytes with
// the 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)), the
// layout wgmma reads without bank conflicts; tiles start 1024-byte aligned.
// K-major (Q, K): 8-row groups 1024 B apart, a k-step of 16 columns is 32 B
// into the row.  MN-major (V): 8-key groups 1024 B apart (sbo), 64-column
// blocks a box apart (lbo).
//
// Otherwise (16, 32, 80, 112): unswizzled boxes of 8 columns, 64 rows of 16 bytes
// each, so every 8 x 8 core matrix is 128 contiguous bytes; column blocks
// 1024 B apart.  The descriptor's lbo steps between core matrices along the
// contraction axis, sbo along M or N.
template <int HD>
struct TileLayout {
  static constexpr bool SWIZZLE = HD % 64 == 0;
  static constexpr int BOX_COLS = SWIZZLE ? 64 : 8;
  static constexpr int BOXES = HD / BOX_COLS;
  static constexpr int BOX_BYTES = KV_ROWS * BOX_COLS * 2;

  // Descriptors of the tile at `tile` for k-step 0; k-step kk adds
  // *_step(kk) to them (the address field counts 16-byte units).
  // Q as A or K as B (K-major), columns 16kk..16kk+15
  __device__ __forceinline__ static uint64_t kmajor(uint32_t tile) {
    if constexpr (SWIZZLE)
      return make_desc(tile, 16, 1024) | SWIZZLE_128B;
    else
      return make_desc(tile, BOX_BYTES, 128);
  }
  __host__ __device__ static constexpr uint32_t kmajor_step(int kk) {
    return (SWIZZLE ? (kk / 4) * BOX_BYTES + (kk % 4) * 32
                    : kk * 2 * BOX_BYTES) / 16;
  }
  // V as B (MN-major: D contiguous), keys 16kk..16kk+15
  __device__ __forceinline__ static uint64_t mnmajor(uint32_t tile) {
    if constexpr (SWIZZLE)
      return make_desc(tile, BOX_BYTES, 1024) | SWIZZLE_128B;
    else
      return make_desc(tile, 128, BOX_BYTES);
  }
  __host__ __device__ static constexpr uint32_t mnmajor_step(int kk) {
    return (SWIZZLE ? kk * 16 * 128 : kk * 16 * 16) / 16;
  }
  // TMA rows [row0, row0 + 64) of (head, batch) into a tile; rows past the
  // tensor's end arrive as zeros
  __device__ __forceinline__ static void load(uint32_t dst,
                                              const TmaOperand& op,
                                              uint32_t bar, int row0,
                                              int head, int batch) {
    auto coord = [&](int pos) {
      return op.pos_row == pos ? row0 : op.pos_head == pos ? head : batch;
    };
    const int c1 = coord(1), c2 = coord(2), c3 = coord(3);
#pragma unroll
    for (int bx = 0; bx < BOXES; ++bx)
      tma_load(dst + bx * BOX_BYTES, &op.map, bar,
               {bx * BOX_COLS, c1, c2, c3});
  }
};

__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n16k16(float (&d)[8],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n32k16(float (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n80k16(float (&d)[40],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n112k16(float (&d)[56],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
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
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}


template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (N == 16) wgmma_rs_m64n16k16(d, a, desc_b, 1);
  if constexpr (N == 32) wgmma_rs_m64n32k16(d, a, desc_b, 1);
  if constexpr (N == 64) wgmma_rs_m64n64k16(d, a, desc_b, 1);
  if constexpr (N == 80) wgmma_rs_m64n80k16(d, a, desc_b, 1);
  if constexpr (N == 112) wgmma_rs_m64n112k16(d, a, desc_b, 1);
  if constexpr (N == 128) wgmma_rs_m64n128k16(d, a, desc_b, 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// floor(a / b) for b > 0
__device__ __forceinline__ int floordiv(int a, int b) {
  return a >= 0 ? a / b : -((b - 1 - a) / b);
}

// The kv tiles [lo, hi] that run for the 64-row query tile whose row 0 sits
// at position q_start (the TPU kernel's block skip: causal, the tile's first
// key is past the query tile's last; window, its last key is at or before
// the first query minus the window), and among them the tiles [ne_lo,
// ne_hi] with no masked score (all keys before Skv, below the diagonal and
// inside the window).
struct TileRange {
  int lo, hi, ne_lo, ne_hi;
};
__device__ __forceinline__ TileRange tile_range(const Args& a, int q_start,
                                                int bkv, int nkv) {
  const int q_last = q_start + min(WG_ROWS, a.sq) - 1;
  TileRange r;
  r.hi = a.causal ? min(nkv - 1, floordiv(q_last, bkv)) : nkv - 1;
  r.lo = a.has_window
             ? max(0, floordiv(q_start - a.window - bkv + 1, bkv) + 1)
             : 0;
  r.ne_hi = floordiv(a.skv - KV_ROWS, bkv);
  if (a.causal) r.ne_hi = min(r.ne_hi, floordiv(q_start - KV_ROWS + 1, bkv));
  r.ne_lo = a.has_window
                ? floordiv(q_start + WG_ROWS - 1 - a.window, bkv) + 1
                : 0;
  return r;
}

// Register fragments (wgmma's f32 accumulator layout).  Thread t of a
// warpgroup (warp w = t/32, lane l) holds, for every 8-column block n of
// the tile, element 4n + e at row 16w + l/4 + 8·(e/2) and column
// 8n + 2·(l%4) + e%2.  So each thread holds two rows, and each row is held
// by the four threads of a quad.  For the second product, the S fragment of
// keys 16kk..16kk+15 (its elements 8kk..8kk+7) is, pair by pair, the bf16
// A fragment of wgmma's k-step kk.
template <int HD>
__global__ void __launch_bounds__(TC_THREADS, HD <= 64 ? 2 : 1)
    flash_attention_wgmma_kernel(const __grid_constant__ TcArgs t,
                                 int ncta_q) {
  static_assert(HD % 16 == 0 && HD <= 128, "head dim");
  using Tile = TileLayout<HD>;
  constexpr int TILE_BYTES = KV_ROWS * HD * 2;  // one 64-row bf16 tile
  constexpr int OREGS = HD / 2;
  const Args& a = t.a;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const uint32_t q_smem = smem_addr(tc_smem);                // [2][64][HD]
  const uint32_t kv_smem = q_smem + 2 * TILE_BYTES;         // [STAGES][K|V]
  // mbarriers: Q landed; the tile in stage s landed (full).  Then one
  // counter per stage of the warps done with its tile.
  const uint32_t q_full = kv_smem + STAGES * 2 * TILE_BYTES;
  auto full = [&](int st) { return q_full + 8 * (1 + st); };
  int* done = reinterpret_cast<int*>(tc_smem + 2 * TILE_BYTES +
                                     STAGES * 2 * TILE_BYTES +
                                     8 * (1 + STAGES));

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;

  // heaviest query tiles first: all (b, h) of the last 128 rows, then the
  // 128 before them, ...
  const int bh = blockIdx.x % a.BH;
  const int qc = ncta_q - 1 - blockIdx.x / a.BH;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int kvh = h / (a.H / a.Hkv);

  const int sq = a.sq, skv = a.skv;
  const int nq = (sq + WG_ROWS - 1) / WG_ROWS;  // 64-row query tiles
  const int bkv = min(KV_ROWS, skv);              // the kv block
  const int skv_p = (skv + bkv - 1) / bkv * bkv;  // its padded kv length
  const int nkv = skv_p / bkv;
  // this warpgroup's query tile and the position of its row 0
  const int qi = 2 * qc + wg;
  const bool live = qi < nq;
  const int q_start = qi * WG_ROWS + (skv - sq);
  // the kv tiles this warpgroup runs, and those the CTA loads: the union
  // of both warpgroups' ranges, which is one range
  const TileRange mine = tile_range(a, q_start, bkv, nkv);
  const int run_lo = live ? mine.lo : 1, run_hi = live ? mine.hi : 0;
  const TileRange other = tile_range(a, q_start + (wg ? -WG_ROWS : WG_ROWS),
                                     bkv, nkv);
  const bool other_live = wg == 1 || 2 * qc + 1 < nq;
  int j_lo = run_lo, j_hi = run_hi;
  if (run_lo > run_hi) j_lo = nkv, j_hi = -1;
  if (other_live && other.lo <= other.hi) {
    j_lo = min(j_lo, other.lo);
    j_hi = max(j_hi, other.hi);
  }
  // TMA of kv tile jt into stage st, by one thread: thread 0 for the first
  // STAGES tiles, then the last warp done with the stage (release below)
  auto load_kv = [&](int jt, int st) {
    const uint32_t ks = kv_smem + st * 2 * TILE_BYTES;
    mbar_expect_tx(full(st), 2 * TILE_BYTES);
    Tile::load(ks, t.k, full(st), jt * bkv, kvh, b);
    Tile::load(ks + TILE_BYTES, t.v, full(st), jt * bkv, kvh, b);
  };

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      done[st] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // prologue: Q, then the first STAGES kv tiles
    mbar_expect_tx(q_full, 2 * TILE_BYTES);
    Tile::load(q_smem, t.q, q_full, qc * CTA_ROWS, h, b);
    Tile::load(q_smem + TILE_BYTES, t.q, q_full, qc * CTA_ROWS + WG_ROWS, h,
               b);
    for (int n = 0; n < STAGES && j_lo + n <= j_hi; ++n) load_kv(j_lo + n, n);
  }
  __syncthreads();  // the barriers are initialised

  const float scale2 = a.scale * LOG2E;
  const int r0 = warp * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
  const int c0 = 2 * (lane % 4);        // and columns c0, c0 + 1 of each 8
  float o[OREGS];
#pragma unroll
  for (int i = 0; i < OREGS; ++i) o[i] = 0.f;
  float m[2] = {NEG, NEG};   // running max, log2 domain
  float l[2] = {0.f, 0.f};   // this thread's part of the denominator
  const uint32_t q_wg = q_smem + wg * TILE_BYTES;
  // the keys each of this thread's two rows sees: key_lo < key <= key_hi
  // (before Skv, causal, window), kept in registers for the masks
  int key_lo[2], key_hi[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qpos = q_start + r0 + 8 * e;
    key_hi[e] = a.causal ? min(skv - 1, qpos) : skv - 1;
    key_lo[e] = a.has_window ? qpos - a.window : INT_MIN;
  }

  // This warp is done with kv tile n (in stage n % STAGES).  The last of
  // the 8 warps to be done loads tile n + STAGES there, so no thread waits
  // for a free stage.
  auto release = [&](int n) {
    __syncwarp();
    const int st = n % STAGES;
    if (lane == 0 && atomicAdd(&done[st], 1) == 7) {
      atomicExch(&done[st], 0);
      if (j_lo + n + STAGES <= j_hi) load_kv(j_lo + n + STAGES, st);
    }
  };
  // P of the tile before, waiting for its product with V; zeros before the
  // first tile, so that every step issues both products without a branch
  // (wgmma in a branch would be serialised)
  uint32_t pa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) pa[kk][e] = 0u;
  int pv_stage = -1;  // the stage P V reads; -1: none yet
  // descriptors: Q of this warpgroup, and K and V of stage 0 (stage st
  // lies st · 2 · TILE_BYTES further)
  const uint64_t desc_q = Tile::kmajor(q_wg);
  const uint64_t desc_k = Tile::kmajor(kv_smem);
  const uint64_t desc_v = Tile::mnmajor(kv_smem + TILE_BYTES);
  constexpr uint32_t STAGE_STEP = 2 * TILE_BYTES / 16;
  auto issue_pv = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<HD>(o, pa[kk],
                   desc_v + st * STAGE_STEP + Tile::mnmajor_step(kk));
    wgmma_commit();
  };

  mbar_wait(q_full, 0);
  // u counts the kv tiles this CTA loads; tile u lies in stage u % STAGES.
  // Each step issues S of tile u and, behind it, P V of tile u - 1, so the
  // softmax of tile u runs while the tensor cores finish P V.  A warpgroup
  // that skips tile u still computes its S and then masks all of it, which
  // leaves m, l and O as they were.
  for (int u = 0, j = j_lo; j <= j_hi; ++u, ++j) {
    const int stage = u % STAGES;
    mbar_wait(full(stage), (u / STAGES) & 1);

    const int k_start = j * bkv;
    const bool run = run_lo <= j && j <= run_hi;
    float s[32];
    wgmma_fence();
    // S = Q Kᵀ: both K-major; the first k-step overwrites S
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_m64n64k16(
          s, desc_q + Tile::kmajor_step(kk),
          desc_k + stage * STAGE_STEP + Tile::kmajor_step(kk), kk > 0);
    wgmma_commit();
    issue_pv(pv_stage < 0 ? stage : pv_stage);
    wgmma_wait<1>();  // S has landed; P V may still run
    fence_regs(s);

    // Online softmax in the log2 domain.  A tile that crosses the kv end,
    // the diagonal or the window's edge (or one this warpgroup skips) is
    // scaled and masked in place first; any other tile (most of them)
    // takes the row max on the raw dots and scales inside the exponent's
    // FMA.
    const bool edge =
        !run || j < mine.ne_lo || j > mine.ne_hi || !(scale2 > 0.f);
    float sc = scale2;  // takes s to the log2 domain
    if (edge) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        // selects only, so that S stays in its registers
        const int kpos = k_start + (i / 4) * 8 + c0 + (i % 2);
        const int e = (i / 2) % 2;
        const bool ok = kpos > key_lo[e] && kpos <= key_hi[e];
        // a skipped tile, or past the TPU kernel's padded block: no key
        const bool none = !run || kpos >= skv_p;
        s[i] = none ? -INFINITY : ok ? s[i] * scale2 : NEG;
      }
      sc = 1.f;
    }
    // row maxima in four independent chains per row
    float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i / 2) % 4] = fmaxf(mx[(i / 2) % 4], s[i]);
    float alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[e] = fmaxf(mx[e], mx[e + 2]);  // elements i with (i / 2) % 2 == e
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
      // sc is positive, so max(s)·sc is max(s·sc).  The running max moves
      // only when the tile's passes it by more than 8 (P stays below 2^8):
      // softmax does not depend on the shift, and O is seldom rescaled.
      const float m_tile = mx[e] * sc;
      alpha[e] = 1.f;
      if (m_tile > m[e] + 8.f) {
        alpha[e] = ex2(m[e] - m_tile);
        m[e] = m_tile;
        l[e] *= alpha[e];
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = ex2(fmaf(s[i], sc, -m[(i / 2) % 2]));
    float sum[4] = {s[0] + s[1], s[2] + s[3], s[4] + s[5], s[6] + s[7]};
#pragma unroll
    for (int i = 8; i < 32; ++i) sum[(i / 2) % 4] += s[i];
    l[0] += sum[0] + sum[2];
    l[1] += sum[1] + sum[3];

    // P V of tile u - 1 is done: O, P's registers and the stage are free.
    // The fences keep the softmax above the wait and the old P's registers
    // alive up to it.
    fence_regs(s);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    if (pv_stage >= 0) release(u - 1);
    // rescale O only where a row's max moved
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < OREGS; ++i) o[i] *= alpha[(i / 2) % 2];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
    pv_stage = stage;
  }
  if (pv_stage >= 0) {
    wgmma_fence();
    issue_pv(pv_stage);
    wgmma_wait<0>();
    fence_regs(o);
    release(j_hi - j_lo);
  }

  if (!live) return;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o) + b * a.so.b +
                      h * a.so.h;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    if (l[e] == 0.f) l[e] = 1.f;  // every tile skipped → zeros
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = qi * WG_ROWS + r0 + 8 * e;
    if (row >= sq) continue;
    __nv_bfloat16* orow = og + row * a.so.s;
    // one division per row; the product differs from o / l by at most an
    // f32 ulp, far below the bf16 rounding that follows
    const float inv = 1.f / l[e];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const __nv_bfloat162 v2 = __floats2bfloat162_rn(
          o[4 * n + 2 * e] * inv, o[4 * n + 2 * e + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + c0) = v2;
    }
  }
}

// ---------------------------------------------------------------------------
// launch

template <int HD>
int launch_f32(const Args& a, cudaStream_t stream) {
  auto kernel = flash_attention_f32_kernel<HD>;
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nq = (a.sq + BQ - 1) / BQ;
  kernel<<<dim3((unsigned)(a.BH * nq)), dim3(THREADS), smem, stream>>>(a, nq);
  return static_cast<int>(cudaGetLastError());
}

// The tensor map of one bf16 operand, a (batch, head, row, D) view with
// element strides st, read in boxes of TileLayout's columns x 64 rows.  Its
// axes after D are ordered by stride, as TMA expects.
template <int HD>
int make_operand(TmaOperand* op, const void* ptr, long long rows,
                 long long heads, long long batch, const Strides& st) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return NO_TENSOR_MAPS;
  struct Axis {
    long long size, stride;
    int role;  // 0 row, 1 head, 2 batch
  } ax[3] = {{rows, st.s, 0}, {heads, st.h, 1}, {batch, st.b, 2}};
  // an axis of one element may have any stride; give it one TMA takes
  for (Axis& x : ax)
    if (x.size == 1) x.stride = HD;
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k + 1 < 3 - i; ++k)
      if (ax[k].stride > ax[k + 1].stride) {
        const Axis tmp = ax[k];
        ax[k] = ax[k + 1];
        ax[k + 1] = tmp;
      }
  cuuint64_t dims[4] = {HD, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {TileLayout<HD>::BOX_COLS, 1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = static_cast<cuuint64_t>(ax[i].size);
    strides[i] = static_cast<cuuint64_t>(ax[i].stride) * 2;
    if (ax[i].role == 0) {
      box[i + 1] = KV_ROWS;
      op->pos_row = i + 1;
    } else if (ax[i].role == 1) {
      op->pos_head = i + 1;
    } else {
      op->pos_batch = i + 1;
    }
  }
  const CUresult r = encode(
      &op->map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      TileLayout<HD>::SWIZZLE ? CU_TENSOR_MAP_SWIZZLE_128B
                              : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TENSOR_MAP_FAILED + static_cast<int>(r);
}

template <int HD>
int launch_bf16(const Args& a, cudaStream_t stream) {
  TcArgs t;
  t.a = a;
  const int B = a.BH / a.H;
  int rc = make_operand<HD>(&t.q, a.q, a.sq, a.H, B, a.sq_);
  if (rc == 0) rc = make_operand<HD>(&t.k, a.k, a.skv, a.Hkv, B, a.sk);
  if (rc == 0) rc = make_operand<HD>(&t.v, a.v, a.skv, a.Hkv, B, a.sv);
  if (rc != 0) return rc;
  auto kernel = flash_attention_wgmma_kernel<HD>;
  const int smem = tc_smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ncta_q = (a.sq + CTA_ROWS - 1) / CTA_ROWS;
  kernel<<<dim3((unsigned)(a.BH * ncta_q)), dim3(TC_THREADS), smem, stream>>>(
      t, ncta_q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 element strides, (batch, head, row) of q, k, v and out in turn
extern "C" int simd2_flash_attention(int dtype, int head_dim, const void* q,
                                     const void* k, const void* v, void* o,
                                     int B, int H, int Hkv, int sq, int skv,
                                     int causal, int has_window, int window,
                                     float scale, const long long* strides,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  Strides* st[4] = {&a.sq_, &a.sk, &a.sv, &a.so};
  for (int i = 0; i < 4; ++i)
    *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.BH = B * H;
  a.H = H;
  a.Hkv = Hkv;
  a.sq = sq;
  a.skv = skv;
  a.causal = causal;
  a.has_window = has_window;
  a.window = window;
  a.scale = scale;
#define FA_CASE(HD)                                          \
  case HD:                                                   \
    return dtype == F32 ? launch_f32<HD>(a, s) : launch_bf16<HD>(a, s);
  if (dtype != F32 && dtype != BF16) return -1;
  switch (head_dim) {
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(80)
    FA_CASE(112)
    FA_CASE(128)
    default:
      return -1;
  }
#undef FA_CASE
}
