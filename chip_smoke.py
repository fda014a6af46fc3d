#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

  0. the static analyzer — ``python -m repro_torch.analysis --json`` on the
     tree this script runs from must exit 0 (no new semiring, lock or
     capture finding); prints the count of rules and findings;
  1. device and card — needs CUDA; prints the nvidia-smi name/power line;
  2. build — compiles the SIMD² unit kernel (K1), the fused closure
     fixpoint (K2), flash attention (K3) and the SSD intra-chunk kernel (K4)
     from the checkout's sources, one nvcc each, in parallel, and prints
     each one's ptxas summary; K1's and K2's mma instances and K3's bf16
     instances must hold tensor-core instructions (HGMMA in ``cuobjdump
     -sass``), every K4 instance too (HMMA or HGMMA), K1's and K2's other
     instances cp.async (LDGSTS);
  3. kernels vs their plain PyTorch versions on the card — K1: all nine
     rings at three shapes, a batched ragged k_valid case, bf16, the six
     min/max rings in int32 (bit-exact, INT32_MAX ⊗ 1 wrapping on minplus,
     a ragged k_valid case) and every ring but orand in float16 (widened
     to the f32 instance, rounded once), and one 4096³ minplus step
     C ⊕ C⊗C; K2: every ring with a ⊗-identity × both algorithms at
     n̄ ∈ {12, 64, 200} (ragged kv, budgets that differ, a frozen request),
     a NaN edge, and one minplus Leyzorek chunk (g = 2) at 4096; then K2's
     fused arm against the K1 dispatch arm, which must be bit-identical on
     every ring, mma included; the six min/max rings in int32 and float16
     at n̄ ∈ {12, 64, 200}, both algorithms, each chunk against the plain
     version and the fused arm against K1 dispatch, bit for bit; K3 at the LM main path's
     shape (bf16, B 4, H 32, Hkv 4, S 2048, D 64, causal), the reference's
     FA_CASES in f32 and bf16 (a window, head dims 32 to 128, Sq ≠ Skv,
     non-causal), head dims 128 and 16 in bf16, rows that see no key in
     both dtypes, a steep score (q × 20), and strided views with out=; K3
     at head dim 112 in f32 and bf16 (zamba2's prefill shape B 4, H 32,
     Hkv 32, S 2048, causal; Sq ≠ Skv; a strided view with out=) and at
     mixtral's (bf16, B 4, H 32, Hkv 8, S 2048, D 128, window 4096); K4
     at the reference kernel test's shapes in f32 and bf16, the
     mamba2-780m prefill's shape (BZ 32, H 48, G 1, Q 256, N 128, P 64) and
     zamba2-7b's (BZ 32, H 112, G 1, Q 256, N 64, P 64) in f32 and bf16,
     grouped cases with G < H, the design's edges (N 20 and
     256, P 8 and 128, Q 600, a ragged head block), and a decay whose exp
     overflows above the diagonal;
  4. main path, batch mode — ``MMOEngine(backend="pallas", max_batch=8)``
     serves a mixed stream sized from the paper's Table 4 "small" column
     (APSP 4096, reachability 1024, KNN 4096 queries × 16384×16 corpus, a
     4096³ minplus mmo, and a ragged bucket of 8 APSP requests with n in
     200–256), with the kernels' launch counters reset just before and read
     just after; every result is then held against the plain path on the
     card;
  4b. the fused arm — ``MMOEngine(backend="megakernel")`` serves the
     stream's closure requests; every result must equal the 'pallas'
     engine's, K2 must launch and K1 must not;
  4c. arena mode — ``MMOEngine(mode="arena", arena_capacity=8, arena_g=4)``
     serves the same closure requests plus 48 small ones (n ∈ {12, 24, 48};
     minplus, orand, maxmin) in three waves, each submitted while slots of
     the earlier waves are live; every result must equal batch mode on the
     'pallas' arm, with no executable built after prewarm;
  4d. QoS serving on ``auto`` — the Table-4 stream's points autotuned with
     CUDA events (``tune_for_requests``: measured against the prior, the
     decision per bucket; every closure bucket must hold measured
     ``pallas`` and ``megakernel`` rows), the stream served on
     ``MMOEngine(backend="auto", adaptive=True)`` with every result equal
     to the fixed arm's and K1 or K2 launched; then 8 APSP-4096 bulk
     closures against 16 urgent ones (n 200–256, deadline 0.25 s, one
     every 20 ms) on fifo and on deadline (``max_batch_seconds=0.05``),
     with the urgent p50/p99, expired and failed-fast counts, the bulk
     batch sizes and per bucket the static prediction, the EWMA and the
     measured service per padded slot, the outcomes adding up and every
     completed result equal to the fixed arm's; then one admission burst
     (``max_queue=4``, ``max_backlog_s=0.1``) whose rejected futures raise
     ``RejectedError``; and K1's time per back-to-back launch;
  4e. operability around K1 and K2 — on the same stream: a transient
     execute fault on APSP 4096 ridden out by one retry; one poisoned
     request in the ragged bucket of 8 failed alone by bisection, the
     attempts within (retries+1)(2B−1); a persistent fault on K1 opening
     APSP 4096's breaker (traffic on K2, ``/healthz`` 503 degraded from an
     ``ObservabilityServer(port=0)``), then a probe after the cooldown
     moving it back to K1 (``/healthz`` ok, ``/metrics`` parses); K2 and K1
     broken on the ragged bucket, which the ranked fallback chain serves on
     'xla', then K2's probe; the arena with a NaN-poisoned slot failing
     alone and a transient tick fault retried; a 1 s stall under a 0.1 s
     watchdog failing its batch with the next batch correct; the arena's
     trace through a file, balanced, with its admit and tick events; and
     the tracer's cost on the stream (on/off, printed only).  Every
     completed result must equal phase 4's; K1/K2 launches are counted
     around each step;
  5. timing — K1, its plain version and (for mma) torch.matmul at the main
     path's shapes, each result held against the plain version (for mma
     also the split pass and the tensor-core tiles apart, by
     torch.profiler); K1's int32 and float16 minplus at 4096³ (float16 with
     its widen and round passes); K2 per chunk at the main path's shapes
     and its plain version, and the APSP-4096 chunk in int32 and float16; the APSP-4096 fixpoint on the dispatch arm (one host sync per
     iteration) against the fused arm; each with the tile it takes and its
     bound on this card
     (``ops_seconds``: the tensor-core rate for mma, the CUDA-core issue
     rate at the SM clock for the other rings, the int8 rate for orand);
  6. LM serving — tinyllama-1.1b at full width (22 layers, d 2048) with
     random weights from a seeded generator serves 4 prompts of 2048
     tokens, 32 new tokens each, through ``Engine(impl="pallas")``; K3 must
     launch 22 times for the prefill and never for the decode; the prefill
     logits are held against the 'xla' arm's and the greedy tokens against
     the ``Engine(impl="xla")`` tokens under the near-tie rule; one
     generate and one prefill alone run under torch.profiler; then K3, its
     plain version and scaled_dot_product_attention (the library yardstick,
     not used by the port) are timed at the main path's shape, with K3's
     share of its bound, its registers and shared memory, the f32
     instance's time on the same inputs, and K3 against SDPA at the other
     head dims (16, 32, 80, 112, 128) of the same shape;
  7. SSM serving — the tinyllama model is freed; mamba2-780m at full width
     (48 layers, d 1536, 48 SSM heads of 64, state 128, chunk 256) with
     random weights serves the same 4 × 2048 prompts, 32 new tokens each, on
     both arms, with the same checks; K4 must launch 48 times for the
     prefill and never for the decode; the same weights computing in f32
     must give both arms the same prefill logits to 1e-4; then K4, its
     plain version and the 'xla' arm's intra-chunk einsums (no single
     library call computes the term) are timed at the prefill's shape, in
     the model's layout, with K4's share of its bound (the products at the
     3×TF32 tensor-core rate; the f32 CUDA-core figure beside it) and its
     head block;
  8. the rest of the applications, at Table 4's sizes from
     ``repro_torch.configs.simd2_apps`` — (a) the eight solvers on
     'pallas' against the port's numpy baselines (``apps/baselines.py``,
     computed meanwhile in worker processes) under tests/test_apps.py's
     tolerances, inputs built as benchmarks/apps_bench.py builds them: MST
     and GTC at APP_SIZES "small" (1024), four Floyd-Warshall apps and KNN
     at BENCH_SIZES "large" (1024), a cut: the numpy k-pivot baseline at
     Table 4's 4096 would take minutes on the host (phase 4 serves APSP
     4096 against the plain path); minrp at BENCH_SIZES "small" (256):
     from 512 on its f32 products underflow and 0 ⊗ ∞ turns every entry
     into NaN, the reference's too; then the seven closure apps on the fused
     arm, equal to 'pallas'; (b) ``newton_inverse`` at n = 4096 on K1 mma
     (65 launches), its residual and its error against float64
     ``torch.linalg.inv`` within stated limits; (c) ``kmeans`` on K1
     addnorm (256 well-separated centres × 64 points, D 16, 20
     iterations), every assignment equal to the 'xla' arm's; (d)
     ``prune_24`` and ``mmo_sparse24`` at n = 1024 (a cut: the gathered
     (M, K/2, N) block is 2 GiB there, 128 GiB at 4096) on mma, minplus and
     maxmin against the CPU, mma also against K1 on ``densify_24``'s
     output, and ``csr_spmm`` at densities 0.01 and 0.1 against dense K1;
     (e) int32 and float16 minplus mmo and closure requests through
     ``MMOEngine`` on 'pallas' and on the fused arm.  Each step prints its
     host seconds and K1/K2 launches;
  9. sharded serving on a virtual mesh — ``make_host_mesh(devices=
     ["cuda:0"] * 4)``, 2 × 2 shards of the one card (its collectives are
     on-card copies and its shards run one after another: no interconnect
     time is claimed from it). (a) ``mmo_sharded_batched`` on each schedule
     at the raw 4096³ minplus and mma points (dp with 4 requests) and
     maxmin and orand at 1024³, minplus/maxmin/orand bit-identical to local
     K1, mma within rtol 1e-5 / atol 1e-4 of the float64 product, and KNN
     (4096 × 16384 × 16) on kspan against ``addnorm_ref`` in float64, each
     with its CUDA-event ms beside local K1's and its K1 launches per call
     (4 for dp and SUMMA, 2 for kspan and 4 for ring: kspan and ring run
     the one line of 2 shards along their axis); dp's host cost per sharded
     call
     (``cost_table.DP_OVERHEAD_S``); (b) a ragged 8 × 256³ batch (k_valid
     1–256) on kspan and ring, every ring, mma on the tensor-core route
     included, so shards get k_valid = 0, against local K1; (c)
     ``sharded_closure_batched`` — APSP 4096 on summa, GTC 1024 on ring,
     the ragged bucket on dp — equal to phase 4's results and iteration
     counts bit for bit, then ``distributed_leyzorek`` on APSP 1024 against
     the local closure; (d) ``tune_mesh`` over the stream's points (each
     row beside ``sharded_prior_seconds``), then ``MMOEngine(mesh=…)``
     serves the stream on ``schedule="auto"`` (the mesh rows), then a batch
     of 4 APSP 4096 and 4 raw mmo requests that the auto router must run on
     the mesh, then the stream pinned to summa, kspan and dp, and APSP 4096
     on ``backend="megakernel"`` routed to summa (its shards on K1, K2
     never); every result equals phase 4's, and each engine's routing,
     where each batch ran (the placements of the executables that ran) and
     its K1/K2 launches are printed;
  10. LM training on the card, ``impl="xla"`` (K3 and K4 have no backward,
     as the reference's Pallas arms have none; no K1–K4 launch here): (a)
     the flash backward's dq, dk, dv against ``xla_autodiff`` at tinyllama's
     attention shape (B 4, S 2048, H 32, KV 4, D 64) in bf16 and f32, and
     against a float64 autograd at B 1, S 1024, each arm's fwd+bwd ms; (b)
     tinyllama-1.1b at its published width and depth, bf16 compute, f32
     master, AdamW, 4 × 2048 SyntheticLM tokens per step: one batch at
     accum=2 against accum=1 and remat="full" against none (lr 0), then 1
     warm-up and 8 timed steps (CUDA events), every loss finite, step ms,
     tokens/s, peak ``max_memory_allocated`` and model FLOPs per step over
     the bf16 dense peak; (c) mamba2-780m at full width with 8 of its 48
     layers, the same step; (d) ``python -m repro_torch.launch.train
     --smoke --deterministic`` killed at step 20 (exit 42) and resumed:
     the final loss equals the uninterrupted run's within rtol 1e-5; (e)
     mixtral-8x7b at full width with 2 of its 32 layers and (f) zamba2-7b
     at full width with 7 of its 81 (one application of the shared block,
     then a tail layer), each with (b)'s probes and timed steps, every aux
     finite and the MoE aux non-zero;
  11. MoE serving (lines ``[moe]``) — mixtral-8x7b at its published width
     (d 4096, 32/8 heads of 128, d_ff 14336, 8 experts top-2, window 4096)
     with 8 of its 32 layers, then phi3.5-moe-42b-a6.6b (16 experts, d_ff
     6400) with 4 of 32 (neither fits the card whole), seeded random
     weights, serve the phase-6 prompts on both arms: K3 once per layer per
     prefill and never in the decode; per layer the (token, choice) pairs
     each arm dropped by capacity and the routes that differ between the
     arms; the differing routes of the first layer with any at router
     near-ties, the bf16 prefill logits and both arms' logits along the
     same tokens at every decode step within stated limits, the greedy
     tokens under a near-tie gap of twice that difference (at least the
     reference's MoE gap, 0.1); the same weights in f32 with identical
     routes (but at an f32 tie) and logits within a stated atol; then K3
     at mixtral's served shape against its plain version and SDPA;
  12. hybrid serving (lines ``[hybrid]``) — zamba2-7b at its published
     width and depth (81 layers, d 3584, 112 SSM heads of 64, state 64, the
     shared block every 6 layers) on both arms: K4 81 and K3 13 launches
     per prefill, neither in the decode, the same logit and token checks,
     the same weights in f32; then K3 at head dim 112 against SDPA and K4
     at zamba2's shape against its plain version and the 'xla' einsums;
  13. enc-dec serving (lines ``[encdec]``) — seamless-m4t-large-v2 at its
     published width and depth (24 + 24 layers, d 1024, 16 heads of 64,
     d_ff 8192, vocabulary 256,206): 4 requests of a 4096-frame seeded
     source and a 256-token prompt, 32 new tokens; the engine encodes once
     on its arm, so on 'pallas' K3 launches 72 times per prefill (24
     non-causal encoder, 24 causal decoder, 24 cross-attention with Sq 256
     over Skv 4096, reading each layer's cross K/V as a strided view) and
     never in the decode; the same logit and token checks as phase 11, the
     same weights in f32; then K3 at the three new shapes against its
     plain version and SDPA;
  14. VLM serving (lines ``[vlm]``) — chameleon-34b at its published width
     (d 8192, 64/8 heads of 128, d_ff 22016, qk-norm, vocabulary 65,536)
     with 8 of its 48 layers: a seeded 8192 × 256 codebook, 1024 patches
     per request (drawn codes plus 0.05 noise) tokenized by one K1 addnorm
     launch (``vq_tokenize(backend="pallas")``; the ids equal the drawn
     codes, a float64 brute force and the 'vector' arm), fused ahead of 1024
     text tokens at offset 32768 and served: K1 once and K3 8 times per
     generate, the same checks, the same weights in f32; then K3 at
     chameleon's shape and K1 at the VQ shape timed;
  15. the pipeline (lines ``[pipe]``) — the GPipe schedule
     (``models/pipeline.py``) on a virtual 4 × 2 mesh of eight shards of the
     card, tests/test_pipeline.py's construction widened: 4 stages of 3
     tanh layers, D 4096, 8 microbatches of 512 rows split over "data", f32:
     forward and gradients against the sequential layers and float64, the
     bubble fraction and ms per call against the sequential call (a
     virtual mesh measures the schedule, not an interconnect);
  16. the dry run (lines ``[dryrun]``) — (a) on the host, with no device
     memory allocated: ``launch.dryrun.run_cell`` for seven single-pod
     cells (tinyllama-1.1b × decode_32k, mixtral-8x7b × prefill_32k,
     mamba2-780m × long_500k, zamba2-7b × train_4k, seamless-m4t-large-v2 ×
     prefill_32k, chameleon-34b × decode_32k: status "ok"; granite-8b ×
     long_500k: "skipped") and tinyllama's decode_32k on the multi-pod
     mesh; (b) the rows of a (1, 1) mesh at two shapes the card ran, printed
     beside phase 6's prefill and phase 10's train step as measured ÷ bound;
     (c) the APSP anchor: one min-plus squaring C ← C ⊕ (C ⊗ C) at |V| =
     16384 (f32, 1 GiB) through ``core.distributed.summa_mmo`` on a virtual
     2 × 2 mesh of the card, 4 K1 launches, rows 0–255 bit for bit equal to
     local K1 and to its plain version on those rows, its CUDA-event time
     against ``launch.dryrun_apsp``'s K1 bound for that mesh and the
     production mesh's row.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the per-kernel JSON record.  Imports nothing of JAX.
"""
from __future__ import annotations

import copy
import gc
import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# The H100's published peaks and the CUDA-core issue rate live with the
# dispatch cost prior, so the kernel bounds below and the prior are one
# formula; main() sets the SM clock from nvidia-smi's clocks.max.sm.
from repro_torch.roofline import hw  # noqa: E402  (imports no torch)
K1_DESIGN = ("mma: a split pass writes A's and Bᵀ's big and small TF32 "
             "parts, then wgmma.m64n128k8 TF32 on the tensor cores, 3×TF32 "
             "(A_small·B_big, A_big·B_small, A_big·B_big per 8-deep k group; "
             "bf16 inputs one product), two warpgroups per 128×128 tile, "
             "32-deep slabs by TMA into the 128-byte swizzle, three stages "
             "on mbarriers (the last warp done with a stage reloads it), "
             "slab sums added with Kahan's compensation; other "
             "rings: CUDA cores, 8×8 (128×128 tile) or 4×4 (64×64, where "
             "128×128 covers < 2 waves) register tiles per thread, 16-deep "
             "slabs double-buffered with cp.async")
K2_DESIGN = ("cooperative persistent grid, two grid barriers per step "
             "(three for mma: the split pass); tiles contracted by K1's "
             "routines (mma 128×128 on the tensor cores, other rings "
             "128×128 or 64×64 by K1's rule applied to the live tiles each "
             "step)")
MIN_MAX_RINGS = ("minplus", "maxplus", "minmul", "maxmul", "minmax", "maxmin")
ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "int32": 4, "bool": 1}
TOL = {"rtol": 1e-5, "atol": 1e-4}   # mma / addnorm: summation order differs
BF16_TOL = {"rtol": 3e-2, "atol": 3e-2}  # the reference's own bf16 tolerance
# K3 vs its plain version: the reference kernel test's own tolerances
# (tests/test_kernels.py): f32 atol 2e-5 (the summation order differs),
# bf16 atol 3e-2 (one bf16 rounding of the output on top of that)
FA_ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
K3_DESIGN = ("bf16: wgmma S = Q Kᵀ and O += P V (P from registers), two "
             "consumer warpgroups of 64 query rows per CTA, K/V by TMA "
             "through a four-stage mbarrier ring, S of tile u issued behind "
             "P V of tile u - 1; f32: CUDA-core FMA")
K4_DESIGN = ("C Bᵀ once per (z, group, 64-row query tile), kept in shared "
             "memory (≤ 256 keys per pass) and shared by a block of the "
             "group's heads sized for ~2 waves; W = (S · decay) · dt formed "
             "in registers; both products as mma.sync.m16n8k8 TF32 on the "
             "tensor cores, 3×TF32 (big = x truncated, small = the rest "
             "rounded), 16-deep N slices and 32-key stages summed apart and "
             "added in f32; four compute warps of 16 rows and two copying "
             "warps feeding a four-stage cp.async ring; non-finite results "
             "recomputed as plain f32 sums")
# H100 SXM special-function units: 16 exp2 results per clock per SM
# (CUDA programming guide, compute capability 9.0) at the 1.98 GHz boost
# clock on 132 SMs
SFU_EXP_S = 132 * 16 * 1.98e9
# LM main path: tinyllama-1.1b prefill of 4 × 2048 tokens, 32 new tokens
LM_ARCH, LM_BATCH, LM_PROMPT, LM_NEW = "tinyllama-1.1b", 4, 2048, 32
# pallas vs xla prefill logits at full width, a sanity check of the whole
# prefill (K3's own gate is its comparison with its plain version).  Both
# arms compute in bf16 and round attention outputs differently (K3 scales
# after q·k, the xla arm before); a bf16 ulp of difference in a layer's
# attention output carries through 22 residual layers.  Measured on an H100
# with this seed: logits std 0.907, max |d| 0.03125 (one bf16 ulp at 4-8);
# the limit is twice that.
LM_LOGIT_ATOL = 0.0625
TIE_GAP = 2e-2  # the reference's near-tie rule (tests/test_serve.py)
# SSM main path: mamba2-780m prefill of the same prompts, 32 new tokens
SSM_ARCH = "mamba2-780m"
# pallas vs xla prefill logits at full width, a sanity check of the whole
# prefill (K4's own gate is its comparison with its plain version).  The
# arms differ only in the order of the f32 sums inside the intra-chunk term.
# Computing in f32 they agree to 2.44e-5 (logits std 0.785); in bf16 a
# flipped rounding of a block's output grows through the 48 residual layers
# to a max |d| of 0.152 (both measured on an H100 with this seed).  The
# limits are twice the measured maxima (f32: four times, as cuBLAS may pick
# another f32 GEMM on another card).
SSM_LOGIT_ATOL = 0.305
SSM_F32_LOGIT_ATOL = 1e-4
# K4 vs its plain version: the reference kernel test's own tolerances at
# its shapes (tests/test_kernels_ssd.py; bf16 inputs widen to f32 exactly,
# so both dtypes differ only in summation order); at the longer contractions
# (N up to 128 products per score, Q up to 256 weighted rows per output)
# rtol 1e-5 with atol 1e-4, K1's f32 tolerance for sums in another order
SSD_REF_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
SSD_LONG_TOL = {"rtol": 1e-5, "atol": 1e-4}
# (BZ, H, G, Q, N, P)
SSD_REF_SHAPES = [(2, 4, 4, 32, 16, 8), (1, 2, 2, 64, 32, 16),
                  (3, 1, 1, 16, 8, 8)]
SSD_MAIN_SHAPE = (4 * 8, 48, 1, 256, 128, 64)
# zamba2-7b's SSM layers at the 4 × 2048 prefill: 112 heads of 64, state 64
SSD_ZAMBA_SHAPE = (4 * 8, 112, 1, 256, 64, 64)
SSD_GROUPED_SHAPES = [(2, 8, 2, 100, 32, 32), (2, 4, 1, 8, 16, 16),
                      (1, 6, 3, 130, 64, 128)]
# the design's edges (tests/test_torch_ssd_cuda.py): N 20 and 256, P 8 and
# 128 with G < H, Q 600 (three passes of 256 keys)
SSD_EDGE_SHAPES = [(2, 8, 2, 100, 20, 32), (2, 8, 1, 256, 256, 64),
                   (2, 8, 2, 130, 64, 8), (2, 8, 1, 256, 128, 128),
                   (1, 4, 2, 600, 32, 32)]


def log(msg: str) -> None:
  print(msg, flush=True)


def equal_nan(x, y) -> bool:
  import torch
  return bool(torch.all((x == y) | (torch.isnan(x) & torch.isnan(y))))


def max_abs_err(x, y) -> float:
  import torch
  x, y = x.float(), y.float()
  same = (x == y) | (torch.isnan(x) & torch.isnan(y))
  return float(torch.where(same, 0.0, (x - y).abs()).max()) if x.numel() else 0.0


def check(name: str, got, want, op: str, bf16: bool = False) -> float:
  """Kernel vs plain: bit-exact for the min/max rings and orand (f32,
  float16, int32), the stated tolerance for mma/addnorm and for bf16."""
  import torch
  err = max_abs_err(got, want)
  if got.dtype != want.dtype or got.shape != want.shape:
    raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} vs "
                         f"{want.dtype}{tuple(want.shape)}")
  if bf16:
    ok = torch.allclose(got.float(), want.float(), equal_nan=True, **BF16_TOL)
  elif op in MIN_MAX_RINGS or op == "orand":
    ok = equal_nan(got, want)
  else:
    ok = torch.allclose(got, want, equal_nan=True, **TOL)
  log(f"[check] {name}: max_abs_err={err!r} {'ok' if ok else 'FAIL'}")
  if not ok:
    raise AssertionError(f"{name}: kernel disagrees with its plain version")
  return err


def bound_ms(op: str, dtype: str, r: int, m: int, k: int, n: int,
             k_live_total: int, has_c: bool) -> tuple:
  """Least time for R requests of D = C ⊕ (A ⊗ B): M·N·ΣK_live terms at the
  ring's rate (``ops_seconds``), or each operand read once and D written
  once at HBM bandwidth — whichever is larger."""
  isz = ITEMSIZE[dtype]
  osz = 1 if dtype == "bool" else (4 if op in ("mma", "addnorm") else isz)
  nbytes = r * (m * k + k * n) * isz + r * m * n * osz * (2 if has_c else 1)
  t_ops = hw.ops_seconds(op, dtype, float(m) * n * k_live_total)
  t_bytes = nbytes / hw.PEAK_BYTES_S
  return (max(t_ops, t_bytes) * 1e3,
          "operations" if t_ops >= t_bytes else "bytes")


def fixpoint_bound_ms(op: str, dtype: str, r: int, n: int,
                      live_steps_kv: int, has_adj: bool) -> tuple:
  """Least time for one K2 chunk: Σ over live (request, step) pairs of
  n²·kv terms at the ring's rate (``ops_seconds``), or the stack read once
  and written once (plus the constant A for Bellman-Ford) at HBM bandwidth
  — whichever is larger."""
  isz = ITEMSIZE[dtype]
  t_ops = hw.ops_seconds(op, dtype, float(n) * n * live_steps_kv)
  t_bytes = isz * r * n * n * (2 + int(has_adj)) / hw.PEAK_BYTES_S
  return (max(t_ops, t_bytes) * 1e3,
          "operations" if t_ops >= t_bytes else "bytes")


def kernel_ms(torch, fn, reps: int) -> dict:
  """Device time per call of each kernel ``fn`` launches, by kernel name
  (torch.profiler over ``reps`` calls after one warm-up)."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(reps):
      fn()
    torch.cuda.synchronize()
  import re

  def name(key: str) -> str:  # "void (anonymous namespace)::f<T>(...)" → f<T>
    m = re.search(r"(\w+(?:<[^()]*>)?)\(", key.split("namespace)::", 1)[-1])
    return m.group(1) if m else key[:80]
  return {name(e.key): e.self_device_time_total / reps / 1e3
          for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def dtype_instance(row: dict) -> dict:
  """A phase-5 timing row of one of K1's or K2's int32/float16 instances,
  as the kernel record lists it."""
  return {k: row[k] for k in ("dtype", "case", "op", "ms", "plain_ms",
                               "bound_ms", "bound_by", "library_ms",
                               "max_abs_err")}


def served_instance(row: dict) -> dict:
  """A timing row of K1, K3 or K4 at a served shape of phases 11-14, as
  the kernel record lists it."""
  return {k: row[k] for k in ("case", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms", "max_abs_err",
                               "launches")}


def cuda_time_ms(fn, reps: int) -> float:
  import torch
  fn()
  torch.cuda.synchronize()
  e0 = torch.cuda.Event(enable_timing=True)
  e1 = torch.cuda.Event(enable_timing=True)
  e0.record()
  for _ in range(reps):
    fn()
  e1.record()
  torch.cuda.synchronize()
  return e0.elapsed_time(e1) / reps


def phase_kernel_vs_plain(sm, torch, gen):
  """Phase 3 at small shapes: every ring, ragged k_valid, bf16."""
  from repro_torch.core import semiring as sr_mod
  dev = "cuda"
  for op in sr_mod.ALL_OPS:
    for (m, k, n) in ((13, 7, 5), (64, 200, 96), (256, 384, 128)):
      a = torch.randn(1, m, k, generator=gen)
      b = torch.randn(1, k, n, generator=gen)
      c = torch.randn(1, m, n, generator=gen)
      if op == "orand":
        a, b, c = a > 0.8, b > 0.8, c > 1.5
      a, b, c = a.to(dev), b.to(dev), c.to(dev)
      got = sm.semiring_mmo(a, b, c, op=op)
      check(f"{op} {m}x{k}x{n}", got, sm.semiring_mmo_plain(a, b, c, op=op),
            op)
  # batched, ragged per-request k_valid (a frozen request at 0)
  for op in ("mma", "minplus", "maxmin", "orand", "addnorm"):
    pa, pb = sr_mod.contraction_pads(op)
    r, m, k, n = 4, 64, 200, 96
    kv = torch.tensor([200, 131, 17, 0], dtype=torch.int32)
    a = torch.randn(r, m, k, generator=gen)
    b = torch.randn(r, k, n, generator=gen)
    if op == "orand":
      a, b, pa, pb = a > 0.3, b > 0.3, False, False
    for i, kvi in enumerate(kv.tolist()):
      a[i, :, kvi:] = pa
      b[i, kvi:, :] = pb
    a, b, kv = a.to(dev), b.to(dev), kv.to(dev)
    got = sm.semiring_mmo(a, b, op=op, k_valid=kv)
    check(f"{op} ragged R={r} kv={kv.tolist()}", got,
          sm.semiring_mmo_plain(a, b, op=op, k_valid=kv), op)
  for op in ("mma", "minplus", "maxmin", "addnorm"):
    a = torch.randn(2, 64, 96, generator=gen).to(dev, torch.bfloat16)
    b = torch.randn(2, 96, 32, generator=gen).to(dev, torch.bfloat16)
    got = sm.semiring_mmo(a, b, op=op)
    check(f"{op} bf16 2x64x96x32", got, sm.semiring_mmo_plain(a, b, op=op),
          op, bf16=True)
  # int32: the min/max rings' own instances, ⊗ wrapping in two's
  # complement (an INT32_MAX row of A against a column of 1 in B: minplus
  # gives INT32_MIN), bit-exact, and a ragged k_valid case
  top = torch.iinfo(torch.int32).max
  for op in MIN_MAX_RINGS:
    for (m, k, n) in ((13, 7, 5), (64, 200, 96), (256, 384, 128)):
      a, b, c = (torch.randint(-1000, 1001, shape, generator=gen,
                               dtype=torch.int32)
                 for shape in ((1, m, k), (1, k, n), (1, m, n)))
      a[:, 0, :] = top
      b[:, :, 0] = 1
      a, b, c = a.to(dev), b.to(dev), c.to(dev)
      got = sm.semiring_mmo(a, b, c, op=op)
      check(f"{op} int32 {m}x{k}x{n}", got,
            sm.semiring_mmo_plain(a, b, c, op=op), op)
    if op == "minplus" and int(got[0, 0, 0]) != -top - 1:
      raise AssertionError("int32 minplus: INT32_MAX ⊗ 1 did not wrap")
    a, b = (torch.randint(-1000, 1001, shape, generator=gen,
                          dtype=torch.int32).to(dev)
            for shape in ((4, 64, 200), (4, 200, 96)))
    kv = torch.tensor([200, 131, 17, 0], dtype=torch.int32, device=dev)
    check(f"{op} int32 ragged R=4 kv={kv.tolist()}",
          sm.semiring_mmo(a, b, op=op, k_valid=kv),
          sm.semiring_mmo_plain(a, b, op=op, k_valid=kv), op)
  # float16: the f32 instance on widened operands, rounded once (min/max
  # rings bit-exact, mma and addnorm f32 within TOL)
  for op in sr_mod.ALL_OPS:
    if op == "orand":
      continue
    for (m, k, n) in ((13, 7, 5), (64, 200, 96), (256, 384, 128)):
      a = torch.randn(1, m, k, generator=gen).to(dev, torch.float16)
      b = torch.randn(1, k, n, generator=gen).to(dev, torch.float16)
      c = torch.randn(1, m, n, generator=gen).to(
          dev, sm.out_dtype(op, torch.float16))
      got = sm.semiring_mmo(a, b, c, op=op)
      check(f"{op} float16 {m}x{k}x{n}", got,
            sm.semiring_mmo_plain(a, b, c, op=op), op)
  torch.cuda.synchronize()


IDENTITY_RINGS = ("mma", "minplus", "maxplus", "minmul", "maxmul", "minmax",
                  "maxmin", "orand")


def rand_closure_stack(cl, torch, op: str, n: int, r: int, seed: int):
  """(R, n, n) prepared adjacencies in ring ``op``'s conventions; mma
  strictly upper-triangular so its closure stays finite."""
  import numpy as np
  rng = np.random.default_rng(seed)
  missing, _ = cl.closure_pad_values(op)
  if op == "orand":
    w = rng.random((r, n, n)) > 0.9
  else:
    w = rng.uniform(0.2, 1.5, (r, n, n)).astype(np.float32)
    if op == "mma":
      w = np.triu(0.1 * w, k=1).astype(np.float32)
    w = np.where(rng.random((r, n, n)) > 0.7, w,
                 np.float32(missing)).astype(w.dtype)
  return cl.prepare_adjacency(torch.from_numpy(w), op=op)


def chunk_case(cl, torch, op, algorithm, n, seed):
  """Four requests: ragged kv, budgets that differ, one frozen request."""
  dev = "cuda"
  c = rand_closure_stack(cl, torch, op, n, 4, seed).to(dev).contiguous()
  kv = torch.tensor([n, max(1, n - 3), max(1, n // 2), n], dtype=torch.int32,
                    device=dev)
  act = torch.tensor([1, 1, 1, 0], dtype=torch.int32, device=dev)
  it = torch.tensor([0, 2, 5, 7], dtype=torch.int32, device=dev)
  glim = torch.tensor([4, 2, 1, 4], dtype=torch.int32, device=dev)
  return c, (c if algorithm == "bellman_ford" else None), kv, act, it, glim


def check_chunk(name, got, want, op) -> float:
  """K2 vs its plain version: counters and flags exact, the iterate under
  ``check``'s tolerance for the ring."""
  import torch
  if not (torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])):
    raise AssertionError(f"{name}: counters/flags {got[1].tolist()} "
                         f"{got[2].tolist()} vs {want[1].tolist()} "
                         f"{want[2].tolist()}")
  return check(name, got[0], want[0], op)


def phase_fixpoint_vs_plain(mk, cl, torch, adj_big) -> float:
  """Phase 3, K2: every ⊗-identity ring × both algorithms at three sizes,
  a NaN edge, and one 4096 minplus Leyzorek chunk (g = 2).  Returns the
  4096 chunk's max |err|."""
  for op in IDENTITY_RINGS:
    for algorithm in ("leyzorek", "bellman_ford"):
      for n in (12, 64, 200):
        c, adj, kv, act, it, glim = chunk_case(cl, torch, op, algorithm, n,
                                               seed=n)
        got = mk.fixpoint_chunk(c, adj, kv, act, it, glim, op=op, g_steps=4)
        want = mk.fixpoint_chunk_plain(c, adj, kv, act, it, glim, op=op,
                                       g_steps=4)
        check_chunk(f"K2 {op} {algorithm} n={n} kv={kv.tolist()} "
                    f"glim={glim.tolist()} act={act.tolist()}", got, want,
                    op)
        if not torch.equal(got[0][3], c[3]):
          raise AssertionError(f"K2 {op} {algorithm} n={n}: frozen moved")
  c = rand_closure_stack(cl, torch, "minplus", 64, 2, seed=3)
  c[0, 0, 1] = float("nan")
  c = c.cuda().contiguous()
  vec = torch.full((2,), 64, dtype=torch.int32, device="cuda")
  one = torch.ones(2, dtype=torch.int32, device="cuda")
  zero = torch.zeros(2, dtype=torch.int32, device="cuda")
  got = mk.fixpoint_chunk(c, c, vec, one, zero, vec, op="minplus",
                          g_steps=64)
  want = mk.fixpoint_chunk_plain(c, c, vec, one, zero, vec, op="minplus",
                                 g_steps=64)
  check_chunk(f"K2 minplus NaN edge, converged at {got[1].tolist()}", got,
              want, "minplus")
  if got[2].tolist() != [0, 0]:
    raise AssertionError("K2: the NaN-edge request did not converge")
  one = torch.ones(1, dtype=torch.int32, device="cuda")
  vec = torch.tensor([adj_big.shape[-1]], dtype=torch.int32, device="cuda")
  two = torch.tensor([2], dtype=torch.int32, device="cuda")
  zero = torch.zeros(1, dtype=torch.int32, device="cuda")
  got = mk.fixpoint_chunk(adj_big, None, vec, one, zero, two, op="minplus",
                          g_steps=2)
  want = mk.fixpoint_chunk_plain(adj_big, None, vec, one, zero, two,
                                 op="minplus", g_steps=2)
  err = check_chunk("K2 minplus leyzorek 4096 g=2", got, want, "minplus")
  torch.cuda.synchronize()
  return err


def phase_fused_vs_dispatch(cl, torch) -> None:
  """Phase 3, K2 against K1: the fused arm and the per-iteration dispatch
  arm must agree bit for bit, iteration counts included, on every ring."""
  solvers = {"leyzorek": cl.batched_leyzorek_closure,
             "bellman_ford": cl.batched_bellman_ford_closure}
  valid = [96, 70, 33]
  for op in IDENTITY_RINGS:
    adj = rand_closure_stack(cl, torch, op, 96, 3, seed=7)
    for i, v in enumerate(valid):  # isolated-vertex padding past v
      adj[i] = torch.from_numpy(cl.pad_adjacency(adj[i, :v, :v].numpy(), 96,
                                                 op=op))
    adj = adj.cuda()
    kv = torch.tensor(valid, dtype=torch.int32, device="cuda")
    for algorithm, solve in solvers.items():
      want, want_it = solve(adj, op=op, backend="pallas", valid_n=kv)
      got, it = solve(adj, op=op, fixpoint_backend="megakernel",
                      megakernel_g=3, valid_n=kv)
      same = torch.equal(it, want_it) and equal_nan(got, want)
      log(f"[check] K2 fused vs K1 dispatch {op} {algorithm} R=3 n=96 "
          f"valid={valid}: iterations={it.tolist()} "
          f"{'bit-identical' if same else 'FAIL'}")
      if not same:
        raise AssertionError(f"fused arm differs from dispatch: {op} "
                             f"{algorithm}")
  torch.cuda.synchronize()


def int_closure_stack(torch, op: str, n: int, r: int, seed: int):
  """(R, n, n) int32 iterates: small weights, the ring's self value on the
  diagonal, and a tenth of the entries at the ⊕-identity (INT32_MAX or
  INT32_MIN), whose ⊗ with a weight wraps in two's complement."""
  g = torch.Generator().manual_seed(seed)
  lo, hi = (1, 4) if op in ("minmul", "maxmul") else (-50, 51)
  x = torch.randint(lo, hi, (r, n, n), generator=g, dtype=torch.int32)
  info = torch.iinfo(torch.int32)
  x[torch.rand((r, n, n), generator=g) < 0.1] = (
      info.max if op.startswith("min") else info.min)
  if op in ("minplus", "maxplus", "minmul", "maxmul"):
    x.diagonal(dim1=1, dim2=2).fill_(0 if op.endswith("plus") else 1)
  return x


def phase_dtype_fixpoints(mk, cl, torch) -> None:
  """Phase 3, K2 in int32 and float16 (the min/max rings): every chunk case
  against the plain version at n̄ ∈ {12, 64, 200}, then the fused arm
  against per-iteration K1 at the same sizes with ragged valid_n, bit for
  bit, iteration counts included."""
  solvers = {"leyzorek": cl.batched_leyzorek_closure,
             "bellman_ford": cl.batched_bellman_ford_closure}
  for dtype in (torch.int32, torch.float16):
    name = str(dtype).removeprefix("torch.")
    for op in MIN_MAX_RINGS:
      for n in (12, 64, 200):
        for algorithm, solve in solvers.items():
          c, adj, kv, act, it, glim = chunk_case(cl, torch, op, algorithm,
                                                 n, seed=n)
          c = (int_closure_stack(torch, op, n, 4, seed=n).cuda()
               if dtype == torch.int32 else c.to(dtype))
          adj = c if algorithm == "bellman_ford" else None
          got = mk.fixpoint_chunk(c, adj, kv, act, it, glim, op=op,
                                  g_steps=4)
          want = mk.fixpoint_chunk_plain(c, adj, kv, act, it, glim, op=op,
                                         g_steps=4)
          if got[0].dtype != dtype:
            raise AssertionError(f"K2 {op} {name}: iterate is "
                                 f"{got[0].dtype}")
          check_chunk(f"K2 {op} {name} {algorithm} n={n} chunk", got, want,
                      op)
          x = c[:3].contiguous()
          valid = torch.tensor([n, max(1, n - 3), max(1, n // 2)],
                               dtype=torch.int32, device="cuda")
          want, want_it = solve(x, op=op, backend="pallas", valid_n=valid)
          got, got_it = solve(x, op=op, fixpoint_backend="megakernel",
                              megakernel_g=3, valid_n=valid)
          if not (torch.equal(got_it, want_it) and got.dtype == want.dtype
                  and equal_nan(got, want)):
            raise AssertionError(f"K2 fused vs K1 dispatch differ: {op} "
                                 f"{name} {algorithm} n={n}")
      log(f"[check] K2 {op} {name}: chunks equal the plain version and the "
          f"fused arm equals K1 dispatch bit for bit at n=12, 64, 200, both "
          f"algorithms")
  torch.cuda.synchronize()


def small_waves(graphs, api):
  """48 small closure requests in three waves of 16: n ∈ {12, 24, 48};
  minplus (Bellman-Ford on sparse graphs, so slots stay live for several
  ticks), orand and maxmin (Leyzorek)."""
  waves = []
  for w in range(3):
    wave = []
    for i in range(16):
      n = (12, 24, 48)[(w + i) % 3]
      seed = 1000 + 16 * w + i
      kind = i % 3
      if kind == 0:
        wave.append(api.apsp_request(graphs.weighted_digraph(
            n, 2.5 / n, seed=seed), algorithm="bellman_ford"))
      elif kind == 1:
        wave.append(api.reachability_request(graphs.boolean_digraph(
            n, 1.5 / n, seed=seed)))
      else:
        wave.append(api.closure_request(graphs.capacity_graph(
            n, 0.1, seed=seed), op="maxmin"))
    waves.append(wave)
  return waves


def same_result(got, want) -> bool:
  import numpy as np
  return (got.value.dtype == want.value.dtype
          and got.value.shape == want.value.shape
          and np.array_equal(got.value, want.value,
                             equal_nan=got.value.dtype.kind == "f")
          and got.extras["iterations"] == want.extras["iterations"])

def result_equal(kind: str, got, want) -> bool:
  """A served result against the fixed arm's on the same request:
  bit-identical values and iteration counts for closures and the min/max
  mmo, identical indices and distances within TOL for KNN."""
  import numpy as np
  if got.value.shape != want.value.shape or got.value.dtype != want.value.dtype:
    return False
  if kind == "knn":
    return (np.array_equal(got.extras["indices"], want.extras["indices"])
            and np.allclose(got.value, want.value, **TOL))
  return (np.array_equal(got.value, want.value,
                         equal_nan=got.value.dtype.kind == "f")
          and got.extras == want.extras)


def serve_all(engine, reqs) -> list:
  """Serve ``reqs`` on a synchronous engine; the results, in order."""
  futs = [engine.submit(r) for r in reqs]
  engine.run_until_idle()
  return [f.result() for f in futs]


def batch_table(engine, bucket_kind=None) -> dict:
  """Per bucket label: (batch sizes, mean measured service per padded
  slot) from the engine's request records (host clock)."""
  from repro_torch.serve_mmo import bucket_label
  from repro_torch.serve_mmo.scheduler import BucketKey
  with engine._lock:
    records = list(engine._records)
  batches = {}
  for rec in records:
    batches.setdefault((rec.bucket, rec.scheduled_s), []).append(rec)
  out = {}
  for (bucket, _), recs in sorted(batches.items(), key=lambda kv: kv[0][1]):
    label = bucket_label(BucketKey(*bucket))
    sizes, per_slot = out.setdefault(label, ([], []))
    rb = engine._batch_bucket(len(recs))
    sizes.append(len(recs))
    per_slot.append((recs[0].completed_s - recs[0].scheduled_s) / rb)
  return {label: (sizes, sum(ps) / len(ps))
          for label, (sizes, ps) in out.items()}


def phase_qos(sm, mk, graphs, api, np, torch, reqs, results) -> dict:
  """Phase 4d: the Table-4 stream autotuned and served on backend='auto',
  then bulk against urgent closures on fifo and deadline, then an
  admission burst."""
  from repro_torch.serve_mmo import MMOEngine
  from repro_torch.serve_mmo.scheduler import contract_shape, request_bucket
  from repro_torch.tuning import (CLOSURE_BACKENDS, prior_seconds, resolve,
                                  tune_for_requests)
  t_phase = time.perf_counter()
  # the host time per K1 launch, back to back (hw.LAUNCH_OVERHEAD_S)
  x8 = torch.rand(1, 8, 8, device="cuda")
  launch_ms = cuda_time_ms(lambda: sm.semiring_mmo(x8, x8, op="minplus"),
                           500)
  b8, _ = bound_ms("minplus", "float32", 1, 8, 8, 8, 8, False)
  log(f"[qos] K1 launch, minplus 1x8x8x8 back to back: {launch_ms!r} ms per "
      f"call (bound {b8:.3g} ms); the prior's hw.LAUNCH_OVERHEAD_S = "
      f"{hw.LAUNCH_OVERHEAD_S * 1e3!r} ms")

  # (a) autotune the stream's points: CUDA events, best of 3 after 1 warm-up
  t0 = time.perf_counter()
  table = tune_for_requests(reqs, device="cuda", warmup=1, iters=3)
  tune_s = time.perf_counter() - t0
  log(f"[qos] autotune: {len(table)} rows {table.counts()} in {tune_s:.1f}s "
      f"on {table.device}")
  for sig, entry in sorted(table.entries.items()):
    op, shape, dtype, arm, cfg_s = sig.split("|")
    cfg = () if cfg_s == "-" else tuple(int(c) for c in cfg_s.split("x"))
    mkn = tuple(int(d) for d in shape.split("x"))
    prior = prior_seconds(op, mkn, dtype, arm, cfg)
    if not (entry.source == "measured" and np.isfinite(entry.seconds)):
      raise AssertionError(f"autotune row {sig}: {entry}")
    log(f"[qos] row {op}|{shape}|{dtype} arm={arm} cfg={cfg_s}: measured "
        f"{entry.seconds * 1e3!r} ms, prior {prior * 1e3!r} ms, "
        f"measured/prior {entry.seconds / prior!r}")
  keys = []
  for r in reqs:
    key = request_bucket(r)
    if key not in keys:
      keys.append(key)
  for key in keys:
    m, k, n = contract_shape(key)
    closure = key.kind == "closure"
    d = resolve(key.op, m, k, n, key.dtypes[0], table=table,
                backends=CLOSURE_BACKENDS if closure else None)
    log(f"[qos] decision {key.kind}/{key.op}/{'x'.join(map(str, key.shape))}:"
        f" {d.backend} {d.cfg} {d.seconds * 1e3!r} ms ({d.source})")
    if closure:
      pallas = table.lookup(key.op, (m, k, n), key.dtypes[0], "pallas", ())
      fused = [table.lookup(key.op, (m, k, n), key.dtypes[0], "megakernel",
                            (g,)) for g in (2, 4, 8)]
      if pallas is None or any(e is None for e in fused):
        raise AssertionError(f"closure bucket {key} lacks a measured "
                             f"pallas or megakernel row")

  # (b) the stream on 'auto', adaptive, against phase 4's fixed arm
  auto = MMOEngine(backend="auto", cost_table=table, adaptive=True,
                   max_batch=8, device="cuda")
  built = auto.prewarm(reqs)
  sm.semiring_mmo.launches = 0
  mk.fixpoint_chunk.launches = 0
  auto.start()
  try:
    t0 = time.perf_counter()
    ares = [f.result(timeout=900) for f in [auto.submit(r) for r in reqs]]
    awall = time.perf_counter() - t0
  finally:
    auto.stop()
  k1, k2 = sm.semiring_mmo.launches, mk.fixpoint_chunk.launches
  arms = {}
  for key, dec in auto._decisions.items():
    arms[f"{key.kind}/{key.op}/{'x'.join(map(str, key.shape))}"] = dec
  log(f"[qos] auto stream: {len(reqs)} requests in {awall:.3f}s, "
      f"{auto.stats().summary()}, arms {arms}, semiring_mmo launches={k1}, "
      f"closure_megakernel launches={k2}, built {built}")
  if k1 + k2 <= 0:
    raise AssertionError("the auto stream launched neither K1 nor K2")
  fixed = {}
  for i, (r, got) in enumerate(zip(reqs, ares)):
    arm = auto._decisions[request_bucket(r)][0]
    if arm in ("pallas", "megakernel"):
      want = results[i]  # the two arms are bit-identical on closures
    else:
      if arm not in fixed:
        fixed[arm] = MMOEngine(backend=arm, device="cuda")
      want = serve_all(fixed[arm], [r])[0]
    if not result_equal(r.kind, got, want):
      raise AssertionError(f"auto request {i} ({r.kind}/{r.op} on {arm}) "
                           f"differs from the fixed arm")
  log(f"[qos] auto stream: all {len(ares)} results equal the fixed arm's")
  del fixed

  # (c) bulk against urgent, fifo vs deadline on the tuned table
  rng = np.random.default_rng(31)
  bulk_w = [graphs.weighted_digraph(4096, 0.05, seed=300 + i)
            for i in range(8)]
  urgent_w = [graphs.weighted_digraph(int(n), float(d), seed=400 + i)
              for i, (n, d) in enumerate(zip(rng.integers(200, 257, 16),
                                             rng.uniform(0.01, 0.3, 16)))]
  ref_eng = MMOEngine(backend="pallas", max_batch=8, device="cuda")
  want_bulk = serve_all(ref_eng, [api.apsp_request(w) for w in bulk_w])
  want_urgent = serve_all(ref_eng, [api.apsp_request(w) for w in urgent_w])
  del ref_eng
  runs = {}
  for policy, kw in (("fifo", {}),
                     ("deadline", dict(adaptive=True, max_batch_seconds=0.05,
                                       deadline_lookback_s=5.0))):
    eng = MMOEngine(backend="auto", cost_table=table, max_batch=8,
                    policy=policy, device="cuda", **kw)
    eng.prewarm([api.apsp_request(bulk_w[0]), api.apsp_request(urgent_w[0])])
    failed_fast = [0]
    check_ff = eng.scheduler.policy.fail_fast

    def counting_fail_fast(entry, key, sched, now, check_ff=check_ff,
                           failed_fast=failed_fast):
      hit = check_ff(entry, key, sched, now)
      failed_fast[0] += int(hit)
      return hit

    eng.scheduler.policy.fail_fast = counting_fail_fast
    # serve each bucket once so no module load lands in the timed mix; the
    # urgent ones carry a deadline, which arms the batch cap's lookback
    warm = serve_all(eng, [api.apsp_request(bulk_w[0])]
                     + [api.apsp_request(w, deadline_s=60.0, priority=1)
                        for w in urgent_w[:8]])
    del warm
    eng.reset_stats()
    bulk_f = [eng.submit(api.apsp_request(w, tenant="bulk")) for w in bulk_w]
    eng.start()
    try:
      while True:  # the first bulk batch has started
        with eng._lock:
          if eng._inflight:
            break
        time.sleep(0.0005)
      urgent_f = []
      t0 = time.perf_counter()
      for i, w in enumerate(urgent_w):
        delay = t0 + 0.02 * i - time.perf_counter()
        if delay > 0:
          time.sleep(delay)
        urgent_f.append(eng.submit(api.apsp_request(
            w, deadline_s=0.25, priority=1, tenant="urgent")))
      for f in bulk_f + urgent_f:
        f._event.wait(timeout=900)
    finally:
      eng.stop()
    states = [f.state for f in bulk_f + urgent_f]
    counts = {s: states.count(s) for s in ("done", "expired", "failed",
                                           "rejected")}
    if sum(counts.values()) != len(states) or "pending" in states:
      raise AssertionError(f"{policy}: outcomes do not add up: {states}")
    for f, want in zip(bulk_f + urgent_f, want_bulk + want_urgent):
      if f.state == "done" and not result_equal("apsp", f.result(), want):
        raise AssertionError(f"{policy}: request {f.request.request_id} "
                             f"differs from the fixed arm")
    with eng._lock:
      recs = {r.request_id: r for r in eng._records}
    lat = [recs[f.request.request_id].latency_s * 1e3 for f in urgent_f
           if f.state == "done"]
    urgent_states = [f.state for f in urgent_f]
    run = {"urgent_completed": urgent_states.count("done"),
           "urgent_expired": urgent_states.count("expired"),
           "failed_fast": failed_fast[0],
           "urgent_p50_ms": float(np.percentile(lat, 50)) if lat else None,
           "urgent_p99_ms": float(np.percentile(lat, 99)) if lat else None,
           "submitted": len(states), **counts}
    log(f"[qos] {policy}: {json.dumps(run)}")
    cells = {(k, b): (s, c) for k, b, _, s, c in eng.estimator.cells_raw()}
    for label, (sizes, per_slot) in batch_table(eng).items():
      key = next(k for k in eng._decisions
                 if label.startswith(f"{k.kind}/{k.op}/"
                                     f"{'x'.join(map(str, k.shape))}/"))
      contraction_s, trips = eng._static_point(key)
      arm = eng._decisions[key][0]
      ewma = cells.get((key, arm))
      log(f"[qos] {policy} {label} on {arm}: batch sizes {sizes}; static "
          f"prediction {contraction_s * trips * 1e3!r} ms/request "
          f"({contraction_s * 1e3!r} ms x {trips:g} trips), EWMA "
          f"{'none' if ewma is None else repr(ewma[0] * 1e3) + ' ms'} "
          f"({0 if ewma is None else ewma[1]} obs), measured "
          f"{per_slot * 1e3!r} ms per padded slot")
    runs[policy] = run
    del eng

  # (d) admission: one burst against max_queue=4, max_backlog_s=0.1
  adm = MMOEngine(backend="auto", cost_table=table, adaptive=True,
                  max_queue=4, max_backlog_s=0.1, device="cuda")
  burst = ([api.apsp_request(w) for w in bulk_w[:4]]
           + [api.apsp_request(w) for w in urgent_w[:8]])
  want_burst = want_bulk[:4] + want_urgent[:8]
  futs = [adm.submit(r) for r in burst]
  adm.run_until_idle()
  admitted = sum(f.state != "rejected" for f in futs)
  for f, want in zip(futs, want_burst):
    if f.state == "rejected":
      try:
        f.result()
      except api.RejectedError:
        continue
      raise AssertionError("a rejected future did not raise RejectedError")
    if not result_equal("apsp", f.result(), want):
      raise AssertionError("an admitted request differs from the fixed arm")
  reasons = dict(adm.admission.rejections)
  log(f"[qos] admission burst of {len(burst)}: admitted {admitted}, "
      f"rejected {reasons}, snapshot {json.dumps(adm.admission.snapshot())}")
  if admitted + sum(reasons.values()) != len(burst) or not reasons:
    raise AssertionError(f"admission counts do not add up: {reasons}")
  del adm
  gc.collect()
  torch.cuda.empty_cache()
  log(f"[qos] phase 4d in {time.perf_counter() - t_phase:.1f}s")
  return {"k1": k1, "k2": k2, "launch_ms": launch_ms, "runs": runs}


def http_get(url: str) -> tuple:
  """(status, body) of one GET; a 503 is an answer here, not an error."""
  import urllib.error
  import urllib.request
  try:
    with urllib.request.urlopen(url, timeout=30) as resp:
      return resp.status, resp.read().decode("utf-8")
  except urllib.error.HTTPError as e:
    return e.code, e.read().decode("utf-8")


def prometheus_parses(text: str) -> bool:
  """Every line of a Prometheus text exposition is a HELP/TYPE comment or
  a ``name{labels} value`` sample with a numeric value."""
  import re
  sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? (\S+)$')
  for line in text.splitlines():
    if line.startswith(("# HELP ", "# TYPE ")):
      continue
    m = sample.match(line)
    if m is None:
      return False
    try:
      float(m.group(2).replace("Inf", "inf"))
    except ValueError:
      return False
  return text.endswith("\n")


def trace_balanced(events) -> bool:
  """Every request's async slices alternate begin/end, one queued pair and
  one execute pair per attempt, each end at or after its begin."""
  slices = {}
  for ev in events:
    if ev.get("cat") == "request" and ev["ph"] in ("b", "e"):
      slices.setdefault((ev["id"], ev["name"]), []).append(ev)
  for (_, name), evs in slices.items():
    phs = [ev["ph"] for ev in evs]
    if phs != ["b", "e"] * (len(phs) // 2) or not phs:
      return False
    if name == "queued" and len(phs) != 2:
      return False
    if any(b["ts"] > e["ts"] for b, e in zip(evs[::2], evs[1::2])):
      return False
  return True


def phase_operability(sm, mk, api, reqs, results, closure_idx) -> dict:
  """Phase 4e: the recovery and telemetry layer around K1 and K2 on the
  Table-4 stream at full width.  Every completed result is held against
  phase 4's fault-free one (bit for bit: minplus and orand), and the K1/K2
  launch counters are read around each step."""
  import tempfile
  from repro_torch.serve_mmo import (BatchTimeoutError, FaultInjector,
                                     FaultRule, InjectedFault, MMOEngine,
                                     NonFiniteResultError,
                                     ObservabilityServer, bucket_label,
                                     render_prometheus)
  from repro_torch.serve_mmo.scheduler import request_bucket
  t_phase = time.perf_counter()
  total = {"k1": 0, "k2": 0}

  def counted(fn):
    """fn() with the K1/K2 counters set to 0 just before; returns (value,
    K1 launches, K2 launches, seconds) and adds to the phase's totals."""
    sm.semiring_mmo.launches = 0
    mk.fixpoint_chunk.launches = 0
    t0 = time.perf_counter()
    value = fn()
    dt = time.perf_counter() - t0
    k1, k2 = sm.semiring_mmo.launches, mk.fixpoint_chunk.launches
    total["k1"] += k1
    total["k2"] += k2
    return value, k1, k2, dt

  def expect(ok: bool, what: str) -> None:
    if not ok:
      raise AssertionError(f"[ops] {what}")

  big, ragged = reqs[0], reqs[4:12]
  big_label = bucket_label(request_bucket(big))
  ragged_label = bucket_label(request_bucket(ragged[0]))
  out = {}

  # (a) a transient execute fault on APSP 4096, ridden out by one retry
  inj = FaultInjector([FaultRule(point="execute", mode="transient", count=1,
                                 match=big_label, backend="pallas")])
  eng = MMOEngine(backend="pallas", device="cuda", faults=inj,
                  retry_backoff_s=0.0)
  eng.prewarm([big])
  (res,), k1, k2, dt = counted(lambda: serve_all(eng, [big]))
  snap = eng.metrics_snapshot()
  expect(same_result(res, results[0]) and k1 > 0 and k2 == 0
         and snap["counters"]["retries"] == 1
         and snap["batch_failures_by_kind"] == {"execute": 1},
         f"transient fault: k1={k1} k2={k2} {snap['counters']}")
  log(f"[ops] transient execute fault on {big_label}: retries="
      f"{snap['counters']['retries']}, K1 launches={k1}, {dt:.3f}s, "
      f"bit-identical to phase 4")

  # (b) one poisoned request in the ragged bucket of 8: bisection fails it
  # alone; breakers off so the arm does not move
  inj = FaultInjector()
  eng = MMOEngine(backend="pallas", device="cuda", faults=inj,
                  retry_backoff_s=0.0, breaker_threshold=None)
  eng.prewarm(ragged)
  futs = [eng.submit(r) for r in ragged]
  inj.arm(FaultRule(point="execute", request_ids={futs[3].request.request_id}))
  done, k1, k2, dt = counted(eng.run_until_idle)
  for i, f in enumerate(futs):
    if i == 3:
      try:
        f.result()
        expect(False, "the poisoned request completed")
      except InjectedFault:
        pass
    else:
      expect(same_result(f.result(), results[4 + i]),
             f"ragged request {i} differs from phase 4")
  snap = eng.metrics_snapshot()
  attempts = sum(snap["batch_failures_by_kind"].values()) + eng.stats().batches
  bound = (eng.transient_retries + 1) * (2 * len(ragged) - 1)
  bisects = sum(ev["name"] == "batch_bisect"
                for ev in eng.export_trace()["traceEvents"])
  expect(done == 7 and attempts <= bound and k1 > 0,
         f"poisoned request: done={done} attempts={attempts}")
  out["poison"] = {"attempts": attempts, "bound": bound,
                   "bisections": bisects, "s": dt}
  log(f"[ops] poisoned request in {ragged_label} x8: 7 of 8 done, equal to "
      f"phase 4; attempts={attempts} (bound (retries+1)(2B-1)={bound}), "
      f"bisections={bisects}, retries={snap['counters']['retries']}, K1 "
      f"launches={k1}, {dt:.3f}s")

  # (c) a persistent fault on K1 opens APSP 4096's breaker: the traffic
  # moves to K2, and a probe after the cooldown brings it back
  inj = FaultInjector([FaultRule(point="execute", match=big_label,
                                 backend="pallas")])
  probe_s = 2.0  # well past a 4096 batch on K2, so 'open' stays open
  eng = MMOEngine(backend="pallas", device="cuda", faults=inj,
                  fallback_backends=("megakernel",), breaker_threshold=2,
                  transient_retries=2, retry_backoff_s=0.0,
                  breaker_probe_s=probe_s)
  eng.prewarm([big])
  srv = ObservabilityServer(eng, port=0).start()
  try:
    steps = []
    for phase in ("opening", "open", "probe", "closed"):
      if phase == "probe":
        inj.clear()
        time.sleep(probe_s + 0.05)
      (res,), k1, k2, dt = counted(lambda: serve_all(eng, [big]))
      expect(same_result(res, results[0]),
             f"breaker {phase}: result differs from phase 4")
      status, body = http_get(srv.url + "/healthz")
      steps.append({"step": phase, "k1": k1, "k2": k2, "s": dt,
                    "healthz": (status, json.loads(body)["status"])})
    expect([(s["k1"] > 0, s["k2"] > 0) for s in steps]
           == [(False, True), (False, True), (True, False), (True, False)],
           f"breaker K1->K2->K1 launches: {steps}")
    expect([s["healthz"] for s in steps]
           == [(503, "degraded"), (503, "degraded"), (200, "ok"),
               (200, "ok")], f"/healthz: {steps}")
    status, text = http_get(srv.url + "/metrics")
    local = render_prometheus(eng.observability_state())
    expect(status == 200 and prometheus_parses(text)
           and prometheus_parses(local)
           and 'serve_breaker_opens_total{backend="pallas"' in text,
           "/metrics does not serve a parseable exposition")
  finally:
    srv.stop()
  (cell,) = [c for c in eng.resilience.snapshot() if c["backend"] == "pallas"]
  out["breaker_k1_k2"] = steps
  for s in steps:
    log(f"[ops] APSP 4096 breaker {s['step']}: K1 launches={s['k1']} K2 "
        f"launches={s['k2']} {s['s']:.3f}s /healthz={s['healthz']}")
  log(f"[ops] pallas breaker: opens={cell['opens']} probes={cell['probes']} "
      f"closes={cell['closes']} state={cell['state']}; /metrics "
      f"{len(text.splitlines())} lines, parses")

  # (d) K2 broken on the ragged bucket: the ranked chain moves it on; K1
  # is broken too, so it ends on 'xla'
  inj = FaultInjector([FaultRule(point="execute", match=ragged_label,
                                 backend="megakernel"),
                       FaultRule(point="execute", match=ragged_label,
                                 backend="pallas")])
  eng = MMOEngine(backend="megakernel", device="cuda", faults=inj,
                  breaker_threshold=2, retry_backoff_s=0.0,
                  breaker_probe_s=probe_s)
  eng.prewarm(ragged)
  chain = [b for b, _, _ in eng._fallback_arms(request_bucket(ragged[0]))]
  res, k1, k2, dt_xla = counted(lambda: serve_all(eng, ragged))
  expect(all(same_result(g, w) for g, w in zip(res, results[4:12]))
         and k1 == 0 and k2 == 0, f"K2->xla: k1={k1} k2={k2}")
  # the cooldown passes with the faults cleared: K2's probe closes it
  inj.clear()
  time.sleep(probe_s + 0.05)
  res, k1b, k2b, dt_k2 = counted(lambda: serve_all(eng, ragged))
  expect(all(same_result(g, w) for g, w in zip(res, results[4:12]))
         and k2b > 0, "the K2 probe did not serve the ragged bucket")
  states = {c["backend"]: (c["state"], c["opens"], c["closes"])
            for c in eng.resilience.snapshot()}
  expect(states.get("megakernel", ("",))[0] == "closed"
         and states.get("xla", ("closed",))[0] == "closed",
         f"breakers after the K2 probe: {states}")
  out["breaker_k2_xla"] = {"chain": chain, "xla_s": dt_xla, "k2_s": dt_k2,
                           "breakers": states}
  log(f"[ops] ragged x8 on megakernel, ranked chain {chain}: K2 and K1 "
      f"broken -> served on xla in {dt_xla:.3f}s (K1 {k1}, K2 {k2} "
      f"launches), equal to phase 4; after the cooldown K2's probe served "
      f"it in {dt_k2:.3f}s (K2 launches={k2b}); breakers (state, opens, "
      f"closes) {states}")

  # (e) arena: a NaN poison on one slot fails it alone, a transient tick
  # fault is retried, the other residents equal batch mode
  closures = [reqs[i] for i in closure_idx]
  inj = FaultInjector([FaultRule(point="execute", backend="arena",
                                 mode="transient", count=1)])
  arena = MMOEngine(mode="arena", arena_capacity=8, arena_g=4,
                    device="cuda", faults=inj, retry_backoff_s=0.0)
  arena.prewarm(closures)
  futs = [arena.submit(r) for r in closures]
  victim = len(closures) - 3
  inj.arm(FaultRule(point="nonfinite", backend="arena",
                    request_ids={futs[victim].request.request_id}))
  _, k1, k2, dt = counted(arena.run_until_idle)
  for j, (i, f) in enumerate(zip(closure_idx, futs)):
    if j == victim:
      try:
        f.result()
        expect(False, "the poisoned arena slot completed")
      except NonFiniteResultError:
        pass
    else:
      expect(same_result(f.result(), results[i]),
             f"arena request {i} differs from batch mode")
  snap = arena.metrics_snapshot()
  expect(k2 > 0 and k1 == 0 and snap["counters"]["retries"] >= 1
         and snap["batch_failures_by_kind"] == {"execute": 1,
                                                "nonfinite": 1},
         f"arena chaos: k1={k1} k2={k2} {snap['batch_failures_by_kind']}")
  log(f"[ops] arena: transient tick fault retried "
      f"(retries={snap['counters']['retries']}), the NaN slot failed alone, "
      f"{len(closures) - 1} residents equal batch mode; K2 launches={k2}, "
      f"{dt:.3f}s")

  # (f) telemetry: the arena engine's trace, through a file
  with tempfile.TemporaryDirectory() as tmp:
    path = Path(tmp) / "trace.json"
    path.write_text(json.dumps(arena.export_trace()), encoding="utf-8")
    events = json.loads(path.read_text(encoding="utf-8"))["traceEvents"]
  admits = sum(ev.get("ph") == "b" and ev["name"] == "execute"
               and "slot" in ev.get("args", {}) for ev in events)
  ticks = sum(ev["name"] == "arena_tick" for ev in events)
  expect(trace_balanced(events) and admits == len(closures) and ticks > 0,
         f"arena trace: admits={admits} ticks={ticks}")
  log(f"[ops] arena trace: {len(events)} events, balanced, arena_admit="
      f"{admits} arena_tick={ticks}, {arena.tracer.stats()}")

  # (g) the watchdog: a 1 s stall under a 0.1 s watchdog fails its batch;
  # the next batch of the bucket completes and is right
  inj = FaultInjector([FaultRule(point="slow", mode="transient", count=1,
                                 delay_s=1.0, match=ragged_label)])
  eng = MMOEngine(backend="pallas", device="cuda", faults=inj,
                  watchdog_s=0.1, transient_retries=0, bisect=False,
                  breaker_threshold=None)
  eng.prewarm(ragged)
  futs = [eng.submit(r) for r in ragged]
  _, k1, _, dt_fail = counted(eng.run_until_idle)
  timed_out = 0
  for f in futs:
    try:
      f.result()
    except BatchTimeoutError:
      timed_out += 1
  res, k1b, _, dt_next = counted(lambda: serve_all(eng, ragged))
  expect(timed_out == len(ragged) and k1 == 0 and k1b > 0
         and all(same_result(g, w) for g, w in zip(res, results[4:12])),
         f"watchdog: timed out {timed_out}, k1 {k1}/{k1b}")
  t0 = time.perf_counter()
  still = eng.join_abandoned(timeout=30.0)
  expect(still == 0, "an abandoned watchdog worker did not end")
  log(f"[ops] watchdog 0.1s vs a 1.0s stall: {timed_out} requests failed "
      f"with BatchTimeoutError after {dt_fail:.3f}s; the next batch of the "
      f"bucket completed in {dt_next:.3f}s (K1 launches={k1b}), equal to "
      f"phase 4; abandoned worker joined {time.perf_counter() - t0:.3f}s "
      f"later")
  out["watchdog"] = {"fail_s": dt_fail, "next_s": dt_next}

  # (h) the tracer's cost: the fault-free stream with it on and off
  engines = {on: MMOEngine(backend="pallas", device="cuda", trace=on)
             for on in (True, False)}
  for e in engines.values():
    e.prewarm(reqs)
    serve_all(e, reqs)  # every function's first run
  walls = {True: [], False: []}
  for on in (True, False, False, True, True, False):
    got, _, _, dt = counted(lambda e=engines[on]: serve_all(e, reqs))
    walls[on].append(dt)
    expect(all(result_equal(r.kind, g, w)
               for r, g, w in zip(reqs, got, results)),
           "the stream differs from phase 4")
  on_s, off_s = sum(walls[True]) / 3, sum(walls[False]) / 3
  out["overhead"] = {"on_s": walls[True], "off_s": walls[False],
                     "ratio": on_s / off_s}
  log(f"[ops] Table-4 stream, tracer on {walls[True]} s, off "
      f"{walls[False]} s: mean on/off = {on_s / off_s:.4f} "
      f"({engines[True].tracer.stats()['recorded']} events recorded)")
  log(f"[ops] phase 4e in {time.perf_counter() - t_phase:.1f}s")
  out.update(total)
  return out


FA_CASES = [
    # b, h, hkv, sq, skv, d, causal, window (tests/test_kernels.py)
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 8, 2, 96, 160, 32, True, None),
    (2, 4, 4, 128, 128, 64, False, None),
    (1, 4, 1, 200, 200, 64, True, 96),
    (1, 2, 2, 64, 256, 128, True, None),
    (1, 4, 4, 160, 160, 80, True, None),
]
LM_FA_CASE = (LM_BATCH, 32, 4, LM_PROMPT, LM_PROMPT, 64, True, None)
# the served shapes of phases 11 and 12: mixtral-8x7b's attention (32 heads
# over 8 kv heads of 128, window 4096) and zamba2-7b's shared block (32
# heads, 32 kv heads of 112), both at the 4 × 2048 prefill
MIXTRAL_FA_CASE = (LM_BATCH, 32, 8, LM_PROMPT, LM_PROMPT, 128, True, 4096)
ZAMBA_FA_CASE = (LM_BATCH, 32, 32, LM_PROMPT, LM_PROMPT, 112, True, None)


def fa_inputs(torch, case, dtype, seed):
  b, h, hkv, sq, skv, d = case[:6]
  gen = torch.Generator(device="cuda").manual_seed(seed)
  q = torch.randn(b, h, sq, d, generator=gen, device="cuda").to(dtype)
  k = torch.randn(b, hkv, skv, d, generator=gen, device="cuda").to(dtype)
  v = torch.randn(b, hkv, skv, d, generator=gen, device="cuda").to(dtype)
  return q, k, v


def check_fa(fa, torch, case, dtype, seed=0) -> float:
  """K3 against its plain version on one case, at FA_ATOL for the dtype."""
  causal, window = case[6], case[7]
  q, k, v = fa_inputs(torch, case, dtype, seed)
  got = fa.flash_attention(q, k, v, causal=causal, window=window)
  want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
  torch.cuda.synchronize()
  name = str(dtype).removeprefix("torch.")
  err = max_abs_err(got, want)
  ok = (got.dtype == want.dtype and got.shape == want.shape
        and not bool(torch.isnan(got).any()) and err <= FA_ATOL[name])
  log(f"[check] K3 {name} {case}: max_abs_err={err!r} "
      f"{'ok' if ok else 'FAIL'}")
  if not ok:
    raise AssertionError(f"K3 disagrees with its plain version on {case}")
  return err


# Phase 8: the rest of the applications.  Sizes from the paper's Table 4
# (repro_torch.configs.simd2_apps): MST and GTC at APP_SIZES "small"
# (1024); the five Floyd-Warshall apps and KNN at BENCH_SIZES "large"
# (1024), because their numpy k-pivot baseline at Table 4's 4096 would take
# minutes on the host (phase 4 serves APSP 4096 against the plain path).
APP_OPS = {"apsp": "minplus", "aplp": "maxplus", "mcp": "maxmin",
           "maxrp": "maxmul", "minrp": "minmul", "mst": "minmax",
           "gtc": "orand"}
NEWTON_N, NEWTON_ITERS = 4096, 32
# newton_inverse's limits, A = G Gᵀ + n·I (G standard normal, κ ≈ 5):
# four times what an H100 measured with this seed, ‖AX − I‖∞ 2.98e-7 and
# max |X − A⁻¹ (float64)| / max |A⁻¹| 6.39e-7 (the 3×TF32 products hold
# f32 accuracy; another card's cuBLAS may form G Gᵀ in another order)
NEWTON_RESID_MAX = 1.2e-6
NEWTON_REL_MAX = 2.6e-6
# k-means: 256 centres with 64 points each, D = 16 (the KNN corpus's
# width), 20 iterations
KMEANS_K, KMEANS_PER, KMEANS_D, KMEANS_ITERS = 256, 64, 16, 20
SPARSE_N = 1024  # the gathered (M, K/2, N) f32 block: 2 GiB (128 at 4096)


def app_size(app: str) -> int:
  """MST and GTC at APP_SIZES "small"; minrp at BENCH_SIZES "small" (its
  minimum-reliability products fall below f32's smallest normal from 512
  on: they underflow to 0, 0 ⊗ ∞ is NaN, and NaN reaches every entry, in
  the reference's f32 arithmetic as in the port's); the others at
  BENCH_SIZES "large"."""
  from repro_torch.configs.simd2_apps import APP_SIZES, BENCH_SIZES
  if app in ("mst", "gtc"):
    return APP_SIZES[app]["small"]
  return BENCH_SIZES[app]["small" if app == "minrp" else "large"]


def app_inputs(graphs, app: str, n: int, seed: int = 0) -> tuple:
  """One application's inputs, built as benchmarks/apps_bench.py::_inputs
  builds them."""
  if app == "apsp":
    return (graphs.weighted_digraph(n, 0.25, seed=seed),)
  if app == "aplp":
    return (graphs.dag(n, 0.25, seed=seed),)
  if app == "mcp":
    return (graphs.capacity_graph(n, 0.25, seed=seed),)
  if app == "maxrp":
    return (graphs.reliability_graph(n, 0.25, seed=seed, maximize=True),)
  if app == "minrp":
    return (graphs.reliability_graph(n, 0.25, seed=seed, maximize=False),)
  if app == "mst":
    return (graphs.undirected_weighted(n, 0.3, seed=seed),)
  if app == "gtc":
    return (graphs.boolean_digraph(n, 0.03, seed=seed),)
  if app == "knn":
    return graphs.knn_points(n, max(32, n // 8), 64, seed=seed)
  raise KeyError(app)


def app_baseline(app: str, n: int):
  """The port's numpy baseline of one application at size n (in a worker
  process: the k-pivot and BFS loops are host-bound)."""
  import numpy as np
  from repro_torch.apps import baselines as bl
  from repro_torch.apps import graphs
  x = app_inputs(graphs, app, n)
  if app == "apsp":
    return bl.apsp_np(np.where(np.eye(n, dtype=bool), 0, x[0]))
  if app == "mst":
    return bl.minimax_paths_np(x[0]), bl.kruskal_mst_np(x[0])[0]
  if app == "knn":
    return bl.knn_np(x[0], x[1], 8)
  return {"aplp": bl.aplp_np, "mcp": bl.maxcp_np, "maxrp": bl.maxrp_np,
          "minrp": bl.minrp_np, "gtc": bl.gtc_np}[app](x[0])


def app_holds(np, app: str, n: int, got, ref) -> tuple:
  """(ok, max |err| on the finite entries): tests/test_apps.py's checks
  and tolerances; for aplp's long paths rtol n·2⁻²⁴, the f32 rounding of a
  sum of up to n hops."""
  if app == "gtc":
    return bool(np.array_equal(got, ref)), 0.0
  if app == "mst":
    mm, edges = got
    mm_ref, edges_ref = ref
    fin = np.isfinite(mm_ref) & ~np.eye(n, dtype=bool)
    err = float(np.abs(mm[fin] - mm_ref[fin]).max())
    return (bool(np.allclose(mm[fin], mm_ref[fin], rtol=1e-7, atol=1e-4))
            and edges == edges_ref), err
  g = np.asarray(got, np.float64)
  fin = np.isfinite(ref)
  err = float(np.abs(g[fin] - ref[fin]).max())
  rtol, atol = {"apsp": (1e-5, 1e-4), "aplp": (n * 2.0 ** -24, 1e-4),
                "mcp": (1e-7, 1e-4), "maxrp": (1e-7, 1e-5),
                "minrp": (1e-5, 1e-5)}[app]
  ok = bool(np.allclose(g[fin], ref[fin], rtol=rtol, atol=atol))
  if app in ("apsp", "minrp"):
    ok = ok and bool(np.array_equal(~np.isfinite(g), ~fin))
  if app == "maxrp":
    ok = ok and bool(fin.all())
  return ok, err


def phase_apps(sm, mk, torch, np) -> dict:
  """Phase 8: the eight solvers on 'pallas' against the port's numpy
  baselines, the closure apps on the fused arm, newton_inverse at 4096,
  kmeans, the sparse module, and the new dtypes through the engine.
  Returns the K1/K2 launches and the per-step host seconds."""
  import multiprocessing
  from concurrent.futures import ProcessPoolExecutor
  from repro_torch.apps import extras, graphs
  from repro_torch.apps import solvers as sv
  from repro_torch.core import closure as cl
  from repro_torch.core import sparse
  from repro_torch.core.mmo import mmo
  from repro_torch.serve_mmo import MMOEngine, closure_request, mmo_request
  t_phase = time.perf_counter()
  k1_0, k2_0 = sm.semiring_mmo.launches, mk.fixpoint_chunk.launches
  steps = []

  def step(name, fn):
    k1, k2 = sm.semiring_mmo.launches, mk.fixpoint_chunk.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rec = {"step": name, "s": dt, "k1": sm.semiring_mmo.launches - k1,
           "k2": mk.fixpoint_chunk.launches - k2}
    steps.append(rec)
    log(f"[apps] {name}: {dt:.3f}s, K1 launches {rec['k1']}, K2 launches "
        f"{rec['k2']}")
    return out

  # (a) the eight apps on 'pallas' while the baselines run on the host
  apps = list(APP_OPS) + ["knn"]
  ctx = multiprocessing.get_context("spawn")
  with ProcessPoolExecutor(max_workers=len(apps), mp_context=ctx) as pool:
    t_base = time.perf_counter()
    futs = {app: pool.submit(app_baseline, app, app_size(app))
            for app in apps}
    got = {}
    for app in apps:
      n = app_size(app)
      x = app_inputs(graphs, app, n)
      if app == "knn":
        got[app] = step(f"(a) knn {n} refs x {len(x[1])} queries x 64, k=8",
                        lambda: [t.cpu().numpy() for t in sv.knn(
                            x[0], x[1], k=8, backend="pallas")])
      elif app == "mst":
        def run_mst():
          mm, it = sv.mst_minimax(x[0], backend="pallas")
          in_mst, _ = sv.mst_edges(x[0], backend="pallas")
          edges = {(min(i, j), max(i, j))
                   for i, j in zip(*np.nonzero(in_mst.cpu().numpy()))}
          return mm.cpu().numpy(), edges, int(it)
        got[app] = step(f"(a) mst {n}", run_mst)
      else:
        def run_closure_app():
          out, it = sv.ALL_APPS[app](x[0], backend="pallas")
          return out.cpu().numpy(), int(it)
        got[app] = step(f"(a) {app} {n}", run_closure_app)
    refs = {app: f.result(timeout=600) for app, f in futs.items()}
    log(f"[apps] numpy baselines in {time.perf_counter() - t_base:.1f}s "
        f"({len(apps)} worker processes)")
  for app in apps:
    n = app_size(app)
    if app == "knn":
      x = app_inputs(graphs, app, n)
      (d_got, i_got), (d_ref, i_ref) = got[app], refs[app]
      # near-tie rule: a differing index must be as near in float64
      q, r = x[1].astype(np.float64), x[0].astype(np.float64)
      d_at = ((q[:, None, :] - r[i_got.astype(np.int64)]) ** 2).sum(-1)
      flips = int((i_got != i_ref).sum())
      ok = (np.allclose(d_got, d_ref, rtol=1e-3, atol=1e-3)
            and np.allclose(d_at, d_ref, rtol=1e-3, atol=1e-3))
      err = float(np.abs(d_got - d_ref).max())
      log(f"[apps] knn vs knn_np: indices differing {flips} (near ties), "
          f"max |d err| {err!r} {'ok' if ok else 'FAIL'}")
    elif app == "mst":
      mm, edges, _ = got[app]
      ok, err = app_holds(np, app, n, (mm, edges), refs[app])
      log(f"[apps] mst vs minimax_paths_np/kruskal_mst_np: {len(edges)} "
          f"edges, max |err| {err!r} {'ok' if ok else 'FAIL'}")
    else:
      ok, err = app_holds(np, app, n, got[app][0], refs[app])
      log(f"[apps] {app} vs its baseline: iterations {got[app][1]}, max "
          f"|err| {err!r} {'ok' if ok else 'FAIL'}")
    if not ok:
      raise AssertionError(f"{app} differs from its numpy baseline")
  # the closure apps on the fused arm: equal to 'pallas', iterations too
  for app, op in APP_OPS.items():
    n = app_size(app)
    x = app_inputs(graphs, app, n)[0]
    adj = cl.prepare_adjacency(torch.from_numpy(x).cuda(), op=op)[None]
    out, it = step(f"(a) {app} {n} on the fused arm",
                   lambda: cl.batched_leyzorek_closure(
                       adj, op=op, fixpoint_backend="megakernel"))
    want, want_it = (got[app][0], got[app][2]) if app == "mst" else got[app]
    out = out[0].cpu().numpy()
    if not (np.array_equal(out, want, equal_nan=out.dtype.kind == "f")
            and int(it[0]) == int(want_it)):
      raise AssertionError(f"{app}: the fused arm differs from 'pallas'")
  log("[apps] the seven closure apps on the fused arm equal 'pallas' "
      "(values and iterations)")

  # (b) newton_inverse at 4096 on K1 mma
  g = torch.Generator().manual_seed(31)
  gm = torch.randn(NEWTON_N, NEWTON_N, generator=g).cuda()
  a = gm @ gm.T + NEWTON_N * torch.eye(NEWTON_N, device="cuda")
  inv, resid = step(f"(b) newton_inverse n={NEWTON_N} iters={NEWTON_ITERS}",
                    lambda: extras.newton_inverse(a, iters=NEWTON_ITERS,
                                                  backend="pallas"))
  if steps[-1]["k1"] != 2 * NEWTON_ITERS + 1:
    raise AssertionError(f"newton_inverse launched K1 {steps[-1]['k1']} "
                         f"times, want {2 * NEWTON_ITERS + 1}")
  inv64 = torch.linalg.inv(a.double())
  rel = float((inv.double() - inv64).abs().max() / inv64.abs().max())
  resid = float(resid)
  log(f"[apps] newton_inverse: ‖AX − I‖∞ {resid!r} (limit "
      f"{NEWTON_RESID_MAX}), max |X − inv64| / max |inv64| {rel!r} (limit "
      f"{NEWTON_REL_MAX})")
  if not (resid <= NEWTON_RESID_MAX and rel <= NEWTON_REL_MAX):
    raise AssertionError("newton_inverse outside its limits")
  del gm, a, inv, inv64

  # (c) kmeans on K1 addnorm against the 'xla' arm
  rng = np.random.default_rng(37)
  cents = rng.uniform(-2.0, 2.0, (KMEANS_K, KMEANS_D))
  while True:  # well separated: every pair of centres at least 1 apart
    d = np.sqrt(((cents[:, None] - cents[None]) ** 2).sum(-1))
    np.fill_diagonal(d, np.inf)
    close = np.nonzero(d.min(axis=1) < 1.0)[0]
    if not len(close):
      break
    cents[close[:1]] = rng.uniform(-2.0, 2.0, (1, KMEANS_D))
  pts = (np.repeat(cents, KMEANS_PER, axis=0) + 0.05 * rng.standard_normal(
      (KMEANS_K * KMEANS_PER, KMEANS_D))).astype(np.float32)
  init = np.arange(KMEANS_K) * KMEANS_PER  # one point of each cluster
  km = step(f"(c) kmeans {KMEANS_K} x {KMEANS_PER} points, D={KMEANS_D}, "
            f"{KMEANS_ITERS} iterations on K1",
            lambda: extras.kmeans(pts, k=KMEANS_K, iters=KMEANS_ITERS,
                                  init_idx=init, backend="pallas"))
  kx = extras.kmeans(pts, k=KMEANS_K, iters=KMEANS_ITERS, init_idx=init,
                     backend="xla")
  d2 = ((pts.astype(np.float64)[:, None] - km[0].cpu().double().numpy()[None])
        ** 2).sum(-1)
  d2.sort(axis=1)
  margin = float((d2[:, 1] - d2[:, 0]).min())
  labels = np.repeat(np.arange(KMEANS_K), KMEANS_PER)
  ok = (torch.equal(km[1], kx[1])
        and np.array_equal(km[1].cpu().numpy(), labels)
        and torch.allclose(km[0], kx[0], **TOL)
        and abs(float(km[2]) - float(kx[2])) <= len(pts) * TOL["atol"])
  log(f"[apps] kmeans: assignments equal the 'xla' arm's and the clusters; "
      f"centroid max |d| {max_abs_err(km[0], kx[0])!r}, inertia "
      f"{float(km[2])!r} vs {float(kx[2])!r}; smallest margin between a "
      f"point's two nearest centroids {margin!r} (f64) "
      f"{'ok' if ok else 'FAIL'}")
  if not ok or margin <= 1e-2:
    raise AssertionError("kmeans: K1 differs from the 'xla' arm")

  # (d) sparse: 2:4 pruning and the compacted contraction, card vs CPU
  g = torch.Generator().manual_seed(41)
  a_c = torch.randn(SPARSE_N, SPARSE_N, generator=g)
  b_c = torch.randn(SPARSE_N, SPARSE_N, generator=g)
  vals, idx = step(f"(d) prune_24 {SPARSE_N}²",
                   lambda: sparse.prune_24(a_c.cuda()))
  vals_c, idx_c = sparse.prune_24(a_c)
  if not (torch.equal(vals.cpu(), vals_c) and torch.equal(idx.cpu(), idx_c)):
    raise AssertionError("prune_24 on the card differs from the CPU")
  b_g = b_c.cuda()
  for op in ("mma", "minplus", "maxmin"):
    out = step(f"(d) mmo_sparse24 {op} {SPARSE_N}³ (K/2 = {SPARSE_N // 2} "
               f"gathered)", lambda: sparse.mmo_sparse24(vals, idx, b_g,
                                                         op=op))
    check(f"mmo_sparse24 {op} card vs CPU", out,
          sparse.mmo_sparse24(vals_c, idx_c, b_c, op=op).cuda(), op)
    if op == "mma":
      dense = mmo(sparse.densify_24(vals, idx, SPARSE_N), b_g, op="mma",
                  backend="pallas")
      check("mmo_sparse24 mma vs K1 on densify_24", out, dense, "mma")
    del out
  # CSR at two densities, against dense K1 on the same matrix (integer
  # weights: minplus sums are exact in f32 and float64 alike)
  rng = np.random.default_rng(43)
  bm = rng.integers(1, 10, (SPARSE_N, SPARSE_N)).astype(np.float32)
  for density in (0.01, 0.1):
    for op in ("minplus", "mma"):
      w = rng.integers(1, 10, (SPARSE_N, SPARSE_N)).astype(np.float32)
      am = np.where(rng.random(w.shape) < density, w,
                    np.float32(sparse.csr_absent_value(op)))
      csr = sparse.to_csr(am, op=op)
      got_csr = step(f"(d) csr_spmm {op} density {density} "
                     f"({len(csr[2])} stored)",
                     lambda: sparse.csr_spmm(*csr, bm, op=op))
      dense = mmo(torch.from_numpy(am).cuda(), torch.from_numpy(bm).cuda(),
                  op=op, backend="pallas")
      check(f"csr_spmm {op} density {density} vs dense K1",
            torch.from_numpy(got_csr).cuda().float(), dense, op)

  # (e) float16 and int32 through the engine: K1's new instances on
  # mmo requests, K2's on closure requests
  rng = np.random.default_rng(47)
  ints = rng.integers(-1000, 1001, (2, 512, 512)).astype(np.int32)
  halves = rng.standard_normal((2, 512, 512)).astype(np.float16)
  cint = rng.integers(1, 100, (256, 256)).astype(np.int32)
  cint[rng.random(cint.shape) > 0.2] = 1 << 29  # no edge, and no wrap
  np.fill_diagonal(cint, 0)
  chalf = graphs.weighted_digraph(256, 0.2, seed=48).astype(np.float16)
  reqs = [mmo_request(ints[0], ints[1], op="minplus"),
          mmo_request(halves[0], halves[1], op="minplus")]
  closures = [closure_request(cint, op="minplus", prepared=True),
              closure_request(chalf, op="minplus", prepared=True)]
  eng = MMOEngine(backend="pallas", max_batch=4, device="cuda")
  res = step("(e) int32 and float16 minplus mmo + closures on 'pallas'",
             lambda: serve_all(eng, reqs + closures))
  fused = MMOEngine(backend="megakernel", max_batch=4, device="cuda")
  fres = step("(e) the int32 and float16 closures on the fused arm",
              lambda: serve_all(fused, closures))
  for r, x in zip(res[:2], (ints, halves)):
    want = sm.semiring_mmo_plain(torch.from_numpy(x[:1]).cuda(),
                                 torch.from_numpy(x[1:]).cuda(),
                                 op="minplus")[0].cpu().numpy()
    if not (r.value.dtype == x.dtype and np.array_equal(r.value, want)):
      raise AssertionError(f"{x.dtype} mmo request differs from the plain "
                           f"version")
  for got_r, want_r in zip(fres, res[2:]):
    if not same_result(got_r, want_r):
      raise AssertionError("the fused arm differs from 'pallas' on an "
                           "int32 or float16 closure")
  log("[apps] int32 and float16: mmo requests equal the plain version, "
      "closures equal on both arms (values and iterations)")
  total = time.perf_counter() - t_phase
  log(f"[apps] phase 8 in {total:.1f}s")
  return {"k1": sm.semiring_mmo.launches - k1_0,
          "k2": mk.fixpoint_chunk.launches - k2_0, "steps": steps,
          "seconds": total, "newton": {"resid": resid, "rel": rel},
          "kmeans_margin": margin}


def phase_flash_vs_plain(fa, torch) -> float:
  """Phase 3, K3: the LM main path's shape, FA_CASES in f32 and in bf16
  (the tensor-core instance: all five head dims, Sq ≠ Skv, a window,
  non-causal), head dim 128 at a longer sequence, rows that see no key in
  both dtypes, a steep score (q × 20: the running max jumps between kv
  tiles, so the rescale carries the result with bf16 P), and strided views
  with ``out=`` as the model launches it.  Returns the main shape's max
  |err|."""
  from repro_torch.kernels import ops
  main_err = check_fa(fa, torch, LM_FA_CASE, torch.bfloat16)
  for case in FA_CASES:
    check_fa(fa, torch, case, torch.float32)
    check_fa(fa, torch, case, torch.bfloat16)
  check_fa(fa, torch, (1, 16, 2, 300, 300, 128, True, None), torch.bfloat16)
  check_fa(fa, torch, (2, 4, 2, 40, 40, 16, True, None), torch.bfloat16)
  # Sq > Skv, causal: rows 0..31 see no key and end as the mean of V (the
  # TPU kernel's finite mask sentinel), not NaN; in bf16 every P there is
  # exactly 1, so the mean holds to one ulp of the bf16 output
  case = (1, 2, 2, 96, 64, 32, True, None)
  for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -8)):
    check_fa(fa, torch, case, dtype, seed=5)
    q, k, v = fa_inputs(torch, case, dtype, 5)
    got = fa.flash_attention(q, k, v, causal=True)[:, :, :32].float()
    mean_v = v.float().mean(dim=2, keepdim=True).expand_as(got)
    if not torch.allclose(got, mean_v, rtol=0, atol=atol):
      raise AssertionError(f"K3 {dtype}: rows with no key are not the mean "
                           f"of V")
  log("[check] K3 rows with no key (f32, bf16): the mean of V, as the TPU "
      "kernel's")
  gen = torch.Generator(device="cuda").manual_seed(9)
  q = (torch.randn(2, 8, 512, 64, generator=gen, device="cuda") * 20).to(
      torch.bfloat16)
  k, v = (torch.randn(2, 2, 512, 64, generator=gen, device="cuda").to(
      torch.bfloat16) for _ in range(2))
  err = max_abs_err(fa.flash_attention(q, k, v),
                    fa.flash_attention_plain(q, k, v))
  log(f"[check] K3 bfloat16 steep scores (q × 20): max_abs_err={err!r}")
  if err > FA_ATOL["bfloat16"]:
    raise AssertionError("K3 disagrees with its plain version on steep "
                         "scores")
  for dtype in (torch.float32, torch.bfloat16):
    qb, kb, vb = (torch.randn(2, 300, n, 64, generator=gen,
                              device="cuda").to(dtype) for n in (8, 2, 2))
    views = [t.transpose(1, 2) for t in (qb, kb, vb)]
    want = fa.flash_attention(*[t.contiguous() for t in views], window=100)
    buf = torch.full_like(qb, float("nan"))
    ops.flash_attention(*views, window=100, out=buf.transpose(1, 2))
    if not torch.equal(buf.transpose(1, 2), want):
      raise AssertionError(f"K3 {dtype}: strided views with out= differ "
                           f"from the contiguous call")
  log("[check] K3 strided q, k, v views with out= (f32, bf16): the "
      "contiguous call's bits")
  # head dim 112 (zamba2's shared block): its prefill shape, Sq ≠ Skv and a
  # strided view with out=, in both dtypes; mixtral's served shape in bf16
  for dtype in (torch.float32, torch.bfloat16):
    check_fa(fa, torch, ZAMBA_FA_CASE, dtype, seed=3)
    check_fa(fa, torch, (1, 8, 8, 96, 160, 112, True, None), dtype, seed=3)
    qb, kb, vb = (torch.randn(2, 300, 8, 112, generator=gen,
                              device="cuda").to(dtype) for _ in range(3))
    views = [t.transpose(1, 2) for t in (qb, kb, vb)]
    want = fa.flash_attention(*[t.contiguous() for t in views])
    buf = torch.full_like(qb, float("nan"))
    ops.flash_attention(*views, out=buf.transpose(1, 2))
    if not torch.equal(buf.transpose(1, 2), want):
      raise AssertionError(f"K3 {dtype} head dim 112: strided views with out= "
                           f"differ from the contiguous call")
  log("[check] K3 head dim 112 strided views with out= (f32, bf16): the "
      "contiguous call's bits")
  check_fa(fa, torch, MIXTRAL_FA_CASE, torch.bfloat16, seed=3)
  return main_err


def visible_pairs(sq: int, skv: int, causal: bool, window) -> int:
  """(query, key) pairs a row-aligned causal/window mask lets through."""
  import numpy as np
  qpos = np.arange(sq, dtype=np.int64) + (skv - sq)
  hi = np.minimum(qpos, skv - 1) if causal else np.full(sq, skv - 1)
  lo = np.maximum(qpos - window + 1, 0) if window is not None else 0
  return int(np.clip(hi - lo + 1, 0, None).sum())


def attention_bound_ms(case, dtype: str) -> tuple:
  """Least time for one attention call: 4·D flops and one exp per visible
  (query, key) pair per head, at the tensor-core peak for the type and the
  SFU exp rate; or q, k, v read once and out written once at HBM bandwidth
  — whichever is largest."""
  b, h, hkv, sq, skv, d, causal, window = case
  pairs = b * h * visible_pairs(sq, skv, causal, window)
  isz = {"float32": 4, "bfloat16": 2}[dtype]
  nbytes = isz * d * (2 * b * h * sq + 2 * b * hkv * skv)
  t_ops = max(4.0 * d * pairs / hw.PEAK_OPS[dtype], pairs / SFU_EXP_S)
  t_bytes = nbytes / hw.PEAK_BYTES_S
  return (max(t_ops, t_bytes) * 1e3,
          "operations" if t_ops >= t_bytes else "bytes")


def ssd_inputs(torch, shape, dtype, seed=0, decay=(0.001, 0.1)):
  """K4's operands on the card: c, b (BZ, G, Q, N), x (BZ, H, Q, P), dt,
  cum (BZ, H, Q); cum is a cumsum of negative decays drawn from ``decay``,
  as ssd_chunked builds it."""
  bz, h, g, q, n, p = shape
  gen = torch.Generator(device="cuda").manual_seed(seed)
  def rnd(*size):
    return torch.randn(*size, generator=gen, device="cuda")
  def uni(lo, hi, *size):
    return torch.rand(*size, generator=gen, device="cuda") * (hi - lo) + lo
  c, b, x = rnd(bz, g, q, n), rnd(bz, g, q, n), rnd(bz, h, q, p)
  dt = uni(0.01, 0.2, bz, h, q)
  cum = torch.cumsum(-uni(*decay, bz, h, q), dim=-1)
  return [t.to(dtype) for t in (c, b, x, dt, cum)]


def check_ssd(ssd, torch, shape, dtype, tol, seed=0, **kw) -> float:
  """K4 against its plain version on one case: finite, within ``tol``."""
  args = ssd_inputs(torch, shape, dtype, seed, **kw)
  got = ssd.ssd_intra_chunk(*args)
  want = ssd.ssd_intra_chunk_plain(*args)
  torch.cuda.synchronize()
  err = max_abs_err(got, want)
  ok = (got.dtype == want.dtype and got.shape == want.shape
        and bool(torch.isfinite(got).all())
        and torch.allclose(got, want, **tol))
  name = str(dtype).removeprefix("torch.")
  log(f"[check] K4 {name} (BZ, H, G, Q, N, P)={shape}{' ' + str(kw) if kw else ''}: "
      f"max_abs_err={err!r} {'ok' if ok else 'FAIL'}")
  if not ok:
    raise AssertionError(f"K4 disagrees with its plain version on {shape}")
  return err


def phase_ssd_vs_plain(ssd, torch) -> float:
  """Phase 3, K4: the reference test's shapes in f32 and bf16, the main
  path's shape in f32 and bf16, grouped cases, the design's edges (N, P,
  Q past one pass, a ragged head block), and exp overflow above the
  diagonal.
  Returns the main shape's max |err|."""
  for shape in SSD_REF_SHAPES:
    for dtype in (torch.float32, torch.bfloat16):
      t = SSD_REF_TOL[str(dtype).removeprefix("torch.")]
      check_ssd(ssd, torch, shape, dtype, {"rtol": t, "atol": t})
  main_err = check_ssd(ssd, torch, SSD_MAIN_SHAPE, torch.float32,
                       SSD_LONG_TOL, seed=1)
  check_ssd(ssd, torch, SSD_MAIN_SHAPE, torch.bfloat16, SSD_LONG_TOL, seed=1)
  # zamba2's shape: the head block at 112 heads
  for dtype in (torch.float32, torch.bfloat16):
    check_ssd(ssd, torch, SSD_ZAMBA_SHAPE, dtype, SSD_LONG_TOL, seed=1)
  for shape in SSD_GROUPED_SHAPES + SSD_EDGE_SHAPES:
    check_ssd(ssd, torch, shape, torch.float32, SSD_LONG_TOL, seed=1)
  # a group's 48 heads in CTA head blocks with a smaller last block
  bz = next(bz for bz in range(1, 257)
            if (hb := ssd.head_block(torch.float32, 64, bz, 48, 1, 100)) > 1
            and 48 % hb)
  check_ssd(ssd, torch, (bz, 48, 1, 100, 64, 64), torch.float32,
            SSD_LONG_TOL, seed=1)
  # decays of 0.5–1.5 per row: exp(cum_q − cum_k) is +inf far above the
  # diagonal; the kernel's select must keep it out (no inf · 0 = NaN)
  check_ssd(ssd, torch, (2, 4, 1, 256, 32, 64), torch.float32, SSD_LONG_TOL,
            seed=2, decay=(0.5, 1.5))
  return main_err


def ssd_bound_ms(shape, isz: int) -> tuple:
  """Least time for one K4 call on f32 operands: per causal (q, k ≤ q)
  pair, the score's 2·N flops once per group (the heads of a group share
  C Bᵀ) and 2·P flops and one exp per head, the products at f32 accuracy
  on the tensor cores (three TF32 products each, as K1's mma) and the exps
  at the SFU rate; or C and B read once per group, X, dt and cum once per
  head, and the f32 Y written once, at HBM bandwidth — whichever is
  largest.  Also returns the products' time at the f32 CUDA-core rate, the
  bound before the kernel ran on the tensor cores."""
  bz, h, g, q, n, p = shape
  tri = q * (q + 1) // 2
  pairs = bz * h * tri
  flops = 2.0 * n * bz * g * tri + 2.0 * p * pairs
  t_ops = max(3 * flops / hw.PEAK_TF32, pairs / SFU_EXP_S)
  nbytes = isz * (2 * bz * g * q * n + bz * h * q * p + 2 * bz * h * q) \
      + 4 * bz * h * q * p
  t_bytes = nbytes / hw.PEAK_BYTES_S
  return (max(t_ops, t_bytes) * 1e3,
          "operations" if t_ops >= t_bytes else "bytes",
          flops / hw.PEAK_OPS["float32"] * 1e3)


def ptxas_summary(build_log: str) -> tuple:
  """Per kernel instantiation (name and mangled template arguments):
  registers, shared memory and barriers as ptxas reports them; and every
  non-zero spill."""
  import re
  lines = build_log.splitlines()
  regs = []
  for i, line in enumerate(lines):
    hit = re.search(r"_kernelI(\w*?)EEEv", line)
    if "Function properties" not in line or not hit:
      continue
    # the mangled name is "<length><name>_kernel": find the length that fits
    head = line[:hit.start()]
    name = next((head[d.end():] for d in reversed(list(
        re.finditer(r"\d+", head)))
        if int(d.group()) == len(head) - d.end() + len("_kernel")), head)
    regs.append(f"{name}<{hit.group(1)}>: "
                f"{lines[i + 2].split('Used', 1)[1].strip()}")
  spills = sorted({line.strip() for line in lines if "spill" in line
                   and not line.strip().startswith("0 bytes")})
  return regs, spills


def k3_tc_smem(hd: int) -> int:
  """Dynamic shared memory of a CTA of K3's bf16 instance: 128 query rows
  and four stages of a 64-key K and V tile in bf16, and 128 bytes for the
  stages' mbarriers and counters (csrc/flash_attention.cu)."""
  return (128 + 4 * 2 * 64) * hd * 2 + 128


def sass_counts(library: Path, opcodes: tuple) -> dict:
  """Per kernel instantiation (mangled name) in a built library's SASS
  (``cuobjdump -sass``): how many instructions start with each opcode."""
  import shutil
  tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
  sass = subprocess.run([tool, "-sass", str(library)],
                        capture_output=True, text=True, check=True,
                        timeout=300).stdout
  counts, fn = {}, None
  for line in sass.splitlines():
    if "Function :" in line:
      fn = line.split("Function :", 1)[1].strip()
      counts[fn] = dict.fromkeys(opcodes, 0)
    elif fn is not None:
      for opcode in opcodes:
        if opcode in line:
          counts[fn][opcode] += 1
  return counts


def tensor_core_sass(fa) -> dict:
  """HGMMA/HMMA instructions per bf16 K3 instance in the built library's
  SASS; fails unless every head dim's instance has some."""
  import re
  counts = sass_counts(fa.library_path(), ("HGMMA", "HMMA"))
  tc = {int(re.search(r"kernelILi(\d+)E", fn).group(1)): sum(c.values())
        for fn, c in counts.items() if "wgmma_kernel" in fn}
  if sorted(tc) != sorted(fa.HEAD_DIMS) or not all(tc.values()):
    raise AssertionError(f"K3's bf16 instances lack tensor-core "
                         f"instructions: {tc}")
  return tc


def semiring_sass(sm, mk) -> dict:
  """K1's and K2's instances in their SASS: every mma instance must hold
  HGMMA (wgmma), every other ring's instance LDGSTS (cp.async), and the
  int32 minplus and maxplus instances VIADDMNMX.  Returns the counts,
  keyed by kernel and instance kind."""
  import re
  k1 = sass_counts(sm.library_path(), ("HGMMA", "LDGSTS", "VIADDMNMX"))
  k2 = sass_counts(mk.library_path(), ("HGMMA", "LDGSTS", "VIADDMNMX"))
  groups = {
      "K1 mma (HGMMA)": [c["HGMMA"] for fn, c in k1.items()
                         if "semiring_mma_tc_kernel" in fn],
      "K1 other rings (LDGSTS)": [c["LDGSTS"] for fn, c in k1.items()
                                  if "semiring_mmo_kernel" in fn],
      # the ring code is the first template argument: mma is 0
      "K2 mma (HGMMA)": [c["HGMMA"] for fn, c in k2.items()
                         if "fixpoint_kernelILi0E" in fn],
      "K2 other rings (LDGSTS)": [c["LDGSTS"] for fn, c in k2.items()
                                  if "fixpoint_kernel" in fn
                                  and "fixpoint_kernelILi0E" not in fn],
      # int32 minplus (ring 1) and maxplus (2): one fused DPX add-min/max
      # per term, which hw.ops_seconds' bound assumes
      "K1 int32 minplus/maxplus (VIADDMNMX)": [
          c["VIADDMNMX"] for fn, c in k1.items()
          if re.search(r"semiring_mmo_kernelILi[12]EiiLi", fn)],
      "K2 int32 minplus/maxplus (VIADDMNMX)": [
          c["VIADDMNMX"] for fn, c in k2.items()
          if re.search(r"fixpoint_kernelILi[12]EiLi", fn)],
  }
  # instances: K1 mma f32 and bf16; 21 (ring, dtype) pairs (the min/max
  # rings in f32, bf16 and int32, addnorm in f32 and bf16, orand) × two
  # register tiles; K2 mma f32; 25 pairs (the min/max rings in f32, bf16,
  # float16 and int32, orand) × two largest register tiles
  want = {"K1 mma (HGMMA)": 2, "K1 other rings (LDGSTS)": 42,
          "K2 mma (HGMMA)": 1, "K2 other rings (LDGSTS)": 50,
          "K1 int32 minplus/maxplus (VIADDMNMX)": 4,
          "K2 int32 minplus/maxplus (VIADDMNMX)": 4}
  for name, found in groups.items():
    if len(found) != want[name] or not all(found):
      raise AssertionError(f"{name}: {len(found)} instances (want "
                           f"{want[name]}), counts {found}")
  return groups


def k4_smem_bytes(p: int) -> int:
  """Dynamic shared memory of a K4 CTA (csrc/ssd.cu): the scores of one
  pass (4 warps × 32 groups of 8 keys × 128 floats) and four ring stages,
  each the larger of a score stage (C and B slices, 2 × 64 × 20 floats) and
  an X stage (32 keys × (P + 4), their dt and cum, the 64 query rows'
  cum)."""
  stage = max(2 * 64 * 20, 32 * (p + 4) + 2 * 32 + 64)
  return (4 * 32 * 128 + 4 * ((stage + 3) // 4 * 4)) * 4


def ssd_sass(ssd) -> dict:
  """Tensor-core instructions per K4 instance in the built library's SASS;
  fails unless each of the ten (dtype, head dim) instances has some."""
  counts = sass_counts(ssd.library_path(), ("HMMA", "HGMMA"))
  tc = {fn: sum(c.values()) for fn, c in counts.items()
        if "ssd_intra_chunk_kernel" in fn}
  if len(tc) != 2 * len(ssd.HEAD_DIMS) or not all(tc.values()):
    raise AssertionError(f"K4's instances lack tensor-core instructions: "
                         f"{tc}")
  return tc


def prefill(cfg, model, tokens, impl: str, src=None) -> tuple:
  """``make_prefill_step``'s (last-position logits, cache) on ``impl``, and
  the decode steps' extra batch: an enc-dec model first encodes ``src`` on
  the same arm and hands the output to both, as ``Engine.generate``
  does."""
  from repro_torch.models import encdec
  from repro_torch.train.steps import make_prefill_step
  extra = ({} if src is None else
           {"enc_out": encdec.encode(model, cfg, src, impl=impl)})
  last, cache = make_prefill_step(cfg, impl=impl)(model, {"tokens": tokens,
                                                          **extra})
  return last, cache, extra


def logits_along(cfg, model, zoo, torch, tokens, toks, max_len,
                     impl: str = "xla", src=None):
  """An engine's per-step logits along the greedy tokens ``toks``: the
  same prefill (on ``impl``), cache seating and decode steps as
  ``Engine.generate``."""
  from repro_torch.launch.serve import seat_cache
  last, cache, extra = prefill(cfg, model, tokens, impl, src)
  cache = seat_cache(cfg, cache, max_len, "cuda")
  steps = [last.float()]
  for t in range(toks.shape[1] - 1):
    logits, cache, _ = zoo.forward(model, cfg, {"tokens": toks[:, t:t + 1],
                                                **extra},
                                   mode="decode", cache=cache)
    steps.append(logits[:, -1].float())
  return torch.stack(steps, dim=1)  # (B, n_new, V)


def phase_lm_serving(fa, torch, card: str) -> dict:
  """Phase 6: tinyllama-1.1b at full width through ``Engine``."""
  from repro_torch import configs
  cfg = configs.get_config(LM_ARCH)
  return serve_phase(torch, card, cfg, {fa.flash_attention: cfg.n_layers},
                     "lm", LM_LOGIT_ATOL,
                     f"{cfg.n_heads} heads, {cfg.n_kv_heads} kv heads, head "
                     f"dim {cfg.hd}")


def phase_ssm_serving(ssd, torch, card: str) -> dict:
  """Phase 7: mamba2-780m at full width through ``Engine``; then the same
  weights computing in f32, where the two arms' prefill logits must agree
  to ``SSM_F32_LOGIT_ATOL``."""
  import numpy as np
  from repro_torch import configs
  from repro_torch.models import zoo
  from repro_torch.train.steps import make_prefill_step
  cfg = configs.get_config(SSM_ARCH)
  run = serve_phase(torch, card, cfg, {ssd.ssd_intra_chunk: cfg.n_layers},
                    "ssm", SSM_LOGIT_ATOL,
                    f"d_inner {cfg.d_inner}, {cfg.ssm_heads} SSM heads of "
                    f"{cfg.ssm_headdim}, state {cfg.ssm_state}, "
                    f"{cfg.ssm_ngroups} group, chunk {cfg.ssm_chunk}")
  gc.collect()
  cfg32 = cfg.replace(dtype=torch.float32)
  model = zoo.init(cfg32, torch.Generator(device="cuda").manual_seed(0),
                   "cuda")
  prompts = np.random.default_rng(0).integers(
      0, cfg.vocab, (LM_BATCH, LM_PROMPT), dtype=np.int32)
  tokens = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")
  with torch.inference_mode():
    lp, _ = make_prefill_step(cfg32, impl="pallas")(model, {"tokens": tokens})
    lx, _ = make_prefill_step(cfg32, impl="xla")(model, {"tokens": tokens})
  d = float((lp - lx).abs().max())
  log(f"[ssm] f32 compute, same weights: prefill logits pallas vs xla max "
      f"|d|={d!r} (atol {SSM_F32_LOGIT_ATOL}), logits std "
      f"{float(lx.std())!r}")
  if not bool(torch.isfinite(lp).all()) or d > SSM_F32_LOGIT_ATOL:
    raise AssertionError("pallas and xla f32 prefill logits disagree")
  run["f32_logits_max_abs_diff"] = d
  return run


def serve_phase(torch, card: str, cfg, kernels: dict, tag: str,
                logit_atol: float, shape_note: str, tie_gap: float = TIE_GAP,
                logit_check=None, profile_new: int = LM_NEW,
                decode_atol=None, prompts=None, src=None,
                front=None) -> dict:
  """Serve ``cfg`` at full width through ``Engine`` on both arms: the
  'pallas' prefill must launch each kernel of ``kernels`` ({wrapper: launches
  per prefill}) that many times and the decode never; prefill logits and
  greedy tokens (under a near-tie gap of ``tie_gap``) are held against the
  'xla' arm's.  ``logit_check(model, tokens)``, when given, compares the
  prefill logits in place of the plain max |d| against ``logit_atol``.
  With ``decode_atol``, both arms' logits along the 'xla' engine's tokens
  (the two prefills, then the same decode steps) must agree within it at
  every step, and the near-tie gap widens to twice their largest
  difference: a greedy token can flip only where the top two are closer
  than the arms' logits differ.  ``tag`` prefixes the log lines.

  ``prompts`` (B, S) numpy default to LM_BATCH × LM_PROMPT seeded tokens;
  ``src``, an enc-dec model's source frames on the card, goes to every
  generate and prefill.  ``front()``, when given, makes the prompts on the
  card (a frontend with kernels of its own, counted in ``kernels``): the
  measured generates call it inside their counting windows, and its
  prompts must equal ``prompts``."""
  import numpy as np
  from repro_torch.launch.serve import Engine
  from repro_torch.models import zoo
  from repro_torch.models.transformer import padded_vocab
  t0 = time.perf_counter()
  model = zoo.init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
  torch.cuda.synchronize()
  log(f"[{tag}] {cfg.name}: {zoo.param_count(model)} parameters "
      f"({cfg.n_layers} layers, d {cfg.d_model}, {shape_note}) built in "
      f"{time.perf_counter() - t0:.1f}s")
  if prompts is None:
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT), dtype=np.int32)

  def made_prompts():
    if front is None:
      return prompts
    made = front()
    if not np.array_equal(made.cpu().numpy(), prompts):
      raise AssertionError("the frontend's prompts changed between calls")
    return made
  n_prompt = prompts.shape[1]
  max_len = n_prompt + LM_NEW
  eng = Engine(cfg, model, max_len=max_len, impl="pallas", device="cuda")
  xla = Engine(cfg, model, max_len=max_len, impl="xla", device="cuda")
  # warm-up: cuBLAS, the kernels' libraries (a whole chunk for the SSM)
  eng.generate(prompts[:, :256], 2, src_embeds=src)
  xla.generate(prompts[:, :256], 2, src_embeds=src)
  for kernel in kernels:
    kernel.launches = 0
  eng.generate(made_prompts(), 1, src_embeds=src)
  prefill_launches = {k.__name__: k.launches for k in kernels}
  # the main path: counts set to 0 just before, read just after
  for kernel in kernels:
    kernel.launches = 0
  torch.cuda.reset_peak_memory_stats()
  toks = eng.generate(made_prompts(), LM_NEW, src_embeds=src)
  launches = {k.__name__: k.launches for k in kernels}
  peak = torch.cuda.max_memory_allocated()
  tm = eng.last_timing
  want = {k.__name__: n for k, n in kernels.items()}
  log(f"[{tag}] main path: prompts {prompts.shape}"
      f"{'' if src is None else f', sources {tuple(src.shape)}'}, "
      f"{LM_NEW} new tokens; "
      f"launches {prefill_launches} for a prefill alone, {launches} for the "
      f"whole generate (want {want} for both)")
  if prefill_launches != want or launches != want:
    raise AssertionError(f"launches: prefill {prefill_launches}, generate "
                         f"{launches}; want {want} and {want} (none in the "
                         f"decode)")
  if toks.shape != (LM_BATCH, LM_NEW) or not (
      (toks >= 0) & (toks < padded_vocab(cfg))).all():
    raise AssertionError(f"bad tokens {toks.shape}")
  step_ms = tm["decode_s"] / tm["decode_steps"] * 1e3
  lm = {"prefill_ms": tm["prefill_s"] * 1e3, "decode_ms_per_token": step_ms,
        "prefill_tokens_s": LM_BATCH * n_prompt / tm["prefill_s"],
        "decode_tokens_s": LM_BATCH * tm["decode_steps"] / tm["decode_s"],
        "generate_tokens_s": LM_BATCH * LM_NEW / (tm["prefill_s"]
                                                  + tm["decode_s"]),
        "max_memory_allocated_gib": peak / 2 ** 30, "launches": launches,
        "card": card}
  log(f"[{tag}] {json.dumps(lm)}")
  if src is not None:
    lm["source_frames_s"] = src.shape[0] * src.shape[1] / tm["prefill_s"]
  torch.cuda.reset_peak_memory_stats()
  xla_toks = xla.generate(prompts, LM_NEW, src_embeds=src)
  lm["xla_max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
  log(f"[{tag}] xla arm: prefill {xla.last_timing['prefill_s'] * 1e3:.1f}ms, "
      f"decode {xla.last_timing['decode_s'] / (LM_NEW - 1) * 1e3:.2f}"
      f"ms/token")
  # prefill logits: pallas vs xla on the same model
  tokens = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")
  with torch.inference_mode():
    if logit_check is not None:
      lm["prefill_check"] = logit_check(model, tokens)
    else:
      lp = prefill(cfg, model, tokens, "pallas", src)[0]
      lx = prefill(cfg, model, tokens, "xla", src)[0]
      d = (lp.float() - lx.float()).abs()
      log(f"[{tag}] prefill logits pallas vs xla: max |d|={float(d.max())!r} "
          f"mean |d|={float(d.mean())!r} (atol {logit_atol}), logits std "
          f"{float(lx.float().std())!r}")
      if not bool(torch.isfinite(lp.float()).all()) or float(
          d.max()) > logit_atol:
        raise AssertionError("pallas and xla prefill logits disagree")
      lm["logits_max_abs_diff"] = float(d.max())
      del lp, lx, d
    steps = logits_along(cfg, model, zoo, torch, tokens,
                         torch.as_tensor(xla_toks, device="cuda"), max_len,
                         src=src)
    if decode_atol is not None:
      psteps = logits_along(cfg, model, zoo, torch, tokens,
                            torch.as_tensor(xla_toks, device="cuda"),
                            max_len, impl="pallas", src=src)
      dsteps = (psteps - steps).abs().amax(dim=-1).amax(dim=0).tolist()
      lm["decode_logits_max_abs_diff"] = dsteps
      log(f"[{tag}] logits along the xla tokens, pallas prefill vs xla "
          f"prefill, max |d| per step: {[round(x, 4) for x in dsteps]} "
          f"(atol {decode_atol})")
      if max(dsteps) > decode_atol:
        raise AssertionError("the arms' logits along the same tokens "
                             "disagree")
      tie_gap = max(tie_gap, 2 * max(dsteps))
      del psteps
  if not np.array_equal(steps.argmax(dim=-1).cpu().numpy(), xla_toks):
    raise AssertionError("the xla engine's tokens are not its logits' argmax")
  top2 = steps.topk(2, dim=-1).values
  gaps = (top2[..., 0] - top2[..., 1]).cpu().numpy()
  compared = 0
  for b in range(LM_BATCH):
    ties = np.nonzero(gaps[b] < tie_gap)[0]
    upto = int(ties[0]) if len(ties) else LM_NEW
    if not np.array_equal(toks[b, :upto], xla_toks[b, :upto]):
      raise AssertionError(f"row {b}: pallas tokens {toks[b, :upto]} vs "
                           f"xla {xla_toks[b, :upto]} before any near-tie")
    compared += upto
  log(f"[{tag}] greedy tokens pallas == xla on {compared} of "
      f"{LM_BATCH * LM_NEW} positions (the rest follow a top-2 gap under "
      f"{tie_gap}); identical overall: {np.array_equal(toks, xla_toks)}")
  lm["tokens_compared"] = compared
  if profile_new != LM_NEW:
    # unprofiled, then profiled
    eng.generate(prompts, profile_new, src_embeds=src)
  profile_generate(torch, eng, prompts, profile_new, tag, src)
  # the prefill alone, unprofiled, then profiled
  eng.generate(prompts, 1, src_embeds=src)
  profile_generate(torch, eng, prompts, 1, tag, src)
  return lm


def profile_generate(torch, eng, prompts, n_new: int, tag: str,
                     src=None) -> None:
  """Where one generate() spends its time: torch.profiler's kernel time on
  the card, summed by kernel, against the host wall time of the same call
  under the profiler and of the unprofiled call of the same shape before
  it."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  unprofiled = eng.last_timing["prefill_s"] + eng.last_timing["decode_s"]
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    eng.generate(prompts, n_new, src_embeds=src)
    wall = time.perf_counter() - t0
  kernels = [e for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA]
  busy = sum(e.self_device_time_total for e in kernels) / 1e6
  log(f"[{tag}] profile of generate({tuple(prompts.shape)}, {n_new}): "
      f"{sum(e.count for e in kernels)} kernels, {busy * 1e3:.1f}ms on the "
      f"card; wall {wall * 1e3:.1f}ms under the profiler "
      f"({busy / wall:.1%} busy), {unprofiled * 1e3:.1f}ms without "
      f"({busy / unprofiled:.1%} busy)")
  for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                  reverse=True)[:8]:
    log(f"[{tag}]   {e.self_device_time_total / 1e3:9.2f}ms x{e.count:<6} "
        f"{e.key[:100]}")


def phase_flash_timing(fa, torch, err: float, launches: int,
                       ptxas: list) -> dict:
  """Phase 6: K3 (the bf16 tensor-core instance), its plain version and
  SDPA at the main path's shape; the f32 CUDA-core instance on the same
  inputs widened to f32."""
  case = LM_FA_CASE
  q, k, v = fa_inputs(torch, case, torch.bfloat16, 0)
  ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v, causal=True), 20)
  plain_ms = cuda_time_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                           causal=True), 3)
  sdpa = torch.nn.functional.scaled_dot_product_attention
  lib_ms = cuda_time_ms(lambda: sdpa(q, k, v, is_causal=True,
                                     enable_gqa=True), 20)
  lib_err = max_abs_err(sdpa(q, k, v, is_causal=True, enable_gqa=True),
                        fa.flash_attention(q, k, v, causal=True))
  q32, k32, v32 = q.float(), k.float(), v.float()
  f32_ms = cuda_time_ms(lambda: fa.flash_attention(q32, k32, v32,
                                                   causal=True), 3)
  del q32, k32, v32
  # the other head dims the dense configs use, at the same shape otherwise
  by_hd = {}
  for hd in fa.HEAD_DIMS:
    if hd == case[5]:
      continue
    qh, kh, vh = fa_inputs(torch, case[:5] + (hd,) + case[6:], torch.bfloat16,
                           0)
    by_hd[hd] = {
        "ms": cuda_time_ms(lambda: fa.flash_attention(qh, kh, vh), 10),
        "library_ms": cuda_time_ms(lambda: sdpa(qh, kh, vh, is_causal=True,
                                                enable_gqa=True), 10)}
  b_ms, b_by = attention_bound_ms(case, "bfloat16")
  hd = case[5]
  row = {"case": "tinyllama prefill B4 H32/4 S2048 D64 causal bf16",
         "design": K3_DESIGN, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms,
         "library_ms": lib_ms, "library_max_abs_err": lib_err,
         "max_abs_err": err, "launches": launches, "f32_instance_ms": f32_ms,
         "ptxas": [p for p in ptxas if p.startswith(
             f"flash_attention_wgmma<Li{hd}>")],
         "dynamic_shared_memory_bytes": k3_tc_smem(hd),
         "other_head_dims": by_hd}
  log(f"[time] K3 {json.dumps(row)}")
  return row


def phase_ssd_timing(ssd, torch, err, launches: int,
                     shape=SSD_MAIN_SHAPE,
                     label: str = "mamba2-780m prefill") -> dict:
  """Phases 7 and 12: K4 at a prefill's shape (mamba2's, zamba2's), in the
  model's layout (the (B, nc, Q, H, ·) buffers read and written through
  strided views, as ``ssd_chunked`` launches it) and on contiguous (BZ, H,
  Q, ·) copies; its plain version; and, for context, the 'xla' arm's
  intra-chunk einsums."""
  from repro_torch.kernels import ops
  from repro_torch.models import ssm
  bz, h, g, q, n, p = shape
  b_, nc = LM_BATCH, bz // LM_BATCH
  gen = torch.Generator(device="cuda").manual_seed(11)
  xc = torch.randn(b_, nc, q, h, p, generator=gen, device="cuda")
  bc = torch.randn(b_, nc, q, g, n, generator=gen, device="cuda")
  cc = torch.randn(b_, nc, q, g, n, generator=gen, device="cuda")
  # the model's dt ≈ softplus(−4.6 + x·W) ≈ 0.01 and A = −exp(0) = −1
  dtc = torch.rand(b_, nc, q, h, generator=gen, device="cuda") * 0.015 + 0.005
  dac = -dtc
  cum = torch.cumsum(dac, dim=2)
  views = (cc.reshape(bz, q, g, n).transpose(1, 2),
           bc.reshape(bz, q, g, n).transpose(1, 2),
           xc.reshape(bz, q, h, p).transpose(1, 2),
           dtc.reshape(bz, q, h).transpose(1, 2),
           cum.reshape(bz, q, h).transpose(1, 2))
  buf = torch.empty(b_, nc, q, h, p, device="cuda")
  out = buf.view(bz, q, h, p).transpose(1, 2)
  contig = [v.contiguous() for v in views]
  ms = cuda_time_ms(lambda: ops.ssd_intra_chunk(*views, out=out), 20)
  contig_ms = cuda_time_ms(lambda: ssd.ssd_intra_chunk(*contig), 20)
  plain_ms = cuda_time_ms(lambda: ssd.ssd_intra_chunk_plain(*views), 3)
  xla_ms = cuda_time_ms(
      lambda: ssm._y_diag(cc, bc, xc, dtc, dac, cum, "xla"), 3)
  got = ops.ssd_intra_chunk(*views, out=out)
  layout_err = max_abs_err(got, ssd.ssd_intra_chunk_plain(*views))
  xla_err = max_abs_err(buf, ssm._y_diag(cc, bc, xc, dtc, dac, cum, "xla"))
  if err is None:  # no phase-3 figure for this shape: the model layout's
    err = layout_err
  b_ms, b_by, cc_ms = ssd_bound_ms(shape, 4)
  row = {"case": f"{label} (BZ, H, G, Q, N, P)={shape} f32, model layout",
         "ms": ms,
         "contiguous_ms": contig_ms, "plain_ms": plain_ms,
         "xla_arm_ms": xla_ms, "bound_ms": b_ms, "bound_by": b_by,
         "share_of_bound": b_ms / ms, "cuda_core_products_ms": cc_ms,
         "head_block": ssd.head_block(torch.float32, p, bz, h, g, q),
         "library_ms": None, "max_abs_err": err,
         "model_layout_max_abs_err": layout_err,
         "xla_arm_max_abs_err": xla_err, "launches": launches}
  log(f"[time] K4 {json.dumps(row)}")
  if layout_err > SSD_LONG_TOL["atol"] or xla_err > 1e-3:
    raise AssertionError("K4 in the model's layout disagrees")
  return row


# Phase 9: sharded serving on a virtual mesh of 2 × 2 shards of cuda:0.
# The shards share one card, so their collectives are on-card copies and
# their work runs one shard after another: no interconnect time and no
# multi-card speed-up is claimed from it.
MESH_DIMS = (2, 2)
# Engine thresholds (per-request contraction flops, 2·m·k·n): APSP 4096 and
# the raw 4096³ mmo are 1.37e11; KNN (4096 × 16 × 16384) and GTC 1024 are
# both 2³¹ = 2.15e9, so no threshold separates them; the ragged bucket is
# 3.4e7.
SHARD_ALL_BIG = float(2 ** 31)   # APSP, mmo, KNN and GTC are candidates
SHARD_4096 = 1e10                # only APSP 4096 and the raw mmo


def mesh_result_ok(kind: str, got, want) -> bool:
  """A mesh engine's result against phase 4's: closures and the minplus
  mmo bit for bit (iterations too), KNN by result_equal."""
  return (result_equal(kind, got, want) if kind == "knn"
          else same_result(got, want) if kind == "closure"
          else result_equal(kind, got, want))


def addnorm_f64(torch, q, ref_t, rows: int = 1024):
  """Σ_k (q[i,k] − ref_t[k,j])² in float64, ``rows`` queries at a time."""
  from repro_torch.kernels.ref import addnorm_ref
  return torch.cat([addnorm_ref(q[i:i + rows].double(), ref_t.double())
                    for i in range(0, q.shape[0], rows)])


def phase_mesh(sm, mk, torch, np, graphs, reqs, results, a_t, b_t, q_t,
               r_t) -> dict:
  """(a) each schedule against local K1 at the stream's widths; (b) the
  k_valid = 0 edge on kspan and ring, every ring; (c) the sharded closures
  against phase 4; (d) tune_mesh, then MMOEngine on the mesh (auto, summa,
  kspan, dp, and the fused arm's shards on K1) against phase 4."""
  from repro_torch.core import closure as cl
  from repro_torch.core import distributed as dist
  from repro_torch.core import semiring as sr_mod
  from repro_torch.core.mmo import mmo_batched
  from repro_torch.launch.mesh import make_host_mesh
  from repro_torch.serve_mmo import MMOEngine, batching, bucket_label
  from repro_torch.serve_mmo.scheduler import contract_shape, request_bucket
  from repro_torch.tuning import (CostTable, sharded_prior_seconds,
                                  tune_mesh)
  from repro_torch.tuning import cost_table as ct
  t_phase = time.perf_counter()
  mesh = make_host_mesh(4, model=MESH_DIMS[1], devices=["cuda:0"] * 4)
  log(f"[mesh] virtual mesh {MESH_DIMS[0]} x {MESH_DIMS[1]} of "
      f"{[str(d) for d in mesh.flat]}: four shards of one card, so its "
      f"collectives are on-card copies (not NVLink) and its shards run one "
      f"after another; no interconnect time is claimed from it")
  out = {"k1": 0, "k2": 0, "rows": []}

  def launches(fn):
    """fn()'s result, its K1 and K2 launches, and its host seconds."""
    k1, k2 = sm.semiring_mmo.launches, mk.fixpoint_chunk.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return (res, sm.semiring_mmo.launches - k1,
            mk.fixpoint_chunk.launches - k2, time.perf_counter() - t0)

  # -- (a) schedules against local K1 ---------------------------------------
  # K1 launches per call: kspan and ring run one line of shards along
  # their axis (its replicas would compute the same product), ring p steps
  cols = MESH_DIMS[1]
  want_k1 = {"dp": mesh.size, "summa": mesh.size, "kspan": cols,
             "ring": cols * cols}
  g = torch.Generator(device="cuda").manual_seed(9)
  maxmin_a = torch.rand(1, 1024, 1024, device="cuda", generator=g)
  maxmin_b = torch.rand(1, 1024, 1024, device="cuda", generator=g)
  orand_a = torch.rand(1, 1024, 1024, device="cuda", generator=g) < 0.01
  orand_b = torch.rand(1, 1024, 1024, device="cuda", generator=g) < 0.01
  mma_ref = sm.semiring_mmo_plain(a_t[None], b_t[None], op="mma")  # f64 sum
  quad_a = torch.stack([a_t, b_t, a_t.T, b_t.T]).contiguous()
  quad_b = torch.stack([b_t, a_t, b_t.T, a_t.T]).contiguous()
  cases = [("minplus", "raw mmo 4096³", a_t[None], b_t[None], quad_a,
            quad_b),
           ("mma", "mma 4096³", a_t[None], b_t[None],
            a_t[None].expand(4, -1, -1).contiguous(),
            b_t[None].expand(4, -1, -1).contiguous()),
           ("maxmin", "maxmin 1024³", maxmin_a, maxmin_b,
            maxmin_a.expand(4, -1, -1).contiguous(),
            maxmin_b.expand(4, -1, -1).contiguous()),
           ("orand", "orand 1024³", orand_a, orand_b,
            orand_a.expand(4, -1, -1).contiguous(),
            orand_b.expand(4, -1, -1).contiguous())]
  for op, label, a1, b1, a4, b4 in cases:
    local1 = sm.semiring_mmo(a1, b1, op=op)
    local4 = sm.semiring_mmo(a4, b4, op=op)
    local_ms = cuda_time_ms(lambda: sm.semiring_mmo(a1, b1, op=op), 3)
    row = {"case": label, "op": op, "local_k1_ms": local_ms}
    for sched in dist.SCHEDULES:
      a, b, want = (a4, b4, local4) if sched == "dp" else (a1, b1, local1)
      fn = (lambda: dist.mmo_sharded_batched(a, b, op=op, schedule=sched,
                                             mesh=mesh, backend="pallas"))
      got, k1, _, _ = launches(fn)
      if k1 != want_k1[sched]:
        raise AssertionError(f"{label} {sched}: {k1} K1 launches, expected "
                             f"{want_k1[sched]}")
      if op == "mma":  # every request against the float64 product
        err = max(check(f"mesh {label} {sched} vs float64", got[i:i + 1],
                        mma_ref.to(got.dtype), op)
                  for i in range(got.shape[0]))
      else:  # bit for bit against local K1
        err = check(f"mesh {label} {sched} vs local K1", got, want, op)
      ms = cuda_time_ms(fn, 3)
      row[sched] = {"ms": ms, "k1_launches": k1, "requests": a.shape[0],
                    "max_abs_err": err}
    log(f"[mesh] {json.dumps(row)}")
    out["rows"].append(row)
  del mma_ref, quad_a, quad_b
  # KNN addnorm on kspan (K = 16 split in two chunks of 8)
  knn_fn = (lambda: dist.mmo_sharded_batched(
      q_t[None], r_t.T[None].contiguous(), op="addnorm", schedule="kspan",
      mesh=mesh, backend="pallas"))
  got, k1, _, _ = launches(knn_fn)
  want = addnorm_f64(torch, q_t, r_t.T).float()
  err = check("mesh KNN 4096 x 16384 x 16 kspan vs addnorm_ref (float64)",
              got[0], want, "addnorm")
  del want
  knn_local = cuda_time_ms(lambda: sm.semiring_mmo(
      q_t[None], r_t.T[None].contiguous(), op="addnorm"), 3)
  row = {"case": "KNN 4096q x 16384 x 16", "op": "addnorm",
         "local_k1_ms": knn_local,
         "kspan": {"ms": cuda_time_ms(knn_fn, 3), "k1_launches": k1,
                   "max_abs_err": err}}
  log(f"[mesh] {json.dumps(row)}")
  out["rows"].append(row)
  # the host cost of one sharded call beyond its kernels (DP_OVERHEAD_S):
  # dp over the mesh against one local launch on a 4 × 8³ minplus batch
  ta = torch.rand(4, 8, 8, device="cuda")
  tb = torch.rand(4, 8, 8, device="cuda")
  dp_tiny = cuda_time_ms(lambda: dist.mmo_dp_batched(
      ta, tb, op="minplus", mesh=mesh, backend="pallas"), 500)
  local_tiny = cuda_time_ms(lambda: sm.semiring_mmo(ta, tb, op="minplus"),
                            500)
  out["dp_overhead_ms"] = dp_tiny - local_tiny
  log(f"[mesh] dp overhead per sharded call: dp {dp_tiny:.4f} ms - local "
      f"{local_tiny:.4f} ms = {dp_tiny - local_tiny:.4f} ms "
      f"(cost_table.DP_OVERHEAD_S = {ct.DP_OVERHEAD_S * 1e3:.4f} ms)")

  # -- (b) the k_valid = 0 edge: ragged K on kspan and ring, every ring ------
  r, m, k, n = 8, 256, 256, 256
  kv = torch.tensor([1, 40, 128, 129, 200, 256, 17, 96], dtype=torch.int32,
                    device="cuda")
  live = torch.arange(k, device="cuda")[None, :] < kv[:, None]
  for op in sr_mod.ALL_OPS:
    sr = sr_mod.get(op)
    a = torch.randn(r, m, k, device="cuda", generator=g)
    b = torch.randn(r, k, n, device="cuda", generator=g)
    c = torch.randn(r, m, n, device="cuda", generator=g)
    if op in ("minmul", "maxmul"):
      a, b = a.tanh().abs(), b.tanh().abs()
    if sr.boolean:
      a, b, c = a > 0.5, b > 0.5, c > 1.0
      pa = pb = False
    else:
      pa, pb = sr_mod.contraction_pads(op, torch.float32)
    a = torch.where(live[:, None, :], a, pa)
    b = torch.where(live[:, :, None], b, pb)
    want = mmo_batched(a, b, c, op=op, backend="pallas", k_valid=kv)
    for sched in ("kspan", "ring"):
      got, k1, _, _ = launches(lambda: dist.mmo_sharded_batched(
          a, b, c, op=op, schedule=sched, mesh=mesh, backend="pallas",
          k_valid=kv))
      check(f"mesh ragged 8 x 256³ {op} {sched} (kv 1-256, k_valid = 0 on "
            f"the second K-chunk of 4 requests) vs local K1", got, want, op)

  # -- (c) sharded closures against phase 4 -----------------------------------
  def closure_case(idx, sched, label):
    rs = [reqs[i] for i in idx]
    key = request_bucket(rs[0])
    adj, valid = batching.to_device(batching.stack_batch(key, rs), "cuda")
    (closed, iters), k1, k2, secs = launches(
        lambda: dist.sharded_closure_batched(adj, op=key.op, mesh=mesh,
                                             schedule=sched,
                                             backend="pallas",
                                             valid_n=valid))
    out["k1"] += k1
    out["k2"] += k2
    closed, iters = closed.cpu().numpy(), iters.cpu().numpy()
    for j, i in enumerate(idx):
      nn = rs[j].shape[0]
      if not (np.array_equal(closed[j, :nn, :nn], results[i].value)
              and int(iters[j]) == results[i].extras["iterations"]):
        raise AssertionError(f"{label} on {sched}: request {i} differs "
                             f"from phase 4")
    log(f"[mesh] closure {label} on {sched}: equal to phase 4 (values and "
        f"iterations {iters.tolist()}), K1 launches {k1}, K2 {k2}, "
        f"{secs:.3f}s")
  closure_case([0], "summa", "APSP 4096 (density 0.05)")
  closure_case([1], "ring", "GTC 1024 orand")
  closure_case(list(range(4, 12)), "dp", "ragged bucket 8 x n 200-256")
  w1k = graphs.weighted_digraph(1024, 0.05, seed=31)
  adj1k = cl.prepare_adjacency(torch.from_numpy(w1k).cuda(), op="minplus")
  local1k, it1k = cl.batched_leyzorek_closure(adj1k[None].contiguous(),
                                              op="minplus", backend="pallas")
  ley, k1, k2, secs = launches(lambda: dist.distributed_leyzorek(
      adj1k, op="minplus", mesh=mesh, backend="pallas"))
  out["k1"] += k1
  if not torch.equal(ley, local1k[0]):
    raise AssertionError("distributed_leyzorek APSP 1024 differs from the "
                         "local closure")
  log(f"[mesh] distributed_leyzorek APSP 1024: equal to the local closure "
      f"(which converged in {int(it1k[0])} iterations; the distributed one "
      f"runs all 10), K1 launches {k1}, {secs:.3f}s")

  # -- (d) the engine on the mesh ---------------------------------------------
  t0 = time.perf_counter()
  points = {}
  for rq in reqs:
    key = request_bucket(rq)
    points.setdefault((key.op, contract_shape(key), key.dtypes[0]), None)
  table = CostTable(device=torch.cuda.get_device_name(0))
  for op, shape, dtype in points:
    tune_mesh(dims=MESH_DIMS, mesh=mesh, ops=(op,), shapes=(shape,),
              dtypes=(dtype,), table=table, warmup=1, iters=3)
  log(f"[mesh] tune_mesh: {len(table)} mesh rows {table.counts()} in "
      f"{time.perf_counter() - t0:.1f}s (seconds per request, each shard "
      f"on K1)")
  for sig, entry in sorted(table.entries.items()):
    if entry.source != "measured":
      continue
    op, shape, dtype, sched, _ = sig.split("|")
    prior = sharded_prior_seconds(op, tuple(int(x) for x in shape.split("x")),
                                  dtype, sched, MESH_DIMS, backend="pallas")
    log(f"[mesh] row {sig}: measured {entry.seconds * 1e3:.4f} ms, prior "
        f"{prior * 1e3:.4f} ms (measured/prior {entry.seconds / prior:.2f})")

  def serve_mesh(label, engine, rqs, idx):
    built = engine.prewarm(rqs)
    (res, k1, k2, secs) = launches(lambda: serve_all(engine, rqs))
    out["k1"] += k1
    out["k2"] += k2
    # the router's schedule per bucket, and where its batches ran (the
    # placements of the executables that ran): dp falls back to local for a
    # batch that does not divide over the shards
    routed = {bucket_label(key): sched
              for key, sched in engine._schedules.items()}
    with engine.cache._lock:
      ran = [k for k, e in engine.cache._entries.items() if e.ran]
    placed = {}
    for exec_key in ran:
      placed.setdefault(bucket_label(exec_key[0]), set()).add(exec_key[4])
    placed = {lb: sorted(v) for lb, v in placed.items()}
    for j, i in enumerate(idx):
      if not mesh_result_ok(reqs[i].kind, res[j], results[i]):
        raise AssertionError(f"mesh engine {label}: request {i} differs "
                             f"from phase 4")
    if engine.cache.misses != built:
      raise AssertionError(f"{label}: built during serving")
    log(f"[mesh] engine {label}: {len(rqs)} requests in {secs:.3f}s, every "
        f"result equal to phase 4; K1 launches {k1}, K2 {k2}; routed "
        f"{json.dumps(routed)}; ran {json.dumps(placed)}")
    return placed, k1, k2

  all_idx = list(range(len(reqs)))
  placed, _, _ = serve_mesh(
      "auto (mesh rows only)",
      MMOEngine(backend="pallas", mesh=mesh, schedule="auto",
                shard_flops=SHARD_ALL_BIG, cost_table=table, device="cuda"),
      reqs, all_idx)
  out["auto"] = placed
  # batches of 4 that the auto router's mesh rows send to the mesh
  quad = [0] * 4 + [3] * 4
  placed, _, _ = serve_mesh(
      "auto, 4 x APSP 4096 and 4 x raw mmo",
      MMOEngine(backend="pallas", mesh=mesh, schedule="auto",
                shard_flops=SHARD_ALL_BIG, cost_table=table, device="cuda"),
      [copy.copy(reqs[i]) for i in quad], quad)
  if not any(s != "local" for v in placed.values() for s in v):
    raise AssertionError(f"the auto engine ran no batch of 4 on the mesh: "
                         f"{placed}")
  out["auto_quad"] = placed
  serve_mesh("summa", MMOEngine(backend="pallas", mesh=mesh,
                                schedule="summa", shard_flops=SHARD_4096,
                                device="cuda"), reqs, all_idx)
  serve_mesh("kspan", MMOEngine(backend="pallas", mesh=mesh,
                                schedule="kspan", shard_flops=SHARD_ALL_BIG,
                                device="cuda"), reqs, all_idx)
  placed, _, _ = serve_mesh(
      "dp", MMOEngine(backend="pallas", mesh=mesh, schedule="dp",
                      shard_flops=0.0, device="cuda"), reqs, all_idx)
  if not any("dp" in v for v in placed.values()):
    raise AssertionError("the dp engine sharded no bucket")
  placed, k1, k2 = serve_mesh(
      "megakernel, APSP 4096 on summa",
      MMOEngine(backend="megakernel", mesh=mesh, schedule="summa",
                shard_flops=SHARD_4096, device="cuda"), [reqs[0]], [0])
  if k2 != 0 or k1 <= 0:
    raise AssertionError(f"a mesh-routed closure bucket on 'megakernel' "
                         f"launched K2 {k2} times and K1 {k1}")
  log(f"[mesh] phase 9 in {time.perf_counter() - t_phase:.1f}s; K1 "
      f"launches on its main paths (c, d) {out['k1']}, K2 {out['k2']}")
  return out


# Phase 0: the static analyzer over the tree this script runs from.


def phase_analysis() -> dict:
  """``python -m repro_torch.analysis --json`` must exit 0: no new finding
  of the semiring, lock or capture rules over ``src/repro_torch``."""
  t0 = time.perf_counter()
  proc = subprocess.run(
      [sys.executable, "-m", "repro_torch.analysis", "--json"],
      capture_output=True, text=True, timeout=300, cwd=ROOT,
      env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
  doc = json.loads(proc.stdout) if proc.stdout.strip().startswith("{") \
      else {}
  out = {"rc": proc.returncode, "rules": len(doc.get("rules", [])),
         "findings": len(doc.get("findings", [])),
         "baselined": len(doc.get("baselined", [])),
         "suppressed": doc.get("suppressed"),
         "s": time.perf_counter() - t0}
  log(f"[analysis] python -m repro_torch.analysis: exit {proc.returncode}, "
      f"{out['rules']} rules, {out['findings']} new findings, "
      f"{out['baselined']} baselined, {out['suppressed']} suppressed, "
      f"{out['s']:.1f}s")
  if proc.returncode != 0 or not doc.get("ok"):
    raise AssertionError(f"the analyzer reports findings:\n{proc.stdout}"
                         f"{proc.stderr}")
  return out


# Phase 10: LM training on the card, impl="xla" (K3 and K4 are forward
# kernels; the reference trains only on its XLA arm).  Batch 4 × 2048
# tokens of SyntheticLM, bf16 compute, f32 master, AdamW.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_TIMED = 4, 2048, 8
SSM_TRAIN_LAYERS = 8  # of mamba2-780m's 48: a depth cut, widths as published
# (e, f): the MoE and hybrid families at their published widths, cut in
# depth: mixtral-8x7b with 2 of its 32 layers, zamba2-7b with 7 of its 81
# (one application of the shared block, then one tail layer)
MOE_TRAIN_LAYERS, HYBRID_TRAIN_LAYERS = 2, 7
# mixtral's step at 4 × 2048 ran out of the card's memory (68 GiB allocated
# and a 1.75 GiB request refused on the first card run): 2 × 2048 tokens
MOE_TRAIN_BATCH, HYBRID_TRAIN_BATCH = 2, 4
# (a) the flash backward against autograd through the chunks: f32 within
# 1e-4 (both sum 2048 keys in f32, in other orders), bf16 within 2e-2 (each
# gradient rounds to bf16 once at the end: an ulp at magnitude 2-4); against
# a float64 autograd of the same f32 inputs at B 1, S 1024 within 1e-4 (f32
# sums of 1024 terms)
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
FLASH_BWD_F64_TOL = 1e-4
# (b) one batch at accum=2 against accum=1: the mean loss of two halves is
# the mean loss of the whole, but bf16 GEMMs of half the rows may sum in
# another order: loss rtol 2e-3, grad norm rtol 2e-2; remat="full" repeats
# the same forward kernels, so its loss is held to 1e-6
ACCUM_RTOL = {"loss": 2e-3, "grad_norm": 2e-2}
REMAT_RTOL = 1e-6


def attention_f64(torch, q, k, v, scale):
  """Causal GQA attention in float64 over the whole (B, S, H, D) input: the
  plain definition, no chunks."""
  b, s, h, d = q.shape
  g = h // k.shape[2]
  kk = k.repeat_interleave(g, dim=2)
  vv = v.repeat_interleave(g, dim=2)
  sc = torch.einsum("bqhd,bkhd->bhqk", q, kk) * scale
  mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
  p = torch.softmax(torch.where(mask, sc, float("-inf")), dim=-1)
  return torch.einsum("bhqk,bkhd->bqhd", p, vv)


def phase_flash_backward(torch, card: str) -> dict:
  """Phase 10(a): dq, dk, dv of the flash backward against xla_autodiff at
  tinyllama's attention shape, both dtypes, then against float64."""
  from repro_torch.models import attention as attn
  b, s, h, kv, d = TRAIN_BATCH, TRAIN_SEQ, 32, 4, 64
  scale = d ** -0.5
  gen = torch.Generator(device="cuda").manual_seed(10)
  out = {}

  def grads(arm, q, k, v, dout):
    ts = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    if arm == "flash":
      o = attn.flash_xla(*ts, True, None, scale, 0, attn.FLASH_CHUNK)
    elif arm == "autodiff":
      o, _ = attn._flash_fwd_impl(*ts, True, None, scale, 0,
                                  attn.FLASH_CHUNK)
    else:
      o = attention_f64(torch, *ts, scale)
    o.backward(dout)
    return [t.grad for t in ts]

  for dtype in (torch.bfloat16, torch.float32):
    name = str(dtype).removeprefix("torch.")
    q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda").to(
        dtype) for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d),
                             (b, s, h, d)))
    row = {}
    for arm in ("flash", "autodiff"):
      torch.cuda.synchronize()
      torch.cuda.reset_peak_memory_stats()
      base = torch.cuda.memory_allocated()
      row[f"{arm}_ms"] = cuda_time_ms(lambda: grads(arm, q, k, v, dout), 3)
      row[f"{arm}_peak_gib"] = (torch.cuda.max_memory_allocated()
                                - base) / 2 ** 30
    gf = grads("flash", q, k, v, dout)
    ga = grads("autodiff", q, k, v, dout)
    tol = FLASH_BWD_TOL[name]
    for label, x, y in zip(("dq", "dk", "dv"), gf, ga):
      err = max_abs_err(x, y)
      row[f"{label}_max_abs_err"] = err
      if not (bool(torch.isfinite(x).all()) and torch.allclose(
          x.float(), y.float(), rtol=tol, atol=tol)):
        raise AssertionError(f"flash backward {label} ({name}) differs from "
                             f"xla_autodiff: max |d| {err!r}")
    out[name] = row
    log(f"[train] (a) flash backward vs xla_autodiff, {name}, B {b} S {s} "
        f"H {h}/{kv} D {d} (fwd+bwd, CUDA events; tolerance {tol}): "
        f"{json.dumps(row)} {card}")
    del q, k, v, dout, gf, ga
  # against float64, at B 1, S 1024
  q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda")
                   for shape in ((1, 1024, h, d), (1, 1024, kv, d),
                                 (1, 1024, kv, d), (1, 1024, h, d)))
  gf = grads("flash", q, k, v, dout)
  g64 = grads("f64", q.double(), k.double(), v.double(), dout.double())
  row = {}
  for label, x, y in zip(("dq", "dk", "dv"), gf, g64):
    row[f"{label}_max_abs_err"] = max_abs_err(x.double(), y)
    if not torch.allclose(x.double(), y, rtol=FLASH_BWD_F64_TOL,
                          atol=FLASH_BWD_F64_TOL):
      raise AssertionError(f"flash backward {label} differs from float64 "
                           f"autograd: {row}")
  out["f64"] = row
  log(f"[train] (a) flash backward f32 vs float64 autograd, B 1 S 1024 "
      f"(tolerance {FLASH_BWD_F64_TOL}): {json.dumps(row)}")
  return out


def matmul_params(params) -> int:
  """Parameters that enter a matmul: every 2-D or larger leaf but the
  embedding, which is a lookup."""
  from repro_torch.train.optimizer import _leaves
  return sum(p.numel() for p in _leaves(
      {k: v for k, v in params.items() if k != "embed"}) if p.dim() >= 2)


def train_phase_model(torch, cfg, card: str, tag: str, probes: bool,
                      batch_rows: int = TRAIN_BATCH) -> dict:
  """Phase 10(b, c, e, f): train ``cfg`` on the card: (probes) accum=2
  against accum=1 and remat="full" against none on one batch with lr 0
  (the parameters do not move), then 1 warm-up and TRAIN_TIMED timed steps
  on ``batch_rows`` × TRAIN_SEQ tokens.  Every loss and aux must be finite,
  an MoE model's aux non-zero."""
  from repro_torch.models import hybrid, moe
  from repro_torch.data import DataConfig, SyntheticLM
  from repro_torch.models import zoo
  from repro_torch.train import optimizer as opt_mod
  from repro_torch.train.steps import make_train_step
  t0 = time.perf_counter()
  model = zoo.init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
  params = zoo.param_tree(model)
  n_params = zoo.param_count(model)
  data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                global_batch=batch_rows, seed=0))
  opt = opt_mod.init_opt_state(params)
  row = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
         "params": n_params, "batch": batch_rows, "seq": TRAIN_SEQ,
         "impl": "xla", "dtype": str(cfg.dtype).removeprefix("torch."),
         "card": card}
  log(f"[train] {tag} {cfg.name}: {n_params} parameters ({cfg.n_layers} "
      f"layers, d {cfg.d_model}) built in {time.perf_counter() - t0:.1f}s")
  if probes:
    still = opt_mod.AdamWConfig(lr=0.0)
    batch = data.batch_at(0)
    probe = {}
    for label, kw in (("accum1", {}), ("accum2", {"accum": 2}),
                      ("remat_full", {"remat": "full"})):
      _, m = make_train_step(cfg, still, **kw)((model, opt), batch)
      probe[label] = (float(m["loss"]), float(m["grad_norm"]),
                      float(m["aux_loss"]))
      if not all(map(lambda x: x == x and abs(x) < float("inf"),
                     probe[label])):
        raise AssertionError(f"{label}: loss, grad norm or aux not finite")
    (l1, n1, a1), (l2, n2, a2), (lr_, nr, _) = (
        probe["accum1"], probe["accum2"], probe["remat_full"])
    row.update(accum1=probe["accum1"], accum2=probe["accum2"],
               remat_full=probe["remat_full"])
    log(f"[train] {tag} one batch, lr 0: accum=1 loss {l1!r} grad norm "
        f"{n1!r} aux {a1!r}; accum=2 loss {l2!r} grad norm {n2!r} aux "
        f"{a2!r}; remat=full loss {lr_!r} grad norm {nr!r}")
    # an MoE aux is a product of two batch means (top-1 fraction × mean
    # probability), not a sum over rows: its gradient, and so the grad
    # norm, differs between accum=2 and accum=1 (the reference's too)
    if (abs(l2 - l1) > ACCUM_RTOL["loss"] * abs(l1)
        or (not cfg.n_experts
            and abs(n2 - n1) > ACCUM_RTOL["grad_norm"] * abs(n1))):
      raise AssertionError("accum=2 differs from accum=1 on one batch")
    if abs(lr_ - l1) > REMAT_RTOL * abs(l1):
      raise AssertionError("remat='full' changes the loss")
    with torch.no_grad():  # the real run starts from fresh moments
      for t in opt_mod._leaves({"m": opt["m"], "v": opt["v"]}):
        t.zero_()
      opt["step"].zero_()
  oc = opt_mod.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100)
  step = make_train_step(cfg, oc)
  state = (model, opt)
  state, m = step(state, data.batch_at(0))  # warm-up
  losses = [float(m["loss"])]
  auxes = [float(m["aux_loss"])]
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  times = []
  for i in range(1, TRAIN_TIMED + 1):
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    batch = data.batch_at(i)
    e0.record()
    state, m = step(state, batch)
    e1.record()
    losses.append(float(m["loss"]))  # waits for the step
    auxes.append(float(m["aux_loss"]))
    times.append(e0.elapsed_time(e1))
  peak = torch.cuda.max_memory_allocated()
  if not all(x == x and abs(x) < float("inf") for x in losses + auxes):
    raise AssertionError(f"{tag}: a loss or aux is not finite: {losses} "
                         f"{auxes}")
  if cfg.n_experts and not all(a > 0 for a in auxes):
    raise AssertionError(f"{tag}: an MoE aux is zero: {auxes}")
  step_ms = sorted(times)[len(times) // 2]
  state = profile_train_step(torch, step, state, data.batch_at(
      TRAIN_TIMED + 1), step_ms, tag)
  tokens = batch_rows * TRAIN_SEQ
  dense_params = matmul_params(params)
  if cfg.n_experts:
    # each expert runs all C slots of every row: E·C of the S·E pairs
    expert = sum(t.numel() for lp in params["blocks"]
                 for t in lp["moe"]["experts"].values())
    dense_params -= expert * (1 - moe.capacity(cfg, TRAIN_SEQ) / TRAIN_SEQ)
  flops = 6.0 * dense_params * tokens
  attn_layers = {"ssm": 0, "hybrid": hybrid.layout(cfg)[1]}.get(
      cfg.family, cfg.n_layers)
  # causal attention: half of S² per head, 3 passes
  flops += (3 * 2 * 2 * attn_layers * batch_rows * cfg.n_heads
            * TRAIN_SEQ ** 2 * cfg.hd / 2)
  row.update(step_ms_median=step_ms, step_ms=times,
             tokens_s=tokens / (step_ms / 1e3), losses=losses, auxes=auxes,
             max_memory_allocated_gib=peak / 2 ** 30,
             model_flops_per_step=flops,
             bf16_peak_share=flops / (step_ms / 1e3) / hw.PEAK_OPS[
                 "bfloat16"])
  log(f"[train] {tag} {json.dumps(row)}")
  del state, model, params, opt
  return row


def profile_train_step(torch, step, state, batch, step_ms: float,
                       tag: str):
  """Where one train step spends its time: torch.profiler's kernel time on
  the card, summed by kernel, against the step's wall time under the
  profiler and its CUDA-event time unprofiled."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    state, m = step(state, batch)
    float(m["loss"])
    wall = time.perf_counter() - t0
  kernels = [e for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA]
  busy = sum(e.self_device_time_total for e in kernels) / 1e6
  log(f"[train] {tag} profile of one step: {sum(e.count for e in kernels)} "
      f"kernels, {busy * 1e3:.1f}ms on the card; wall {wall * 1e3:.1f}ms "
      f"under the profiler ({busy / wall:.1%} busy), {step_ms:.1f}ms "
      f"unprofiled")
  for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                  reverse=True)[:10]:
    log(f"[train]   {e.self_device_time_total / 1e3:9.2f}ms x{e.count:<6} "
        f"{e.key[:100]}")
  return state


TRAIN_CLI = [sys.executable, "-m", "repro_torch.launch.train", "--device",
             "cuda", "--deterministic"]


def phase_kill_resume(tmp: Path) -> dict:
  """Phase 10(d): the train driver killed at step 20 of 30 (exit 42) and
  restarted from its checkpoint ends at the uninterrupted run's loss
  (rtol 1e-5, the reference's test); the uninterrupted and the crashing run
  go at once."""
  env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
  common = ["--arch", "tinyllama-1.1b", "--smoke", "--steps", "30",
            "--batch", "4", "--seq", "32", "--lr", "1e-3", "--ckpt-every",
            "10", "--log-every", "30"]
  t0 = time.perf_counter()
  runs = [subprocess.Popen(
      TRAIN_CLI + common + extra, stdout=subprocess.PIPE,
      stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
      for extra in (["--ckpt-dir", str(tmp / "ref")],
                    ["--ckpt-dir", str(tmp / "crash"), "--fail-at", "20"])]
  (ref_out, ref_err), (_, crash_err) = (r.communicate(timeout=300)
                                        for r in runs)
  if runs[0].returncode != 0 or runs[1].returncode != 42:
    raise AssertionError(f"train driver exit codes {runs[0].returncode}, "
                         f"{runs[1].returncode} (want 0, 42):\n{ref_err}"
                         f"{crash_err}")
  r2 = subprocess.run(TRAIN_CLI + common + ["--ckpt-dir", str(tmp / "crash")],
                      capture_output=True, text=True, timeout=300, cwd=ROOT,
                      env=env)
  if r2.returncode != 0 or "resumed from step 20" not in r2.stdout:
    raise AssertionError(f"resume failed:\n{r2.stdout}{r2.stderr}")

  def loss_of(text):
    line = [ln for ln in text.splitlines() if "loss=" in ln][-1]
    return float(line.split("loss=")[1].split()[0])
  want, got = loss_of(ref_out), loss_of(r2.stdout)
  out = {"crash_exit": runs[1].returncode, "uninterrupted_loss": want,
         "resumed_loss": got, "s": time.perf_counter() - t0}
  log(f"[train] (d) kill at step 20 (exit 42) and resume: final loss "
      f"{got!r}, uninterrupted {want!r}, {out['s']:.1f}s")
  if abs(got - want) > 1e-5 * abs(want):
    raise AssertionError("the resumed run's loss differs from the "
                         "uninterrupted run's")
  return out


def phase_training(torch, card: str, kernels) -> dict:
  """Phase 10: (a) the flash backward, (b) tinyllama-1.1b at full width and
  depth, (c) mamba2-780m at full width, 8 layers, (d) kill and resume
  through the driver, (e) mixtral-8x7b at full width, 2 layers, (f)
  zamba2-7b at full width, 7 layers.  Training launches none of K1–K4
  (impl='xla')."""
  import tempfile
  from repro_torch import configs
  t_phase = time.perf_counter()
  before = [k.launches for k in kernels]
  out = {"flash_backward": phase_flash_backward(torch, card)}
  gc.collect()
  torch.cuda.empty_cache()
  out["tinyllama"] = train_phase_model(
      torch, configs.get_config(LM_ARCH), card, "(b)", probes=True)
  gc.collect()
  torch.cuda.empty_cache()
  ssm = configs.get_config(SSM_ARCH).replace(n_layers=SSM_TRAIN_LAYERS)
  out["mamba2"] = train_phase_model(torch, ssm, card, "(c)", probes=False)
  gc.collect()
  torch.cuda.empty_cache()
  (ROOT / "build").mkdir(exist_ok=True)
  with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
    out["kill_resume"] = phase_kill_resume(Path(tmp))
  for key, arch, layers, rows, tag in (
      ("mixtral", "mixtral-8x7b", MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, "(e)"),
      ("zamba2", HYBRID_ARCH, HYBRID_TRAIN_LAYERS, HYBRID_TRAIN_BATCH,
       "(f)")):
    gc.collect()
    torch.cuda.empty_cache()
    out[key] = train_phase_model(
        torch, configs.get_config(arch).replace(n_layers=layers), card, tag,
        probes=True, batch_rows=rows)
  if [k.launches for k in kernels] != before:
    raise AssertionError("training launched a hand-written kernel")
  out["s"] = time.perf_counter() - t_phase
  log(f"[train] phase 10 in {out['s']:.1f}s")
  return out


# Phase 11: MoE serving.  Both configs keep their published widths; their
# depth is cut because neither fits one 80 GB card whole (f32 master
# weights: mixtral-8x7b 187 GB, phi3.5-moe 167 GB at 32 layers).
MOE_SERVED = (("mixtral-8x7b", 8), ("phi3.5-moe-42b-a6.6b", 4))
# the reference's near-tie tolerance for MoE (tests/test_serve.py): a router
# near-tie swaps experts and moves logits by more than the dense gap
MOE_TIE_GAP = 0.1
# bf16 prefill logits, pallas vs xla, over every row: the arms round the
# attention output differently, so each router reads another input and
# routes flip (782 of 131,072 (token, choice) routes over mixtral's 8 layers
# on the first card run) yet the logits moved by 0.0391 at most; the limit
# is twice that.  The first layer's flips sat at router margins up to
# 0.00305: the limit on them is twice that.
MOE_LOGIT_ATOL = 0.078
MOE_FLIP_MARGIN = 0.0061
# the arms' logits along the same tokens (the 'xla' engine's), at every
# decode step: a route flipped in the decode moves them further than in
# the prefill (0.176 for mixtral, 0.265 for phi3.5-moe at one step of 32 on
# the second card run, 0.035-0.047 at the others); the limit is twice the
# larger
MOE_DECODE_ATOL = 0.53
# f32 compute: the arms differ in the order of K3's f32 sums; routes flip
# only at a router tie closer than MOE_F32_FLIP_MARGIN (none flipped on the
# card: mixtral's logits agreed to 6.08e-6); the limit is SSM_F32's
MOE_F32_LOGIT_ATOL = 1e-4
MOE_F32_FLIP_MARGIN = 1e-5
# Phase 12: zamba2-7b at its published width and depth (81 SSM layers, the
# shared block every 6: 13 applications).  bf16 logits pallas vs xla, with
# logits std 1.20: the prefill's 0.0547 at most and along the same tokens
# 0.0703 at most (the first two card runs); the limits twice those.  In
# f32 the prefill logits agreed to 1.74e-5; the limit is SSM_F32's.
HYBRID_ARCH = "zamba2-7b"
HYBRID_LOGIT_ATOL = 0.11
HYBRID_DECODE_ATOL = 0.14
HYBRID_F32_LOGIT_ATOL = 1e-4
# Phase 13: seamless-m4t-large-v2 uncut: speech-to-text translation, a long
# audio source (the config's src_len, 4096 frames of seeded N(0, 1)
# embeddings: the audio frontend is a stub) and a short target prefix
ENCDEC_ARCH, ENCDEC_PROMPT = "seamless-m4t-large-v2", 256
# K3's three seamless shapes: encoder self-attention, cross-attention,
# decoder self-attention
SEAMLESS_FA_CASES = (
    ("seamless encoder", (LM_BATCH, 16, 16, 4096, 4096, 64, False, None)),
    ("seamless cross-attention", (LM_BATCH, 16, 16, ENCDEC_PROMPT, 4096, 64,
                                  False, None)),
    ("seamless decoder", (LM_BATCH, 16, 16, ENCDEC_PROMPT, ENCDEC_PROMPT, 64,
                          True, None)))
# bf16 logits pallas vs xla, with logits std 0.640: the prefill's 0.03125
# at most and along the same tokens 0.03125 at most (the first card run,
# an H100, this seed); the limits twice those.  In f32 the prefill logits
# agreed to 2.92e-6; the limit is SSM_F32's.
ENCDEC_LOGIT_ATOL = 0.0625
ENCDEC_DECODE_ATOL = 0.0625
ENCDEC_F32_LOGIT_ATOL = 1e-4
# Phase 14: chameleon-34b at its published width with 8 of its 48 layers
# (34.29e9 parameters whole: 137 GB of f32, 69 GB even in bf16, do not fit
# one card; 8 layers and the embedding and head are 6.6e9, 26.5 GB); the
# image half as examples/vq_retrieval.py builds it: a seeded 8192 × 256
# codebook, 1024 patches per request (one 512 × 512 image), each a drawn
# code plus 0.05·N(0, 1), fused ahead of 1024 text tokens at offset 32768
VLM_ARCH, VLM_LAYERS = "chameleon-34b", 8
VLM_CODES, VLM_CODE_DIM, VLM_PATCHES, VLM_NOISE = 8192, 256, 1024, 0.05
VLM_TEXT, VLM_OFFSET = 1024, 32768
CHAMELEON_FA_CASE = (LM_BATCH, 64, 8, VLM_PATCHES + VLM_TEXT,
                     VLM_PATCHES + VLM_TEXT, 128, True, None)
# bf16 logits pallas vs xla, with logits std 1.81: the prefill's 0.046875
# at most and along the same tokens 0.0625 at most (the first card run);
# the limits twice those.  In f32 the prefill logits agreed to 1.18e-5.
VLM_LOGIT_ATOL = 0.094
VLM_DECODE_ATOL = 0.125
VLM_F32_LOGIT_ATOL = 1e-4
# Phase 15: the GPipe schedule, tests/test_pipeline.py's construction at a
# width that does work on the card: S stages of LPS tanh layers of D, M
# microbatches of MB rows, f32 (TF32 off, as for every f32 product here).
# Forward against float64: f32 sums of D products per layer, outputs in
# [-1, 1]; gradients relative to their largest magnitude.  Limits set from
# the dtype before the first card run, which measured 2.5e-6 (pipeline) and
# 4.1e-6 (sequential) forward, 1.1e-6 and 2.2e-6 gradients
PIPE_S, PIPE_LPS, PIPE_D, PIPE_M, PIPE_MB = 4, 3, 4096, 8, 512
PIPE_FWD_ATOL = 1e-4
PIPE_GRAD_RTOL = 1e-4


class RouteSpy:
  """While active, records every MoE layer's routing: the expert ids (B, S,
  k), the keep mask (B, S, k) and the router's top-k margin (B, S): the
  smallest gap among its k + 1 largest probabilities, computed again in
  f32 from the same input.  It wraps ``models.moe``'s ``_route`` and
  ``_dispatch`` and changes neither result."""

  def __init__(self, torch):
    from repro_torch.models import moe
    self.torch, self.moe, self.layers = torch, moe, []

  def __enter__(self):
    torch, moe = self.torch, self.moe
    route, dispatch = moe._route, moe._dispatch
    self._saved = (route, dispatch)

    def spy_route(w, cfg, x):
      out = route(w, cfg, x)
      probs = torch.softmax(torch.matmul(x.float(), w.float()), dim=-1)
      top = probs.sort(dim=-1, descending=True).values[..., :cfg.topk + 1]
      self.layers.append({"idx": out[1],
                          "margin": (top[..., :-1] - top[..., 1:]).amin(-1)})
      return out

    def spy_dispatch(x, idx, e, cap):
      out = dispatch(x, idx, e, cap)
      self.layers[-1]["keep"] = out[3]
      return out
    moe._route, moe._dispatch = spy_route, spy_dispatch
    return self

  def __exit__(self, *exc):
    self.moe._route, self.moe._dispatch = self._saved


def route_diff(a: RouteSpy, b: RouteSpy, tag: str) -> dict:
  """Per layer of two recorded prefills: the (token, choice) pairs each arm
  dropped by capacity, the routes that differ and the largest router
  margin at one.  Returns the batch rows with no differing route in any
  layer, the totals, and the largest margin at a differing route of the
  first layer that has one (its router reads inputs that differ only by
  the arms' rounding; a later layer's also by the earlier flips)."""
  if len(a.layers) != len(b.layers):
    raise AssertionError(f"{len(a.layers)} vs {len(b.layers)} MoE layers")
  rows, first, flips, per_layer = None, None, 0, []
  for i, (la, lb) in enumerate(zip(a.layers, b.layers)):
    tok = (la["idx"] != lb["idx"]).any(-1)               # (B, S)
    n = int((la["idx"] != lb["idx"]).sum())
    m = float(lb["margin"][tok].max()) if n else 0.0
    drop = [int((~la["keep"]).sum()), int((~lb["keep"]).sum())]
    per_layer.append({"dropped": drop, "differing_routes": n,
                      "max_margin_at_a_flip": m})
    log(f"[{tag}] layer {i}: dropped by capacity {drop[0]} (pallas) and "
        f"{drop[1]} (xla) of {la['keep'].numel()} (token, choice) pairs; "
        f"routes differing {n}, largest router margin at one {m!r}")
    if n and first is None:
      first = m
    flips += n
    ok = ~tok.any(-1)
    rows = ok if rows is None else rows & ok
  return {"rows": rows, "flips": flips, "first_layer_margin": first or 0.0,
          "per_layer": per_layer}


def moe_prefill_check(cfg, tag: str, atol: float, margin: float,
                      rows_without_flips: bool):
  """A ``serve_phase`` logit check for an MoE model: both arms' prefills
  with their routes recorded.  The differing routes of the first layer
  that has any must sit at router near-ties (margin under ``margin``).
  The logits must agree within ``atol``: on every row, or with
  ``rows_without_flips`` on the rows with no differing route (all of them
  when none differs)."""
  def check(model, tokens):
    import torch
    from repro_torch.train.steps import make_prefill_step
    with RouteSpy(torch) as rp:
      lp, _ = make_prefill_step(cfg, impl="pallas")(model, {"tokens": tokens})
    with RouteSpy(torch) as rx:
      lx, _ = make_prefill_step(cfg, impl="xla")(model, {"tokens": tokens})
    diff = route_diff(rp, rx, tag)
    rows = (diff["rows"] if rows_without_flips
            else torch.ones_like(diff["rows"]))
    d = (lp.float() - lx.float()).abs()
    worst = float(d[rows].max()) if bool(rows.any()) else float("nan")
    out = {"flips": diff["flips"], "rows_compared": int(rows.sum()),
           "logits_max_abs_diff": worst,
           "logits_max_abs_diff_all_rows": float(d.max()),
           "first_layer_margin": diff["first_layer_margin"],
           "per_layer": diff["per_layer"]}
    log(f"[{tag}] prefill logits pallas vs xla ({str(cfg.dtype)[6:]}): "
        f"{diff['flips']} routes differ, the largest router margin at one "
        f"of the first layer with any {diff['first_layer_margin']!r} (limit "
        f"{margin}); max |d| {worst!r} over {out['rows_compared']} of "
        f"{rows.numel()} rows (atol {atol}), "
        f"{out['logits_max_abs_diff_all_rows']!r} over all; logits std "
        f"{float(lx.float().std())!r}")
    if not bool(torch.isfinite(lp.float()).all()):
      raise AssertionError("non-finite pallas prefill logits")
    if diff["first_layer_margin"] >= margin:
      raise AssertionError("a route differs between the arms away from a "
                           "router near-tie")
    if not bool(rows.any()) or worst > atol:
      raise AssertionError("pallas and xla prefill logits disagree")
    return out
  return check


def f32_prefill_check(torch, cfg, tag: str, atol: float,
                      moe_margin=None, prompts=None, src=None) -> dict:
  """The same weights (the same seed) computing in f32: both arms' prefill
  logits (on ``prompts``, ``serve_phase``'s default when None, and an
  enc-dec model's ``src``) must agree within ``atol``; for an MoE model
  the routes too, except at a router tie closer than ``moe_margin``."""
  import numpy as np
  from repro_torch.models import zoo
  gc.collect()
  torch.cuda.empty_cache()
  cfg32 = cfg.replace(dtype=torch.float32)
  model = zoo.init(cfg32, torch.Generator(device="cuda").manual_seed(0),
                   "cuda")
  if prompts is None:
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT), dtype=np.int32)
  tokens = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")
  with torch.inference_mode():
    if moe_margin is not None:
      out = moe_prefill_check(cfg32, tag, atol, moe_margin,
                              rows_without_flips=True)(model, tokens)
    else:
      lp = prefill(cfg32, model, tokens, "pallas", src)[0]
      lx = prefill(cfg32, model, tokens, "xla", src)[0]
      d = float((lp - lx).abs().max())
      out = {"logits_max_abs_diff": d}
      log(f"[{tag}] f32 compute, same weights: prefill logits pallas vs xla "
          f"max |d|={d!r} (atol {atol}), logits std {float(lx.std())!r}")
      if not bool(torch.isfinite(lp).all()) or d > atol:
        raise AssertionError("pallas and xla f32 prefill logits disagree")
  del model
  gc.collect()
  torch.cuda.empty_cache()
  return out


def k3_served_row(fa, torch, case, label: str, launches: int) -> dict:
  """K3's bf16 instance at a served shape: ms, its plain version's, SDPA's
  (a window past every key is no window), the bound, and its result
  against the plain version's."""
  b, h, hkv, sq, skv, d, causal, window = case
  if window is not None and window < skv:
    raise ValueError("SDPA takes no sliding window here")
  q, k, v = fa_inputs(torch, case, torch.bfloat16, 3)
  run = (lambda: fa.flash_attention(q, k, v, causal=causal, window=window))
  ms = cuda_time_ms(run, 20)
  plain_ms = cuda_time_ms(lambda: fa.flash_attention_plain(
      q, k, v, causal=causal, window=window), 3)
  sdpa = torch.nn.functional.scaled_dot_product_attention
  lib_ms = cuda_time_ms(lambda: sdpa(q, k, v, is_causal=causal,
                                     enable_gqa=True), 20)
  err = max_abs_err(run(), fa.flash_attention_plain(q, k, v, causal=causal,
                                                    window=window))
  b_ms, b_by = attention_bound_ms(case, "bfloat16")
  row = {"case": f"{label} bf16 B{b} H{h}/{hkv} S{sq} D{d}"
                 f"{'' if window is None else f' window {window}'}",
         "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
         "share_of_bound": b_ms / ms, "library_ms": lib_ms,
         "max_abs_err": err, "launches": launches,
         "dynamic_shared_memory_bytes": k3_tc_smem(d)}
  log(f"[time] K3 {json.dumps(row)}")
  if err > FA_ATOL["bfloat16"]:
    raise AssertionError(f"K3 disagrees with its plain version at {label}")
  return row


def phase_moe_serving(fa, torch, card: str) -> dict:
  """Phase 11: mixtral-8x7b (8 of 32 layers) and phi3.5-moe (4 of 32) at
  their published widths through ``Engine`` on both arms, K3 once per
  layer in the prefill and never in the decode; the bf16 prefill logits
  under the router near-tie rule, then the same weights in f32 with
  identical routes; then K3 at mixtral's served shape against SDPA."""
  from repro_torch import configs
  t_phase = time.perf_counter()
  out = {}
  for arch, layers in MOE_SERVED:
    cfg = configs.get_config(arch).replace(n_layers=layers)
    if (cfg.n_heads, cfg.n_kv_heads, cfg.hd) != MIXTRAL_FA_CASE[1:3] + (
        MIXTRAL_FA_CASE[5],):
      raise AssertionError(f"{arch}'s attention is not MIXTRAL_FA_CASE's")
    gc.collect()
    torch.cuda.empty_cache()
    note = (f"{cfg.n_heads} heads over {cfg.n_kv_heads} kv heads of "
            f"{cfg.hd}, window {cfg.window}, {cfg.n_experts} experts top-"
            f"{cfg.topk}, d_ff {cfg.d_ff}; {layers} of "
            f"{configs.get_config(arch).n_layers} layers")
    run = serve_phase(torch, card, cfg, {fa.flash_attention: cfg.n_layers},
                      "moe", MOE_LOGIT_ATOL, note, tie_gap=MOE_TIE_GAP,
                      logit_check=moe_prefill_check(
                          cfg, "moe", MOE_LOGIT_ATOL, MOE_FLIP_MARGIN,
                          rows_without_flips=False),
                      profile_new=4, decode_atol=MOE_DECODE_ATOL)
    gc.collect()
    torch.cuda.empty_cache()
    run["f32"] = f32_prefill_check(torch, cfg, "moe", MOE_F32_LOGIT_ATOL,
                                   moe_margin=MOE_F32_FLIP_MARGIN)
    out[arch] = run
  out["k3_row"] = k3_served_row(
      fa, torch, MIXTRAL_FA_CASE, "mixtral-8x7b prefill",
      out["mixtral-8x7b"]["launches"]["flash_attention"])
  out["s"] = time.perf_counter() - t_phase
  log(f"[moe] phase 11 in {out['s']:.1f}s")
  return out


def phase_hybrid_serving(fa, ssd, torch, card: str) -> dict:
  """Phase 12: zamba2-7b at its published width and depth through
  ``Engine`` on both arms: K4 once per SSM layer (81) and K3 once per
  application of the shared block (13) in the prefill, neither in the
  decode; then the same weights in f32; then K3 at head dim 112 against
  SDPA and K4 at zamba2's shape against its plain version and the 'xla'
  einsums."""
  from repro_torch import configs
  from repro_torch.models import hybrid
  t_phase = time.perf_counter()
  cfg = configs.get_config(HYBRID_ARCH)
  every, n_apps = hybrid.layout(cfg)
  if (cfg.n_heads, cfg.n_kv_heads, cfg.hd) != ZAMBA_FA_CASE[1:3] + (
      ZAMBA_FA_CASE[5],) or (cfg.ssm_heads, cfg.ssm_state) != (
          SSD_ZAMBA_SHAPE[1], SSD_ZAMBA_SHAPE[4]):
    raise AssertionError("zamba2's shapes are not the phase's constants")
  gc.collect()
  torch.cuda.empty_cache()
  note = (f"{cfg.ssm_heads} SSM heads of {cfg.ssm_headdim}, state "
          f"{cfg.ssm_state}; the shared block every {every} layers "
          f"({n_apps} applications): {cfg.n_heads} heads of {cfg.hd}, d_ff "
          f"{cfg.d_ff}")
  run = serve_phase(torch, card, cfg, {ssd.ssd_intra_chunk: cfg.n_layers,
                                       fa.flash_attention: n_apps},
                    "hybrid", HYBRID_LOGIT_ATOL, note, profile_new=4,
                    decode_atol=HYBRID_DECODE_ATOL)
  gc.collect()
  torch.cuda.empty_cache()
  run["f32"] = f32_prefill_check(torch, cfg, "hybrid", HYBRID_F32_LOGIT_ATOL)
  run["k3_row"] = k3_served_row(fa, torch, ZAMBA_FA_CASE, "zamba2-7b prefill",
                                run["launches"]["flash_attention"])
  run["k4_row"] = phase_ssd_timing(ssd, torch, None,
                                   run["launches"]["ssd_intra_chunk"],
                                   SSD_ZAMBA_SHAPE, "zamba2-7b prefill")
  run["s"] = time.perf_counter() - t_phase
  log(f"[hybrid] phase 12 in {run['s']:.1f}s")
  return run


def phase_encdec_serving(fa, torch, card: str) -> dict:
  """Phase 13: seamless-m4t-large-v2 at its published width and depth
  through ``Engine`` on both arms, 4 sources of 4096 frames and 256-token
  prompts: K3 once per encoder layer and twice per decoder layer (72) in
  the prefill, never in the decode; the same weights in f32; then K3 at
  its three new shapes against its plain version and SDPA."""
  import numpy as np
  from repro_torch import configs
  t_phase = time.perf_counter()
  cfg = configs.get_config(ENCDEC_ARCH)
  for _, case in SEAMLESS_FA_CASES:
    if (cfg.n_heads, cfg.n_kv_heads, cfg.hd) != case[1:3] + (case[5],) or (
        case[4] not in (cfg.src_len, ENCDEC_PROMPT)):
      raise AssertionError("seamless's shapes are not the phase's constants")
  gc.collect()
  torch.cuda.empty_cache()
  src = torch.randn(LM_BATCH, cfg.src_len, cfg.d_model, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
  prompts = np.random.default_rng(0).integers(
      0, cfg.vocab, (LM_BATCH, ENCDEC_PROMPT), dtype=np.int32)
  launches = cfg.enc_layers + 2 * cfg.dec_layers
  note = (f"{cfg.enc_layers} + {cfg.dec_layers} layers, {cfg.n_heads} heads "
          f"of {cfg.hd}, d_ff {cfg.d_ff}, vocabulary {cfg.vocab}; sources of "
          f"{cfg.src_len} frames")
  run = serve_phase(torch, card, cfg, {fa.flash_attention: launches},
                    "encdec", ENCDEC_LOGIT_ATOL, note, profile_new=4,
                    decode_atol=ENCDEC_DECODE_ATOL, prompts=prompts, src=src)
  log(f"[encdec] K3 read every decoder layer's cross K/V as a strided view "
      f"of the one (B, Skv, L, 2, KV, hd) product ({cfg.dec_layers} of the "
      f"{launches} launches; attention._check_override refuses a layout "
      f"the kernel would need copied)")
  gc.collect()
  torch.cuda.empty_cache()
  run["f32"] = f32_prefill_check(torch, cfg, "encdec", ENCDEC_F32_LOGIT_ATOL,
                                 prompts=prompts, src=src)
  run["k3_rows"] = [k3_served_row(fa, torch, case, label, n)
                    for (label, case), n in zip(
                        SEAMLESS_FA_CASES,
                        (cfg.enc_layers, cfg.dec_layers, cfg.dec_layers))]
  run["s"] = time.perf_counter() - t_phase
  log(f"[encdec] phase 13 in {run['s']:.1f}s")
  return run


def k1_vq_row(sm, torch, patches, codebook, launches: int) -> dict:
  """K1's addnorm instance at the VQ shape (all patches × the codebook):
  ms, its plain version's, the bound, ``vq_tokenize`` whole on 'pallas'
  and on the 'xla' arm (cuBLAS's expansion) for context."""
  from repro_torch.models import vlm
  d = patches.shape[-1]
  a = patches.reshape(1, -1, d)
  b = codebook.T.contiguous()[None]
  _, m, k = a.shape
  n = b.shape[-1]
  ms = cuda_time_ms(lambda: sm.semiring_mmo(a, b, op="addnorm"), 20)
  plain_ms = cuda_time_ms(lambda: sm.semiring_mmo_plain(a, b, op="addnorm"),
                          3)
  vq_ms = cuda_time_ms(lambda: vlm.vq_tokenize(patches, codebook,
                                               backend="pallas"), 20)
  xla_ms = cuda_time_ms(lambda: vlm.vq_tokenize(patches, codebook,
                                                backend="xla"), 20)
  err = check(f"K1 addnorm VQ {m} × {k} · {k} × {n}",
              sm.semiring_mmo(a, b, op="addnorm"),
              sm.semiring_mmo_plain(a, b, op="addnorm"), "addnorm")
  b_ms, b_by = bound_ms("addnorm", "float32", 1, m, k, n, k, False)
  row = {"case": f"chameleon VQ tokenizer addnorm f32 {m} × {k} · {k} × {n}",
         "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
         "share_of_bound": b_ms / ms, "library_ms": None, "max_abs_err": err,
         "launches": launches, "vq_tokenize_ms": vq_ms,
         "xla_arm_vq_tokenize_ms": xla_ms}
  log(f"[time] K1 {json.dumps(row)}")
  return row


def phase_vlm_serving(sm, fa, torch, card: str) -> dict:
  """Phase 14: chameleon-34b at its published width with 8 of its 48
  layers: the image half tokenized by one K1 addnorm launch (ids held to
  the drawn codes, a float64 brute force and the 'vector' arm), fused
  ahead of the text and served through ``Engine`` on both arms (K1 once
  and K3 once per layer per generate, K3 never in the decode); the same
  weights in f32; then K3 at chameleon's shape and K1 at the VQ shape."""
  import numpy as np
  from repro_torch import configs
  from repro_torch.models import vlm
  t_phase = time.perf_counter()
  full = configs.get_config(VLM_ARCH)
  cfg = full.replace(n_layers=VLM_LAYERS)
  if (cfg.n_heads, cfg.n_kv_heads, cfg.hd) != CHAMELEON_FA_CASE[1:3] + (
      CHAMELEON_FA_CASE[5],) or not cfg.qk_norm:
    raise AssertionError("chameleon's shapes are not the phase's constants")
  gc.collect()
  torch.cuda.empty_cache()
  gen = torch.Generator(device="cuda").manual_seed(5)
  codebook = torch.randn(VLM_CODES, VLM_CODE_DIM, generator=gen,
                         device="cuda")
  codes = torch.randint(0, VLM_CODES, (LM_BATCH, VLM_PATCHES), generator=gen,
                        device="cuda")
  patches = codebook[codes] + VLM_NOISE * torch.randn(
      LM_BATCH, VLM_PATCHES, VLM_CODE_DIM, generator=gen, device="cuda")
  text = torch.as_tensor(np.random.default_rng(0).integers(
      0, VLM_OFFSET, (LM_BATCH, VLM_TEXT)), device="cuda")
  made = []

  def front():
    ids = vlm.vq_tokenize(patches, codebook, backend="pallas")
    made.append(ids)
    return vlm.fuse_streams(text, ids, VLM_OFFSET)
  prompts = front().cpu().numpy()
  ids = made[0].long()
  flat = patches.reshape(-1, VLM_CODE_DIM)
  f64 = torch.cat([addnorm_f64(torch, flat[i:i + 256], codebook.T,
                               rows=64).argmin(-1)
                   for i in range(0, flat.shape[0], 256)])
  vec = vlm.vq_tokenize(patches, codebook, backend="vector").long()
  same = {"drawn codes": bool(torch.equal(ids, codes)),
          "float64 brute force": bool(torch.equal(ids.flatten(), f64)),
          "'vector' arm": bool(torch.equal(ids, vec))}
  log(f"[vlm] image half: {LM_BATCH} × {VLM_PATCHES} patches of "
      f"{VLM_CODE_DIM} against {VLM_CODES} codes, one K1 addnorm launch; "
      f"ids equal to {same}; fused prompts {prompts.shape}, image ids in "
      f"[{int(prompts[:, :VLM_PATCHES].min())}, "
      f"{int(prompts[:, :VLM_PATCHES].max())}]")
  if not all(same.values()):
    raise AssertionError("the VQ ids differ")
  note = (f"{cfg.n_heads} heads over {cfg.n_kv_heads} kv heads of {cfg.hd}, "
          f"qk-norm, d_ff {cfg.d_ff}, vocabulary {cfg.vocab}; "
          f"{VLM_LAYERS} of {full.n_layers} layers")
  run = serve_phase(torch, card, cfg, {sm.semiring_mmo: 1,
                                       fa.flash_attention: cfg.n_layers},
                    "vlm", VLM_LOGIT_ATOL, note, profile_new=4,
                    decode_atol=VLM_DECODE_ATOL, prompts=prompts,
                    front=front)
  run["vq_ids_equal"] = same
  gc.collect()
  torch.cuda.empty_cache()
  run["f32"] = f32_prefill_check(torch, cfg, "vlm", VLM_F32_LOGIT_ATOL,
                                 prompts=prompts)
  run["k3_row"] = k3_served_row(fa, torch, CHAMELEON_FA_CASE,
                                "chameleon-34b prefill",
                                run["launches"]["flash_attention"])
  run["k1_row"] = k1_vq_row(sm, torch, patches, codebook,
                            run["launches"]["semiring_mmo"])
  run["s"] = time.perf_counter() - t_phase
  log(f"[vlm] phase 14 in {run['s']:.1f}s")
  return run


def phase_pipeline(torch, card: str) -> dict:
  """Phase 15: the GPipe schedule on a virtual 4 × 2 mesh of eight shards
  of the card, microbatch rows split over "data": forward and gradients
  against the sequential layers, each held to float64; ms per call against
  the sequential call.  The shards share one card, so the schedule's
  stages run one after another: this measures the schedule's overhead, not
  an interconnect."""
  from repro_torch.launch.mesh import make_host_mesh
  from repro_torch.models import pipeline
  t_phase = time.perf_counter()
  mesh = make_host_mesh(devices=["cuda:0"] * 8, axis_names=("stage", "data"))
  n_layers = PIPE_S * PIPE_LPS
  gen = torch.Generator(device="cuda").manual_seed(7)
  w = torch.randn(n_layers, PIPE_D, PIPE_D, generator=gen,
                  device="cuda") / PIPE_D ** 0.5
  x = torch.randn(PIPE_M, PIPE_MB, PIPE_D, generator=gen, device="cuda")

  def stage_fn(ws, h):
    for layer in ws:
      h = torch.tanh(h @ layer)
    return h
  run = pipeline.pipeline(stage_fn, mesh, axis="stage", in_spec=("stage",),
                          x_spec=(None, "data"))

  def piped(wt):
    return run(pipeline.split_stages(wt, PIPE_S), x)

  def grads(fn, wt):
    wt = wt.detach().requires_grad_(True)
    y = fn(wt)
    (g,) = torch.autograd.grad((y.double() ** 2).sum(), (wt,))
    return y.detach(), g

  y_p, g_p = grads(piped, w)
  y_s, g_s = grads(lambda wt: stage_fn(wt, x), w)
  y_64, g_64 = grads(lambda wt: stage_fn(wt, x.double()), w.double())
  g_max = float(g_64.abs().max())
  errs = {"forward_pipeline_vs_f64": float((y_p - y_64).abs().max()),
          "forward_sequential_vs_f64": float((y_s - y_64).abs().max()),
          "forward_pipeline_vs_sequential": float((y_p - y_s).abs().max()),
          "grad_pipeline_vs_f64_rel": float((g_p - g_64).abs().max()) / g_max,
          "grad_sequential_vs_f64_rel":
              float((g_s - g_64).abs().max()) / g_max,
          "grad_pipeline_vs_sequential_rel":
              float((g_p - g_s).abs().max()) / g_max}
  del y_64, g_64
  with torch.no_grad():
    pipe_ms = cuda_time_ms(lambda: piped(w), 5)
    seq_ms = cuda_time_ms(lambda: stage_fn(w, x), 5)
  pipe_train_ms = cuda_time_ms(lambda: grads(piped, w), 3)
  seq_train_ms = cuda_time_ms(lambda: grads(lambda wt: stage_fn(wt, x), w), 3)
  out = {"mesh": dict(mesh.shape), "stages": PIPE_S,
         "layers_per_stage": PIPE_LPS, "d": PIPE_D, "microbatches": PIPE_M,
         "rows": PIPE_MB,
         "bubble_fraction": pipeline.bubble_fraction(PIPE_S, PIPE_M),
         "ms": pipe_ms, "sequential_ms": seq_ms,
         "fwd_bwd_ms": pipe_train_ms, "sequential_fwd_bwd_ms": seq_train_ms,
         **errs, "card": card}
  log(f"[pipe] GPipe on a virtual (stage 4, data 2) mesh of cuda:0 (the "
      f"stages share the card and run one after another: the schedule's "
      f"cost, no interconnect): {json.dumps(out)}")
  if not (errs["forward_pipeline_vs_f64"] <= PIPE_FWD_ATOL
          and errs["forward_sequential_vs_f64"] <= PIPE_FWD_ATOL
          and errs["grad_pipeline_vs_f64_rel"] <= PIPE_GRAD_RTOL
          and errs["grad_sequential_vs_f64_rel"] <= PIPE_GRAD_RTOL):
    raise AssertionError("the pipeline disagrees with the sequential layers")
  out["s"] = time.perf_counter() - t_phase
  log(f"[pipe] phase 15 in {out['s']:.1f}s")
  return out


# Phase 16: the dry run's cells (arch, shape, mesh), one call each
DRYRUN_CELLS = (("tinyllama-1.1b", "decode_32k", "single"),
                ("mixtral-8x7b", "prefill_32k", "single"),
                ("mamba2-780m", "long_500k", "single"),
                ("zamba2-7b", "train_4k", "single"),
                ("seamless-m4t-large-v2", "prefill_32k", "single"),
                ("chameleon-34b", "decode_32k", "single"),
                ("granite-8b", "long_500k", "single"),
                ("tinyllama-1.1b", "decode_32k", "multi"))
# the APSP anchor: Table 4's "large" |V|, phase 4's density, the rows held
# bit for bit against local K1
APSP_V, APSP_DENSITY, APSP_ROWS = 16384, 0.05, 256


def device_allocations(torch) -> int:
  return torch.cuda.memory_stats().get("allocation.all.allocated", 0)


def apsp_graph(torch, v: int, seed: int):
  """``apps.graphs.weighted_digraph``'s distribution drawn on the card:
  weights uniform in [1, 10), no edge (inf) where a second draw is at or
  above the density, 0 on the diagonal."""
  g = torch.Generator(device="cuda").manual_seed(seed)
  w = torch.rand(v, v, generator=g, device="cuda") * 9.0 + 1.0
  w = w.masked_fill_(torch.rand(v, v, generator=g, device="cuda")
                     >= APSP_DENSITY, float("inf"))
  return w.fill_diagonal_(0.0)


def phase_dryrun(sm, torch, card: str, lm: dict, train: dict) -> dict:
  """Phase 16: (a) the dry run's rows on the host, (b) its bound against
  two measurements of this run, (c) the APSP squaring at |V| = 16384 on a
  virtual 2 × 2 mesh of the card against the dry run's K1 bound."""
  from repro_torch import configs
  from repro_torch.configs import Shape
  from repro_torch.core import distributed as dist
  from repro_torch.launch import dryrun, dryrun_apsp
  from repro_torch.launch.mesh import AbstractMesh, make_host_mesh
  t_phase = time.perf_counter()
  out = {"card": card, "hbm_bytes": torch.cuda.get_device_properties(
      0).total_memory, "hw_hbm_bytes": hw.HBM_BYTES}
  # -- (a) the rows, on the host ---------------------------------------------
  allocs = device_allocations(torch)
  t0 = time.perf_counter()
  rows = []
  for arch, shape, mesh in DRYRUN_CELLS:
    row = dryrun.run_cell(arch, shape, mesh)
    log(f"[dryrun] {json.dumps(row, default=float)}")
    want = "skipped" if configs.skip_reason(arch, shape) else "ok"
    if row["status"] != want:
      raise AssertionError(f"dry run {arch} × {shape} on {mesh}: status "
                           f"{row['status']}, want {want}")
    if want == "ok" and not row["peak_mem_per_dev"] < hw.HBM_BYTES:
      raise AssertionError(f"dry run {arch} × {shape}: "
                           f"{row['peak_mem_per_dev']} bytes per device")
    rows.append(row)
  out["a_s"] = time.perf_counter() - t0
  if device_allocations(torch) != allocs:
    raise AssertionError("the dry run allocated device memory")
  out["rows"] = rows
  log(f"[dryrun] (a) {len(rows)} rows in {out['a_s']:.1f}s on the host, "
      f"no device allocation; the card's memory "
      f"{out['hbm_bytes']} bytes (hw.HBM_BYTES {hw.HBM_BYTES}) {card}")
  # -- (b) the bound against this run's measurements --------------------------
  one = AbstractMesh((1, 1), ("data", "model"))
  pre = dryrun.run_cell(LM_ARCH, Shape("prefill_2k", LM_PROMPT, LM_BATCH,
                                       "prefill"), one)
  trn = dryrun.run_cell(LM_ARCH, Shape("train_2k", TRAIN_SEQ, TRAIN_BATCH,
                                       "train"), one, remat="none", accum=1)
  if device_allocations(torch) != allocs:
    raise AssertionError("the dry run allocated device memory")
  bound = {"prefill": max(pre["t_compute_s"], pre["t_memory_s"],
                          pre["t_collective_s"]),
           "train": max(trn["t_compute_s"], trn["t_memory_s"],
                        trn["t_collective_s"])}
  measured = {"prefill": lm["prefill_ms"] / 1e3,
              "train": train["tinyllama"]["step_ms_median"] / 1e3}
  out["vs_card"] = {k: {"measured_s": measured[k], "bound_s": bound[k],
                        "bottleneck": r["bottleneck"],
                        "measured_over_bound": measured[k] / bound[k]}
                    for k, r in (("prefill", pre), ("train", trn))}
  log(f"[dryrun] (b) {LM_ARCH} on a (1, 1) mesh, {LM_BATCH} × {LM_PROMPT}: "
      f"measured ÷ the dry run's bound {json.dumps(out['vs_card'])} (the "
      f"prefill measured on 'pallas' with K3 in phase 6, host clock; the "
      f"row counts the 'xla' arm; the train step phase 10's CUDA-event "
      f"median, remat none) {card}")
  # -- (c) the APSP anchor ----------------------------------------------------
  v = APSP_V
  mesh = make_host_mesh(4, model=2, devices=["cuda:0"] * 4)
  c = apsp_graph(torch, v, 16)
  torch.cuda.synchronize()

  def squaring():
    return dist.summa_mmo(c, c, c, op="minplus", mesh=mesh,
                          backend="pallas")
  sm.semiring_mmo.launches = 0     # the main path: counted just around it
  got = squaring()
  torch.cuda.synchronize()
  launches = sm.semiring_mmo.launches
  if launches != mesh.size:
    raise AssertionError(f"SUMMA at {v}: {launches} K1 launches, want "
                         f"{mesh.size}")
  rows_a = c[None, :APSP_ROWS].contiguous()
  local = sm.semiring_mmo(rows_a, c[None], rows_a, op="minplus")[0]
  plain = sm.semiring_mmo_plain(rows_a, c[None], rows_a, op="minplus")[0]
  if not (torch.equal(got[:APSP_ROWS], local) and torch.equal(local, plain)):
    raise AssertionError(f"SUMMA at {v}: rows 0-{APSP_ROWS - 1} differ from "
                         f"local K1 or its plain version")
  # a squaring only shortens: no NaN, no entry above C's, 0 on the diagonal
  if not (got.shape == (v, v) and not bool(torch.isnan(got).any())
          and bool((got <= c).all()) and not bool(got.diagonal().any())):
    raise AssertionError(f"SUMMA at {v}: not a squaring of C")
  ms = cuda_time_ms(squaring, 3)
  local_ms = cuda_time_ms(
      lambda: sm.semiring_mmo(rows_a, c[None], rows_a, op="minplus"), 3)
  plain_ms = cuda_time_ms(
      lambda: sm.semiring_mmo_plain(rows_a, c[None], rows_a, op="minplus"),
      1)
  del got, local, plain, rows_a, c
  small = dryrun_apsp.run(v, AbstractMesh((2, 2), ("data", "model")))
  prod = dryrun_apsp.run(v, "single")
  b_ms, b_by = bound_ms("minplus", "float32", 1, v, v, v, v, True)
  per_chip_ms = small["t_step_pallas_vpu"] * 1e3
  out["apsp"] = {
      "case": f"minplus {v}³ squaring as {mesh.size} SUMMA shards of "
              f"{v // 2} × {v} × {v // 2} (virtual 2 × 2 mesh of cuda:0; "
              f"plain_ms: rows 0-{APSP_ROWS - 1}, 1/{v // APSP_ROWS} of the "
              f"work)",
      "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
      "share_of_bound": b_ms / ms, "library_ms": None, "max_abs_err": 0.0,
      "launches": launches, "local_rows_ms": local_ms,
      "dryrun_t_step_pallas_vpu_ms": per_chip_ms,
      "measured_over_dryrun_one_card": ms / (mesh.size * per_chip_ms),
      "dryrun_2x2": small, "dryrun_single_pod": prod}
  log(f"[dryrun] (c) APSP |V| = {v}: one SUMMA squaring {ms!r} ms on the "
      f"card ({launches} K1 launches; rows 0-{APSP_ROWS - 1} bit for bit "
      f"equal to local K1, {local_ms!r} ms, and its plain version); the dry "
      f"run's K1 bound on the (2, 2) mesh {per_chip_ms!r} ms per chip, "
      f"{mesh.size * per_chip_ms!r} ms for the four shards on one card "
      f"(measured ÷ that {out['apsp']['measured_over_dryrun_one_card']!r}); "
      f"the single pod's row: t_step_pallas_vpu "
      f"{prod['t_step_pallas_vpu'] * 1e3!r} ms, t_step_xla_vector "
      f"{prod['t_step_xla_vector'] * 1e3!r} ms, t_step_simd2_unit "
      f"{prod['t_step_simd2_unit'] * 1e3!r} ms, solve bound "
      f"{prod['solve_bound_s']!r} s {card}")
  k1_row = {k: x for k, x in out["apsp"].items()
            if k not in ("dryrun_2x2", "dryrun_single_pod")}
  log(f"[time] K1 {json.dumps(k1_row)}")
  out["s"] = time.perf_counter() - t_phase
  log(f"[dryrun] phase 16 in {out['s']:.1f}s")
  return out


def main() -> int:
  import numpy as np
  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is false — this script "
          "needs an NVIDIA GPU", file=sys.stderr)
    return 2
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True, timeout=60).stdout.strip()
  card = smi.splitlines()[0]
  clock = subprocess.run(
      ["nvidia-smi", "--query-gpu=clocks.max.sm",
       "--format=csv,noheader,nounits"],
      capture_output=True, text=True, check=True, timeout=60).stdout
  hw.set_sm_clock(float(clock.splitlines()[0]) * 1e6)
  log(card)
  log(f"[env] clocks.max.sm {hw.SM_CLOCK_HZ / 1e6:.0f} MHz: CUDA-core issue "
      f"bound {hw.SMS} SMs x {hw.LANES} lanes x that clock")
  log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
      f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
  # -- phase 0: the static analyzer ------------------------------------------
  analysis = phase_analysis()
  # full-precision f32 for every torch.matmul yardstick and rewrite
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False

  from repro_torch.apps import graphs
  from repro_torch.apps.solvers import smallest_k
  from repro_torch.core import closure as cl
  from repro_torch import serve_mmo as api
  from repro_torch.kernels import closure_megakernel as mk
  from repro_torch.kernels import nvcc
  from repro_torch.kernels import ssd
  # the package's semiring_mmo and flash_attention are the batched entry
  # points; the kernel modules of those names are reached by path
  fa = importlib.import_module("repro_torch.kernels.flash_attention")
  sm = importlib.import_module("repro_torch.kernels.semiring_mmo")
  from repro_torch.serve_mmo import (MMOEngine, apsp_request, knn_request,
                                     mmo_request, reachability_request)

  # -- phase 2: build ---------------------------------------------------------
  t0 = time.perf_counter()
  nvcc.build_all([sm.LIBRARY, mk.LIBRARY, fa.LIBRARY, ssd.LIBRARY])
  sm.load()
  mk.load()
  fa.load()
  ssd.load()
  log(f"[build] {sm.library_path().name}, {mk.library_path().name}, "
      f"{fa.library_path().name}, {ssd.library_path().name} in "
      f"{time.perf_counter() - t0:.1f}s (one nvcc each, in parallel)")
  regs = sorted({line.split("Used")[1].split(",")[0].strip()
                 for line in sm.build_log().splitlines() if "Used" in line})
  log(f"[build] ptxas: {regs}")
  k2_ptxas = sorted({line.split("Used", 1)[1].strip()
                     for line in mk.build_log().splitlines()
                     if "Used" in line})
  spills = sorted({line.strip() for line in mk.build_log().splitlines()
                   if "spill" in line and not line.strip().startswith(
                       "0 bytes")})
  log(f"[build] K2 ptxas: {k2_ptxas} spills: {spills}")
  k3_ptxas, k3_spills = ptxas_summary(fa.build_log())
  k3_smem = {"f32": {hd: (2 * hd * (fa.TILE[0] + 4) + fa.TILE[1] * hd
                          + fa.TILE[1] * (fa.TILE[0] + 4)) * 4
                     for hd in fa.HEAD_DIMS},
             "bf16": {hd: k3_tc_smem(hd) for hd in fa.HEAD_DIMS}}
  log(f"[build] K3 ptxas (instance<head dim>: registers): {k3_ptxas}; "
      f"spills: {k3_spills}; dynamic shared memory per CTA by head dim: "
      f"{k3_smem} bytes")
  sass = semiring_sass(sm, mk)
  log(f"[build] K1/K2 instances, opcode counts in the SASS (cuobjdump "
      f"-sass): {json.dumps(sass)}")
  k3_tc = tensor_core_sass(fa)
  log(f"[build] K3 bf16 instances, HGMMA/HMMA instructions in the SASS by "
      f"head dim (cuobjdump -sass): {k3_tc}")
  k4_ptxas, k4_spills = ptxas_summary(ssd.build_log())
  k4_smem = {pd: k4_smem_bytes(pd) for pd in ssd.HEAD_DIMS}
  log(f"[build] K4 ptxas (dtype, head dim: registers): {k4_ptxas}; spills: "
      f"{k4_spills}; dynamic shared memory per CTA by head dim: {k4_smem} "
      f"bytes")
  k4_tc = ssd_sass(ssd)
  log(f"[build] K4 instances, HMMA/HGMMA instructions in the SASS "
      f"(cuobjdump -sass): {json.dumps(k4_tc)}")

  # -- phase 3: kernel vs plain ---------------------------------------------
  gen = torch.Generator().manual_seed(0)
  phase_kernel_vs_plain(sm, torch, gen)
  n_big = 4096
  w_big = graphs.weighted_digraph(n_big, 0.05, seed=11)
  adj_big = cl.prepare_adjacency(torch.from_numpy(w_big).cuda(),
                                 op="minplus")[None].contiguous()
  step_k = sm.semiring_mmo(adj_big, adj_big, adj_big, op="minplus")
  step_p = sm.semiring_mmo_plain(adj_big, adj_big, adj_big, op="minplus")
  big_err = check("minplus step C ⊕ C⊗C 4096³", step_k, step_p, "minplus")
  del step_k, step_p
  k2_err = phase_fixpoint_vs_plain(mk, cl, torch, adj_big)
  phase_fused_vs_dispatch(cl, torch)
  phase_dtype_fixpoints(mk, cl, torch)
  k3_err = phase_flash_vs_plain(fa, torch)
  k4_err = phase_ssd_vs_plain(ssd, torch)

  # -- phase 4: the main path -----------------------------------------------
  rng = np.random.default_rng(7)
  reach_adj = graphs.boolean_digraph(1024, 0.005, seed=12)
  ref_pts, qry_pts = graphs.knn_points(16384, 4096, 16, seed=13)
  mm_a = rng.standard_normal((4096, 4096)).astype(np.float32)
  mm_b = rng.standard_normal((4096, 4096)).astype(np.float32)
  ragged = [graphs.weighted_digraph(int(n), float(d), seed=20 + i)
            for i, (n, d) in enumerate(zip(rng.integers(200, 257, 8),
                                           rng.uniform(0.01, 0.3, 8)))]
  reqs = ([apsp_request(w_big), reachability_request(reach_adj),
           knn_request(qry_pts, ref_pts, k=8), mmo_request(mm_a, mm_b,
                                                          op="minplus")]
          + [apsp_request(w) for w in ragged])
  engine = MMOEngine(backend="pallas", max_batch=8, device="cuda")
  built = engine.prewarm(reqs)
  log(f"[main] prewarm built {built} executables")
  sm.semiring_mmo.launches = 0
  mk.fixpoint_chunk.launches = 0
  engine.start()
  try:
    t0 = time.perf_counter()
    futs = [engine.submit(r) for r in reqs]
    results = [f.result(timeout=900) for f in futs]
    wall = time.perf_counter() - t0
  finally:
    engine.stop()
  launches = sm.semiring_mmo.launches
  if mk.fixpoint_chunk.launches != 0:
    raise AssertionError("the 'pallas' engine launched K2")
  st = engine.stats()
  log(f"[main] {st.summary()}")
  log(f"[main] stream: {len(reqs)} requests in {wall:.3f}s = "
      f"{len(reqs) / wall:.2f} requests/s, p50="
      f"{st.percentile(50) * 1e3:.1f}ms p99={st.percentile(99) * 1e3:.1f}ms, "
      f"semiring_mmo launches={launches}")
  with engine._lock:  # per-batch host-clock breakdown of the stream
    records = list(engine._records)
  batches = {}
  for rec in records:
    batches.setdefault((rec.scheduled_s, rec.bucket), []).append(rec)
  for (sched_s, bucket), recs in sorted(batches.items()):
    shape = "x".join(str(d) for d in bucket[2])
    log(f"[main] batch {bucket[0]}/{bucket[1]}/{shape} x{len(recs)}: "
        f"waited {(sched_s - recs[0].arrival_s) * 1e3:.1f}ms, served in "
        f"{(recs[0].completed_s - sched_s) * 1e3:.1f}ms")
  if launches <= 0:
    raise AssertionError("the main path launched the kernel no time")
  if engine.cache.misses != built:
    raise AssertionError(f"cache built during serving: {engine.cache.stats()}")

  # every result against the plain path on the card
  for res in results:
    if res.value.dtype.kind == "f" and np.isnan(res.value).any():
      raise AssertionError("NaN in a served result")
  plain = MMOEngine(backend="vector", max_batch=8, device="cuda")
  small = [1] + list(range(4, len(reqs)))
  pfuts = [plain.submit(reqs[i]) for i in small]
  plain.run_until_idle()
  for i, pf in zip(small, pfuts):
    r, got, want = reqs[i], results[i], pf.result()
    same = np.array_equal(got.value, want.value)
    its = (got.extras["iterations"], want.extras["iterations"])
    log(f"[main] {r.kind}/{r.op} n={r.shape[0]}: plain-path equal={same} "
        f"iterations={its}")
    if not same or its[0] != its[1]:
      raise AssertionError(f"{r.kind} n={r.shape[0]} differs from the plain "
                           f"path")
  # raw 4096³ minplus mmo: bit-exact against the plain version
  a_t, b_t = torch.from_numpy(mm_a).cuda(), torch.from_numpy(mm_b).cuda()
  want = sm.semiring_mmo_plain(a_t[None], b_t[None], op="minplus")[0]
  if not equal_nan(torch.from_numpy(results[3].value).cuda(), want):
    raise AssertionError("4096³ minplus mmo differs from the plain version")
  log("[main] mmo minplus 4096³: plain-path equal=True")
  # KNN: distances within tolerance; the chosen rows are the plain top-8
  q_t, r_t = torch.from_numpy(qry_pts).cuda(), torch.from_numpy(ref_pts).cuda()
  d2 = sm.semiring_mmo_plain(q_t[None], r_t.T[None], op="addnorm")[0]
  pv, _ = smallest_k(d2, 8)
  got_idx = torch.from_numpy(results[2].extras["indices"]).cuda().long()
  at_got = torch.gather(d2, 1, got_idx)
  if not (torch.allclose(torch.from_numpy(results[2].value).cuda(), pv,
                         **TOL) and torch.allclose(at_got, pv, **TOL)):
    raise AssertionError("KNN top-8 differs from the plain version")
  log("[main] knn 4096q x 16384x16 k=8: plain-path top-8 ok")
  # APSP 4096: spot rows are a fixed point under the plain version, bounded
  # by the graph, and agree with single-source Bellman-Ford
  d_big = torch.from_numpy(results[0].value).cuda()
  it_big = results[0].extras["iterations"]
  rows = torch.tensor([0, 1, n_big // 2 - 1, n_big - 1], device="cuda")
  fix = sm.semiring_mmo_plain(d_big[rows][None], d_big[None],
                              d_big[rows][None], op="minplus")[0]
  w_t = torch.from_numpy(w_big).cuda()
  src = cl.prepare_adjacency(w_t, op="minplus")
  bf = src[rows]
  for _ in range(n_big):
    nxt = torch.minimum(bf, (bf[:, :, None] + src[None]).amin(dim=1))
    if torch.equal(nxt, bf):
      break
    bf = nxt
  if not (equal_nan(fix, d_big[rows]) and bool((d_big[rows] <= src[rows]).all())
          and torch.allclose(d_big[rows], bf, rtol=1e-5, atol=1e-4)):
    raise AssertionError("APSP 4096 spot rows fail the plain checks")
  log(f"[main] apsp 4096: iterations={it_big}, spot rows ok")

  # -- phase 4b: the fused arm serves the closure requests --------------------
  closure_idx = [i for i, r in enumerate(reqs) if r.kind == "closure"]
  fused = MMOEngine(backend="megakernel", max_batch=8, device="cuda")
  built_fused = fused.prewarm([reqs[i] for i in closure_idx])
  sm.semiring_mmo.launches = 0
  mk.fixpoint_chunk.launches = 0
  fused.start()
  try:
    t0 = time.perf_counter()
    ffuts = [fused.submit(reqs[i]) for i in closure_idx]
    fres = [f.result(timeout=900) for f in ffuts]
    fwall = time.perf_counter() - t0
  finally:
    fused.stop()
  k2_batch, k1_fused = mk.fixpoint_chunk.launches, sm.semiring_mmo.launches
  fst = fused.stats()
  log(f"[fused] {fst.summary()}")
  log(f"[fused] {len(closure_idx)} closure requests in {fwall:.3f}s, "
      f"p50={fst.percentile(50) * 1e3:.1f}ms "
      f"p99={fst.percentile(99) * 1e3:.1f}ms, closure_megakernel "
      f"launches={k2_batch}, semiring_mmo launches={k1_fused}")
  if k2_batch <= 0 or k1_fused != 0:
    raise AssertionError(f"fused arm: K2 launches {k2_batch}, K1 {k1_fused}")
  if fused.cache.misses != built_fused:
    raise AssertionError(f"cache built during serving: {fused.cache.stats()}")
  for i, got in zip(closure_idx, fres):
    if not same_result(got, results[i]):
      raise AssertionError(f"fused arm differs from 'pallas' on request {i}")
  log(f"[fused] all {len(fres)} results equal the 'pallas' engine's "
      f"(values and iterations)")

  # -- phase 4c: arena mode, Table-4 closures + three waves of small ones ----
  waves = small_waves(graphs, api)
  arena_eng = MMOEngine(mode="arena", arena_capacity=8, arena_g=4,
                        device="cuda")
  table4 = [reqs[i] for i in closure_idx]
  built_arena = arena_eng.prewarm(table4 + [r for w in waves for r in w])
  sm.semiring_mmo.launches = 0
  mk.fixpoint_chunk.launches = 0
  t0 = time.perf_counter()
  afuts = [arena_eng.submit(r) for r in table4 + waves[0]]
  arena_eng.step()
  wave_futs = [afuts[len(table4):]]
  for wave in waves[1:]:
    live = sum(not f.done() for f in wave_futs[-1])
    if live == 0:
      raise AssertionError("no slot of the previous wave is still live")
    log(f"[arena] submitting a wave of {len(wave)} with {live} of the "
        f"previous wave's requests still resident")
    wave_futs.append([arena_eng.submit(r) for r in wave])
    afuts += wave_futs[-1]
    arena_eng.step()
  arena_eng.run_until_idle()
  awall = time.perf_counter() - t0
  ares = [f.result(timeout=60) for f in afuts]
  k2_arena, k1_arena = mk.fixpoint_chunk.launches, sm.semiring_mmo.launches
  ticks = sum(a["ticks"] for a in arena_eng.arena_stats().values())
  ast = arena_eng.stats()
  log(f"[arena] {ast.summary()}")
  log(f"[arena] {len(afuts)} requests in {awall:.3f}s, "
      f"p50={ast.percentile(50) * 1e3:.1f}ms "
      f"p99={ast.percentile(99) * 1e3:.1f}ms, ticks={ticks}, "
      f"closure_megakernel launches={k2_arena}, semiring_mmo launches="
      f"{k1_arena}, arenas={len(arena_eng.arena_stats())}")
  if k2_arena <= 0 or k1_arena != 0:
    raise AssertionError(f"arena: K2 launches {k2_arena}, K1 {k1_arena}")
  if arena_eng.cache.misses != built_arena:
    raise AssertionError(f"arena built after prewarm: "
                         f"{arena_eng.cache.stats()}")
  small = [r for w in waves for r in w]
  batch_small = MMOEngine(backend="pallas", max_batch=8, device="cuda")
  bfuts = [batch_small.submit(r) for r in small]
  batch_small.run_until_idle()
  want_all = [results[i] for i in closure_idx] + [f.result() for f in bfuts]
  for j, (got, want) in enumerate(zip(ares, want_all)):
    if not same_result(got, want):
      raise AssertionError(f"arena result {j} differs from batch 'pallas'")
  log(f"[arena] all {len(ares)} results equal batch mode on 'pallas' "
      f"(values and iterations); cache misses after prewarm: 0")

  # -- phase 4d: QoS serving on auto ------------------------------------------
  qos = phase_qos(sm, mk, graphs, api, np, torch, reqs, results)

  # -- phase 4e: operability around K1 and K2 ---------------------------------
  ops = phase_operability(sm, mk, api, reqs, results, closure_idx)

  # -- phase 5: timing at the main path's shapes ------------------------------
  cases = []
  x = adj_big
  cases.append(("minplus", x, x, x, None, "APSP 4096 squaring"))
  cases.append(("minplus", a_t[None], b_t[None], None,
                 torch.tensor([4096], dtype=torch.int32, device="cuda"),
                 "raw mmo 4096³"))
  reach_t = cl.prepare_adjacency(torch.from_numpy(reach_adj).cuda(),
                                 op="orand")[None].contiguous()
  cases.append(("orand", reach_t, reach_t, reach_t, None, "GTC 1024"))
  cases.append(("addnorm", q_t[None], r_t.T[None].contiguous(), None, None,
                "KNN 4096q x 16384"))
  rag = torch.from_numpy(np.stack([cl.pad_adjacency(
      np.asarray(r.arrays["adj"]), 256, op="minplus") for r in reqs[4:]])).cuda()
  rag_kv = torch.tensor([r.shape[0] for r in reqs[4:]], dtype=torch.int32,
                        device="cuda")
  cases.append(("minplus", rag, rag, rag, rag_kv, "ragged APSP 8x256"))
  cases.append(("mma", a_t[None], b_t[None], None, None,
                "mma 4096³ (library yardstick)"))
  rows_out = []
  for op, a, b, c, kv, label in cases:
    r, m, k = a.shape
    n = b.shape[-1]
    big = m * n * k >= 1 << 30
    ms = cuda_time_ms(lambda: sm.semiring_mmo(a, b, c, op=op, k_valid=kv),
                      3 if big else 20)
    plain_ms = cuda_time_ms(
        lambda: sm.semiring_mmo_plain(a, b, c, op=op, k_valid=kv),
        1 if big else 3)
    lib_ms = None
    if op == "mma":
      lib_ms = cuda_time_ms(lambda: torch.matmul(a, b), 3)
      # the split pass and the tensor-core tiles, apart
      parts = kernel_ms(torch, lambda: sm.semiring_mmo(a, b, c, op=op,
                                                        k_valid=kv), 3)
    k_live = int(kv.clamp(0, k).sum()) if kv is not None else r * k
    dtype = str(a.dtype).removeprefix("torch.")
    b_ms, b_by = bound_ms(op, dtype, r, m, k, n, k_live, c is not None)
    # the timed call's result against the plain version, at check()'s
    # tolerance for the ring (bit-exact for min/max and orand)
    err = check(f"{label} {op}", sm.semiring_mmo(a, b, c, op=op, k_valid=kv),
                sm.semiring_mmo_plain(a, b, c, op=op, k_valid=kv), op)
    row = {"case": label, "op": op, "shape": [r, m, k, n],
           "tile": list(sm.tile_shape(op, a.dtype, r, m, n)), "ms": ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "share_of_bound": b_ms / ms, "library_ms": lib_ms,
           "max_abs_err": err}
    if op == "orand":  # the CUDA-core route's own issue bound, for context
      row["cuda_core_bound_ms"] = hw.cuda_core_seconds(float(m) * n
                                                       * k_live) * 1e3
    if op == "mma":
      row["kernels_ms"] = parts
    rows_out.append(row)
    log(f"[time] {json.dumps(row)}")
  # K1's int32 and float16 minplus at the raw mmo's 4096³: int32 on its
  # own instance; float16 widened, on the f32 instance, rounded once (the
  # two elementwise passes are in the time, and apart in kernels_ms)
  k1_dtype_rows = []
  for dtype, a, b in (
      ("int32", (a_t * 100).round().to(torch.int32)[None],
       (b_t * 100).round().to(torch.int32)[None]),
      ("float16", a_t.half()[None], b_t.half()[None])):
    fn = (lambda: sm.semiring_mmo(a, b, op="minplus"))
    ms = cuda_time_ms(fn, 10)
    plain_ms = cuda_time_ms(
        lambda: sm.semiring_mmo_plain(a, b, op="minplus"), 1)
    err = check(f"raw mmo 4096³ minplus {dtype}", fn(),
                sm.semiring_mmo_plain(a, b, op="minplus"), "minplus")
    b_ms, b_by = bound_ms("minplus", dtype, 1, 4096, 4096, 4096, 4096,
                          False)
    row = {"case": f"raw mmo 4096³ {dtype}", "op": "minplus",
           "dtype": dtype, "shape": [1, 4096, 4096, 4096],
           "tile": list(sm.tile_shape("minplus", a.dtype, 1, 4096, 4096)),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "share_of_bound": b_ms / ms,
           "library_ms": None, "max_abs_err": err,
           "kernels_ms": kernel_ms(torch, fn, 3)}
    k1_dtype_rows.append(row)
    log(f"[time] {json.dumps(row)}")
  # K2 per chunk at the main path's shapes: the first chunk of each
  # closure bucket (g = 8, the fused arm's default), from the adjacency
  k2_rows = []
  k2_cases = [("minplus", adj_big, None, "APSP 4096 chunk"),
              ("orand", reach_t, None, "GTC 1024 chunk"),
              ("minplus", rag, rag_kv, "ragged APSP 8x256 chunk")]
  for op, x, kv, label in k2_cases:
    r, n = x.shape[0], x.shape[-1]
    kv = (torch.full((r,), n, dtype=torch.int32, device="cuda")
          if kv is None else kv)
    act = torch.ones(r, dtype=torch.int32, device="cuda")
    it0 = torch.zeros(r, dtype=torch.int32, device="cuda")
    glim = torch.full((r,), 8, dtype=torch.int32, device="cuda")
    args = (x, None, kv, act, it0, glim)
    got = mk.fixpoint_chunk(*args, op=op, g_steps=8)
    big = n >= 4096
    ms = cuda_time_ms(lambda: mk.fixpoint_chunk(*args, op=op, g_steps=8),
                      2 if big else 10)
    plain_ms = cuda_time_ms(
        lambda: mk.fixpoint_chunk_plain(*args, op=op, g_steps=8), 1)
    want = mk.fixpoint_chunk_plain(*args, op=op, g_steps=8)
    err = check_chunk(f"K2 {label}", got, want, op)
    steps = got[1].to(torch.int64)
    live_kv = int((steps * kv.clamp(0, n)).sum())
    b_ms, b_by = fixpoint_bound_ms(op, str(x.dtype).removeprefix("torch."),
                                   r, n, live_kv, False)
    row = {"case": label, "op": op, "shape": [r, n], "g": 8,
           "tile_all_live": list(mk.tile_shape(op, x.dtype, r, n)),
           "steps": got[1].tolist(), "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms,
           "library_ms": None, "max_abs_err": err}
    k2_rows.append(row)
    log(f"[time] K2 {json.dumps(row)}")
  # K2's int32 and float16 instances on the APSP-4096 chunk: float16 is the
  # adjacency rounded; int32 weights ×100, no edge 2²⁹ (no sum wraps)
  w_i = torch.from_numpy(np.where(np.isfinite(w_big), np.round(w_big * 100),
                                  2 ** 29).astype(np.int32)).cuda()
  w_i.fill_diagonal_(0)
  k2_dtype_rows = []
  for dtype, x in (("int32", w_i[None].contiguous()),
                   ("float16", adj_big.half())):
    r, n = 1, x.shape[-1]
    kv = torch.full((r,), n, dtype=torch.int32, device="cuda")
    act = torch.ones(r, dtype=torch.int32, device="cuda")
    it0 = torch.zeros(r, dtype=torch.int32, device="cuda")
    glim = torch.full((r,), 8, dtype=torch.int32, device="cuda")
    args = (x, None, kv, act, it0, glim)
    got = mk.fixpoint_chunk(*args, op="minplus", g_steps=8)
    ms = cuda_time_ms(lambda: mk.fixpoint_chunk(*args, op="minplus",
                                                g_steps=8), 2)
    plain_ms = cuda_time_ms(
        lambda: mk.fixpoint_chunk_plain(*args, op="minplus", g_steps=8), 1)
    want = mk.fixpoint_chunk_plain(*args, op="minplus", g_steps=8)
    err = check_chunk(f"K2 APSP 4096 chunk {dtype}", got, want, "minplus")
    live_kv = int((got[1].to(torch.int64) * n).sum())
    b_ms, b_by = fixpoint_bound_ms("minplus", dtype, r, n, live_kv, False)
    row = {"case": f"APSP 4096 chunk {dtype}", "op": "minplus",
           "dtype": dtype, "shape": [r, n], "g": 8,
           "tile_all_live": list(mk.tile_shape("minplus", x.dtype, r, n)),
           "steps": got[1].tolist(), "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms,
           "library_ms": None, "max_abs_err": err}
    k2_dtype_rows.append(row)
    log(f"[time] K2 {json.dumps(row)}")
  del w_i
  # the same fixpoints on both arms, host clock to the result: dispatch
  # (K1 + one sync per iteration) vs fused (K2 + one sync per chunk), in
  # turns, for APSP 4096 and the ragged 8x256 bucket
  arms = {"dispatch": dict(backend="pallas"),
          "fused": dict(fixpoint_backend="megakernel")}
  for label, x, kv in (("APSP 4096", adj_big, None),
                       ("ragged APSP 8x256", rag, rag_kv)):
    walls = {a: [] for a in arms}
    for arm in ("dispatch", "fused", "fused", "dispatch") * 2:
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      _, it_f = cl.batched_leyzorek_closure(x, op="minplus", valid_n=kv,
                                            **arms[arm])
      torch.cuda.synchronize()
      walls[arm].append((time.perf_counter() - t0) * 1e3)
    log(f"[time] {label} fixpoint (iterations {it_f.tolist()}), host clock "
        f"ms: dispatch {walls['dispatch']} fused {walls['fused']}")

  # -- phase 6: LM serving at full width, then K3 timing ----------------------
  lm = phase_lm_serving(fa, torch, card)
  k3 = phase_flash_timing(fa, torch, k3_err,
                          lm["launches"]["flash_attention"], k3_ptxas)

  # -- phase 7: SSM serving at full width, then K4 timing ---------------------
  gc.collect()  # the tinyllama engines and weights went out of scope
  torch.cuda.empty_cache()
  log(f"[ssm] device memory allocated before the SSM phase: "
      f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB")
  ssm_run = phase_ssm_serving(ssd, torch, card)
  gc.collect()
  torch.cuda.empty_cache()
  k4 = phase_ssd_timing(ssd, torch, k4_err,
                        ssm_run["launches"]["ssd_intra_chunk"])

  # -- phase 8: the rest of the applications ----------------------------------
  gc.collect()
  torch.cuda.empty_cache()
  apps = phase_apps(sm, mk, torch, np)

  # -- phase 9: sharded serving on a virtual mesh of one card -----------------
  gc.collect()
  torch.cuda.empty_cache()
  mesh = phase_mesh(sm, mk, torch, np, graphs, reqs, results, a_t, b_t, q_t,
                    r_t)

  # -- phase 10: LM training on the card --------------------------------------
  del a_t, b_t, q_t, r_t
  gc.collect()
  torch.cuda.empty_cache()
  train = phase_training(torch, card, (sm.semiring_mmo, mk.fixpoint_chunk,
                                       fa.flash_attention,
                                       ssd.ssd_intra_chunk))
  log(f"[summary] analysis {json.dumps(analysis)}; training "
      f"step ms {train['tinyllama']['step_ms_median']!r} (tinyllama-1.1b), "
      f"{train['mamba2']['step_ms_median']!r} (mamba2-780m, "
      f"{SSM_TRAIN_LAYERS} layers), {train['mixtral']['step_ms_median']!r} "
      f"(mixtral-8x7b, {MOE_TRAIN_LAYERS} layers), "
      f"{train['zamba2']['step_ms_median']!r} (zamba2-7b, "
      f"{HYBRID_TRAIN_LAYERS} layers) {card}")

  # -- phase 11: MoE serving ---------------------------------------------------
  gc.collect()
  torch.cuda.empty_cache()
  moe_run = phase_moe_serving(fa, torch, card)

  # -- phase 12: hybrid serving ------------------------------------------------
  gc.collect()
  torch.cuda.empty_cache()
  hyb = phase_hybrid_serving(fa, ssd, torch, card)
  k3_paths = {"tinyllama-1.1b": k3["launches"],
              **{arch: moe_run[arch]["launches"]["flash_attention"]
                 for arch, _ in MOE_SERVED},
              HYBRID_ARCH: hyb["launches"]["flash_attention"]}
  k4_paths = {SSM_ARCH: k4["launches"],
              HYBRID_ARCH: hyb["launches"]["ssd_intra_chunk"]}

  # -- phase 13: enc-dec serving -----------------------------------------------
  gc.collect()
  torch.cuda.empty_cache()
  encdec_run = phase_encdec_serving(fa, torch, card)

  # -- phase 14: VLM serving ---------------------------------------------------
  gc.collect()
  torch.cuda.empty_cache()
  vlm_run = phase_vlm_serving(sm, fa, torch, card)

  # -- phase 15: the pipeline schedule -----------------------------------------
  gc.collect()
  torch.cuda.empty_cache()
  pipe = phase_pipeline(torch, card)
  k3_paths[ENCDEC_ARCH] = encdec_run["launches"]["flash_attention"]
  k3_paths[VLM_ARCH] = vlm_run["launches"]["flash_attention"]
  served = {arch: moe_run[arch] for arch, _ in MOE_SERVED}
  served[HYBRID_ARCH] = hyb
  served[ENCDEC_ARCH] = encdec_run
  served[VLM_ARCH] = vlm_run
  log(f"[summary] phases 11-15 {card}: " + "; ".join(
      f"{arch} prefill {r['prefill_ms']!r} ms, decode "
      f"{r['decode_ms_per_token']!r} ms/token, peak "
      f"{r['max_memory_allocated_gib']!r} GiB" for arch, r in served.items())
      + f"; pipeline {pipe['ms']!r} ms per call against "
      f"{pipe['sequential_ms']!r} sequential (bubble fraction "
      f"{pipe['bubble_fraction']!r}); phase 11 {moe_run['s']:.1f}s, phase "
      f"12 {hyb['s']:.1f}s, phase 13 {encdec_run['s']:.1f}s, phase 14 "
      f"{vlm_run['s']:.1f}s, phase 15 {pipe['s']:.1f}s")

  # -- phase 16: the dry run and its APSP anchor --------------------------------
  gc.collect()
  torch.cuda.empty_cache()
  dry = phase_dryrun(sm, torch, card, lm, train)

  head = rows_out[0]
  k2 = k2_rows[0]
  record = {"kernels": [{
      "name": "semiring_mmo", "design": K1_DESIGN, "route": "cuda",
      "source": "src/repro_torch/kernels/csrc/semiring_mmo.cu",
      "replaces": "src/repro/kernels/semiring_mmo.py:147",
      "launches": launches + qos["k1"] + ops["k1"] + apps["k1"]
                  + mesh["k1"] + vlm_run["launches"]["semiring_mmo"]
                  + dry["apsp"]["launches"],
      "max_abs_err": big_err,
      "ms": head["ms"],
      "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
      "bound_by": head["bound_by"], "library_ms": head["library_ms"],
      "instances": [dtype_instance(row) for row in k1_dtype_rows]
                   + [served_instance(vlm_run["k1_row"]),
                      served_instance(dry["apsp"])]}, {
      "name": "closure_megakernel", "design": K2_DESIGN, "route": "cuda",
      "source": "src/repro_torch/kernels/csrc/closure_megakernel.cu",
      "replaces": "src/repro/kernels/closure_megakernel.py:164",
      "launches": (k2_batch + k2_arena + qos["k2"] + ops["k2"] + apps["k2"]
                   + mesh["k2"]),
      "max_abs_err": k2_err,
      "ms": k2["ms"], "plain_ms": k2["plain_ms"],
      "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
      "library_ms": None,
      "instances": [dtype_instance(row) for row in k2_dtype_rows]}, {
      "name": "flash_attention_wgmma", "design": K3_DESIGN, "route": "cuda",
      "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
      "replaces": "src/repro/kernels/flash_attention.py:107",
      "launches": sum(k3_paths.values()), "launches_by_path": k3_paths,
      "max_abs_err": k3["max_abs_err"],
      "ms": k3["ms"], "plain_ms": k3["plain_ms"],
      "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
      "library_ms": k3["library_ms"],
      "instances": [served_instance(row) for row in (
          moe_run["k3_row"], hyb["k3_row"], *encdec_run["k3_rows"],
          vlm_run["k3_row"])]}, {
      "name": "ssd_intra_chunk", "design": K4_DESIGN, "route": "cuda",
      "source": "src/repro_torch/kernels/csrc/ssd.cu",
      "replaces": "src/repro/kernels/ssd.py:54",
      "launches": sum(k4_paths.values()), "launches_by_path": k4_paths,
      "max_abs_err": k4["max_abs_err"],
      "ms": k4["ms"], "plain_ms": k4["plain_ms"],
      "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
      "library_ms": None,
      "instances": [served_instance(hyb["k4_row"])]}]}
  log(json.dumps(record))
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
