#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

  1. device and card — needs CUDA; prints the nvidia-smi name/power line;
  2. build — compiles the SIMD² unit kernel (K1) from the checkout's source;
  3. kernel vs its plain PyTorch version on the card — all nine rings at
     three shapes, a batched ragged k_valid case, bf16, and one 4096³
     minplus step C ⊕ C⊗C;
  4. main path — ``MMOEngine(backend="pallas", max_batch=8)`` serves a
     mixed stream sized from the paper's Table 4 "small" column (APSP 4096,
     reachability 1024, KNN 4096 queries × 16384×16 corpus, a 4096³ minplus
     mmo, and a ragged bucket of 8 APSP requests with n in 200–256), with
     the kernel's launch counter reset just before and read just after;
     every result is then held against the plain path on the card;
  5. timing — the kernel, its plain version and (for mma) torch.matmul at
     the main path's shapes, with each shape's bound on this card.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the per-kernel JSON record.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense): CUDA-core FP32, bf16
# and int8 tensor rates, HBM3 bandwidth.  Rates assume a 700 W power limit.
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "bool": 1979e12}
PEAK_BYTES_S = 3.35e12
MIN_MAX_RINGS = ("minplus", "maxplus", "minmul", "maxmul", "minmax", "maxmin")
TOL = {"rtol": 1e-5, "atol": 1e-4}   # mma / addnorm: summation order differs
BF16_TOL = {"rtol": 3e-2, "atol": 3e-2}  # the reference's own bf16 tolerance


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
  """Kernel vs plain: bit-exact for the min/max rings and orand in f32, the
  stated tolerance for mma/addnorm and for bf16."""
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
  """Least time for R requests of D = C ⊕ (A ⊗ B): 2·M·N·ΣK_live ring
  operations at the card's peak for the input type, or each operand read
  once and D written once at HBM bandwidth — whichever is larger."""
  isz = {"float32": 4, "bfloat16": 2, "bool": 1}[dtype]
  osz = 1 if dtype == "bool" else (4 if op in ("mma", "addnorm") else isz)
  nbytes = r * (m * k + k * n) * isz + r * m * n * osz * (2 if has_c else 1)
  t_ops = 2.0 * m * n * k_live_total / PEAK_OPS[dtype]
  t_bytes = nbytes / PEAK_BYTES_S
  return (max(t_ops, t_bytes) * 1e3,
          "operations" if t_ops >= t_bytes else "bytes")


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
  torch.cuda.synchronize()


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
  log(card)
  log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
      f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
  # full-precision f32 for every torch.matmul yardstick and rewrite
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False

  from repro_torch.apps import graphs
  from repro_torch.apps.solvers import smallest_k
  from repro_torch.core import closure as cl
  from repro_torch.kernels import semiring_mmo as sm
  from repro_torch.serve_mmo import (MMOEngine, apsp_request, knn_request,
                                     mmo_request, reachability_request)

  # -- phase 2: build ---------------------------------------------------------
  t0 = time.perf_counter()
  sm.build_library()
  sm.load()
  log(f"[build] {sm.library_path().name} in {time.perf_counter() - t0:.1f}s")
  regs = sorted({line.split("Used")[1].split(",")[0].strip()
                 for line in sm.build_log().splitlines() if "Used" in line})
  log(f"[build] ptxas: {regs}")

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
  engine.start()
  try:
    t0 = time.perf_counter()
    futs = [engine.submit(r) for r in reqs]
    results = [f.result(timeout=900) for f in futs]
    wall = time.perf_counter() - t0
  finally:
    engine.stop()
  launches = sm.semiring_mmo.launches
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
    k_live = int(kv.clamp(0, k).sum()) if kv is not None else r * k
    b_ms, b_by = bound_ms(op, str(a.dtype).removeprefix("torch."), r, m, k,
                          n, k_live, c is not None)
    err = max_abs_err(sm.semiring_mmo(a, b, c, op=op, k_valid=kv),
                      sm.semiring_mmo_plain(a, b, c, op=op, k_valid=kv))
    row = {"case": label, "op": op, "shape": [r, m, k, n], "ms": ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": lib_ms, "max_abs_err": err}
    rows_out.append(row)
    log(f"[time] {json.dumps(row)}")
  head = rows_out[0]
  record = {"kernels": [{
      "name": "semiring_mmo", "route": "cuda",
      "source": "src/repro_torch/kernels/csrc/semiring_mmo.cu",
      "replaces": "src/repro/kernels/semiring_mmo.py:147",
      "launches": launches, "max_abs_err": big_err, "ms": head["ms"],
      "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
      "bound_by": head["bound_by"], "library_ms": head["library_ms"]}]}
  log(json.dumps(record))
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
