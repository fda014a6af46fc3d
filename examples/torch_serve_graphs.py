"""Serving SIMD² graph workloads on the PyTorch/CUDA port — request API
quickstart.

    PYTHONPATH=src python examples/torch_serve_graphs.py [--device cpu]

Counterpart of ``examples/serve_graphs.py``.  Submits a mixed stream of
the paper's applications (APSP, KNN, transitive closure, a raw min-plus
mmo) to the MMO serving engine and cross-checks each result against the
direct library solver.  Shows the three ways to consume results:
run_until_idle + future.result(), lazy future-driven execution, and the
background serving loop.  Each check prints ``<label>: True`` or
``False``; the script exits 1 if any is False.
"""
import argparse
import sys

import numpy as np

from repro_torch.apps import baselines, graphs, solvers
from repro_torch.device import resolve_device
from repro_torch.serve_mmo import (MMOEngine, apsp_request, knn_request,
                                   mmo_request, reachability_request)


def main(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("--device", default="cuda")
  args = ap.parse_args(argv)
  dev = resolve_device(args.device)
  eng = MMOEngine(backend="xla", max_batch=8, device=dev)
  checks = []

  # -- 1. batch submit + drain ----------------------------------------------
  weights = [graphs.weighted_digraph(n, 0.3, seed=n) for n in (10, 14, 16, 21)]
  futs = [eng.submit(apsp_request(w)) for w in weights]
  eng.run_until_idle()
  for w, f in zip(weights, futs):
    res = f.result()
    ref, _ = solvers.apsp(w, device=dev)
    ok = bool(np.allclose(res.value, ref.cpu().numpy(), atol=1e-5))
    print(f"apsp n={w.shape[0]:>2}  closed in {res.extras['iterations']} "
          f"mmo iterations, matches the direct solver: {ok}")
    checks.append(ok)

  # -- 2. lazy execution: result() drives the engine ------------------------
  ref_pts, qry_pts = graphs.knn_points(64, 9, 8, seed=1)
  fut = eng.submit(knn_request(qry_pts, ref_pts, k=5))
  idx = fut.result().extras["indices"]
  print("knn top-1 indices:", idx[:, 0])
  _, want = baselines.knn_np(ref_pts, qry_pts, 5)
  ok = bool(np.array_equal(idx[:, 0], want[:, 0]))
  print("knn top-1 matches brute force:", ok)
  checks.append(ok)

  adj = graphs.boolean_digraph(12, 0.12, seed=2)
  fut = eng.submit(reachability_request(adj))
  reach = fut.result().value
  print(f"reachability: {int(reach.sum())}/{reach.size} pairs connected")
  ok = bool(np.array_equal(reach.astype(bool),
                           baselines.gtc_np(adj).astype(bool)))
  print("reachability matches the closure baseline:", ok)
  checks.append(ok)

  # -- 3. background serving loop + raw mmo instructions --------------------
  eng.start()
  rng = np.random.default_rng(0)
  a = rng.standard_normal((9, 17)).astype(np.float32)
  b = rng.standard_normal((17, 11)).astype(np.float32)
  fut = eng.submit(mmo_request(a, b, op="minplus"))
  d = fut.result(timeout=60).value
  print(f"raw minplus mmo: {a.shape} ⊗ {b.shape} → {d.shape}")
  ok = bool(np.array_equal(d, (a[:, :, None] + b[None]).min(axis=1)))
  print("raw minplus mmo matches numpy:", ok)
  checks.append(ok)
  eng.stop()

  print(eng.stats().summary())
  print(f"[checks] {sum(checks)} of {len(checks)} passed")
  return 0 if all(checks) else 1


if __name__ == "__main__":
  sys.exit(main())
