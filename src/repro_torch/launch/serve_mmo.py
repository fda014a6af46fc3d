"""Open-loop load generator for semiring workloads → MMO engine.

    PYTHONPATH=src python -m repro_torch.launch.serve_mmo --rate 40 \
        --duration 3 --backend pallas --max-batch 8

Counterpart of ``repro/launch/serve_mmo.py`` for the port's batch-mode
engine.  Generates a Poisson arrival stream of mixed SIMD² problems (APSP,
KNN, reachability, raw minplus mmo at several sizes), submits each request
at its arrival time against the engine's background serving loop, and
reports throughput (problems/s), latency percentiles and executable-cache
behaviour.  Open-loop means arrivals do not wait for completions.  Runs on
the card (``--device cuda``, the default) unless told otherwise.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.apps import graphs
from repro_torch.serve_mmo import (DeadlineExceededError, MMOEngine,
                                   RejectedError, apsp_request, knn_request,
                                   mmo_request, reachability_request)
from repro_torch.serve_mmo.engine import ENGINE_BACKENDS

TENANTS = ("alpha", "beta", "gamma")


def synthesize_request(rng: np.random.Generator, sizes):
  """One random problem from the mixed APSP/KNN/reachability/mmo workload
  (the reference's draw order, so one seed gives both packages the same
  stream)."""
  kind = rng.choice(("apsp", "knn", "reach", "mmo"))
  n = int(rng.choice(sizes))
  seed = int(rng.integers(0, 2 ** 31))
  qos = {"tenant": TENANTS[int(rng.integers(0, len(TENANTS)))]}
  if kind == "apsp":
    return apsp_request(graphs.weighted_digraph(n, 0.3, seed=seed), **qos)
  if kind == "reach":
    return reachability_request(graphs.boolean_digraph(n, 0.1, seed=seed),
                                **qos)
  if kind == "knn":
    ref, qry = graphs.knn_points(4 * n, n, 16, seed=seed)
    return knn_request(qry, ref, k=min(8, 4 * n), **qos)
  a = rng.standard_normal((n, n)).astype(np.float32)
  b = rng.standard_normal((n, n)).astype(np.float32)
  return mmo_request(a, b, op="minplus", **qos)


def warmup(engine: MMOEngine, rng: np.random.Generator, sizes, n: int = 40):
  """Build the bucket executables so the measured run is steady-state.

  A sample of the synthetic workload discovers the buckets; ``prewarm``
  then builds every (bucket, batch) variant those buckets can produce.
  """
  engine.prewarm([synthesize_request(rng, sizes) for _ in range(n)])
  engine.reset_stats()


def main(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("--rate", type=float, default=40.0,
                  help="mean arrival rate (problems/s)")
  ap.add_argument("--duration", type=float, default=3.0,
                  help="traffic window (s)")
  ap.add_argument("--backend", default="pallas", choices=ENGINE_BACKENDS)
  ap.add_argument("--max-batch", type=int, default=8)
  ap.add_argument("--min-bucket", type=int, default=8)
  ap.add_argument("--sizes", default="12,24,48",
                  help="comma-separated problem sizes")
  ap.add_argument("--seed", type=int, default=0)
  ap.add_argument("--no-warmup", action="store_true")
  ap.add_argument("--device", default="cuda",
                  help="torch device to serve on (default cuda; fails "
                       "without a card)")
  args = ap.parse_args(argv)

  try:
    sizes = tuple(int(s) for s in args.sizes.split(","))
    if not sizes or any(s <= 0 for s in sizes):
      raise ValueError
  except ValueError:
    ap.error(f"--sizes must be comma-separated positive ints, got "
             f"{args.sizes!r}")
  rng = np.random.default_rng(args.seed)

  engine = MMOEngine(backend=args.backend, max_batch=args.max_batch,
                     min_bucket=args.min_bucket, device=args.device)

  if not args.no_warmup:
    t0 = time.perf_counter()
    warmup(engine, rng, sizes)
    print(f"[serve_mmo] warmup: {engine.cache.stats()} "
          f"({time.perf_counter() - t0:.2f}s)")

  # Poisson arrivals, materialized up front so generation cost is not on the
  # serving path.
  arrivals = np.cumsum(rng.exponential(1.0 / args.rate,
                                       int(args.rate * args.duration)))
  reqs = [synthesize_request(rng, sizes) for _ in arrivals]
  misses_before = engine.cache.misses

  engine.start()
  t0 = time.perf_counter()
  futures = []
  try:
    for t_arr, req in zip(arrivals, reqs):
      now = time.perf_counter() - t0
      if t_arr > now:
        time.sleep(t_arr - now)
      futures.append(engine.submit(req))
    outcomes = {"done": 0, "rejected": 0, "expired": 0, "failed": 0}
    for f in futures:
      try:
        f.result(timeout=600)
        outcomes["done"] += 1
      except RejectedError:
        outcomes["rejected"] += 1
      except DeadlineExceededError:
        outcomes["expired"] += 1
      except Exception:  # noqa: BLE001 — tally, keep draining
        outcomes["failed"] += 1
    wall = time.perf_counter() - t0
  finally:
    engine.stop()

  st = engine.stats()
  misses_during = engine.cache.misses - misses_before
  print(f"[serve_mmo] backend={args.backend} device={engine.device} "
        f"rate={args.rate}/s duration={args.duration}s "
        f"offered={len(futures)}")
  print(f"[serve_mmo] served {st.completed} problems in {wall:.2f}s "
        f"({st.completed / wall:.1f} problems/s) outcomes={outcomes}")
  if st.completed:
    print(f"[serve_mmo] latency p50={st.percentile(50) * 1e3:.1f}ms "
          f"p90={st.percentile(90) * 1e3:.1f}ms "
          f"p99={st.percentile(99) * 1e3:.1f}ms")
  print(f"[serve_mmo] batches={st.batches} mean_batch={st.mean_batch:.2f} "
        f"cache={st.cache}")
  if not args.no_warmup and misses_during:
    print(f"[serve_mmo] WARNING: {misses_during} builds during the measured "
          f"window (cold buckets)")
  return 0 if outcomes["failed"] == 0 else 1


if __name__ == "__main__":
  sys.exit(main())
