"""Adaptive QoS on the PyTorch/CUDA port — live-latency feedback correcting
static predictions.

    PYTHONPATH=src python examples/torch_serve_adaptive.py [--device cpu]

Counterpart of ``examples/serve_adaptive.py``.  The cost table (or its
roofline prior) answers "what should this bucket cost" for an idealized
card; the machine actually serving traffic answers differently.  This
example shows the drift and the fix:

  1. a static engine prices a bulk closure bucket off the roofline prior
     while the measured batch takes longer, so its service-time batch cap
     (``max_batch_seconds``) may never bind and urgent arrivals wait behind
     full bulk batches;
  2. an adaptive engine serves the same mix: after a few batches its EWMA
     estimator has learned the real per-request latency (and the measured
     convergence counts of the closure traffic), the cap binds, bulk
     batches stay short, and the urgent slice's latency collapses.

Each check prints ``<label>: True`` or ``False``; the script exits 1 if
any is False.
"""
import argparse
import sys

import numpy as np

from repro_torch.apps import graphs
from repro_torch.device import resolve_device
from repro_torch.serve_mmo import MMOEngine, apsp_request, mmo_request
from repro_torch.serve_mmo.scheduler import request_bucket

RNG = np.random.default_rng(0)
BULK_N = 72           # pads to the 128 closure bucket — compute-dominated
CAP_S = 0.025         # ~one measured bulk request of work per batch


def bulk_req(seed, n=BULK_N):
  return apsp_request(graphs.weighted_digraph(n, 0.3, seed=seed),
                      tenant="bulk")


def urgent_req():
  a = RNG.standard_normal((12, 12)).astype(np.float32)
  b = RNG.standard_normal((12, 12)).astype(np.float32)
  return mmo_request(a, b, op="minplus", tenant="interactive",
                     deadline_s=30.0, priority=1)


def serve(adaptive: bool, dev, bulk_n: int = BULK_N) -> bool:
  eng = MMOEngine(backend="xla", max_batch=8, policy="deadline",
                  adaptive=adaptive, max_batch_seconds=CAP_S,
                  deadline_lookback_s=60.0, device=dev)
  eng.prewarm([bulk_req(0, bulk_n), urgent_req()])

  # warm the feedback loop: the estimator needs a few observed batches
  # before it overrides the static prior (min_observations)
  for wave in range(4):
    eng.submit(bulk_req(100 + wave, bulk_n))
    eng.submit(urgent_req())
    eng.run_until_idle()
  eng.reset_stats()

  key = request_bucket(bulk_req(0, bulk_n))
  est = eng.predict_request(key)
  print(f"\n--- adaptive={adaptive} ---")
  print(f"bulk prediction: {est.seconds * 1e3:.3f} ms/request "
        f"(source: {est.source})")

  # a bulk flood with urgent requests interleaved — synchronous stepping so
  # the batch sizes are easy to see
  futs = [eng.submit(bulk_req(i, bulk_n)) for i in range(12)]
  urgent = []
  for _ in range(4):
    eng.step()
    urgent.append(eng.submit(urgent_req()))
  eng.run_until_idle()
  done = all(f.state == "done" for f in futs + urgent)

  recs = {r.request_id: r for r in eng._records}
  bulk_batches = [recs[f.request.request_id].batch_size for f in futs]
  lat = [recs[f.request.request_id].latency_s * 1e3 for f in urgent]
  print(f"bulk batch sizes under the {CAP_S * 1e3:.0f}ms cap: "
        f"mean={np.mean(bulk_batches):.2f}")
  print(f"urgent latency: p50={np.percentile(lat, 50):.1f}ms "
        f"max={max(lat):.1f}ms")
  snap = eng.metrics_snapshot()["estimator"]
  for label, cell in snap["cells"].items():
    print(f"estimator {label}: {cell['seconds'] * 1e3:.3f} ms/request "
          f"({cell['observations']} batches)")
  for label, cell in snap["iterations"].items():
    print(f"measured convergence {label}: {cell['iterations']:.1f} "
          f"iterations (worst case would be charged 7)")
  print(f"adaptive={adaptive}: every request served:", done)
  return done


def main(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("--device", default="cuda")
  ap.add_argument("--bulk-n", type=int, default=BULK_N,
                  help="vertices of a bulk APSP request (default 72)")
  args = ap.parse_args(argv)
  dev = resolve_device(args.device)
  checks = [serve(adaptive, dev, args.bulk_n) for adaptive in (False, True)]
  print(f"[checks] {sum(checks)} of {len(checks)} passed")
  return 0 if all(checks) else 1


if __name__ == "__main__":
  sys.exit(main())
