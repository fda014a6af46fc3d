"""QoS serving on the PyTorch/CUDA port — deadlines, priorities, tenants,
admission, live metrics.

    PYTHONPATH=src python examples/torch_serve_qos.py [--device cpu]

Counterpart of ``examples/serve_qos.py``.  A bulk tenant floods the engine
with big closure problems while an interactive tenant submits small
deadline-tagged lookups.  The deadline policy serves the interactive slice
first (earliest feasible deadline, priority tiers), admission bounds what
the bulk tenant may queue, and a mid-run metrics snapshot shows rolling
p50/p99 without stopping the loop.  Each check prints ``<label>: True`` or
``False``; the script exits 1 if any is False.
"""
import argparse
import json
import sys

import numpy as np

from repro_torch.apps import graphs
from repro_torch.device import resolve_device
from repro_torch.serve_mmo import (MMOEngine, RejectedError, apsp_request,
                                   mmo_request)


def main(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("--device", default="cuda")
  args = ap.parse_args(argv)
  dev = resolve_device(args.device)
  checks = []
  eng = MMOEngine(backend="xla", max_batch=4, policy="deadline",
                  max_queue=64, tenant_quota={"bulk": 12}, device=dev)
  eng.prewarm([apsp_request(graphs.weighted_digraph(40, 0.3, seed=0)),
               mmo_request(np.zeros((12, 12), np.float32),
                           np.zeros((12, 12), np.float32), op="minplus")])

  # -- bulk tenant: 20 offered, quota admits 12 ------------------------------
  bulk = [eng.submit(apsp_request(graphs.weighted_digraph(40, 0.3, seed=i),
                                  tenant="bulk"))
          for i in range(20)]
  over_quota = [f for f in bulk if f.state == "rejected"]
  print(f"bulk: offered {len(bulk)}, admitted {len(bulk) - len(over_quota)}, "
        f"{len(over_quota)} rejected by the tenant quota")
  ok = len(over_quota) == 8
  print("the quota admits 12 of 20:", ok)
  checks.append(ok)

  # -- interactive tenant: deadline-tagged, jumps the bulk queue -------------
  rng = np.random.default_rng(0)
  urgent = [eng.submit(mmo_request(
      rng.standard_normal((12, 12)).astype(np.float32),
      rng.standard_normal((12, 12)).astype(np.float32),
      op="minplus", tenant="interactive", deadline_s=30.0, priority=1))
      for _ in range(6)]

  eng.start()
  for f in urgent:  # resolve while bulk work is still queued behind them
    f.result(timeout=120)
  snap = eng.metrics_snapshot()  # live: the loop is still serving bulk
  print(f"mid-run metrics: queue_depth={snap['queue_depth']} "
        f"counters={snap['counters']}")
  eng.stop()

  raised = False
  for f in over_quota:
    try:
      f.result()
    except RejectedError as e:
      print(f"rejected future raises at result(): {e}")
      raised = True
      break
  print("a rejected future raises RejectedError:", raised)
  checks.append(raised)

  recs = {r.request_id: r for r in eng._records}
  lat = [recs[f.request.request_id].latency_s * 1e3 for f in urgent]
  print(f"interactive latency under bulk flood: "
        f"p50={np.percentile(lat, 50):.1f}ms max={max(lat):.1f}ms")
  ok = all(f.state == "done" for f in urgent)
  print("every interactive request served:", ok)
  checks.append(ok)
  print(eng.stats().summary())
  print(json.dumps(eng.metrics_snapshot()["buckets"], indent=2,
                   default=float))
  print(f"[checks] {sum(checks)} of {len(checks)} passed")
  return 0 if all(checks) else 1


if __name__ == "__main__":
  sys.exit(main())
