"""The control of the comparison: the plain reference, put in the program's
place and computed one precision below the configuration's.

    python3 bench/control.py --workload apsp-bulk --seeds 1,2,3 --seconds 20

Each configuration states float32, so the control computes in bfloat16
(float32's nearest lower precision outside the tensor cores; the program
has no bfloat16 path a numpy request can reach).  It replaces the batch
function every bucket of the engine runs (``batching.make_batch_fn``), so
the whole run — clients, engine, padding, unpadding, the check — is the
benchmark's own, and only the arithmetic is the control's.  Every seed
must come out not correct: a run prints each number compared, and the
smallest of them over the seeds is the upper reading a limit is set below.
The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
  if str(p) not in sys.path:
    sys.path.insert(0, str(p))


def control_batch_fn(key, dtype):
  """The batch function of one bucket, computed by the reference in
  ``dtype``."""
  import torch

  from bench.reference import closure as ref_closure
  from bench.reference import knn as ref_knn

  if key.kind == "closure":

    def fn(adj, valid):
      r, nb = adj.shape[0], adj.shape[-1]
      out = torch.empty((r, nb, nb), dtype=torch.float32, device=adj.device)
      iters = torch.empty((r,), dtype=torch.int32)
      for i in range(r):
        n = int(valid[i])
        closed, _, run = ref_closure.closure(adj[i, :n, :n].to(dtype),
                                             key.op)
        out[i, :n, :n] = closed.to(torch.float32)
        iters[i] = run
      return out, iters.to(adj.device)

    return fn
  if key.kind == "knn":
    (k,) = key.params

    def fn(q, ref, valid):
      vals, idx = [], []
      for i in range(q.shape[0]):
        d = ref_knn.distances(q[i], ref[i, :int(valid[i])], dtype=dtype)
        v, j = ref_knn.smallest(d, k)
        vals.append(v.to(torch.float32))
        idx.append(j.to(torch.int32))
      return torch.stack(vals), torch.stack(idx)

    return fn
  raise ValueError(f"no control for bucket kind {key.kind!r}")


@contextlib.contextmanager
def installed(dtype=None):
  """Within the block, every batch function the engine builds is the
  control's."""
  import torch

  from repro_torch.serve_mmo import batching
  dtype = torch.bfloat16 if dtype is None else dtype
  orig = batching.make_batch_fn

  def make(key, **kw):
    return control_batch_fn(key, dtype)

  batching.make_batch_fn = make
  try:
    yield
  finally:
    batching.make_batch_fn = orig


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seeds", required=True, help="comma-separated seeds")
  ap.add_argument("--seconds", type=float, required=True)
  args = ap.parse_args(argv)
  import torch

  from bench.lib import cell as cell_mod
  from bench.lib import spec
  if not torch.cuda.is_available():
    print("the control runs on the card", file=sys.stderr)
    return 2
  cell = spec.load_cell(args.workload)
  readings = []
  with installed():
    for seed in (int(s) for s in args.seeds.split(",")):
      res = cell_mod.run_cell(cell, seed=seed, seconds=args.seconds,
                              trace=False)
      line = {"seed": seed, "correct": res["correct"],
              "attempted": res["attempted"], "checks": res["checks"]}
      print(json.dumps(line), flush=True)
      readings.append(line)
  print(json.dumps({"control_correct_on_any_seed":
                    any(r["correct"] for r in readings)}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
