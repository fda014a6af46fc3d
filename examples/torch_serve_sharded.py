"""Sharded serving on the PyTorch/CUDA port — one engine, small buckets
local, big buckets on a mesh.

    PYTHONPATH=src python examples/torch_serve_sharded.py [--device cpu]

Counterpart of ``examples/serve_sharded.py``, which fakes 8 host devices
through XLA_FLAGS.  The port's mesh is single-controller
(``launch.mesh.Mesh``): ``--shards 8`` (the default) makes a virtual mesh
of eight shards of ``--device``, laid out (data=2, model=4) as the
reference's.  The engine routes each shape bucket by contraction size:
APSP requests below the ``shard_flops`` cutoff execute on one device, the
big ones run their closure as a batched SUMMA squaring schedule across
all the shards — same request API, same results, one scheduler.  Each
check prints ``<label>: True`` or ``False``; the script exits 1 if any is
False.
"""
import argparse
import sys

import numpy as np

from repro_torch.apps import solvers
from repro_torch.apps import graphs
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve_mmo import MMOEngine, apsp_request


def main(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("--device", default="cuda")
  ap.add_argument("--shards", type=int, default=8,
                  help="shards of --device in the virtual mesh (default 8)")
  args = ap.parse_args(argv)
  dev = resolve_device(args.device)
  n_dev = args.shards
  dims = (2, 4) if n_dev >= 8 else (1, n_dev)
  mesh = make_host_mesh(dims[0] * dims[1], model=dims[1],
                        devices=[dev] * n_dev)
  print(f"mesh: data={dims[0]} × model={dims[1]} on {n_dev} shards of "
        f"{dev}")
  checks = []

  # 2·16³ ≈ 8e3 flops stays local; 2·64³ ≈ 5e5 crosses the 1e5 cutoff
  eng = MMOEngine(backend="xla", mesh=mesh, schedule="summa",
                  shard_flops=1e5, max_batch=4, device=dev)

  small = {n: graphs.weighted_digraph(n, 0.3, seed=n) for n in (9, 12, 14)}
  big = {n: graphs.weighted_digraph(n, 0.25, seed=n) for n in (49, 55, 62)}
  futs = {n: eng.submit(apsp_request(w)) for n, w in {**small, **big}.items()}
  eng.run_until_idle()

  placement = {k.shape[0]: s for k, s in eng._schedules.items()}
  for n, w in sorted({**small, **big}.items()):
    res = futs[n].result()
    ref, _ = solvers.apsp(w, device=dev)
    ok = bool(np.allclose(res.value, ref.cpu().numpy(), atol=1e-5))
    bucket = 1 << (n - 1).bit_length()
    print(f"apsp n={n:>2} → bucket {bucket:>3} [{placement[bucket]:>6}]  "
          f"closed in {res.extras['iterations']} iterations, matches "
          f"solver: {ok}")
    checks.append(ok)
  ok = placement[64] == "summa" and placement[16] != "summa"
  print("big buckets on the mesh, small ones local:", ok)
  checks.append(ok)

  # steady state: repeat traffic replays cached executables on both paths
  misses = eng.cache.misses
  futs2 = [eng.submit(apsp_request(w)) for w in {**small, **big}.values()]
  eng.run_until_idle()
  new = eng.cache.misses - misses
  print(f"repeat traffic: {new} new compiles "
        f"(sharded + local executables cached independently)")
  ok = all(f.done() for f in futs2) and new == 0
  print("repeat traffic served from the cache:", ok)
  checks.append(ok)
  print(eng.stats().summary())
  print(f"[checks] {sum(checks)} of {len(checks)} passed")
  return 0 if all(checks) else 1


if __name__ == "__main__":
  sys.exit(main())
