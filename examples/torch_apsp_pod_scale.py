"""Distributed APSP on the PyTorch/CUDA port: the paper's flagship
application at (simulated) pod scale — the min-plus closure runs
2-D-sharded across a device mesh with SUMMA semiring matmuls
(``core/distributed.py``).

    PYTHONPATH=src python examples/torch_apsp_pod_scale.py  # the devices
    PYTHONPATH=src python examples/torch_apsp_pod_scale.py --shards 16

Counterpart of ``examples/apsp_pod_scale.py``, which counts host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=16`` for 16).  Here
``--shards N`` makes a virtual mesh of N shards of ``--device``; without
it the mesh has one shard per device of that type present.  The mesh
shape is the reference's: model 4 when N divides by 4, data N // model.
Each check prints ``<label>: True`` or ``False``; the script exits 1 if
any is False.
"""
import argparse
import sys

import numpy as np
import torch


def main(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("--device", default="cuda")
  ap.add_argument("--shards", type=int, default=0,
                  help="shards of --device in a virtual mesh (default: one "
                       "per device present)")
  ap.add_argument("--n", type=int, default=512,
                  help="vertices of the graph (default 512)")
  args = ap.parse_args(argv)
  from repro_torch.apps import graphs
  from repro_torch.apps.baselines import apsp_np
  from repro_torch.core import prepare_adjacency
  from repro_torch.core.distributed import distributed_leyzorek
  from repro_torch.device import resolve_device
  from repro_torch.launch.mesh import available_devices, make_host_mesh

  dev = resolve_device(args.device)
  pool = ([dev] * args.shards if args.shards
          else available_devices(args.device))
  n_dev = len(pool)
  model = 4 if n_dev % 4 == 0 and n_dev >= 4 else 1
  data = max(1, n_dev // model)
  mesh = make_host_mesh(data * model, model=model, devices=pool)
  print(f"mesh: data={data} × model={model} ({n_dev} shards of "
        f"{mesh.device_type})")

  n = args.n
  w = graphs.weighted_digraph(n, 0.1, seed=7)
  adj = prepare_adjacency(torch.from_numpy(w).to(dev), op="minplus")
  dist = distributed_leyzorek(adj, op="minplus", mesh=mesh)

  ref = apsp_np(w)
  fin = np.isfinite(ref)
  got = dist.cpu().numpy()
  err = np.abs(got[fin] - ref[fin]).max()
  print(f"APSP |V|={n}: sharded closure max err = {err:.2e} "
        f"(validated vs Floyd-Warshall)")
  print("C stays 2-D block-sharded across iterations; each squaring "
        "moves only SUMMA K-panels (all-gather row/col).")
  ok = bool(err <= 1e-4) and bool(np.array_equal(np.isfinite(got), fin))
  print("APSP max err <= 1e-4:", ok)
  print(f"[checks] {int(ok)} of 1 passed")
  return 0 if ok else 1


if __name__ == "__main__":
  sys.exit(main())
