"""Quickstart on the PyTorch/CUDA port: the SIMD² programming model in five
minutes.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Counterpart of ``examples/quickstart.py``.  Mirrors the paper's Figures
6–7: generalized matrix ops (``mmo``), a closure solver composed from them
(APSP via Leyzorek's algorithm with convergence checks), and the same op on
the SIMD² unit kernel (K1; on the CPU its plain PyTorch version).  Each
check prints ``<label>: True`` or ``False``; the script exits 1 if any is
False.
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.apps import graphs
from repro_torch.apps.baselines import apsp_np
from repro_torch.core import leyzorek_closure, mmo, prepare_adjacency
from repro_torch.device import resolve_device


def main(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("--device", default="cuda",
                  help="torch device (default: cuda; cpu for the plain "
                       "PyTorch versions)")
  args = ap.parse_args(argv)
  dev = resolve_device(args.device)
  checks = []

  # 1. D = C ⊕ (A ⊗ B) with the ⊕/⊗ pair selected per op (paper Table 2)
  rng = np.random.default_rng(0)
  a = torch.from_numpy(rng.standard_normal((128, 128)).astype(np.float32)).to(
      dev)
  b = torch.from_numpy(rng.standard_normal((128, 128)).astype(np.float32)).to(
      dev)
  for op in ("mma", "minplus", "maxmin", "addnorm"):
    d = mmo(a, b, op=op)
    print(f"mmo[{op:8s}] -> {tuple(d.shape)} {d.dtype}, "
          f"d[0,0]={float(d[0, 0]):.3f}")

  # 2. the same op on the SIMD²-unit kernel and on the matmul rewrite arm
  d_kernel = mmo(a, b, op="minplus", backend="pallas")
  d_xla = mmo(a, b, op="minplus", backend="xla")
  ok = bool(torch.allclose(d_kernel, d_xla, atol=1e-4))
  print("pallas == xla:", ok)
  checks.append(ok)

  # 3. a whole application: APSP = min-plus closure (Fig 7, Leyzorek form)
  w = graphs.weighted_digraph(256, 0.2, seed=1)
  adj = prepare_adjacency(torch.from_numpy(w).to(dev), op="minplus")
  dist, iters = leyzorek_closure(adj, op="minplus")
  ref = apsp_np(w)
  fin = np.isfinite(ref)
  err = np.abs(dist.cpu().numpy()[fin] - ref[fin]).max()
  print(f"APSP closure: {int(iters)} squarings (lg|V|="
        f"{int(np.ceil(np.log2(256)))} worst case), max err vs "
        f"Floyd-Warshall = {err:.2e}")
  ok = bool(err <= 1e-4)
  print("APSP max err <= 1e-4:", ok)
  checks.append(ok)
  print(f"[checks] {sum(checks)} of {len(checks)} passed")
  return 0 if all(checks) else 1


if __name__ == "__main__":
  sys.exit(main())
