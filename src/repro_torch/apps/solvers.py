"""SIMD²-ized solvers for the paper's 8 applications (§5.2), PyTorch.

Counterpart of ``repro/apps/solvers.py``: each solver prepares the adjacency
for its ring, runs a closure built from SIMD² MMOs (Leyzorek by default, AP
Bellman-Ford / Floyd-Warshall selectable) and post-processes.  Inputs are
numpy arrays or tensors; ``device`` (default ``"cuda"``, which raises without
a card) says where they run.  ``backend`` forwards to core.mmo ('xla' =
matmul rewrites + blocked vector, 'vector' = the SIMD²-w/-CUDA-cores arm,
'pallas' = the SIMD²-unit kernel).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import closure as cl
from repro_torch.core.mmo import mmo
from repro_torch.device import DEFAULT_DEVICE, resolve_device

Tensor = torch.Tensor

_ALGOS = ("leyzorek", "bellman_ford", "floyd_warshall")


def _as_tensor(x, device) -> Tensor:
  if isinstance(x, Tensor):
    return x.to(resolve_device(device))
  return torch.as_tensor(np.asarray(x), device=resolve_device(device))


def _closure(adj, *, op, algorithm="leyzorek", convergence=True,
             backend="pallas", max_iters=None):
  if algorithm == "leyzorek":
    out, it = cl.leyzorek_closure(adj, op=op, backend=backend,
                                  check_convergence=convergence,
                                  max_iters=max_iters)
  elif algorithm == "bellman_ford":
    out, it = cl.bellman_ford_closure(adj, op=op, backend=backend,
                                      check_convergence=convergence,
                                      max_iters=max_iters)
  elif algorithm == "floyd_warshall":
    out, it = cl.floyd_warshall(adj, op=op), adj.shape[-1]
  else:
    raise ValueError(f"algorithm must be one of {_ALGOS}")
  return out, it


def _ring_closure(w, op, device, kw):
  adj = cl.prepare_adjacency(_as_tensor(w, device), op=op)
  return _closure(adj, op=op, **kw)


def apsp(w, *, device=DEFAULT_DEVICE, **kw):
  """All-pairs shortest paths — SIMD².minplus (w: +inf for missing, 0 diag)."""
  return _ring_closure(w, "minplus", device, kw)


def aplp(w, *, device=DEFAULT_DEVICE, **kw):
  """All-pairs longest (critical) paths on a DAG — SIMD².maxplus."""
  return _ring_closure(w, "maxplus", device, kw)


def maxcp(c, *, device=DEFAULT_DEVICE, **kw):
  """Maximum capacity (widest) paths — SIMD².maxmin."""
  return _ring_closure(c, "maxmin", device, kw)


def maxrp(p, *, device=DEFAULT_DEVICE, **kw):
  """Maximum reliability paths — SIMD².maxmul (p: 0 for missing, 1 diag)."""
  return _ring_closure(p, "maxmul", device, kw)


def minrp(p, *, device=DEFAULT_DEVICE, **kw):
  """Minimum reliability paths — SIMD².minmul (p: +inf for missing, 1 diag)."""
  return _ring_closure(p, "minmul", device, kw)


def mst_minimax(w, *, device=DEFAULT_DEVICE, **kw):
  """Min-max closure: minimax (bottleneck) path matrix — SIMD².minmax."""
  return _ring_closure(w, "minmax", device, kw)


def mst_edges(w, *, device=DEFAULT_DEVICE, **kw):
  """Minimum spanning tree via the cycle property: for unique weights, edge
  (i,j) ∈ MST ⟺ w(i,j) equals the minimax path value between i and j."""
  mm, it = mst_minimax(w, device=device, **kw)
  w = _as_tensor(w, device)
  eye = torch.eye(w.shape[0], dtype=torch.bool, device=w.device)
  in_mst = torch.isfinite(w) & (w <= mm) & ~eye
  return in_mst, it


def gtc(adj, *, device=DEFAULT_DEVICE, **kw):
  """Graph transitive (reflexive) closure — SIMD².orand."""
  return _ring_closure(adj, "orand", device, kw)


def smallest_k(d2: Tensor, k: int):
  """The k smallest entries along the last dim, ascending, ties to the lower
  index — the order ``lax.top_k(-d2, k)`` gives in the reference.  A stable
  sort pins that order; ``torch.topk`` does not promise one."""
  vals, idx = torch.sort(d2, dim=-1, stable=True)
  return vals[..., :k], idx[..., :k].to(torch.int32)


def knn(ref, qry, *, k: int, backend: str = "pallas",
        device=DEFAULT_DEVICE):
  """K-nearest neighbours — SIMD².addnorm + top-k.

  Returns (sq-dists (Q,k), indices (Q,k) int32), ascending."""
  ref = _as_tensor(ref, device)
  qry = _as_tensor(qry, device)
  d2 = mmo(qry, ref.T.contiguous(), op="addnorm", backend=backend)
  return smallest_k(d2, k)


ALL_APPS = {
    "apsp": apsp,
    "aplp": aplp,
    "mcp": maxcp,
    "maxrp": maxrp,
    "minrp": minrp,
    "mst": mst_minimax,
    "gtc": gtc,
    "knn": knn,
}
