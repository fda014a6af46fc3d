"""Synthetic problem generators for the 8 SIMD² applications (paper §5.2).

The port's own copy of ``repro/apps/graphs.py`` (numpy only), so both
packages build identical request payloads from one seed.  Conventions per
ring (missing-edge sentinel, self value) follow
core/closure.prepare_adjacency; reliabilities are sampled in (0, 1] so
min-mul's +inf sentinel can never meet a zero (no NaN paths).
"""
from __future__ import annotations

import numpy as np


def weighted_digraph(n: int, density: float = 0.3, *, seed: int = 0,
                     wmin: float = 1.0, wmax: float = 10.0) -> np.ndarray:
  """APSP input: weights > 0, np.inf where no edge."""
  rng = np.random.default_rng(seed)
  w = rng.uniform(wmin, wmax, (n, n)).astype(np.float32)
  w[rng.random((n, n)) >= density] = np.inf
  np.fill_diagonal(w, 0.0)
  return w


def dag(n: int, density: float = 0.3, *, seed: int = 0,
        wmin: float = 1.0, wmax: float = 10.0) -> np.ndarray:
  """APLP input: edges only i→j for i<j (acyclic); -inf where no edge."""
  rng = np.random.default_rng(seed)
  w = rng.uniform(wmin, wmax, (n, n)).astype(np.float32)
  keep = (rng.random((n, n)) < density) & np.triu(np.ones((n, n), bool), 1)
  w = np.where(keep, w, -np.inf).astype(np.float32)
  np.fill_diagonal(w, 0.0)
  return w


def reliability_graph(n: int, density: float = 0.3, *, seed: int = 0,
                      maximize: bool = True) -> np.ndarray:
  """Edge success probabilities in (0.05, 1]; sentinel 0 (max-mul) or
  +inf (min-mul) where no edge; diagonal 1.

  The min-mul instance is generated ACYCLIC (edges i→j only for i<j): with
  min-reduction over sub-1 products, cyclic graphs have no fixed point (every
  extra lap shrinks the product), so minimum-reliability paths are only
  well-defined on DAG reliability networks — matching the paper's use case."""
  rng = np.random.default_rng(seed)
  p = rng.uniform(0.05, 1.0, (n, n)).astype(np.float32)
  missing = 0.0 if maximize else np.inf
  p[rng.random((n, n)) >= density] = missing
  if not maximize:
    p[np.tril_indices(n, 0)] = missing
  np.fill_diagonal(p, 1.0)
  return p


def capacity_graph(n: int, density: float = 0.3, *, seed: int = 0) -> np.ndarray:
  """Edge capacities > 0; 0 where no edge; +inf self capacity."""
  rng = np.random.default_rng(seed)
  c = rng.uniform(1.0, 100.0, (n, n)).astype(np.float32)
  c[rng.random((n, n)) >= density] = 0.0
  np.fill_diagonal(c, np.inf)
  return c


def undirected_weighted(n: int, density: float = 0.3, *, seed: int = 0
                        ) -> np.ndarray:
  """MST input: symmetric, unique positive weights, +inf where no edge.
  A random spanning path is added so the graph is always connected."""
  rng = np.random.default_rng(seed)
  w = np.full((n, n), np.inf, dtype=np.float32)
  iu = np.triu_indices(n, 1)
  keep = rng.random(len(iu[0])) < density
  # unique weights → unique MST (makes the oracle comparison exact)
  vals = rng.permutation(len(iu[0])).astype(np.float32) + 1.0
  w[iu[0][keep], iu[1][keep]] = vals[keep]
  order = rng.permutation(n)
  for t, (a, b) in enumerate(zip(order[:-1], order[1:])):
    i, j = min(a, b), max(a, b)
    if not np.isfinite(w[i, j]):
      w[i, j] = float(len(vals) + 1 + t)  # unique, larger than sampled vals
  w = np.minimum(w, w.T)
  np.fill_diagonal(w, 0.0)
  return w


def boolean_digraph(n: int, density: float = 0.05, *, seed: int = 0
                    ) -> np.ndarray:
  rng = np.random.default_rng(seed)
  adj = rng.random((n, n)) < density
  np.fill_diagonal(adj, True)
  return adj


def knn_points(n_ref: int, n_query: int, dim: int, *, seed: int = 0):
  rng = np.random.default_rng(seed)
  ref = rng.standard_normal((n_ref, dim)).astype(np.float32)
  qry = rng.standard_normal((n_query, dim)).astype(np.float32)
  return ref, qry
