"""Independent scalar/numpy baselines — the paper's "state-of-the-art GPU
baseline" arm (§5.2), reimplemented as classic algorithms so that each
SIMD²-ized solver is validated against a *different* algorithm, exactly as
the paper's correctness-validation flow demands (§5.1.2):

  APSP/APLP/MaxCP/MaxRP/MinRP → Floyd-Warshall k-pivot recurrences
  MST                         → Kruskal with union-find (+ tree path maxima)
  GTC                         → per-source BFS reachability
  KNN                         → brute-force norm expansion + argpartition

Counterpart of ``repro/apps/baselines.py``: the port keeps its own copy
(numpy only), so it imports nothing of the reference.
"""
from __future__ import annotations

import numpy as np


def floyd_warshall_np(adj: np.ndarray, oplus, otimes) -> np.ndarray:
  """Generic k-pivot closure. adj must already hold self values/sentinels."""
  d = adj.astype(np.float64, copy=True)
  n = d.shape[0]
  for k in range(n):
    with np.errstate(invalid="ignore", over="ignore"):
      cand = otimes(d[:, k:k + 1], d[k:k + 1, :])
    d = oplus(d, cand)
  return d


def apsp_np(w: np.ndarray) -> np.ndarray:
  return floyd_warshall_np(w, np.minimum, np.add)


def aplp_np(w: np.ndarray) -> np.ndarray:
  # longest path on a DAG: -inf sentinels never contribute (−inf + x = −inf)
  return floyd_warshall_np(w, np.maximum, np.add)


def maxcp_np(c: np.ndarray) -> np.ndarray:
  # max capacity: widest-path recurrence
  return floyd_warshall_np(c, np.maximum, np.minimum)


def maxrp_np(p: np.ndarray) -> np.ndarray:
  return floyd_warshall_np(p, np.maximum, np.multiply)


def minrp_np(p: np.ndarray) -> np.ndarray:
  return floyd_warshall_np(p, np.minimum, np.multiply)


def gtc_np(adj: np.ndarray) -> np.ndarray:
  """Reflexive-transitive closure by BFS from every source."""
  n = adj.shape[0]
  out = np.zeros((n, n), dtype=bool)
  nbrs = [np.nonzero(adj[i])[0] for i in range(n)]
  for s in range(n):
    seen = np.zeros(n, dtype=bool)
    seen[s] = True
    frontier = [s]
    while frontier:
      nxt = []
      for u in frontier:
        for v in nbrs[u]:
          if not seen[v]:
            seen[v] = True
            nxt.append(v)
      frontier = nxt
    out[s] = seen
  return out


class _UnionFind:
  def __init__(self, n):
    self.p = list(range(n))

  def find(self, x):
    while self.p[x] != x:
      self.p[x] = self.p[self.p[x]]
      x = self.p[x]
    return x

  def union(self, a, b):
    ra, rb = self.find(a), self.find(b)
    if ra == rb:
      return False
    self.p[ra] = rb
    return True


def kruskal_mst_np(w: np.ndarray):
  """Returns (edge set as sorted (i,j) tuples, total weight)."""
  n = w.shape[0]
  iu, ju = np.triu_indices(n, 1)
  finite = np.isfinite(w[iu, ju])
  edges = sorted(zip(w[iu[finite], ju[finite]], iu[finite], ju[finite]))
  uf = _UnionFind(n)
  out, total = set(), 0.0
  for wt, i, j in edges:
    if uf.union(int(i), int(j)):
      out.add((int(i), int(j)))
      total += float(wt)
  return out, total


def minimax_paths_np(w: np.ndarray) -> np.ndarray:
  """Minimax (bottleneck) path matrix — the quantity the min-max closure
  computes; derived here independently from the MST (max edge on the unique
  tree path), for cross-validation against the semiring solver."""
  n = w.shape[0]
  edges, _ = kruskal_mst_np(w)
  adj = [[] for _ in range(n)]
  for i, j in edges:
    adj[i].append((j, w[i, j]))
    adj[j].append((i, w[i, j]))
  out = np.full((n, n), np.inf)
  np.fill_diagonal(out, -np.inf)  # semiring self value (min-max identity-ish)
  for s in range(n):
    # DFS carrying the max edge weight seen
    stack = [(s, -np.inf)]
    seen = {s}
    while stack:
      u, mx = stack.pop()
      for v, wt in adj[u]:
        if v not in seen:
          seen.add(v)
          m2 = max(mx, wt)
          out[s, v] = m2
          stack.append((v, m2))
  return out


def knn_np(ref: np.ndarray, qry: np.ndarray, k: int):
  """Brute-force: returns (sq-dists (Q,k), indices (Q,k)) sorted ascending."""
  d2 = ((qry[:, None, :].astype(np.float64)
         - ref[None, :, :].astype(np.float64)) ** 2).sum(-1)
  idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
  return np.take_along_axis(d2, idx, axis=1), idx
