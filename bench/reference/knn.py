"""Plain PyTorch k-nearest neighbours: squared L2 distances in float64.

The yardstick for served KNN answers: every distance is formed as
sum_d (q_d - r_d)^2 from the points the benchmark drew, in float64, so its
own rounding (~1e-16 relative) is far below a float32 program's.
"""
from __future__ import annotations

import torch

# bytes of one (rows, corpus, dim) block of float64 differences
DIFF_BLOCK_BYTES = 1 << 29


def distances(queries: torch.Tensor, corpus: torch.Tensor,
              dtype=torch.float64) -> torch.Tensor:
  """(Q, R) squared distances, computed in ``dtype`` from inputs rounded
  to ``dtype``."""
  q, r = queries.to(dtype), corpus.to(dtype)
  rows = max(1, DIFF_BLOCK_BYTES // max(1, r.numel() * r.element_size()))
  out = []
  for i in range(0, q.shape[0], rows):
    diff = q[i:i + rows, None, :] - r[None, :, :]
    out.append((diff * diff).sum(dim=-1))
  return torch.cat(out)


def pair_distances(queries: torch.Tensor, corpus: torch.Tensor,
                   indices: torch.Tensor) -> torch.Tensor:
  """(Q, k) float64 distances from each query to the corpus points that
  ``indices`` names (every index must lie in range)."""
  q = queries.to(torch.float64)
  picked = corpus.to(torch.float64)[indices.long()]
  diff = picked - q[:, None, :]
  return (diff * diff).sum(dim=-1)


def smallest(d: torch.Tensor, k: int):
  """(values, indices) of the k smallest per row, ascending."""
  return torch.topk(d, k, dim=-1, largest=False, sorted=True)
