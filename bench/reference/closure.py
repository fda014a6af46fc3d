"""Plain PyTorch semiring closure: the yardstick the served closures are
held to.

Repeated squaring D <- D (+) (D (x) D) from the prepared adjacency (the
ring's self value on the diagonal), written from the rings' definitions in
SIMD2 (arXiv:2205.01252, Table 1) with nothing of the program under test.
Each squaring forms every (i, k, j) term: a block of k at a time,
``D[:, k, None] (x) D[None, k, :]`` reduced by (+) over k, so a float32
squaring rounds each candidate path sum once, as the definition does.  The
min/max reductions are exact, so the float32 closure is the exact closure
of float32 arithmetic whatever order the terms are taken in.
"""
from __future__ import annotations

import math

import torch

# ring -> ((+) of two tensors, (+) reduction over a dim, (x), graph sentinel
# for a missing edge, self value on the diagonal)
RINGS = {
    "minplus": (torch.minimum, torch.amin, torch.add, math.inf, 0.0),
    "maxplus": (torch.maximum, torch.amax, torch.add, -math.inf, 0.0),
    "minmax": (torch.minimum, torch.amin, torch.maximum, math.inf,
               -math.inf),
    "maxmin": (torch.maximum, torch.amax, torch.minimum, 0.0, math.inf),
    "minmul": (torch.minimum, torch.amin, torch.mul, math.inf, 1.0),
    "maxmul": (torch.maximum, torch.amax, torch.mul, 0.0, 1.0),
    "orand": (torch.logical_or, torch.any, torch.logical_and, False, True),
}

# bytes of one (n, block, n) block of terms
TERM_BLOCK_BYTES = 1 << 30


def ring(op: str):
  if op not in RINGS:
    raise ValueError(f"no reference for ring {op!r}; one of {sorted(RINGS)}")
  return RINGS[op]


def squaring_cap(n: int) -> int:
  """Squarings that cover every path of up to n - 1 edges: ceil(log2 n)."""
  return max(1, math.ceil(math.log2(max(n, 2))))


def square(d: torch.Tensor, op: str) -> torch.Tensor:
  """One step D (+) (D (x) D) of an (n, n) iterate."""
  plus, reduce, times, _, _ = ring(op)
  n = d.shape[-1]
  block = max(1, min(n, TERM_BLOCK_BYTES // max(1, n * n * d.element_size())))
  acc = d
  for k0 in range(0, n, block):
    terms = times(d[:, k0:k0 + block, None], d[None, k0:k0 + block, :])
    acc = plus(acc, reduce(terms, dim=1))
  return acc


def closure(adj: torch.Tensor, op: str):
  """(closure, needed, run) of one prepared (n, n) adjacency.

  ``needed`` counts the squarings that changed the iterate (after them it
  is the fixpoint); ``run`` counts the squarings a solver that stops at the
  first unchanged step runs, at most ``squaring_cap(n)``, which already
  covers every simple path."""
  cap = squaring_cap(adj.shape[-1])
  d, needed = adj, 0
  for step in range(1, cap + 1):
    new = square(d, op)
    if torch.equal(new, d):
      return d, needed, step
    d, needed = new, needed + 1
  return d, needed, cap
