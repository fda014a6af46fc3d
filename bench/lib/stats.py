"""Small statistics the benchmark reports: rates over a window, and tails
in which a failure counts as infinitely late."""
from __future__ import annotations

import math


def window_credit(start: float, end: float, t0: float, t1: float) -> float:
  """Share of a request's time in the system, [start, end], that falls in
  the window [t0, t1].  Summed over the requests a closed loop completed,
  this is the work done in the window without the quantisation of counting
  whole batches at its edges."""
  if end <= start:
    return 1.0 if t0 <= end <= t1 else 0.0
  overlap = min(end, t1) - max(start, t0)
  return max(0.0, overlap) / (end - start)


def nearest_rank(values, q: float) -> float:
  """The q-th percentile by nearest rank: the smallest value with at least
  q % of the values at or below it.  ``math.inf`` (a request that failed,
  expired or was refused) sorts last."""
  vals = sorted(values)
  if not vals:
    raise ValueError("no values")
  rank = max(1, math.ceil(q / 100.0 * len(vals)))
  return vals[rank - 1]

