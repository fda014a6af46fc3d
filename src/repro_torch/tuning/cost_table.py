"""Shape bucketing shared by the scheduler and (later) the cost table.

Only the bucketing helpers of ``repro/tuning/cost_table.py`` are ported so
far; the measured cost table, its priors and ``backend="auto"`` dispatch
wait for ROADMAP Queue 1 item 7.
"""
from __future__ import annotations

MIN_BUCKET = 8  # canonical bucket floor; serve_mmo.scheduler re-exports it


def bucket_dim(n: int, min_bucket: int = MIN_BUCKET) -> int:
  """Round ``n`` up to the next power of two, with a floor."""
  if n <= 0:
    raise ValueError(f"dimension must be positive, got {n}")
  b = min_bucket
  while b < n:
    b *= 2
  return b


def bucket_shape(shape: tuple, min_bucket: int = MIN_BUCKET) -> tuple:
  return tuple(bucket_dim(int(d), min_bucket) for d in shape)
