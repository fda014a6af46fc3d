"""Fixed log-bucketed cumulative histograms for the serving metrics.

Counterpart of the histogram half of ``repro/serve_mmo/exposition.py``:
``LogHistogram`` and its shared ``HISTOGRAM_BOUNDS_S``, which
``ServeMetrics`` keeps beside each rolling window.  A window answers "p99
over the last 512 observations"; a cumulative histogram answers "the whole
distribution since start" in a form that sums across scrapes and engines.
Buckets double from 10 µs to ~21 s, which bounds the relative quantile
error at 2× with 22 buckets, and the boundaries are fixed so every engine
emits the same ones.  The Prometheus text renderer (``render_prometheus``)
comes with ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

import bisect
import math

__all__ = ["LogHistogram", "HISTOGRAM_BOUNDS_S"]

# 10 µs · 2^k for k = 0..21 → top finite bound ≈ 21 s
HISTOGRAM_BOUNDS_S = tuple(1e-5 * 2.0 ** k for k in range(22))


class LogHistogram:
  """Cumulative histogram over fixed log-spaced boundaries.

  ``add`` is O(log #buckets) (a bisect) under the owner's lock — the
  ``ServeMetrics`` registry embeds these next to its rolling windows and
  guards both with its one lock.  ``state()`` snapshots (counts, sum,
  total) for the renderer."""

  __slots__ = ("bounds", "_counts", "_sum", "_n")

  def __init__(self, bounds=HISTOGRAM_BOUNDS_S):
    self.bounds = tuple(float(b) for b in bounds)
    if not self.bounds or list(self.bounds) != sorted(self.bounds):
      raise ValueError("histogram bounds must be non-empty and ascending")
    self._counts = [0] * (len(self.bounds) + 1)  # last slot: > top bound
    self._sum = 0.0
    self._n = 0

  def add(self, value: float) -> None:
    value = float(value)
    if not (value >= 0.0 and math.isfinite(value)):
      return  # telemetry must never throw on a bogus reading
    self._counts[bisect.bisect_left(self.bounds, value)] += 1
    self._sum += value
    self._n += 1

  @property
  def count(self) -> int:
    return self._n

  def state(self) -> tuple:
    """(per-bucket counts incl. overflow, sum, total count) — copy."""
    return list(self._counts), self._sum, self._n
