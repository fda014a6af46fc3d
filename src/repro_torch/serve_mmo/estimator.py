"""Live service-time estimation: EWMA over measured batch latencies.

Counterpart of ``repro/serve_mmo/estimator.py``, pure Python.  The static
cost table answers "what *should* this bucket cost" — a measured
microbenchmark row or the H100 roofline prior.  Both drift from reality the
moment the device is loaded, a competing tenant warms a cache, or a closure
converges faster than its worst-case trip count.  The QoS layers that
consume ``MMOEngine.predict_request_seconds`` (deadline feasibility,
predicted-backlog admission, the service-time batch cap) are exactly the
layers that should track the *actual* device, so this module closes the
loop:

  * every completed batch contributes one observation — the same service
    latency that lands in the ``ServeMetrics`` rolling windows — normalized
    to per-request seconds (batch compute scales linearly with occupied
    slots, so seconds / padded-batch-size is the request's marginal cost),
    keyed by (bucket, backend, schedule) so a bucket re-routed to the mesh
    or to a different backend never inherits stale numbers;
  * closure batches additionally contribute their *measured* convergence
    iteration counts (``_batched_fixpoint`` reports per-request counts), so
    the cold-start prediction for a closure bucket multiplies the
    per-contraction cost by how many contractions this traffic actually
    runs, not the solver's worst-case trip count (lg n squarings / n−1
    relaxations — often 2–10× pessimistic on real graphs);
  * predictions blend: a warm EWMA (``min_observations`` reached) answers
    directly; a cold cell falls back to the static per-contraction cost ×
    the measured-iterations estimate, and with no observations at all to
    the static prediction unchanged — the engine's historical behavior.

The estimator is decoupled from engine internals and independently
thread-safe (one short lock per observe/predict): ``observe_*`` runs on the
background serving loop inside ``step`` while ``predict`` runs on caller
threads inside ``submit`` and on the scheduler's pick path.

EWMA decay is per-*observation* with a configurable half-life: after
``half_life`` observations an old reading retains half its weight, so the
estimate tracks load shifts at batch-arrival rate without needing a clock —
which also keeps synthetic-clock tests exact.
"""
from __future__ import annotations

import math
import threading
from typing import NamedTuple

__all__ = ["Estimate", "ServiceEstimator", "DEFAULT_HALF_LIFE",
           "DEFAULT_MIN_OBSERVATIONS"]

DEFAULT_HALF_LIFE = 8.0
DEFAULT_MIN_OBSERVATIONS = 3


class Estimate(NamedTuple):
  """One prediction: ``seconds`` per request, and where it came from —
  'ewma' (warm live estimate), 'iterations' (static per-contraction cost ×
  measured convergence counts), or 'static' (cost table / roofline prior ×
  worst-case trips, the cold-start behavior)."""
  seconds: float
  source: str


class _Ewma:
  """Exponentially-weighted mean with per-observation decay."""

  __slots__ = ("value", "count", "_alpha")

  def __init__(self, alpha: float):
    self.value = 0.0
    self.count = 0
    self._alpha = alpha

  def add(self, x: float) -> None:
    x = float(x)
    if self.count == 0:
      self.value = x
    else:
      self.value += self._alpha * (x - self.value)
    self.count += 1


class ServiceEstimator:
  """Per-(bucket, backend, schedule) EWMA service-time estimator.

  ``half_life`` is in observations: ``alpha = 1 − 2^(−1/half_life)``, so a
  reading's weight halves every ``half_life`` subsequent batches.  A cell
  answers predictions only once it holds ``min_observations`` readings —
  below that the static prior is the better-conditioned estimate and one
  outlier batch (a compile hiding in the first measurement, a page fault)
  must not steer admission.
  """

  def __init__(self, *, half_life: float = DEFAULT_HALF_LIFE,
               min_observations: int = DEFAULT_MIN_OBSERVATIONS):
    if not half_life > 0.0:
      raise ValueError(f"half_life must be > 0, got {half_life}")
    if min_observations < 1:
      raise ValueError(
          f"min_observations must be >= 1, got {min_observations}")
    self.half_life = float(half_life)
    self.min_observations = int(min_observations)
    self._alpha = 1.0 - 2.0 ** (-1.0 / self.half_life)
    self._lock = threading.Lock()
    self._cells: dict[tuple, _Ewma] = {}  # (bucket, backend, schedule)
    self._iters: dict = {}                # bucket → _Ewma of measured iters

  # -- observations (serving-loop side) ---------------------------------------

  def observe_batch(self, key, backend: str, schedule: str, slots: int,
                    seconds: float) -> None:
    """One completed batch: ``seconds`` of device service over ``slots``
    padded batch slots (the executable computes every slot, so per-request
    marginal cost is seconds / slots)."""
    if slots < 1 or not (seconds >= 0.0 and math.isfinite(seconds)):
      return  # never let a bogus reading poison the estimate
    cell_key = (key, backend, schedule)
    with self._lock:
      cell = self._cells.get(cell_key)
      if cell is None:
        cell = self._cells[cell_key] = _Ewma(self._alpha)
      cell.add(seconds / slots)

  def observe_iterations(self, key, iterations) -> None:
    """Measured per-request convergence counts from one closure batch (the
    live slots only — padded copies would double-count their template).
    Recorded separately from batch seconds so a batch that fails *after*
    the fixpoint ran (the poisoned-batch path) still contributes what it
    measured."""
    its = [float(i) for i in iterations]
    if not its:
      return
    mean = sum(its) / len(its)
    if not (mean >= 0.0 and math.isfinite(mean)):
      return
    with self._lock:
      cell = self._iters.get(key)
      if cell is None:
        cell = self._iters[key] = _Ewma(self._alpha)
      cell.add(mean)

  # -- predictions (submit / pick side) ---------------------------------------

  def iteration_estimate(self, key, worst_trips: float) -> float:
    """Expected contractions per request for this bucket: the measured EWMA
    clamped to [1, worst_trips] (the worst case is a true bound — measured
    counts above it can only be noise), or ``worst_trips`` when unmeasured."""
    with self._lock:
      cell = self._iters.get(key)
      value = cell.value if cell is not None and cell.count > 0 else None
    if value is None:
      return float(worst_trips)
    return float(min(max(value, 1.0), worst_trips))

  def predict(self, key, backend: str, schedule: str,
              static_contraction_s: float, worst_trips: float) -> Estimate:
    """Per-request service seconds for one bucket.

    Precedence: warm EWMA ('ewma') > static per-contraction cost ×
    measured-iterations estimate ('iterations') > static cost × worst-case
    trips ('static' — byte-for-byte the non-adaptive prediction).

    Observations are keyed by the schedule that *actually executed*, and
    per-batch placement may downgrade a distributed bucket to 'local'
    (e.g. dp batches whose size does not divide the mesh), so when the
    distributed cell is still cold the bucket's local cell answers before
    the static prior does — measured local latency beats an idealized
    model, and the two regimes' readings are never averaged together."""
    with self._lock:
      cell = self._cells.get((key, backend, schedule))
      warm = cell is not None and cell.count >= self.min_observations
      if not warm and schedule != "local":
        cell = self._cells.get((key, backend, "local"))
        warm = cell is not None and cell.count >= self.min_observations
      value = cell.value if warm else None
    if value is not None:
      return Estimate(value, "ewma")
    trips = self.iteration_estimate(key, worst_trips)
    source = "iterations" if trips != float(worst_trips) else "static"
    return Estimate(static_contraction_s * trips, source)

  def observations(self, key, backend: str, schedule: str) -> int:
    """How many batches the (bucket, backend, schedule) cell has seen."""
    with self._lock:
      cell = self._cells.get((key, backend, schedule))
      return cell.count if cell is not None else 0

  def cells_raw(self) -> list:
    """Every live cell as (bucket key, backend, schedule, ewma seconds,
    observation count) tuples — the unformatted view the engine's
    observability state uses to compute per-cell drift against the static
    cost model (the keys stay real BucketKeys so the engine can price the
    static side; ``snapshot`` is the label-formatted JSON counterpart)."""
    with self._lock:
      return [(k, b, s, c.value, c.count)
              for (k, b, s), c in self._cells.items()]

  # -- reading ----------------------------------------------------------------

  def snapshot(self) -> dict:
    """JSON-able state: per-cell EWMA seconds + observation counts, and the
    measured-iterations estimate per closure bucket."""
    from repro_torch.serve_mmo.metrics import bucket_label
    with self._lock:
      cells = {f"{bucket_label(k)}|{b}|{s}": {
          "seconds": c.value, "observations": c.count}
          for (k, b, s), c in self._cells.items()}
      iters = {bucket_label(k): {"iterations": c.value,
                                 "observations": c.count}
               for k, c in self._iters.items()}
    return {"half_life": self.half_life,
            "min_observations": self.min_observations,
            "cells": cells, "iterations": iters}
