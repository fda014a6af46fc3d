"""Live serving metrics: lock-cheap rolling windows, snapshotable mid-run.

Counterpart of ``repro/serve_mmo/metrics.py``.

``EngineStats`` summarizes a *finished* run from the full record list; this
module is the opposite trade — bounded memory, O(1) appends under one short
lock, and a ``snapshot()`` that is safe to call from any thread while the
background serving loop is mid-batch (no stop, no drain).  That is what a
metrics endpoint / ``launch/serve_mmo.py --metrics-every`` needs: p99 *now*,
not p99 after the run.

Per bucket, rolling windows for queue latency (submit → batch pick) and
service latency (batch pick → results ready), plus per-batch host time
(pad-and-stack + split) and device compute time — the host/device breakdown
the engine measures around each batch.  Percentiles come from the last
``window`` observations — a rolling estimate that tracks load shifts
instead of averaging them away.  A window that has seen nothing reports its
percentiles as ``None`` (never NaN: ``json.dumps`` renders NaN as the
bareword ``NaN``, which is not strict JSON — a bucket created by
``on_expire`` alone must still snapshot to parseable output).

Alongside each window sits a fixed log-bucketed cumulative histogram
(serve_mmo/exposition.py) — the form Prometheus can aggregate across
scrapes and instances; the windows answer "now" for humans, the histograms
answer "since start" for the scraper.

Global counters (submitted / completed / rejected / expired / failed /
batches / h2d_bytes) are plain monotonic ints.

The same per-batch service-latency observations that fill these windows
also feed the engine's adaptive EWMA estimator (serve_mmo/estimator.py) —
the windows answer "what happened" for humans and dashboards, the
estimator answers "what will this cost" for admission, feasibility, and
batch capping; ``snapshot`` carries both (the engine passes the
estimator's state in as a gauge).
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from repro_torch.serve_mmo.exposition import HISTOGRAM_BOUNDS_S, LogHistogram

__all__ = ["RollingWindow", "ServeMetrics", "bucket_label"]


class RollingWindow:
  """Fixed-capacity ring of float observations with percentile queries.

  Appends are O(1) (one slot write + index bump); ``percentile`` sorts the
  live slots — called only from ``snapshot``, never on the serving path.
  """

  __slots__ = ("_buf", "_size", "_n")

  def __init__(self, size: int = 512):
    if size < 1:
      raise ValueError(f"window size must be >= 1, got {size}")
    self._buf = [0.0] * size
    self._size = size
    self._n = 0  # total observations ever (live slots = min(n, size))

  def add(self, value: float) -> None:
    self._buf[self._n % self._size] = float(value)
    self._n += 1

  @property
  def count(self) -> int:
    return self._n

  def values(self) -> list:
    return list(self._buf[:min(self._n, self._size)])

  def percentile(self, q: float) -> Optional[float]:
    """Nearest-rank percentile of the live slots, or None when empty."""
    return _rank(sorted(self.values()), q)


def _rank(sorted_vals: list, q: float) -> Optional[float]:
  """Nearest-rank percentile over a pre-sorted list (no numpy on the
  metrics path).  Empty windows answer ``None`` — the JSON-safe spelling of
  "no data" (``float('nan')`` serializes as bareword ``NaN``, breaking any
  strict parser downstream of the snapshot)."""
  if not sorted_vals:
    return None
  idx = min(len(sorted_vals) - 1,
            max(0, round(q / 100.0 * (len(sorted_vals) - 1))))
  return sorted_vals[int(idx)]


def _ms(seconds: Optional[float]) -> Optional[float]:
  return None if seconds is None else seconds * 1e3


def bucket_label(key) -> str:
  """Compact human/JSON label for one BucketKey.  Uniform-dtype buckets (the
  overwhelming majority) keep the historical single-dtype spelling; mixed
  operand dtypes are all spelled out, so two buckets differing only in a
  non-leading operand dtype can never collide under one label."""
  shape = "x".join(str(d) for d in key.shape)
  if len(set(key.dtypes)) <= 1:
    dtypes = key.dtypes[0]
  else:
    dtypes = "+".join(key.dtypes)
  return f"{key.kind}/{key.op}/{shape}/{dtypes}"


class ServeMetrics:
  """The engine's live metrics registry (one per MMOEngine).

  Every hook takes the lock for a few dict/ring operations and returns —
  cheap enough to sit inside ``submit`` and ``step`` without stretching the
  engine's critical sections.  ``snapshot`` is read-only aggregation and can
  run concurrently with serving.
  """

  COUNTERS = ("submitted", "completed", "rejected", "expired", "failed",
              "batches", "h2d_bytes", "retries")
  WINDOWS = ("queue", "service", "host", "device")

  def __init__(self, *, clock=None, window: int = 512):
    self._clock = clock if clock is not None else time.perf_counter
    self._window = window
    self._lock = threading.Lock()
    self._started_s = self._clock()
    self._counters = {name: 0 for name in self.COUNTERS}
    self._rejected_by_reason: dict[str, int] = {}
    self._batch_failures_by_kind: dict[str, int] = {}
    self._buckets: dict[str, dict] = {}  # label → windows + histograms

  # -- engine hooks ------------------------------------------------------------

  def _bucket_locked(self, key) -> dict:
    # caller holds self._lock
    label = bucket_label(key)
    b = self._buckets.get(label)
    if b is None:
      b = self._buckets[label] = {
          "completed": 0, "expired": 0, "failed": 0,
          **{name: RollingWindow(self._window) for name in self.WINDOWS},
          **{f"{name}_hist": LogHistogram() for name in self.WINDOWS},
      }
    return b

  def on_submit(self) -> None:
    with self._lock:
      self._counters["submitted"] += 1

  def on_reject(self, kind: str) -> None:
    with self._lock:
      self._counters["rejected"] += 1
      self._rejected_by_reason[kind] = self._rejected_by_reason.get(kind, 0) + 1

  def on_expire(self, key) -> None:
    with self._lock:
      self._counters["expired"] += 1
      self._bucket_locked(key)["expired"] += 1

  def on_fail(self, key) -> None:
    with self._lock:
      self._counters["failed"] += 1
      self._bucket_locked(key)["failed"] += 1

  def on_retry(self, n: int = 1) -> None:
    """``n`` sub-batches re-dispatched by the recovery path (a transient
    retry counts 1, a bisection counts one per half).  Distinct from
    ``on_fail``: retried requests have not failed — most never will."""
    with self._lock:
      self._counters["retries"] += int(n)

  def on_batch_failure(self, kind: str) -> None:
    """One failed batch *attempt*, classified (faults.FAILURE_KINDS).
    Every failed attempt counts — including ones whose requests later
    complete via retry/bisection — so the by-kind breakdown sees transient
    noise that the request-level ``failed`` counter (final outcomes only)
    never shows."""
    with self._lock:
      self._batch_failures_by_kind[kind] = (
          self._batch_failures_by_kind.get(kind, 0) + 1)

  def on_batch(self, key=None, *, host_s: Optional[float] = None,
               device_s: Optional[float] = None,
               h2d_bytes: Optional[int] = None) -> None:
    """One executed batch.  With a bucket key, also records the batch's
    host/device time breakdown (host = pad-and-stack + split-results,
    device = compiled-program execution) and the bytes staged host→device."""
    with self._lock:
      self._counters["batches"] += 1
      if h2d_bytes:
        self._counters["h2d_bytes"] += int(h2d_bytes)
      if key is not None:
        b = self._bucket_locked(key)
        if host_s is not None:
          b["host"].add(host_s)
          b["host_hist"].add(host_s)
        if device_s is not None:
          b["device"].add(device_s)
          b["device_hist"].add(device_s)

  def on_complete(self, key, queue_s: float, service_s: float) -> None:
    with self._lock:
      self._counters["completed"] += 1
      b = self._bucket_locked(key)
      b["completed"] += 1
      b["queue"].add(queue_s)
      b["queue_hist"].add(queue_s)
      b["service"].add(service_s)
      b["service_hist"].add(service_s)

  # -- reading -----------------------------------------------------------------

  def counter(self, name: str) -> int:
    with self._lock:
      return self._counters[name]

  def snapshot(self, *, queue_depth: Optional[int] = None,
               executing: Optional[int] = None,
               admission: Optional[dict] = None,
               estimator: Optional[dict] = None) -> dict:
    """JSON-able point-in-time view.  ``queue_depth`` / ``executing`` /
    ``admission`` / ``estimator`` are gauges the engine reads under its own
    (or the estimator's) lock and passes in (the registry never reaches
    back into the engine — no lock-order coupling).  Only O(1)-per-bucket
    window *copies* happen under the metrics lock; the sorts behind the
    percentiles run after it is released, so a slow snapshot can never
    stall the serving hooks.  Strict-JSON safe: empty windows report their
    percentiles as None, never NaN."""
    with self._lock:
      raw = {label: (b["completed"], b["expired"], b["failed"],
                     {name: b[name].values() for name in self.WINDOWS})
             for label, b in self._buckets.items()}
      snap = {
          "uptime_s": self._clock() - self._started_s,
          "counters": dict(self._counters),
          "rejected_by_reason": dict(self._rejected_by_reason),
          "batch_failures_by_kind": dict(self._batch_failures_by_kind),
      }
    buckets = {}
    for label, (completed, expired, failed, windows) in raw.items():
      stanza = {"completed": completed, "expired": expired, "failed": failed}
      for name, vals in windows.items():
        vals.sort()
        stanza[f"{name}_ms"] = {"p50": _ms(_rank(vals, 50)),
                                "p99": _ms(_rank(vals, 99))}
      stanza["window"] = len(windows["queue"])
      buckets[label] = stanza
    snap["buckets"] = buckets
    if queue_depth is not None:
      snap["queue_depth"] = queue_depth
    if executing is not None:
      snap["executing"] = executing
    if admission is not None:
      snap["admission"] = admission
    if estimator is not None:
      snap["estimator"] = estimator
    return snap

  def exposition_state(self) -> dict:
    """Raw counter + histogram state for the Prometheus renderer
    (serve_mmo/exposition.py): per-bucket cumulative histogram (counts,
    sum, count) tuples copied under the lock, shared fixed boundaries."""
    with self._lock:
      buckets = {
          label: {
              "completed": b["completed"],
              "expired": b["expired"],
              "failed": b["failed"],
              "histograms": {name: b[f"{name}_hist"].state()
                             for name in self.WINDOWS
                             if b[f"{name}_hist"].count},
          }
          for label, b in self._buckets.items()
      }
      return {
          "uptime_s": self._clock() - self._started_s,
          "counters": dict(self._counters),
          "rejected_by_reason": dict(self._rejected_by_reason),
          "batch_failures_by_kind": dict(self._batch_failures_by_kind),
          "histogram_bounds_s": list(HISTOGRAM_BOUNDS_S),
          "buckets": buckets,
      }
