"""Prometheus text exposition for the serving engine — dependency-free.

Counterpart of ``repro/serve_mmo/exposition.py``.  Renders the engine's
live state (``ServeMetrics`` counters + histograms, scheduler/admission
gauges, executable-cache counters, estimator cells and their drift against
the static cost model, breaker cells, flight-recorder stats) as Prometheus
text exposition format 0.0.4: ``# HELP`` / ``# TYPE`` once per family, one
sample line per labelled series.  No client library.

Histograms here are fixed and log-bucketed, beside the rolling windows in
metrics.py: a window answers "p99 over the last 512 observations", a
cumulative histogram answers "the whole distribution since start" in a
form that sums across scrapes and engines.  Buckets double from 10 µs to
~21 s, which bounds the relative quantile error at 2× with 22 buckets, and
the boundaries are fixed so every engine emits the same ``le`` labels.
One state renders byte for byte as the reference renders it
(``tests/data/golden_metrics.prom``).
"""
from __future__ import annotations

import bisect
import math

__all__ = ["LogHistogram", "HISTOGRAM_BOUNDS_S", "render_prometheus",
           "escape_label_value"]

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


def escape_label_value(value: str) -> str:
  """Prometheus label-value escaping: backslash, double quote, newline."""
  return (str(value).replace("\\", "\\\\").replace('"', '\\"')
          .replace("\n", "\\n"))


def _labels(**kv) -> str:
  if not kv:
    return ""
  inner = ",".join(f'{k}="{escape_label_value(v)}"'
                   for k, v in sorted(kv.items()))
  return "{" + inner + "}"


def _num(v) -> str:
  """Prometheus sample value formatting (+Inf/-Inf/NaN spellings)."""
  f = float(v)
  if math.isinf(f):
    return "+Inf" if f > 0 else "-Inf"
  if math.isnan(f):
    return "NaN"
  return repr(f) if f != int(f) else str(int(f))


class _Writer:
  """Accumulates families; enforces one HELP/TYPE per metric name."""

  def __init__(self):
    self._lines = []
    self._seen = set()

  def family(self, name: str, mtype: str, help_text: str):
    if name in self._seen:
      raise ValueError(f"duplicate metric family {name!r}")
    self._seen.add(name)
    self._lines.append(f"# HELP {name} {help_text}")
    self._lines.append(f"# TYPE {name} {mtype}")

  def sample(self, name: str, value, **labels):
    self._lines.append(f"{name}{_labels(**labels)} {_num(value)}")

  def text(self) -> str:
    return "\n".join(self._lines) + "\n"


def _histogram(w: _Writer, name: str, bounds, series: dict):
  """One histogram family; ``series`` maps label-dict-tuples → state."""
  for labels, (counts, total_sum, n) in series.items():
    labels = dict(labels)
    cum = 0
    for bound, c in zip(bounds, counts):
      cum += c
      w.sample(f"{name}_bucket", cum, le=_num(bound), **labels)
    w.sample(f"{name}_bucket", n, le="+Inf", **labels)
    w.sample(f"{name}_sum", total_sum, **labels)
    w.sample(f"{name}_count", n, **labels)


def render_prometheus(state: dict) -> str:
  """Render one engine observability state (``MMOEngine.observability_state``)
  as Prometheus text exposition.  Pure function of the passed snapshot — no
  locks, callable from the HTTP handler thread without touching the serving
  path."""
  w = _Writer()
  m = state["metrics"]

  w.family("serve_uptime_seconds", "gauge",
           "Seconds since the metrics registry started.")
  w.sample("serve_uptime_seconds", m["uptime_s"])

  counter_help = {
      "submitted": "Requests submitted (pre-admission).",
      "completed": "Requests completed successfully.",
      "rejected": "Requests refused by admission control.",
      "expired": "Requests that missed their deadline while queued.",
      "failed": "Requests failed by a batch execution error.",
      "batches": "Batches executed.",
      "h2d_bytes": "Host-to-device bytes pad-and-stacked into batches.",
      "retries": "Sub-batches re-dispatched by the recovery path "
                 "(transient retries + bisection halves).",
  }
  for name, count in sorted(m["counters"].items()):
    w.family(f"serve_{name}_total", "counter",
             counter_help.get(name, f"Engine counter {name}."))
    w.sample(f"serve_{name}_total", count)

  w.family("serve_rejected_by_reason_total", "counter",
           "Admission rejections by reason kind.")
  for reason, count in sorted(m["rejected_by_reason"].items()):
    w.sample("serve_rejected_by_reason_total", count, reason=reason)

  w.family("serve_batch_failures_total", "counter",
           "Failed batch attempts by failure kind (every failed attempt "
           "counts, including ones recovered by retry/bisection).")
  for kind, count in sorted(m.get("batch_failures_by_kind", {}).items()):
    w.sample("serve_batch_failures_total", count, kind=kind)

  # per-bucket outcome counters
  w.family("serve_bucket_completed_total", "counter",
           "Completed requests per shape bucket.")
  w.family("serve_bucket_expired_total", "counter",
           "Deadline-expired requests per shape bucket.")
  w.family("serve_bucket_failed_total", "counter",
           "Failed requests per shape bucket.")
  for label, b in sorted(m["buckets"].items()):
    w.sample("serve_bucket_completed_total", b["completed"], bucket=label)
    w.sample("serve_bucket_expired_total", b["expired"], bucket=label)
    w.sample("serve_bucket_failed_total", b["failed"], bucket=label)

  # per-bucket latency histograms (fixed log buckets — see module docstring)
  hist_help = {
      "queue": ("serve_queue_seconds",
                "Queue latency (submit to batch pick) per bucket."),
      "service": ("serve_service_seconds",
                  "Service latency (batch pick to results) per bucket."),
      "host": ("serve_batch_host_seconds",
               "Per-batch host time (pad-and-stack + split) per bucket."),
      "device": ("serve_batch_device_seconds",
                 "Per-batch device compute time per bucket."),
  }
  for which, (name, help_text) in hist_help.items():
    series = {}
    for label, b in sorted(m["buckets"].items()):
      hist = b["histograms"].get(which)
      if hist is not None:
        series[(("bucket", label),)] = hist
    if series:
      bounds = m["histogram_bounds_s"]
      w.family(name, "histogram", help_text)
      _histogram(w, name, bounds, series)

  # live gauges
  w.family("serve_queue_depth", "gauge", "Requests queued right now.")
  w.sample("serve_queue_depth", state["queue_depth"])
  w.family("serve_executing", "gauge",
           "Requests inside the currently executing batch.")
  w.sample("serve_executing", state["executing"])

  adm = state["admission"]
  w.family("serve_backlog_seconds", "gauge",
           "Predicted seconds of work in the queue (admission accounting).")
  w.sample("serve_backlog_seconds", adm["backlog_s"])
  w.family("serve_admission_evaluations_total", "counter",
           "Admission decisions taken (admit + reject).")
  w.sample("serve_admission_evaluations_total", adm["evaluations"])
  w.family("serve_tenant_inflight", "gauge",
           "In-flight (queued + executing) requests per tenant.")
  for tenant, n in sorted(adm["inflight"].items()):
    w.sample("serve_tenant_inflight", n, tenant=tenant)

  cache = state["cache"]
  w.family("serve_executable_cache_hits_total", "counter",
           "Executable cache hits (batch reused a stored program).")
  w.sample("serve_executable_cache_hits_total", cache["hits"])
  w.family("serve_executable_cache_misses_total", "counter",
           "Executable cache misses (a batch traced + compiled — retraces).")
  w.sample("serve_executable_cache_misses_total", cache["misses"])
  w.family("serve_executable_cache_size", "gauge",
           "Stored executables.")
  w.sample("serve_executable_cache_size", cache["executables"])

  sched = state["scheduler"]
  w.family("serve_scheduler_picks_total", "counter",
           "Bucket picks taken by the scheduling policy.")
  w.sample("serve_scheduler_picks_total", sched["picks"])
  w.family("serve_scheduler_pick_seconds_total", "counter",
           "Wall seconds spent picking buckets (policy + harvest).")
  w.sample("serve_scheduler_pick_seconds_total", sched["pick_seconds"])

  # estimator: live EWMA cells + drift against the static cost model
  w.family("serve_estimator_seconds", "gauge",
           "Warm per-request EWMA service seconds per "
           "(bucket, backend, schedule) cell.")
  w.family("serve_estimator_observations", "gauge",
           "Observations held by each estimator cell.")
  w.family("serve_estimator_drift_ratio", "gauge",
           "Measured EWMA / static cost-model prediction per cell: how far "
           "reality has drifted from the table (1.0 = model is exact).")
  for cell in state["estimator_cells"]:
    labels = dict(bucket=cell["bucket"], backend=cell["backend"],
                  schedule=cell["schedule"])
    w.sample("serve_estimator_seconds", cell["seconds"], **labels)
    w.sample("serve_estimator_observations", cell["observations"], **labels)
    if cell.get("drift") is not None:
      w.sample("serve_estimator_drift_ratio", cell["drift"], **labels)

  # circuit breakers: one gauge per (bucket, backend, schedule) arm
  w.family("serve_breaker_state", "gauge",
           "Circuit-breaker state per (bucket, backend, schedule) arm: "
           "0=closed, 1=open, 2=half_open.")
  w.family("serve_breaker_opens_total", "counter",
           "Times each arm's breaker opened.")
  w.family("serve_breaker_probes_total", "counter",
           "Half-open probe batches sent to each arm.")
  _breaker_gauge = {"closed": 0, "open": 1, "half_open": 2}
  for cell in state.get("breakers", ()):
    labels = dict(bucket=cell["bucket"], backend=cell["backend"],
                  schedule=cell["schedule"])
    w.sample("serve_breaker_state",
             _breaker_gauge.get(cell["state"], 0), **labels)
    w.sample("serve_breaker_opens_total", cell["opens"], **labels)
    w.sample("serve_breaker_probes_total", cell["probes"], **labels)

  trace = state["trace"]
  w.family("serve_trace_events_total", "counter",
           "Trace events recorded by the flight recorder.")
  w.sample("serve_trace_events_total", trace["recorded"])
  w.family("serve_trace_events_dropped_total", "counter",
           "Trace events evicted from the flight-recorder ring.")
  w.sample("serve_trace_events_dropped_total", trace["dropped"])
  w.family("serve_trace_enabled", "gauge",
           "Whether request-lifecycle tracing is on (1) or off (0).")
  w.sample("serve_trace_enabled", 1 if trace["enabled"] else 0)

  return w.text()
