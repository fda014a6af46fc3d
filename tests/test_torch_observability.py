"""The port's observability layer on the CPU: flight-recorder ring, Chrome
trace validity across every request outcome, Prometheus exposition grammar
and golden rendering, thread safety under live serving, the HTTP endpoint
and the flags of launch/serve_mmo.py.

The reference's tests (tests/test_observability.py) run here on the
port's engine with ``device="cpu"``; ``render_prometheus`` must reproduce
``tests/data/golden_metrics.prom`` byte for byte, and one mixed stream
under ``conftest.FakeClock`` must give the reference's sequence of trace
event names and the reference's exposition text.  Servers bind port 0;
every engine started here is stopped and every thread joined.
"""
import json
import os
import re
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import FakeClock  # noqa: E402
from repro import serve_mmo as jserve  # noqa: E402
from repro.serve_mmo.exposition import \
    render_prometheus as j_render  # noqa: E402
from repro_torch import serve_mmo as tserve  # noqa: E402
from repro_torch.apps import graphs  # noqa: E402
from repro_torch.serve_mmo import (DeadlineExceededError, MMOEngine,  # noqa: E402
                                   RejectedError, apsp_request, mmo_request)
from repro_torch.serve_mmo.exposition import (HISTOGRAM_BOUNDS_S,  # noqa: E402
                                              LogHistogram,
                                              escape_label_value,
                                              render_prometheus)
from repro_torch.serve_mmo.httpd import (PROMETHEUS_CONTENT_TYPE,  # noqa: E402
                                         ObservabilityServer)
from repro_torch.serve_mmo.metrics import (RollingWindow,  # noqa: E402
                                           ServeMetrics, bucket_label)
from repro_torch.serve_mmo.observability import (  # noqa: E402
    MAX_ITERATION_SLICES, FlightRecorder)
from repro_torch.serve_mmo.scheduler import (BucketKey,  # noqa: E402
                                             request_bucket)

RNG = np.random.default_rng(0)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _engine(**kw):
  kw.setdefault("backend", "xla")
  kw.setdefault("device", "cpu")
  return MMOEngine(**kw)


def _mmo_req(n=12):
  a = RNG.standard_normal((n, n)).astype(np.float32)
  b = RNG.standard_normal((n, n)).astype(np.float32)
  return mmo_request(a, b, op="minplus")


def _apsp_req(n=12, seed=0):
  return apsp_request(graphs.weighted_digraph(n, 0.3, seed=seed))


def _async_request_events(events):
  """The trace's nestable async request events, grouped (id, name) → evs."""
  grouped = {}
  for ev in events:
    if ev.get("cat") == "request" and ev["ph"] in ("b", "e"):
      grouped.setdefault((ev["id"], ev["name"]), []).append(ev)
  return grouped


def _assert_balanced(events):
  """Every async request slice alternates open/close with equal counts,
  each end at or after its begin; ``queued`` happens once, ``execute``
  once per attempt."""
  for (rid, name), evs in _async_request_events(events).items():
    phs = [ev["ph"] for ev in evs]
    assert phs == ["b", "e"] * (len(phs) // 2) and phs, \
        f"request {rid} slice {name!r} unbalanced: {phs}"
    for b, e in zip(evs[::2], evs[1::2]):
      assert b["ts"] <= e["ts"]
    if name == "queued":
      assert phs == ["b", "e"], f"request {rid} queued slice re-opened"


# ---------------------------------------------------------------------------
# flight recorder mechanics
# ---------------------------------------------------------------------------


def test_ring_bounds_memory_and_reports_drops():
  rec = FlightRecorder(capacity=10, clock=FakeClock())
  for i in range(25):
    rec.instant(f"ev{i}")
  st = rec.stats()
  assert st["live"] == 10 and st["recorded"] == 25 and st["dropped"] == 15
  assert [ev["name"] for ev in rec.events()] == \
      [f"ev{i}" for i in range(15, 25)]
  rec.clear()
  assert rec.stats() == {"enabled": True, "capacity": 10, "recorded": 0,
                         "live": 0, "dropped": 0}


def test_disabled_recorder_records_nothing():
  rec = FlightRecorder(capacity=16, clock=FakeClock(), enabled=False)
  rec.request_begin(1, kind="mmo", op="mma", tenant="t")
  rec.request_picked(1)
  rec.request_end(1, "done", executing=True)
  rec.request_rejected(2, "queue_full", kind="mmo", op="mma", tenant="t")
  rec.arena_admit(3, slot=0, bucket="b")
  rec.arena_tick("b", live=1, evicted=0, g=4, t0_s=0.0, t1_s=0.1)
  rec.batch_complete(label="b", scheduled_s=0.0, stacked_s=0.1,
                     executed_s=0.2, device_s=0.3, completed_s=0.4,
                     backend="xla", schedule="local", batch=1, padded=1,
                     h2d_bytes=0, cache_hit=True, request_ids=[1],
                     arrivals_s=[0.0])
  rec.instant("nope")
  assert rec.stats()["recorded"] == 0 and rec.events() == []


def test_recorder_rejects_nonpositive_capacity():
  with pytest.raises(ValueError):
    FlightRecorder(capacity=0)


def test_lifecycle_timestamps_come_from_injected_clock():
  clock = FakeClock(1.0)
  rec = FlightRecorder(clock=clock)
  rec.request_begin(7, kind="closure", op="minplus", tenant="alpha")
  clock.t = 1.5
  rec.request_picked(7)
  clock.t = 2.25
  rec.request_end(7, "done", executing=True)
  evs = rec.events()
  assert [ev["ts"] for ev in evs] == [1.0e6, 1.5e6, 1.5e6, 2.25e6]
  _assert_balanced(evs)
  assert evs[0]["args"] == {"kind": "closure", "op": "minplus",
                            "tenant": "alpha"}
  assert evs[-1]["args"]["outcome"] == "done"


def test_batch_complete_emits_the_reference_events():
  """Phase spans, apportioned iteration slices and per-request completion
  args, event for event as the reference's recorder emits them (tids
  aside)."""
  def emit(mod):
    rec = mod.FlightRecorder(clock=FakeClock())
    rec.request_begin(1, kind="closure", op="minplus", tenant="t", t_s=0.0)
    rec.request_begin(2, kind="closure", op="minplus", tenant="t", t_s=0.1)
    rec.batch_complete(label="closure/minplus/16/float32",
                       scheduled_s=1.0, stacked_s=1.1, executed_s=1.3,
                       device_s=1.7, completed_s=1.8, backend="xla",
                       schedule="local", batch=2, padded=2, h2d_bytes=2048,
                       cache_hit=True, request_ids=[1, 2],
                       arrivals_s=[0.0, 0.1], iterations=[3, 5])
    return [{k: v for k, v in ev.items() if k != "tid"}
            for ev in rec.events()]

  evs = emit(tserve)
  assert evs == emit(jserve)
  _assert_balanced(evs)
  phases = {ev["name"]: ev for ev in evs
            if ev["ph"] == "X" and not ev["name"].startswith("squaring")}
  assert set(phases) == {"pad_and_stack", "resolve_compile",
                         "device_compute", "split_results"}
  assert phases["device_compute"]["dur"] == pytest.approx(0.4e6)
  assert phases["device_compute"]["args"]["iterations"] == [3, 5]
  slices = [ev for ev in evs if ev["name"].startswith("squaring_iter")]
  assert len(slices) == 5
  assert all(ev["args"]["apportioned"] is True for ev in slices)
  assert sum(ev["dur"] for ev in slices) == pytest.approx(0.4e6)
  done = [ev for ev in evs if ev.get("cat") == "request"
          and ev["ph"] == "e" and ev["name"] == "execute"]
  assert {ev["id"]: ev["args"]["latency_ms"] for ev in done} == \
      {1: pytest.approx(1800.0), 2: pytest.approx(1700.0)}


def test_iteration_slices_are_capped():
  rec = FlightRecorder(clock=FakeClock())
  rec.batch_complete(label="b", scheduled_s=0.0, stacked_s=0.0,
                     executed_s=0.0, device_s=1.0, completed_s=1.0,
                     backend="xla", schedule="local", batch=1, padded=1,
                     h2d_bytes=0, cache_hit=True, request_ids=[],
                     arrivals_s=[], iterations=[1000])
  slices = [ev for ev in rec.events()
            if ev["name"].startswith("squaring_iter")]
  assert len(slices) == MAX_ITERATION_SLICES


def test_export_is_json_serializable_chrome_trace():
  rec = FlightRecorder(clock=FakeClock())
  rec.instant("hello", args={"k": 1})
  doc = json.loads(json.dumps(rec.export()))
  assert doc["displayTimeUnit"] == "ms"
  assert doc["traceEvents"][0] == {
      "ph": "M", "pid": 1, "name": "process_name",
      "args": {"name": "serve_mmo engine"}}
  assert doc["traceEvents"][1]["name"] == "hello"


# ---------------------------------------------------------------------------
# engine integration: one trace per request outcome
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served_engine():
  """One engine that served a small mixed workload (mmo + closure buckets),
  shared by the trace/exposition assertions below."""
  engine = _engine(max_batch=4)
  futs = [engine.submit(r) for r in
          [_mmo_req(), _mmo_req(), _apsp_req(seed=1), _apsp_req(seed=2)]]
  engine.run_until_idle()
  for f in futs:
    assert f.done()
  return engine


def test_live_trace_is_balanced_and_loads_as_json(served_engine):
  doc = json.loads(json.dumps(served_engine.export_trace()))
  evs = doc["traceEvents"]
  _assert_balanced(evs)
  for ev in evs:
    if ev["ph"] == "X":
      assert ev["dur"] >= 0.0
  names = {ev["name"] for ev in evs}
  assert {"pad_and_stack", "resolve_compile", "device_compute",
          "split_results", "queued", "execute"} <= names
  closure_devs = [ev for ev in evs if ev["name"] == "device_compute"
                  and "iterations" in ev.get("args", {})]
  assert closure_devs and all(
      min(ev["args"]["iterations"]) >= 1 for ev in closure_devs)
  assert any(ev["name"].startswith("squaring_iter") for ev in evs)
  done = [ev for ev in evs if ev.get("cat") == "request"
          and ev["ph"] == "e" and ev["name"] == "execute"]
  assert len(done) == 4
  assert all(ev["args"]["outcome"] == "done" for ev in done)


def test_trace_records_expired_requests():
  clock = FakeClock()
  engine = _engine(clock=clock)
  fut = engine.submit(_mmo_req())
  doomed = _mmo_req()
  doomed.deadline_s = 0.5
  fut2 = engine.submit(doomed)
  clock.t = 2.0  # past the deadline before any batch runs
  engine.run_until_idle()
  assert fut.done()
  with pytest.raises(DeadlineExceededError):
    fut2.result(timeout=5)
  evs = engine.export_trace()["traceEvents"]
  _assert_balanced(evs)
  ends = {ev["id"]: ev["args"]["outcome"] for ev in evs
          if ev.get("cat") == "request" and ev["ph"] == "e"
          and "args" in ev}
  assert "expired" in ends.values() and "done" in ends.values()
  expired_id = next(i for i, o in ends.items() if o == "expired")
  assert (expired_id, "execute") not in _async_request_events(evs)


def test_trace_records_failed_batches():
  engine = _engine(retry_backoff_s=0.0)

  def boom(*a, **kw):
    raise RuntimeError("poisoned compile")

  engine.cache.get_or_compile = boom
  fut = engine.submit(_mmo_req())
  engine.run_until_idle()
  with pytest.raises(RuntimeError):
    fut.result(timeout=5)
  evs = engine.export_trace()["traceEvents"]
  _assert_balanced(evs)
  fails = [ev for ev in evs if ev.get("cat") == "request"
           and ev["ph"] == "e" and ev["name"] == "execute"]
  assert fails
  assert all(ev["args"]["outcome"] == "retried" for ev in fails[:-1])
  assert fails[-1]["args"] == {"outcome": "failed", "error": "RuntimeError"}
  assert any(ev["name"] == "batch_fail" for ev in evs)


def test_trace_records_rejections_as_instants():
  engine = _engine(max_queue=1)
  kept = engine.submit(_mmo_req())
  with pytest.raises(RejectedError):
    engine.submit(_mmo_req()).result(timeout=5)
  engine.run_until_idle()
  assert kept.done()
  evs = engine.export_trace()["traceEvents"]
  _assert_balanced(evs)
  rejects = [ev for ev in evs if ev["name"] == "reject"]
  assert len(rejects) == 1
  assert rejects[0]["ph"] == "i"
  assert rejects[0]["args"]["reason"] == "queue_full"


def test_trace_off_engine_records_nothing():
  engine = _engine(trace=False)
  fut = engine.submit(_mmo_req())
  engine.run_until_idle()
  assert fut.done()
  assert engine.tracer.stats()["recorded"] == 0
  assert len(engine.export_trace()["traceEvents"]) == 1  # metadata only
  text = render_prometheus(engine.observability_state())
  assert "serve_trace_enabled 0" in text


def _specs():
  rng = np.random.default_rng(3)
  out = []
  for i in range(12):
    kind = ("apsp", "reach", "mmo", "knn")[i % 4]
    out.append((kind, int(rng.integers(9, 30)), int(rng.integers(2 ** 31)),
                {"deadline_s": 0.5} if i == 5 else {}))
  return out


def _request(api, spec):
  kind, n, seed, qos = spec
  if kind == "apsp":
    return api.apsp_request(graphs.weighted_digraph(n, 0.3, seed=seed), **qos)
  if kind == "reach":
    return api.reachability_request(graphs.boolean_digraph(n, 0.1, seed=seed),
                                    **qos)
  if kind == "knn":
    ref, qry = graphs.knn_points(4 * n, n, 16, seed=seed)
    return api.knn_request(qry, ref, k=4, **qos)
  rng = np.random.default_rng(seed)
  a = rng.standard_normal((n, n)).astype(np.float32)
  return api.mmo_request(a, a.T.copy(), op="minplus", **qos)


def _serve_traced(api, render, mode):
  clock = FakeClock()
  kw = dict(backend="xla", max_batch=4, clock=clock, max_queue=11,
            mode=mode, arena_capacity=2, arena_g=2)
  if api is tserve:
    kw["device"] = "cpu"
  eng = api.MMOEngine(**kw)
  futs = [eng.submit(_request(api, s)) for s in _specs()]
  clock.t = 1.0  # the deadline-tagged request expires in the queue
  eng.run_until_idle()
  states = [f.state for f in futs]
  names = [ev["name"] for ev in eng.export_trace()["traceEvents"]]
  return states, names, render(eng.observability_state())


@pytest.mark.parametrize("mode", ["batch", "arena"])
def test_trace_and_exposition_match_the_reference_engine(mode):
  """One stream (a rejection, an expiry, closures in arena mode) through
  both engines on one fake clock: the same outcomes, the same trace event
  names in the same order, and the same Prometheus text but for the
  scheduler's pick seconds (host time) and the estimator, which the
  reference fills at a build's first run and the port only from the
  second."""
  want = _serve_traced(jserve, j_render, mode)
  got = _serve_traced(tserve, render_prometheus, mode)
  assert got[0] == want[0]
  assert {"rejected", "expired", "done"} <= set(got[0])
  assert got[1] == want[1]
  if mode == "arena":
    assert "arena_tick" in got[1]

  def stable(text):
    return [line for line in text.splitlines()
            if not line.startswith(("serve_scheduler_pick_seconds_total",
                                    "serve_estimator_"))]

  assert stable(got[2]) == stable(want[2])


# ---------------------------------------------------------------------------
# Prometheus exposition: grammar, histograms, golden rendering
# ---------------------------------------------------------------------------

_METRIC_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^{}]*)\})?"
    r" (?P<value>[^ ]+)$")
_LABEL_RE = re.compile(r'^[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\["\\n])*"$')


def _parse_exposition(text: str):
  """Validate Prometheus text-format 0.0.4 line by line; returns
  (families, samples)."""
  assert text.endswith("\n")
  families, helped, samples = {}, set(), []
  for line in text.splitlines():
    if line.startswith("# HELP "):
      name = line.split(" ", 3)[2]
      assert _METRIC_RE.match(name)
      assert name not in helped, f"duplicate HELP for {name}"
      helped.add(name)
    elif line.startswith("# TYPE "):
      _, _, name, mtype = line.split(" ", 3)
      assert _METRIC_RE.match(name)
      assert mtype in ("counter", "gauge", "histogram", "summary", "untyped")
      assert name not in families, f"duplicate TYPE for {name}"
      assert name in helped, f"TYPE for {name} precedes its HELP"
      families[name] = mtype
    else:
      m = _SAMPLE_RE.match(line)
      assert m, f"malformed sample line: {line!r}"
      labels = {}
      if m.group("labels"):
        for pair in re.split(r",(?=[a-zA-Z_])", m.group("labels")):
          assert _LABEL_RE.match(pair), f"malformed label: {pair!r}"
          k, v = pair.split("=", 1)
          labels[k] = v[1:-1]
      value = m.group("value")
      fval = {"+Inf": float("inf"), "-Inf": float("-inf")}.get(value)
      samples.append((m.group("name"), labels,
                      fval if fval is not None else float(value)))
  return families, samples


def test_live_exposition_parses_and_histograms_are_cumulative(served_engine):
  text = render_prometheus(served_engine.observability_state())
  families, samples = _parse_exposition(text)
  for name, _, _ in samples:
    base = re.sub(r"_(bucket|sum|count)$", "", name)
    assert name in families or base in families, f"undeclared sample {name}"
  assert families["serve_submitted_total"] == "counter"
  assert families["serve_queue_depth"] == "gauge"
  assert families["serve_service_seconds"] == "histogram"
  by_name: dict = {}
  for name, labels, value in samples:
    by_name.setdefault(name, []).append((labels, value))
  assert by_name["serve_submitted_total"] == [({}, 4)]
  hname = "serve_service_seconds"
  series: dict = {}
  for labels, value in by_name[f"{hname}_bucket"]:
    series.setdefault(labels["bucket"], []).append((labels["le"], value))
  counts = {labels["bucket"]: value
            for labels, value in by_name[f"{hname}_count"]}
  assert series and set(series) == set(counts)
  for blabel, buckets in series.items():
    values = [v for _, v in buckets]
    assert values == sorted(values), f"non-cumulative histogram {blabel}"
    assert dict(buckets)["+Inf"] == counts[blabel]
    assert len(buckets) == len(HISTOGRAM_BOUNDS_S) + 1


def test_exposition_includes_estimator_drift():
  """The port observes a batch function from its second run on, so the
  engine serves the stream twice before its cells report drift."""
  engine = _engine(max_batch=4)
  for _ in range(2):
    for r in [_mmo_req(), _apsp_req(seed=1), _apsp_req(seed=2)]:
      engine.submit(r)
    engine.run_until_idle()
  _, samples = _parse_exposition(
      render_prometheus(engine.observability_state()))
  drift = [(labels, v) for name, labels, v in samples
           if name == "serve_estimator_drift_ratio"]
  assert drift, "served engine must report estimator drift cells"
  for labels, v in drift:
    assert {"bucket", "backend", "schedule"} <= set(labels)
    assert v > 0.0


def _golden_state():
  q1 = [0] * 23
  q1[8], q1[10] = 3, 1
  s1 = [0] * 23
  s1[12] = 4
  q2 = [0] * 23
  q2[5] = 2
  return {
      "metrics": {
          "uptime_s": 12.5,
          "counters": {"submitted": 9, "completed": 6, "rejected": 1,
                       "expired": 1, "failed": 1, "batches": 3,
                       "h2d_bytes": 4096, "retries": 3},
          "rejected_by_reason": {"queue_full": 1},
          "batch_failures_by_kind": {"execute": 2, "nonfinite": 1},
          "histogram_bounds_s": list(HISTOGRAM_BOUNDS_S),
          "buckets": {
              "closure/minplus/16/float32": {
                  "completed": 4, "expired": 1, "failed": 0,
                  "histograms": {"queue": (q1, 0.0421, 4),
                                 "service": (s1, 0.0631, 4)}},
              "mmo/mma/16x16x16/float32+float16": {
                  "completed": 2, "expired": 0, "failed": 1,
                  "histograms": {"queue": (q2, 0.0015, 2)}},
          },
      },
      "queue_depth": 2,
      "executing": 1,
      "admission": {"queued": 2, "backlog_s": 0.25, "evaluations": 9,
                    "inflight": {"alpha": 2, "beta": 1},
                    "rejections": {"queue_full": 1},
                    "limits": {"max_queue": 64, "tenant_quota": None,
                               "max_backlog_s": None}},
      "cache": {"executables": 5, "hits": 12, "misses": 5,
                "compile_s": 1.5},
      "scheduler": {"picks": 3, "pick_seconds": 0.004},
      "estimator_cells": [
          {"bucket": "closure/minplus/16/float32", "backend": "xla",
           "schedule": "local", "seconds": 0.002, "observations": 4,
           "drift": 1.25}],
      "breakers": [
          {"bucket": "closure/minplus/16/float32", "backend": "xla",
           "schedule": "local", "state": "open",
           "consecutive_failures": 5, "opens": 1, "closes": 0, "probes": 0},
          {"bucket": "closure/minplus/16/float32", "backend": "vector",
           "schedule": "local", "state": "closed",
           "consecutive_failures": 0, "opens": 0, "closes": 0, "probes": 1}],
      "trace": {"enabled": True, "capacity": 65536, "recorded": 120,
                "live": 120, "dropped": 0},
  }


def test_golden_exposition_rendering():
  """The full rendered text of one synthetic state, byte for byte the
  reference's golden file."""
  text = render_prometheus(_golden_state())
  _parse_exposition(text)
  with open(os.path.join(ROOT, "tests", "data", "golden_metrics.prom"),
            encoding="utf-8") as f:
    assert text == f.read()


def test_log_histogram_drops_bogus_values():
  h = LogHistogram()
  for bad in (float("nan"), float("inf"), -1.0):
    h.add(bad)
  assert h.count == 0
  h.add(0.0)
  h.add(1e-5)   # at the first boundary → first bucket (le is inclusive)
  h.add(100.0)  # beyond the top bound → overflow slot
  counts, total, n = h.state()
  assert n == 3 and counts[0] == 2 and counts[-1] == 1
  assert total == pytest.approx(100.00001)


def test_escape_label_value():
  assert escape_label_value('a"b\\c\nd') == 'a\\"b\\\\c\\nd'


# ---------------------------------------------------------------------------
# metrics satellites: strict-JSON empty windows, mixed-dtype bucket labels
# ---------------------------------------------------------------------------


def test_empty_window_percentiles_are_null_not_nan():
  assert RollingWindow().percentile(50) is None
  metrics = ServeMetrics()
  metrics.on_expire(request_bucket(_mmo_req()))
  snap = metrics.snapshot(queue_depth=0, executing=0)
  text = json.dumps(snap, allow_nan=False)  # raises on NaN/Inf
  (bucket,) = snap["buckets"].values()
  assert bucket["queue_ms"] == {"p50": None, "p99": None}
  assert json.loads(text)["counters"]["expired"] == 1


def test_bucket_label_spells_out_mixed_dtypes():
  uniform = BucketKey(kind="mmo", op="mma", shape=(16, 16, 16),
                      dtypes=("float32", "float32"), params=())
  mixed_a = BucketKey(kind="mmo", op="mma", shape=(16, 16, 16),
                      dtypes=("float32", "float16"), params=())
  mixed_b = BucketKey(kind="mmo", op="mma", shape=(16, 16, 16),
                      dtypes=("float32", "bfloat16"), params=())
  assert bucket_label(uniform) == "mmo/mma/16x16x16/float32"
  assert bucket_label(mixed_a) == "mmo/mma/16x16x16/float32+float16"
  assert bucket_label(mixed_a) != bucket_label(mixed_b)


# ---------------------------------------------------------------------------
# thread safety: snapshots + renders + trace exports against a live engine
# ---------------------------------------------------------------------------


def test_concurrent_observability_reads_during_serving():
  """Every observability read path from 4 threads while 4 more submit and
  the serving loop runs: no exceptions, every read parseable, all traffic
  completes, every thread joined."""
  engine = _engine(max_batch=4)
  reqs = [_mmo_req() for _ in range(12)] + \
         [_apsp_req(seed=s) for s in range(4)]
  engine.prewarm(reqs)
  engine.start()
  errs, futures = [], []
  barrier = threading.Barrier(8)

  def submitter(i):
    try:
      barrier.wait(timeout=30)
      for r in reqs[i::4]:
        futures.append(engine.submit(r))
    except Exception as e:  # noqa: BLE001
      errs.append(e)

  def reader(i):
    try:
      barrier.wait(timeout=30)
      for _ in range(25):
        json.dumps(engine.metrics_snapshot(), default=float,
                   allow_nan=False)
        _parse_exposition(render_prometheus(engine.observability_state()))
        json.dumps(engine.export_trace())
    except Exception as e:  # noqa: BLE001
      errs.append(e)

  threads = [threading.Thread(target=submitter, args=(i,)) for i in range(4)]
  threads += [threading.Thread(target=reader, args=(i,)) for i in range(4)]
  try:
    for t in threads:
      t.start()
    for t in threads:
      t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for f in futures:
      f.result(timeout=120)
  finally:
    engine.stop()
  assert not errs
  assert len(futures) == len(reqs) and all(f.done() for f in futures)
  _assert_balanced(engine.export_trace()["traceEvents"])


# ---------------------------------------------------------------------------
# HTTP endpoint
# ---------------------------------------------------------------------------


def test_http_endpoint_serves_all_routes(served_engine):
  with ObservabilityServer(served_engine, port=0) as srv:
    assert srv.port != 0

    def get(path):
      with urllib.request.urlopen(f"{srv.url}{path}", timeout=10) as resp:
        return resp.status, resp.headers.get("Content-Type"), \
            resp.read().decode("utf-8")

    status, ctype, body = get("/metrics")
    assert status == 200 and ctype == PROMETHEUS_CONTENT_TYPE
    families, _ = _parse_exposition(body)
    assert "serve_completed_total" in families

    status, ctype, body = get("/healthz")
    assert status == 200 and ctype == "application/json"
    health = json.loads(body)
    assert health["status"] == "ok" and health["pending"] == 0

    status, _, body = get("/snapshot")
    assert status == 200
    assert json.loads(body)["counters"]["completed"] == 4

    status, _, body = get("/trace")
    assert status == 200
    _assert_balanced(json.loads(body)["traceEvents"])

    with pytest.raises(urllib.error.HTTPError) as err:
      get("/nope")
    assert err.value.code == 404


# ---------------------------------------------------------------------------
# launch/serve_mmo.py: the metrics ticker on stderr, faults and the trace file
# ---------------------------------------------------------------------------


def test_launch_driver_faults_trace_and_ticker(tmp_path):
  """launch/serve_mmo.py in a subprocess, one second of traffic on the CPU:
  the ticker writes to stderr only, injected faults are ridden out, and the
  trace file is balanced Chrome-trace JSON."""
  env = dict(os.environ, PYTHONPATH="src")
  trace = tmp_path / "trace.json"
  proc = subprocess.run(
      [sys.executable, "-m", "repro_torch.launch.serve_mmo", "--device",
       "cpu", "--rate", "30", "--duration", "1", "--sizes", "12",
       "--max-batch", "4", "--metrics-every", "0.3", "--inject-faults",
       "execute:transient:2", "--transient-retries", "2", "--trace-out",
       str(trace), "--http-port", "0"],
      capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
  assert proc.returncode == 0, proc.stderr
  assert "[serve_mmo][metrics]" not in proc.stdout
  assert "'failed': 0" in proc.stdout
  assert "resilience: retries=2 batch_failures={'execute': 2}" in proc.stdout
  ticks = [line for line in proc.stderr.splitlines()
           if line.startswith("[serve_mmo][metrics] ")]
  assert ticks, "ticker produced no stderr snapshots"
  for line in ticks:
    snap = json.loads(line.split(" ", 1)[1])
    assert "counters" in snap and "queue_depth" in snap
  _assert_balanced(json.loads(trace.read_text())["traceEvents"])
