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
import contextlib
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
from fixtures import closure_corpus as corpus  # noqa: E402
from repro_torch.core import closure as tcl  # noqa: E402
from repro_torch.core import stamps as stage_hook  # noqa: E402
from repro_torch.kernels import closure_megakernel as tmk  # noqa: E402
from repro_torch.serve_mmo import (DeadlineExceededError, FaultInjector,  # noqa: E402
                                   FaultRule, MMOEngine, RejectedError,
                                   apsp_request, knn_request, mmo_request)
from repro_torch.serve_mmo import engine as engine_mod  # noqa: E402
from repro_torch.serve_mmo.exposition import (HISTOGRAM_BOUNDS_S,  # noqa: E402
                                              LogHistogram,
                                              escape_label_value,
                                              render_prometheus)
from repro_torch.serve_mmo.httpd import (PROMETHEUS_CONTENT_TYPE,  # noqa: E402
                                         ObservabilityServer)
from repro_torch.serve_mmo.metrics import (RollingWindow,  # noqa: E402
                                           ServeMetrics, bucket_label)
from repro_torch.serve_mmo.observability import (  # noqa: E402
    DEVICE_TID, MAX_SYNC_SPANS, STAGES, BatchStamps, FlightRecorder)
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


def _stamped(times, *, select=False, syncs=(), copies=2):
  """A ``BatchStamps`` walked through one batch on a fake clock: ``times``
  gives the clock at each call in order (stack start/end, then the device
  boundaries H2D, COMPUTE, [SELECT,] D2H, END, then the nan scan and split
  starts and ends); each sync in ``syncs`` takes (start, end)."""
  clock = FakeClock()
  st = BatchStamps(None, clock)
  st.begin()
  it = iter(times)
  st.span("stack", next(it), next(it))
  bounds = [st.H2D, st.COMPUTE] + ([st.SELECT] if select else [])
  for b in bounds:
    clock.t = next(it)
    st.boundary(b)
  for t0, t1 in syncs:
    ticks = iter((t0, t1))
    st._clock = lambda: next(ticks)
    assert st.sync(torch.tensor(True), bool) is True
  st._clock = clock
  for b in (st.D2H, st.END):
    clock.t = next(it)
    st.boundary(b)
  st.span("nan_scan", next(it), next(it))
  st.span("split", next(it), next(it))
  return st.read(copies)


def test_batch_complete_emits_the_reference_events():
  """Phase spans and per-request completion args, event for event as the
  reference's recorder emits them (tids aside), except the reference's
  apportioned squaring slices: the port stamps each sync where it runs,
  and emits its stage spans, host and device, nested in their phases."""
  def emit(mod, **kw):
    rec = mod.FlightRecorder(clock=FakeClock())
    rec.request_begin(1, kind="closure", op="minplus", tenant="t", t_s=0.0)
    rec.request_begin(2, kind="closure", op="minplus", tenant="t", t_s=0.1)
    rec.batch_complete(label="closure/minplus/16/float32",
                       scheduled_s=1.0, stacked_s=1.1, executed_s=1.3,
                       device_s=1.7, completed_s=1.8, backend="xla",
                       schedule="local", batch=2, padded=2, h2d_bytes=2048,
                       cache_hit=True, request_ids=[1, 2],
                       arrivals_s=[0.0, 0.1], iterations=[3, 5], **kw)
    return [{k: v for k, v in ev.items() if k != "tid"}
            for ev in rec.events()]

  want = [ev for ev in emit(jserve)
          if not ev["name"].startswith("squaring_iter")]
  evs = emit(tserve)
  assert evs == want
  _assert_balanced(evs)
  phases = {ev["name"]: ev for ev in evs if ev["ph"] == "X"}
  assert set(phases) == {"pad_and_stack", "resolve_compile",
                         "device_compute", "split_results"}
  assert phases["device_compute"]["dur"] == pytest.approx(0.4e6)
  assert phases["device_compute"]["args"]["iterations"] == [3, 5]
  done = [ev for ev in evs if ev.get("cat") == "request"
          and ev["ph"] == "e" and ev["name"] == "execute"]
  assert {ev["id"]: ev["args"]["latency_ms"] for ev in done} == \
      {1: pytest.approx(1800.0), 2: pytest.approx(1700.0)}

  rec = _stamped([1.0, 1.05, 1.31, 1.35, 1.6, 1.69, 1.71, 1.75, 1.76, 1.79],
                 syncs=[(1.4, 1.41), (1.5, 1.52)])
  staged = emit(tserve, stages=rec)
  spans = [ev for ev in staged if ev.get("cat") in ("stage", "device")]
  assert [ev for ev in staged if ev not in spans] == evs
  got = sorted((ev["cat"], ev["name"], round(ev["ts"]), round(ev["dur"]))
               for ev in spans)
  assert got == sorted([
      ("stage", "stack", 1_000_000, 50_000),
      ("stage", "h2d", 1_310_000, 40_000),
      ("stage", "sync", 1_400_000, 10_000),
      ("stage", "sync", 1_500_000, 20_000),
      ("stage", "nan_scan", 1_710_000, 40_000),
      ("stage", "split", 1_760_000, 30_000),
      ("device", "h2d", 1_310_000, 40_000),
      ("device", "compute", 1_350_000, 250_000),
      ("device", "d2h", 1_600_000, 90_000)])
  assert rec.syncs == 4   # two fixpoint checks, two output copies
  assert sorted(n for n, _ in rec.seconds) == sorted(
      ["stack", "h2d", "compute", "d2h", "sync", "sync", "nan_scan",
       "split"])


def test_iteration_slices_are_capped():
  """The stamped syncs that replaced the apportioned iteration slices:
  a batch emits at most ``MAX_SYNC_SPANS`` sync spans, and the metrics
  still observe every sync."""
  n = 1000
  rec = _stamped([0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
                 syncs=[(0.001 * i, 0.001 * i + 0.0005) for i in range(n)],
                 copies=2)
  assert rec.syncs == n + 2
  assert sum(1 for name, _ in rec.seconds if name == "sync") == n
  recorder = FlightRecorder(clock=FakeClock())
  recorder.batch_complete(label="b", scheduled_s=0.0, stacked_s=0.0,
                          executed_s=0.0, device_s=1.0, completed_s=1.0,
                          backend="xla", schedule="local", batch=1,
                          padded=1, h2d_bytes=0, cache_hit=True,
                          request_ids=[], arrivals_s=[], iterations=[n],
                          stages=rec)
  syncs = [ev for ev in recorder.events() if ev["name"] == "sync"]
  assert len(syncs) == MAX_SYNC_SPANS
  assert not any(ev["name"].startswith("squaring_iter")
                 for ev in recorder.events())


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
  assert any(ev["name"] == "sync" for ev in evs)
  assert not any(ev["name"].startswith("squaring_iter") for ev in evs)
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


# ---------------------------------------------------------------------------
# stage stamps: each stage of a batch where it runs
# ---------------------------------------------------------------------------

# each stage span's phase span
_PARENT = {"stack": "pad_and_stack", "h2d": "device_compute",
           "compute": "device_compute", "select": "device_compute",
           "sync": "device_compute", "d2h": "device_compute",
           "nan_scan": "split_results", "split": "split_results"}


def _knn_req(seed=0):
  ref, qry = graphs.knn_points(48, 12, 8, seed=seed)
  return knn_request(qry, ref, k=3)


def _stage_hists(engine) -> dict:
  """bucket label → {window: (sum s, observations)} of every histogram."""
  state = engine.observability_state()["metrics"]
  return {label: {name: (h[1], h[2]) for name, h in b["histograms"].items()}
          for label, b in state["buckets"].items()}


@contextlib.contextmanager
def _counted_fixpoints():
  """Count the closure fixpoint loops' host synchronisations from their
  steps, per batch, in order: the dispatch loop syncs before each step and
  once more when it stops early, the fused arm once after each chunk."""
  per_batch, seen = [], []
  orig_step, orig_chunk = tcl._fixpoint_step, tmk.fixpoint_chunk
  orig_loop, orig_mk = tcl._batched_fixpoint, tmk.megakernel_fixpoint

  def step(state, step_fn):
    seen.append(stage_hook.current())
    per_batch[-1][0] += 1
    return orig_step(state, step_fn)

  def chunk(*a, **kw):
    seen.append(stage_hook.current())
    per_batch[-1][0] += 1
    return orig_chunk(*a, **kw)

  def loop(adj, step_fn, max_iters, valid_n=None):
    per_batch.append([0, max_iters, "dispatch"])
    return orig_loop(adj, step_fn, max_iters, valid_n=valid_n)

  def fused(adj, **kw):
    per_batch.append([0, None, "fused"])
    return orig_mk(adj, **kw)

  tcl._fixpoint_step, tmk.fixpoint_chunk = step, chunk
  tcl._batched_fixpoint, tmk.megakernel_fixpoint = loop, fused
  try:
    yield per_batch, seen
  finally:
    tcl._fixpoint_step, tmk.fixpoint_chunk = orig_step, orig_chunk
    tcl._batched_fixpoint, tmk.megakernel_fixpoint = orig_loop, orig_mk


def _syncs_of(counted) -> int:
  steps, budget, arm = counted
  if arm == "fused":
    return steps
  return steps + (1 if steps < budget else 0)


def _nested(evs) -> None:
  """Every stage span lies inside one span of its phase; device stages on
  the device track, host stages on their phase's thread."""
  phases = [ev for ev in evs if ev["ph"] == "X" and ev.get("cat") == "batch"]
  stages = [ev for ev in evs if ev.get("cat") in ("stage", "device")]
  assert stages
  for st in stages:
    assert (st["tid"] == DEVICE_TID) == (st["cat"] == "device")
    homes = [ph for ph in phases if ph["name"] == _PARENT[st["name"]]
             and ph["ts"] - 1e-3 <= st["ts"]
             and st["ts"] + st["dur"] <= ph["ts"] + ph["dur"] + 1e-3
             and (st["cat"] == "device" or st["tid"] == ph["tid"])]
    assert len(homes) == 1, st


@pytest.mark.parametrize("backend", ["xla", "megakernel"])
def test_each_stage_is_observed_once_per_batch(backend):
  """Closure and KNN buckets: every stage histogram observes once per
  batch (the selection in KNN batches only), ``sync`` once per fixpoint
  synchronisation (closure batches only)."""
  engine = _engine(backend=backend, max_batch=2)
  with _counted_fixpoints() as (counted, _):
    futs = [engine.submit(r) for r in
            [_apsp_req(seed=s) for s in range(3)]
            + [_knn_req(s) for s in range(3)]]
    engine.run_until_idle()
  for f in futs:
    f.result(timeout=5)
  hists = _stage_hists(engine)
  kinds = {label.split("/")[0]: h for label, h in hists.items()}
  assert set(kinds) == {"closure", "knn"}
  for kind, h in kinds.items():
    batches = h["host"][1]
    assert batches == 2
    for name in ("stack", "h2d", "compute", "d2h", "nan_scan", "split"):
      assert h[name][1] == batches, (kind, name)
    if kind == "knn":
      assert h["select"][1] == batches and "sync" not in h
    else:
      assert "select" not in h
      assert h["sync"][1] == sum(_syncs_of(c) for c in counted)


def test_host_stages_never_exceed_host_time():
  engine = _engine(max_batch=2)
  for r in ([_apsp_req(seed=s) for s in range(3)]
            + [_knn_req(s) for s in range(2)] + [_mmo_req(), _mmo_req()]):
    engine.submit(r)
  engine.run_until_idle()
  for label, h in _stage_hists(engine).items():
    inner = sum(h[name][0] for name in ("stack", "nan_scan", "split"))
    assert 0.0 < inner <= h["host"][0], label


def test_every_stage_span_nests_in_its_phase(served_engine):
  evs = served_engine.export_trace()["traceEvents"]
  _nested(evs)
  names = {ev["name"] for ev in evs if ev.get("cat") == "device"}
  assert names == {"h2d", "compute", "d2h"}
  assert evs[-1] == {"ph": "M", "pid": 1, "tid": DEVICE_TID,
                     "name": "thread_name",
                     "args": {"name": "device (CUDA events)"}}


@pytest.mark.parametrize("backend", ["xla", "megakernel"])
def test_sync_spans_are_the_fixpoint_loops_syncs(backend):
  """One closure a batch: its sync spans are the syncs the wrapped loop
  made, on both arms; a Bellman-Ford line of 40 makes more than the cap,
  which holds while the histogram still sees every sync."""
  engine = _engine(backend=backend, max_batch=1)
  reqs = [_apsp_req(n=14, seed=s) for s in range(3)] + [
      apsp_request(corpus.line_graph(40), algorithm="bellman_ford")]
  with _counted_fixpoints() as (counted, _):
    for r in reqs:
      engine.submit(r)
      engine.run_until_idle()
  assert len(counted) == len(reqs)
  evs = engine.export_trace()["traceEvents"]
  _nested(evs)
  devs = [ev for ev in evs if ev["name"] == "device_compute"]
  assert len(devs) == len(reqs)
  want = [_syncs_of(c) for c in counted]
  got = [sum(1 for ev in evs if ev["name"] == "sync"
             and dev["ts"] <= ev["ts"] <= dev["ts"] + dev["dur"])
         for dev in devs]
  assert got == [min(w, MAX_SYNC_SPANS) for w in want]
  if backend == "xla":
    assert want[-1] > MAX_SYNC_SPANS
  observed = sum(h["sync"][1] for h in _stage_hists(engine).values())
  assert observed == sum(want)


def test_syncs_and_d2h_bytes_count_what_was_done(monkeypatch):
  copies, nbytes = [], []
  orig = engine_mod._outputs_to_numpy

  def to_numpy(out):
    host = orig(out)
    arrs = host if isinstance(host, tuple) else (host,)
    copies.append(len(arrs))
    nbytes.append(sum(a.nbytes for a in arrs))
    return host

  monkeypatch.setattr(engine_mod, "_outputs_to_numpy", to_numpy)
  engine = _engine(max_batch=2)
  with _counted_fixpoints() as (counted, _):
    for r in ([_apsp_req(seed=s) for s in range(3)]
              + [_knn_req(s) for s in range(2)] + [_mmo_req()]):
      engine.submit(r)
    engine.run_until_idle()
  counters = engine.metrics_snapshot()["counters"]
  assert len(copies) == counters["batches"] == 4
  assert counters["syncs"] == sum(copies) + sum(_syncs_of(c)
                                                for c in counted)
  assert counters["d2h_bytes"] == sum(nbytes) > 0


def test_trace_off_engine_stamps_nothing():
  """No stage span, no stage histogram, the hook unset inside the batch
  (a traced engine's batches see their stamps there); d2h bytes still
  count, syncs do not."""
  seen = {}
  for trace in (True, False):
    engine = _engine(trace=trace, max_batch=2)
    with _counted_fixpoints() as (_, hooks):
      for r in [_apsp_req(seed=1), _apsp_req(seed=2), _knn_req()]:
        engine.submit(r)
      engine.run_until_idle()
    seen[trace] = (engine, hooks)
  engine, hooks = seen[False]
  assert hooks and all(h is None for h in hooks)
  assert all(isinstance(h, BatchStamps) for h in seen[True][1])
  assert engine.tracer.stats()["recorded"] == 0
  for h in _stage_hists(engine).values():
    assert not set(h) & set(STAGES)
  counters = engine.metrics_snapshot()["counters"]
  assert counters["syncs"] == 0 and counters["d2h_bytes"] > 0
  assert engine._stamp_pool == []
  assert stage_hook.current() is None


def test_stamps_follow_a_batch_into_the_watchdog_worker():
  engine = _engine(watchdog_s=60.0, max_batch=2)
  threads = []
  orig = tcl._fixpoint_step

  def step(state, step_fn):
    threads.append((threading.current_thread().name,
                    stage_hook.current() is not None))
    return orig(state, step_fn)

  tcl._fixpoint_step = step
  try:
    futs = [engine.submit(_apsp_req(seed=s)) for s in range(2)]
    engine.run_until_idle()
  finally:
    tcl._fixpoint_step = orig
  for f in futs:
    f.result(timeout=5)
  assert threads and set(threads) == {("mmo-batch-watchdog", True)}
  assert stage_hook.current() is None   # never installed in this thread
  evs = engine.export_trace()["traceEvents"]
  assert any(ev["name"] == "sync" for ev in evs)
  _nested(evs)
  assert engine.join_abandoned(timeout=10.0) == 0


def test_stamps_are_pooled_and_a_timed_out_batch_keeps_its_set():
  """Batches reuse one set of stamps (no per-batch events); a batch the
  watchdog abandons keeps its set, so the next batch takes a new one."""
  inj = FaultInjector([FaultRule(point="slow", mode="transient", count=1,
                                 delay_s=0.5)])
  engine = _engine(max_batch=1, faults=inj, transient_retries=0,
                   bisect=False, breaker_threshold=None, watchdog_s=0.05)
  taken = []
  orig = engine._take_stamps

  def take():
    taken.append(orig())
    return taken[-1]

  engine._take_stamps = take
  first = engine.submit(_mmo_req())
  engine.run_until_idle()
  with pytest.raises(Exception):
    first.result(timeout=5)
  assert engine._stamp_pool == []          # the worker still holds it
  for _ in range(3):
    engine.submit(_mmo_req())
    engine.run_until_idle()
  assert len(taken) == 4
  assert taken[1] is not taken[0]
  assert taken[1] is taken[2] is taken[3]
  assert engine._stamp_pool == [taken[1]]
  assert engine.join_abandoned(timeout=10.0) == 0


def test_expired_request_names_the_batch_in_service():
  """An expiry's ``queued`` end carries its wait and the batch it waited
  behind: bucket, size and pick time on the engine clock."""
  clock = FakeClock()
  engine = _engine(clock=clock)
  bulk = engine.submit(_apsp_req(n=16, seed=4))
  doomed = _mmo_req()
  doomed.deadline_s = 0.5
  doomed_fut = engine.submit(doomed)
  orig = tcl._fixpoint_step

  def slow_step(state, step_fn):
    clock.t += 0.2   # each squaring takes 0.2 s on the engine clock
    return orig(state, step_fn)

  tcl._fixpoint_step = slow_step
  try:
    engine.run_until_idle()
  finally:
    tcl._fixpoint_step = orig
  assert bulk.done() and clock.t > 0.5
  with pytest.raises(DeadlineExceededError):
    doomed_fut.result(timeout=5)
  evs = engine.export_trace()["traceEvents"]
  (end,) = [ev for ev in evs if ev.get("ph") == "e"
            and ev["name"] == "queued"
            and ev["id"] == doomed.request_id]
  assert end["args"]["outcome"] == "expired"
  assert end["args"]["waited_ms"] == pytest.approx(clock.t * 1e3)
  assert end["args"]["in_service"] == {
      "bucket": bucket_label(request_bucket(bulk.request)), "batch": 1,
      "start_s": 0.0}
  _assert_balanced(evs)


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
  # the port stamps each batch's stages where the reference apportions
  # squaring slices, and exposes their histograms and two counters more
  assert {"stack", "select", "d2h"} <= set(got[1])
  assert ("sync" in got[1]) == (mode == "batch")  # arena closures: no batch
  assert ([n for n in got[1] if n not in STAGES and n != "thread_name"]
          == [n for n in want[1] if not n.startswith("squaring_iter")])
  if mode == "arena":
    assert "arena_tick" in got[1]
  port_only = tuple(f"serve_{name}" for name in (
      "batch_stack_", "batch_h2d_", "batch_compute_", "batch_select_",
      "sync_seconds", "batch_d2h_", "batch_nan_scan_", "batch_split_",
      "d2h_bytes_total", "syncs_total"))
  port_only += tuple(f"# {k} {name}" for k in ("HELP", "TYPE")
                     for name in port_only)

  def recorded(names, text):
    # every event recorded is in the trace: the names less the metadata
    meta = sum(1 for n in names if n in ("process_name", "thread_name"))
    return f"serve_trace_events_total {len(names) - meta}" in text

  assert recorded(got[1], got[2]) and recorded(want[1], want[2])

  def stable(text, port=False):
    # the port's help says what the device window times: the host clock
    skip = ("serve_scheduler_pick_seconds_total", "serve_estimator_",
            "# HELP serve_batch_device_seconds", "serve_trace_events_total")
    return [line for line in text.splitlines()
            if not line.startswith(skip)
            and not (port and line.startswith(port_only))]

  assert any(line.startswith(port_only) for line in got[2].splitlines())
  assert stable(got[2], port=True) == stable(want[2])


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
