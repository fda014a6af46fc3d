"""The port's batch-mode serving engine against the reference engine.

One seeded mixed stream (APSP, KNN, reachability and raw minplus mmo,
sizes 12–48, so several true sizes share each padded bucket) goes through
``repro.serve_mmo.MMOEngine(backend="pallas")`` and through the port's
engine on the CPU.  Closure and mmo results and iteration counts must be
identical; KNN indices identical and distances within rtol 1e-5 /
atol 1e-4 (the reference's addnorm is the ‖a‖²−2ab+‖b‖² rewrite).
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import FakeClock  # noqa: E402
from repro import serve_mmo as jserve  # noqa: E402
from repro_torch import serve_mmo as tserve  # noqa: E402
from repro_torch.apps import graphs  # noqa: E402
from repro_torch.launch import serve_mmo as tlaunch  # noqa: E402
from repro_torch.serve_mmo.cache import ExecutableCache  # noqa: E402

KINDS = ("apsp", "knn", "reach", "mmo")


def _payloads(seed=0, count=16):
  """(kind, args) per request; the same numpy arrays feed both engines."""
  rng = np.random.default_rng(seed)
  out = []
  for i in range(count):
    kind = KINDS[i % 4]
    n = int(rng.integers(12, 49))
    s = int(rng.integers(0, 2 ** 31))
    if kind == "apsp":
      out.append((kind, (graphs.weighted_digraph(n, 0.15, seed=s),)))
    elif kind == "reach":
      out.append((kind, (graphs.boolean_digraph(n, 0.05, seed=s),)))
    elif kind == "knn":
      ref, qry = graphs.knn_points(4 * n, n, 16, seed=s)
      out.append((kind, (qry, ref)))
    else:
      a = rng.standard_normal((n, n)).astype(np.float32)
      b = rng.standard_normal((n, n)).astype(np.float32)
      out.append((kind, (a, b)))
  return out


def _request(api, kind, args):
  if kind == "apsp":
    return api.apsp_request(*args)
  if kind == "reach":
    return api.reachability_request(*args)
  if kind == "knn":
    return api.knn_request(*args, k=8)
  return api.mmo_request(*args, op="minplus")


def _serve(engine, api, payloads):
  futs = [engine.submit(_request(api, k, a)) for k, a in payloads]
  engine.run_until_idle()
  return [f.result() for f in futs]


@pytest.fixture(scope="module")
def stream():
  payloads = _payloads()
  ref = _serve(jserve.MMOEngine(backend="pallas", max_batch=8), jserve,
               payloads)
  return payloads, ref


@pytest.mark.parametrize("backend", ["pallas", "xla", "vector"])
def test_mixed_stream_matches_reference_engine(stream, backend):
  payloads, ref = stream
  eng = tserve.MMOEngine(backend=backend, max_batch=8, device="cpu")
  got = _serve(eng, tserve, payloads)
  for (kind, _), g, r in zip(payloads, got, ref):
    assert g.value.shape == r.value.shape and g.value.dtype == r.value.dtype
    if kind == "knn":
      np.testing.assert_array_equal(g.extras["indices"], r.extras["indices"])
      np.testing.assert_allclose(g.value, r.value, rtol=1e-5, atol=1e-4)
    else:
      np.testing.assert_array_equal(g.value, r.value)
      assert g.extras == r.extras
  st = eng.stats()
  assert st.completed == len(payloads) and st.batches >= 4


def test_zero_cache_misses_after_prewarm():
  payloads = _payloads(seed=1, count=12)
  eng = tserve.MMOEngine(max_batch=4, device="cpu")
  built = eng.prewarm([_request(tserve, k, a) for k, a in payloads])
  assert built == eng.cache.misses > 0
  _serve(eng, tserve, payloads)
  assert eng.cache.misses == built
  assert eng.cache.stats()["hits"] == eng.stats().batches
  assert eng.prewarm([_request(tserve, k, a) for k, a in payloads]) == 0


def test_engine_defaults_to_the_card(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="cuda"):
    tserve.MMOEngine()


@pytest.mark.parametrize("schedule", ["dp", "kspan", "summa", "ring"])
def test_pinned_schedule_needs_a_mesh(schedule):
  """The reference's ValueError for a pinned schedule without a mesh, in
  both packages."""
  with pytest.raises(ValueError, match="needs a mesh"):
    tserve.MMOEngine(device="cpu", schedule=schedule)
  with pytest.raises(ValueError, match="needs a mesh"):
    jserve.MMOEngine(schedule=schedule)


@pytest.mark.parametrize("with_mesh", [False, True])
def test_unknown_schedule_raises(with_mesh):
  from repro_torch.launch.mesh import make_host_mesh
  mesh = make_host_mesh(1, devices=["cpu"]) if with_mesh else None
  with pytest.raises(ValueError, match="unknown schedule"):
    tserve.MMOEngine(device="cpu", mesh=mesh, schedule="suma")


def test_mesh_of_another_device_type_is_refused():
  from repro_torch.launch.mesh import Mesh
  with pytest.raises(ValueError, match="cannot serve"):
    tserve.MMOEngine(device="cpu", mesh=Mesh((("cuda:0",),)))
  with pytest.raises(TypeError, match="unexpected keyword"):
    tserve.MMOEngine(device="cpu", mesh_shape=(2, 4))


# ROADMAP item 9's knobs, each with a value that asks for something
_OPERABILITY_KNOBS = {
    "trace": False,
    "trace_capacity": 64,
    "tracer": "recorder",
    "faults": "injector",
    "transient_retries": 3,
    "retry_backoff_s": 0.0,
    "bisect": False,
    "breaker_threshold": None,
    "breaker_probe_s": 1.0,
    "watchdog_s": 30.0,
    "fallback_backends": ("vector",),
    "resilience": "manager",
}


def test_operability_knobs_take_the_reference_defaults():
  import inspect
  ref = inspect.signature(jserve.MMOEngine).parameters
  port = inspect.signature(tserve.MMOEngine).parameters
  assert set(_OPERABILITY_KNOBS) <= set(port)
  for name in _OPERABILITY_KNOBS:
    assert port[name].default == ref[name].default, name
  for name in ("mesh", "schedule", "shard_flops"):  # the mesh knobs too
    assert port[name].default == ref[name].default, name


@pytest.mark.parametrize("knob", sorted(_OPERABILITY_KNOBS))
def test_each_operability_knob_constructs_and_serves(knob):
  """Each knob once refused as unported now builds an engine that serves:
  one APSP request, the same distances as the default engine."""
  value = {"recorder": tserve.FlightRecorder(capacity=64),
           "injector": tserve.FaultInjector(),
           "manager": tserve.ResilienceManager()}.get(
               _OPERABILITY_KNOBS[knob], _OPERABILITY_KNOBS[knob])
  w = graphs.weighted_digraph(12, 0.3, seed=4)
  eng = tserve.MMOEngine(device="cpu", **{knob: value})
  fut = eng.submit(tserve.apsp_request(w))
  want = tserve.MMOEngine(device="cpu").submit(tserve.apsp_request(w))
  np.testing.assert_array_equal(fut.result().value, want.result().value)
  assert eng.metrics_snapshot()["counters"]["completed"] == 1
  assert eng._abandoned == []


def _knob_values():
  from repro_torch.tuning import CostTable
  table = CostTable(device="test")
  table.record("minplus", (16, 16, 16), "float32", "vector", (128,), 1e-3)
  return {
      "cost_table": dict(backend="auto", cost_table=table),
      "max_queue": dict(max_queue=4),
      "tenant_quota": dict(tenant_quota=2),
      "max_backlog_s": dict(max_backlog_s=10.0),
      "admission": dict(admission=tserve.AdmissionController(max_queue=4)),
      "adaptive": dict(adaptive=True),
      "estimator": dict(estimator=tserve.ServiceEstimator()),
      "max_batch_seconds": dict(policy="deadline", max_batch_seconds=0.5),
      "deadline_lookback_s": dict(deadline_lookback_s=2.0),
      "metrics_window": dict(metrics_window=16),
      "policy_deadline": dict(policy="deadline"),
      "policy_fair": dict(policy=tserve.FairSharePolicy(weights={"a": 2})),
      "backend_auto": dict(backend="auto"),
  }


@pytest.mark.parametrize("knob", sorted(_knob_values()))
def test_each_ported_qos_knob_constructs_and_serves(knob):
  """Each knob this slice ports (once an unported one) builds an engine that
  serves: one APSP request, the same distances as the 'pallas' engine."""
  w = graphs.weighted_digraph(12, 0.3, seed=4)
  eng = tserve.MMOEngine(device="cpu", **_knob_values()[knob])
  fut = eng.submit(tserve.apsp_request(w, tenant="a", deadline_s=600.0))
  want = tserve.MMOEngine(device="cpu").submit(tserve.apsp_request(w))
  np.testing.assert_array_equal(fut.result().value, want.result().value)
  assert eng.metrics_snapshot()["counters"]["completed"] == 1


@pytest.mark.parametrize("kw", [dict(mode="nope"), dict(backend="nope"),
                                dict(policy="nope"), dict(max_batch=0)])
def test_bad_values_raise(kw):
  with pytest.raises(ValueError):
    tserve.MMOEngine(device="cpu", **kw)
  with pytest.raises(TypeError):
    tserve.MMOEngine(device="cpu", no_such_knob=1)


def test_knn_large_coordinates_exact_on_the_kernel_arm():
  """The reference's failing case (coordinates near 1e6), on the port's
  kernel arm: the top-4 of an exact float64 computation on the same float32
  inputs, ties to the lower index — the rewrite's cancellation is gone."""
  _assert_large_coordinate_knn_exact("pallas")


def test_knn_large_coordinates_exact_on_the_xla_arm():
  """The same case on the 'xla' arm, whose ‖a‖²−2ab+‖b‖² expansion now runs
  on coordinates translated by one corpus point (corpus rows padded to the
  bucket are zeros, so a mean would not do)."""
  _assert_large_coordinate_knn_exact("xla")


def _assert_large_coordinate_knn_exact(backend):
  ref_pts, qry_pts = graphs.knn_points(21, 7, 5, seed=3)
  ref_pts = ref_pts + 1.0e6
  qry_pts = qry_pts + 1.0e6
  eng = tserve.MMOEngine(backend=backend, device="cpu")
  res = eng.submit(tserve.knn_request(qry_pts, ref_pts, k=4)).result()
  d64 = ((qry_pts.astype(np.float64)[:, None, :]
          - ref_pts.astype(np.float64)[None, :, :]) ** 2).sum(-1)
  want = np.argsort(d64, axis=1, kind="stable")[:, :4]
  np.testing.assert_array_equal(res.extras["indices"], want)
  np.testing.assert_allclose(res.value, np.take_along_axis(d64, want, 1),
                             rtol=1e-5, atol=1e-4)


def test_megakernel_backend_serves_closures_fused_and_the_rest_on_k1(
    stream):
  """backend='megakernel' runs closure buckets through the fused fixpoint
  and every other bucket through the kernel arm: the same results as the
  'pallas' engine, bit for bit."""
  payloads, _ = stream
  want = _serve(tserve.MMOEngine(backend="pallas", device="cpu"), tserve,
                payloads)
  eng = tserve.MMOEngine(backend="megakernel", device="cpu")
  got = _serve(eng, tserve, payloads)
  for (kind, _), g, w in zip(payloads, got, want):
    np.testing.assert_array_equal(g.value, w.value)
    assert g.extras.keys() == w.extras.keys()
    for k in g.extras:
      np.testing.assert_array_equal(g.extras[k], w.extras[k])
  decisions = {key.kind: dec for key, dec in eng._decisions.items()}
  assert decisions == {"closure": ("megakernel", ()), "mmo": ("pallas", ()),
                       "knn": ("pallas", ())}


def test_background_loop_serves_and_stop_is_terminal():
  eng = tserve.MMOEngine(device="cpu")
  eng.start()
  futs = [eng.submit(tserve.apsp_request(graphs.weighted_digraph(n, 0.3,
                                                                 seed=n)))
          for n in (10, 12, 20)]
  assert [f.result(timeout=60).value.shape for f in futs] == [
      (10, 10), (12, 12), (20, 20)]
  eng.stop()
  with pytest.raises(RuntimeError, match="stopped engine"):
    eng.submit(tserve.apsp_request(graphs.weighted_digraph(10, seed=0)))
  eng.start()
  fut = eng.submit(tserve.apsp_request(graphs.weighted_digraph(10, seed=1)))
  eng.stop()
  assert fut.result().value.shape == (10, 10)
  assert eng.stats().completed == 4


def test_nan_result_fails_its_batch_and_serving_continues():
  a = np.ones((6, 6), np.float32)
  a[2, 3] = np.nan
  eng = tserve.MMOEngine(device="cpu")
  bad = eng.submit(tserve.mmo_request(a, a, op="minplus"))
  eng.run_until_idle()
  with pytest.raises(tserve.NonFiniteResultError):
    bad.result()
  assert bad.state == "failed"
  good = eng.submit(tserve.mmo_request(np.ones((6, 6), np.float32),
                                       np.ones((6, 6), np.float32),
                                       op="minplus"))
  np.testing.assert_array_equal(good.result().value, np.full((6, 6), 2.0))
  inf_ok = eng.submit(tserve.apsp_request(np.full((5, 5), np.inf,
                                                  np.float32)))
  assert np.isinf(inf_ok.result().value).sum() == 20  # +inf is legitimate


def test_deadline_expires_queued_request():
  clock = FakeClock()
  eng = tserve.MMOEngine(device="cpu", clock=clock)
  late = eng.submit(tserve.apsp_request(graphs.weighted_digraph(8, seed=0),
                                        deadline_s=0.5))
  on_time = eng.submit(tserve.apsp_request(graphs.weighted_digraph(
      8, seed=1)))
  clock.t = 1.0
  eng.run_until_idle()
  with pytest.raises(tserve.DeadlineExceededError):
    late.result()
  assert late.state == "expired" and on_time.state == "done"
  assert eng.stats().expired == 1


def test_executable_is_pinned_to_its_shapes():
  cache = ExecutableCache()
  fn = cache.get_or_compile("k", lambda: (lambda x: x + 1),
                            (np.zeros((2, 3), np.float32),))
  assert fn(torch.zeros(2, 3)).sum() == 6
  with pytest.raises(ValueError, match="built for"):
    fn(torch.zeros(3, 3))
  with pytest.raises(ValueError, match="built for"):
    fn(torch.zeros(2, 3, dtype=torch.float64))


def test_cache_first_insert_wins_under_concurrent_misses():
  cache = ExecutableCache()
  barrier = threading.Barrier(6)
  got = []

  def worker():
    barrier.wait(timeout=10)
    got.append(cache.get_or_compile(
        "key", lambda: (lambda: None), (np.zeros(1, np.float32),)))

  threads = [threading.Thread(target=worker) for _ in range(6)]
  for t in threads:
    t.start()
  for t in threads:
    t.join(timeout=10)
    assert not t.is_alive()
  assert len({id(f) for f in got}) == 1
  st = cache.stats()
  assert st["executables"] == 1
  assert st["hits"] + st["misses"] >= 6 and st["misses"] >= 1


def test_launch_serve_mmo_runs_on_cpu(capsys):
  assert tlaunch.main(["--device", "cpu", "--rate", "30", "--duration",
                       "0.3", "--sizes", "12,20", "--max-batch", "4"]) == 0
  out = capsys.readouterr().out
  assert "outcomes={'done'" in out and "'failed': 0" in out
