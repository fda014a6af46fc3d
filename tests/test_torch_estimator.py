"""The port's service-time estimator against the reference's, and its
feedback loop through the port's engine on the CPU.

The estimator is pure Python in both packages, so one observation sequence
must give exactly equal predictions, iteration estimates and snapshots.
The engine keeps each batch function's first run out of the estimator (on a
card it pays CUDA's lazy module load), where the reference keeps only its
compile time out.
"""
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import FakeClock  # noqa: E402
from repro import serve_mmo as jserve  # noqa: E402
from repro.serve_mmo.scheduler import request_bucket as jbucket  # noqa: E402
from repro_torch import serve_mmo as tserve  # noqa: E402
from repro_torch.apps import graphs  # noqa: E402
from repro_torch.serve_mmo.scheduler import request_bucket  # noqa: E402
from repro_torch.tuning import CostTable  # noqa: E402

Estimate = tserve.Estimate
ServiceEstimator = tserve.ServiceEstimator
RNG = np.random.default_rng(0)


def _keys(api, bucket):
  """Four buckets, built by one package's request constructors."""
  a = np.ones((12, 12), np.float32)
  w = graphs.weighted_digraph(12, 0.3, seed=0)
  return [bucket(api.mmo_request(a, a, op="mma")),
          bucket(api.apsp_request(w)),
          bucket(api.apsp_request(graphs.weighted_digraph(40, 0.3, seed=1))),
          bucket(api.reachability_request(graphs.boolean_digraph(20, 0.1,
                                                                 seed=2)))]


def _mmo_key(n=12):
  a = RNG.standard_normal((n, n)).astype(np.float32)
  return request_bucket(tserve.mmo_request(a, a, op="mma"))


def _closure_key(n=12):
  return request_bucket(tserve.apsp_request(graphs.weighted_digraph(
      n, 0.3, seed=0)))


@pytest.mark.parametrize("half_life,min_obs", [(8.0, 3), (1.0, 1),
                                               (2.5, 5)])
def test_same_observations_give_equal_estimates(half_life, min_obs):
  """One seeded script of observe_batch / observe_iterations / predict
  through both packages' estimators: every prediction, iteration estimate
  and the snapshot are exactly equal."""
  j = jserve.ServiceEstimator(half_life=half_life, min_observations=min_obs)
  t = ServiceEstimator(half_life=half_life, min_observations=min_obs)
  jkeys, tkeys = _keys(jserve, jbucket), _keys(tserve, request_bucket)
  rng = np.random.default_rng(int(half_life * 10) + min_obs)
  backends = ("xla", "pallas", "megakernel")
  for _ in range(300):
    i = int(rng.integers(len(tkeys)))
    b = backends[int(rng.integers(3))]
    op = rng.random()
    if op < 0.4:
      slots = int(rng.choice([0, 1, 2, 4, 8]))
      secs = float(rng.choice([rng.uniform(0, 0.1), np.nan, np.inf, -1.0],
                              p=[0.85, 0.05, 0.05, 0.05]))
      j.observe_batch(jkeys[i], b, "local", slots, secs)
      t.observe_batch(tkeys[i], b, "local", slots, secs)
    elif op < 0.6:
      its = [int(x) for x in rng.integers(0, 12, int(rng.integers(0, 4)))]
      j.observe_iterations(jkeys[i], its)
      t.observe_iterations(tkeys[i], its)
    else:
      static, trips = float(rng.uniform(1e-4, 1e-2)), float(
          rng.integers(1, 12))
      want = j.predict(jkeys[i], b, "local", static, trips)
      got = t.predict(tkeys[i], b, "local", static, trips)
      assert tuple(got) == tuple(want)
      assert t.iteration_estimate(tkeys[i], trips) == j.iteration_estimate(
          jkeys[i], trips)
      assert t.observations(tkeys[i], b, "local") == j.observations(
          jkeys[i], b, "local")
  assert t.snapshot() == j.snapshot()
  assert json.loads(json.dumps(t.snapshot())) == t.snapshot()


def test_ewma_pins_exact_update_rule():
  est = ServiceEstimator(half_life=1.0, min_observations=1)
  key = _mmo_key()
  est.observe_batch(key, "xla", "local", 1, 1.0)
  assert est.predict(key, "xla", "local", 99.0, 1.0).seconds == 1.0
  est.observe_batch(key, "xla", "local", 1, 3.0)
  assert est.predict(key, "xla", "local", 99.0, 1.0).seconds == \
      pytest.approx(2.0)
  est.observe_batch(key, "xla", "local", 1, 3.0)
  assert est.predict(key, "xla", "local", 99.0, 1.0).seconds == \
      pytest.approx(2.5)


def test_ewma_converges_to_shifted_load_within_half_lives():
  est = ServiceEstimator(half_life=8.0, min_observations=1)
  key = _mmo_key()
  for _ in range(50):
    est.observe_batch(key, "xla", "local", 1, 0.001)
  for _ in range(32):
    est.observe_batch(key, "xla", "local", 1, 0.1)
  got = est.predict(key, "xla", "local", 1e-6, 1.0).seconds
  assert got == pytest.approx(0.1, rel=0.10) and got > 0.05


@pytest.mark.parametrize("slots,seconds,want", [
    (8, 0.8, Estimate(0.1, "ewma")),          # per padded slot
    (0, 1.0, Estimate(7.0, "static")),        # zero slots dropped
    (1, float("nan"), Estimate(7.0, "static")),
    (1, float("inf"), Estimate(7.0, "static")),
])
def test_observations_per_padded_slot_and_bogus_dropped(slots, seconds, want):
  est = ServiceEstimator(min_observations=1)
  key = _mmo_key()
  est.observe_batch(key, "xla", "local", slots, seconds)
  assert est.predict(key, "xla", "local", 7.0, 1.0) == want


def test_constructor_validation():
  with pytest.raises(ValueError, match="half_life"):
    ServiceEstimator(half_life=0.0)
  with pytest.raises(ValueError, match="min_observations"):
    ServiceEstimator(min_observations=0)


def test_cold_start_then_warm_precedence():
  est = ServiceEstimator(min_observations=3)
  key = _closure_key()
  assert est.predict(key, "xla", "local", 2.0, 3.0) == Estimate(6.0, "static")
  est.observe_iterations(key, [2, 2])
  assert est.predict(key, "xla", "local", 2.0, 3.0) == Estimate(
      4.0, "iterations")
  for _ in range(2):
    est.observe_batch(key, "xla", "local", 1, 100.0)
  assert est.predict(key, "xla", "local", 2.0, 3.0).source == "iterations"
  est.observe_batch(key, "xla", "local", 1, 100.0)
  assert est.predict(key, "xla", "local", 2.0, 3.0) == Estimate(100.0, "ewma")
  # cells are per backend: another arm stays cold
  assert est.predict(key, "pallas", "local", 2.0, 3.0).source == "iterations"
  # measured iterations clamp to [1, worst_trips]
  est2 = ServiceEstimator()
  est2.observe_iterations(key, [9.0])
  assert est2.iteration_estimate(key, 4.0) == 4.0
  est3 = ServiceEstimator()
  est3.observe_iterations(key, [0.0])
  assert est3.iteration_estimate(key, 4.0) == 1.0


def test_concurrent_observe_predict_is_safe():
  est = ServiceEstimator(half_life=4.0, min_observations=1)
  keys = [_mmo_key(), _closure_key()]
  errs, n_per_thread = [], 200
  barrier = threading.Barrier(8)

  def writer():
    try:
      barrier.wait(timeout=30)
      for j in range(n_per_thread):
        est.observe_batch(keys[0], "xla", "local", 1, 0.01 + 0.01 * (j % 3))
        est.observe_iterations(keys[1], [1 + (j % 4)])
    except Exception as e:  # noqa: BLE001
      errs.append(e)

  def reader():
    try:
      barrier.wait(timeout=30)
      for _ in range(n_per_thread):
        assert est.predict(keys[0], "xla", "local", 1.0, 1.0).seconds >= 0.0
        est.snapshot()
        est.iteration_estimate(keys[1], 8.0)
    except Exception as e:  # noqa: BLE001
      errs.append(e)

  threads = [threading.Thread(target=writer) for _ in range(4)]
  threads += [threading.Thread(target=reader) for _ in range(4)]
  for th in threads:
    th.start()
  for th in threads:
    th.join(timeout=60)
    assert not th.is_alive()
  assert not errs
  assert est.observations(keys[0], "xla", "local") == 4 * n_per_thread
  final = est.predict(keys[0], "xla", "local", 1.0, 1.0)
  assert final.source == "ewma" and 0.01 <= final.seconds <= 0.03
  assert 1.0 <= est.iteration_estimate(keys[1], 8.0) <= 4.0


# ---------------------------------------------------------------------------
# the engine's feedback loop (CPU)
# ---------------------------------------------------------------------------


def test_adaptive_engine_corrects_wrong_static_prediction():
  """A measured row that says 100 s for a millisecond bucket poisons the
  static prediction; after a few batches the adaptive engine's prediction
  is the measured one, while the static engine keeps the table's."""
  table = CostTable(device="test")
  table.record("mma", (16, 16, 16), "float32", "xla", (512,), 100.0)

  def run(adaptive):
    eng = tserve.MMOEngine(backend="xla", max_batch=2, cost_table=table,
                           adaptive=adaptive, device="cpu")
    key = None
    for _ in range(8):
      a = RNG.standard_normal((12, 12)).astype(np.float32)
      req = tserve.mmo_request(a, a, op="mma")
      key = key or request_bucket(req)
      eng.submit(req)
    eng.run_until_idle()
    return eng.predict_request(key)

  assert run(adaptive=False) == Estimate(100.0, "static")
  live = run(adaptive=True)
  assert live.source == "ewma" and live.seconds < 1.0


def test_estimator_skips_the_build_and_the_first_run():
  """Neither the build of a batch function (the reference's compile) nor
  its first run (a lazy module load on a card) feeds the EWMA: the first
  batch is not observed at all, the second is, without the build."""
  clock = FakeClock()
  eng = tserve.MMOEngine(backend="xla", max_batch=2, clock=clock,
                         device="cpu")
  real = eng.cache.get_or_compile

  def slow_build(*a, **kw):
    clock.t += 100.0  # a build hiding inside the batch
    return real(*a, **kw)

  eng.cache.get_or_compile = slow_build
  a = RNG.standard_normal((12, 12)).astype(np.float32)
  eng.submit(tserve.mmo_request(a, a, op="mma"))
  eng.run_until_idle()
  assert eng.estimator.snapshot()["cells"] == {}
  eng.submit(tserve.mmo_request(a, a, op="mma"))
  eng.run_until_idle()
  (label,) = eng.estimator.snapshot()["cells"]
  assert label == "mmo/mma/16x16x16/float32|xla|local"
  assert eng.estimator.snapshot()["cells"][label] == {"seconds": 0.0,
                                                      "observations": 1}


def test_prewarm_runs_nothing_and_leaves_functions_cold():
  eng = tserve.MMOEngine(backend="xla", max_batch=2, device="cpu")
  a = RNG.standard_normal((12, 12)).astype(np.float32)
  req = tserve.mmo_request(a, a, op="mma")
  assert eng.prewarm([req]) == 2
  key = request_bucket(req)
  exec_key = eng._exec_key(key, 1, "xla", (), "local")
  assert eng.cache.first_run(exec_key)  # cold until its first run
  assert not eng.cache.first_run(exec_key)
  assert not eng.cache.first_run(("no", "such", "key"))


def test_adaptive_engine_uses_measured_closure_iterations_cold():
  table = CostTable(device="test")
  table.record("minplus", (16, 16, 16), "float32", "xla", (512,), 2.0)
  eng = tserve.MMOEngine(backend="xla", max_batch=4, cost_table=table,
                         adaptive=True, device="cpu",
                         estimator=ServiceEstimator(min_observations=100))
  w = graphs.weighted_digraph(12, 0.9, seed=0)
  key = request_bucket(tserve.apsp_request(w))
  assert eng.predict_request(key) == Estimate(8.0, "static")  # 2.0 × lg 16
  fut = eng.submit(tserve.apsp_request(w))
  eng.run_until_idle()
  iters = fut.result().extras["iterations"]
  got = eng.predict_request(key)
  assert got.source == "iterations"
  assert got.seconds == pytest.approx(2.0 * min(max(iters, 1), 4))


@pytest.mark.parametrize("adaptive", [False, True])
def test_engine_predictions_match_the_reference_on_one_table(adaptive):
  """The same measured table in both engines gives the same static
  predictions per bucket (the trip factors and the table read agree)."""
  from repro.tuning import CostTable as JCostTable
  jt = JCostTable(device="test")
  for n in (16, 32, 64):
    jt.record("minplus", (n, n, n), "float32", "xla", (512,), 1e-3 * n)
    jt.record("orand", (n, n, n), "bool", "xla", (512,), 2e-3 * n)
  tt = CostTable.from_json(jt.to_json())
  jeng = jserve.MMOEngine(backend="xla", cost_table=jt, adaptive=adaptive)
  teng = tserve.MMOEngine(backend="xla", cost_table=tt, adaptive=adaptive,
                          device="cpu")
  reqs = [("apsp", 12), ("apsp", 40), ("reach", 20), ("reach", 64)]
  for kind, n in reqs:
    if kind == "apsp":
      w = graphs.weighted_digraph(n, 0.3, seed=n)
      jk, tk = jbucket(jserve.apsp_request(w)), request_bucket(
          tserve.apsp_request(w))
    else:
      w = graphs.boolean_digraph(n, 0.1, seed=n)
      jk = jbucket(jserve.reachability_request(w))
      tk = request_bucket(tserve.reachability_request(w))
    assert tuple(teng.predict_request(tk)) == tuple(jeng.predict_request(jk))


def test_arena_feeds_the_estimator_after_its_first_tick():
  """Arena mode observes slot-seconds per evicted request, except for
  requests that lived through the arena's first (cold) tick; iterations are
  observed for every eviction."""
  eng = tserve.MMOEngine(mode="arena", arena_capacity=2, arena_g=2,
                         adaptive=True, device="cpu")
  ws = [graphs.weighted_digraph(12, 0.3, seed=s) for s in range(5)]
  futs = [eng.submit(tserve.apsp_request(w)) for w in ws[:2]]
  eng.run_until_idle()
  snap = eng.estimator.snapshot()
  assert snap["cells"] == {}  # both residents saw the cold tick
  (it_label,) = snap["iterations"]
  assert snap["iterations"][it_label]["observations"] == 2
  futs += [eng.submit(tserve.apsp_request(w)) for w in ws[2:]]
  eng.run_until_idle()
  assert all(f.state == "done" for f in futs)
  cells = eng.estimator.snapshot()["cells"]
  assert list(cells) == ["closure/minplus/16/float32|arena|local"]
  assert cells["closure/minplus/16/float32|arena|local"][
      "observations"] == 3
  assert eng.metrics_snapshot()["counters"]["completed"] == 5
  assert eng.admission.queued == 0 and dict(eng.admission.inflight) == {}
