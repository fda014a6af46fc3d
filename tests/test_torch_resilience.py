"""The port's fault tolerance on the CPU: injection harness, batch
bisection, circuit breakers, the watchdog — and parity with the reference.

The reference's tests (tests/test_resilience.py) run here on the port's
engine with ``device="cpu"``.  Then one seeded stream goes through the
reference's ``MMOEngine(backend="xla")`` and the port's under the same
``parse_fault_spec`` string and seed and the same ``conftest.FakeClock``:
both must give the same per-request outcomes, failure kinds, breaker cells
and sequence of trace event names, with results bit-identical on the
min/max rings and orand and within rtol 1e-5 / atol 1e-4 on mma and KNN
distances.

Steadiness: breaker cooldowns run on ``FakeClock``; the one wall-clock
bound left (the watchdog's) has a 20× margin; every engine is stopped and
its abandoned watchdog workers joined in the fixture's teardown; servers
bind port 0.
"""
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import FakeClock  # noqa: E402
from repro import serve_mmo as jserve  # noqa: E402
from repro_torch import serve_mmo as tserve  # noqa: E402
from repro_torch.apps import graphs, solvers  # noqa: E402
from repro_torch.serve_mmo import (BatchTimeoutError, FaultInjector,  # noqa: E402
                                   FaultRule, InjectedFault,
                                   NonFiniteResultError, ObservabilityServer,
                                   ResilienceManager, apsp_request,
                                   parse_fault_spec)
from repro_torch.serve_mmo import batching  # noqa: E402
from repro_torch.serve_mmo.faults import classify_failure  # noqa: E402
from repro_torch.serve_mmo.observability import STAGES  # noqa: E402
from repro_torch.serve_mmo.scheduler import request_bucket  # noqa: E402

EXACT = ("minplus", "maxplus", "minmul", "maxmul", "minmax", "maxmin",
         "orand")


@pytest.fixture
def engines():
  """Engine factory on the CPU (``backend="vector"``, no backoff); the
  teardown stops each engine and joins the watchdog workers its timed-out
  batches abandoned, so no thread outlives the test."""
  made = []

  def make(**kw):
    kw.setdefault("backend", "vector")
    kw.setdefault("retry_backoff_s", 0.0)
    kw.setdefault("device", "cpu")
    eng = tserve.MMOEngine(**kw)
    made.append(eng)
    return eng

  yield make
  for eng in made:
    eng.stop(drain=False)
    assert eng.join_abandoned(timeout=10.0) == 0


def _submit_apsp(eng, n_reqs, *, nodes=10, **req_kw):
  return [eng.submit(apsp_request(
      graphs.weighted_digraph(nodes, 0.3, seed=i), **req_kw))
      for i in range(n_reqs)]


def _apsp_want(i, nodes=10):
  dist, _ = solvers.apsp(graphs.weighted_digraph(nodes, 0.3, seed=i),
                         device="cpu")
  return dist.numpy()


def _trace_events(eng):
  return eng.export_trace()["traceEvents"]


def _http_get(url):
  """(status, body) — urllib raises on 503, which is a valid answer here."""
  try:
    with urllib.request.urlopen(url, timeout=10) as resp:
      return resp.status, resp.read().decode("utf-8")
  except urllib.error.HTTPError as e:
    return e.code, e.read().decode("utf-8")


# ---------------------------------------------------------------------------
# fault injector: rules, schedules, determinism, spec grammar
# ---------------------------------------------------------------------------


def test_fault_rule_validation():
  with pytest.raises(ValueError, match="point"):
    FaultRule(point="nope")
  with pytest.raises(ValueError, match="mode"):
    FaultRule(point="execute", mode="sometimes")
  with pytest.raises(ValueError, match="rate"):
    FaultRule(point="execute", mode="rate", rate=1.5)
  with pytest.raises(ValueError, match="count"):
    FaultRule(point="execute", mode="transient", count=0)


def test_transient_rule_exhausts():
  inj = FaultInjector([FaultRule(point="execute", mode="transient", count=2)])
  assert inj.check("execute") is not None
  assert inj.check("execute") is not None
  assert inj.check("execute") is None  # budget spent
  assert inj.stats()["fired"]["execute"] == 2


def test_persistent_rule_fires_until_cleared():
  inj = FaultInjector([FaultRule(point="compile", mode="persistent")])
  for _ in range(5):
    assert inj.check("compile") is not None
  assert inj.check("execute") is None  # other points untouched
  assert inj.clear("execute") == 0     # nothing armed there
  assert inj.clear() == 1              # "the fault cleared"
  assert inj.check("compile") is None


def test_rate_rule_fires_on_the_reference_checks():
  """The same seed fires on the same checks in both packages (Python's
  seeded random.Random), and it is actually probabilistic."""
  def pattern(api, seed):
    inj = api.FaultInjector(
        [api.FaultRule(point="execute", mode="rate", rate=0.3)], seed=seed)
    return [inj.check("execute") is not None for _ in range(200)]

  p = pattern(tserve, 7)
  assert p == pattern(tserve, 7) == pattern(jserve, 7)
  assert p != pattern(tserve, 8)
  assert 0 < sum(p) < 200


def test_rule_scoping_filters():
  inj = FaultInjector([
      FaultRule(point="execute", mode="persistent", backend="xla"),
      FaultRule(point="compile", mode="persistent", match="closure"),
      FaultRule(point="nonfinite", mode="persistent",
                request_ids=frozenset({7})),
  ])
  assert inj.check("execute", backend="vector") is None
  assert inj.check("execute", backend="xla") is not None
  assert inj.check("compile", label="mmo/minplus") is None
  assert inj.check("compile", label="closure/minplus/n16") is not None
  assert inj.check("nonfinite", request_ids=[1, 2]) is None
  assert inj.check("nonfinite", request_ids=[2, 7]) is not None


def test_parse_fault_spec_grammar():
  spec = ("execute:rate:0.02;slow:transient:1:delay=0.2;"
          "execute:persistent:backend=xla;nonfinite:persistent:rid=3,5@closure")
  rules = parse_fault_spec(spec).rules()
  assert [r.point for r in rules] == ["execute", "slow", "execute",
                                      "nonfinite"]
  assert rules[0].mode == "rate" and rules[0].rate == 0.02
  assert rules[1].count == 1 and rules[1].delay_s == 0.2
  assert rules[2].backend == "xla"
  assert rules[3].request_ids == frozenset({3, 5})
  assert rules[3].match == "closure"
  ref = jserve.parse_fault_spec(spec).rules()
  fields = ("point", "mode", "count", "rate", "match", "backend",
            "request_ids", "delay_s")
  assert ([[getattr(r, f) for f in fields] for r in rules]
          == [[getattr(r, f) for f in fields] for r in ref])


def test_parse_fault_spec_rejects_garbage():
  with pytest.raises(ValueError, match="point"):
    parse_fault_spec("frobnicate:persistent")
  with pytest.raises(ValueError, match="unknown fault rule key"):
    parse_fault_spec("execute:persistent:color=red")
  with pytest.raises(ValueError, match="too many positional"):
    parse_fault_spec("execute:transient:1:2")
  with pytest.raises(ValueError, match="no rules"):
    parse_fault_spec(" ; ")


def test_classify_failure_taxonomy():
  assert classify_failure(NonFiniteResultError("b", [0]), "split") == "nonfinite"
  assert classify_failure(BatchTimeoutError("b", 0.1), "execute") == "timeout"
  assert classify_failure(InjectedFault("compile"), "execute") == "compile"
  assert classify_failure(RuntimeError("x"), "stack") == "stack"
  assert classify_failure(RuntimeError("x"), "weird-phase") == "other"
  # NonFiniteResultError is the api's, re-exported as the reference does
  from repro_torch.serve_mmo import api, faults
  assert faults.NonFiniteResultError is api.NonFiniteResultError


# ---------------------------------------------------------------------------
# result validation primitives
# ---------------------------------------------------------------------------


def test_validate_finite_flags_nan_not_inf():
  key = request_bucket(apsp_request(graphs.weighted_digraph(10, 0.3, seed=0)),
                       8)
  out = np.zeros((4, 16, 16), np.float32)
  out[3] = np.inf          # legitimate tropical output (unreachable pair)
  assert batching.validate_finite(key, out, 4) == []
  out[1, 5, 5] = np.nan
  out[3, 0, 0] = np.nan    # padded-slot NaN beyond live must be ignored too
  assert batching.validate_finite(key, out, 2) == [1]
  assert batching.validate_finite(key, out, 4) == [1, 3]
  iters = np.array([2, 2, 2, 2], np.int32)
  assert batching.validate_finite(key, (out, iters), 4) == [1, 3]
  assert batching.validate_finite(key, out.astype(bool), 4) == []


def test_poison_output_corrupts_requested_slots():
  key = request_bucket(apsp_request(graphs.weighted_digraph(10, 0.3, seed=0)),
                       8)
  out = np.zeros((3, 4, 4), np.float32)
  poisoned = batching.poison_output(key, (out, np.arange(3)), [1])
  assert np.isnan(poisoned[0][1]).all()
  assert not np.isnan(poisoned[0][0]).any()
  np.testing.assert_array_equal(poisoned[1], np.arange(3))
  assert batching.poison_output(key, out.astype(bool), [1]).dtype == bool


# ---------------------------------------------------------------------------
# circuit breaker state machine (unit level, fake clock)
# ---------------------------------------------------------------------------


def test_breaker_opens_probes_and_closes():
  fake_clock = FakeClock()
  mgr = ResilienceManager(threshold=2, probe_after_s=1.0, clock=fake_clock)
  key = request_bucket(apsp_request(graphs.weighted_digraph(10, 0.3, seed=0)),
                       8)
  primary = ("xla", (), "local")
  fallbacks = lambda: (("vector", (), "local"),)  # noqa: E731

  assert mgr.pick(key, primary, fallbacks) == (primary, False)
  assert mgr.on_failure(key, primary) is None          # 1 of 2
  assert mgr.pick(key, primary, fallbacks) == (primary, False)
  assert mgr.on_failure(key, primary) == "open"        # threshold hit
  assert mgr.pick(key, primary, fallbacks) == (("vector", (), "local"), False)
  assert mgr.open_arms()[0]["backend"] == "xla"
  fake_clock.t += 1.5
  arm, probe = mgr.pick(key, primary, fallbacks)
  assert arm == primary and probe
  assert mgr.on_failure(key, primary) == "open"        # probe failed
  assert mgr.pick(key, primary, fallbacks)[0] == ("vector", (), "local")
  fake_clock.t += 1.5
  arm, probe = mgr.pick(key, primary, fallbacks)
  assert probe
  assert mgr.on_success(key, primary) == "close"       # probe recovered it
  assert mgr.pick(key, primary, fallbacks) == (primary, False)
  (cell,) = mgr.snapshot()
  assert (cell["state"], cell["opens"], cell["closes"], cell["probes"]) == (
      "closed", 2, 1, 2)
  assert mgr.open_arms() == []


def test_breaker_success_resets_consecutive_count():
  mgr = ResilienceManager(threshold=3, clock=FakeClock())
  key = request_bucket(apsp_request(graphs.weighted_digraph(10, 0.3, seed=0)),
                       8)
  arm = ("xla", (), "local")
  mgr.on_failure(key, arm)
  mgr.on_failure(key, arm)
  assert mgr.on_success(key, arm) is None   # plain success, not a probe
  mgr.on_failure(key, arm)
  mgr.on_failure(key, arm)
  assert mgr.snapshot()[0]["state"] == "closed"  # never 3 consecutive


def test_breaker_all_arms_open_serves_last():
  mgr = ResilienceManager(threshold=1, probe_after_s=100.0, clock=FakeClock())
  key = request_bucket(apsp_request(graphs.weighted_digraph(10, 0.3, seed=0)),
                       8)
  primary = ("xla", (), "local")
  last = ("vector", (), "local")
  mgr.on_failure(key, primary)
  mgr.on_failure(key, last)
  assert mgr.pick(key, primary, lambda: (last,)) == (last, False)


def test_breaker_threshold_none_disables():
  mgr = ResilienceManager(threshold=None)
  key = request_bucket(apsp_request(graphs.weighted_digraph(10, 0.3, seed=0)),
                       8)
  arm = ("xla", (), "local")
  for _ in range(50):
    assert mgr.on_failure(key, arm) is None
  assert mgr.pick(key, arm, lambda: ()) == (arm, False)
  assert mgr.snapshot() == []


def test_breaker_threshold_validation(engines):
  with pytest.raises(ValueError, match="threshold"):
    ResilienceManager(threshold=0)
  with pytest.raises(ValueError, match="transient_retries"):
    engines(transient_retries=-1)


# ---------------------------------------------------------------------------
# engine fault matrix: every injection point × transient / persistent
# ---------------------------------------------------------------------------

_MATRIX = [
    ("compile", "compile", InjectedFault),
    ("execute", "execute", InjectedFault),
    ("nonfinite", "nonfinite", NonFiniteResultError),
    ("slow", "timeout", BatchTimeoutError),
]


@pytest.mark.parametrize("point,kind,_exc", _MATRIX,
                         ids=[m[0] for m in _MATRIX])
def test_transient_fault_is_ridden_out(engines, point, kind, _exc):
  """A blip at any injection point is absorbed by the retry budget: every
  request completes, the retry counter moves, the failure is classified."""
  inj = FaultInjector([FaultRule(point=point, mode="transient", count=1,
                                 delay_s=2.0)])
  eng = engines(max_batch=2, faults=inj, transient_retries=2,
                breaker_threshold=None,
                watchdog_s=0.1 if point == "slow" else None)
  futs = _submit_apsp(eng, 2)
  assert eng.run_until_idle() == 2
  for i, fut in enumerate(futs):
    np.testing.assert_array_equal(fut.result().value, _apsp_want(i))
  snap = eng.metrics_snapshot()
  assert snap["counters"]["retries"] >= 1
  assert snap["counters"]["failed"] == 0
  assert snap["batch_failures_by_kind"] == {kind: 1}


@pytest.mark.parametrize("point,kind,exc", _MATRIX,
                         ids=[m[0] for m in _MATRIX])
def test_persistent_fault_exhausts_budget_and_fails(engines, point, kind,
                                                     exc):
  """A persistent fault burns retries and bisection, then fails every
  poisoned request with the typed failure — and the engine keeps serving."""
  inj = FaultInjector([FaultRule(point=point, mode="persistent",
                                 delay_s=0.5)])
  eng = engines(max_batch=2, faults=inj, transient_retries=1,
                breaker_threshold=None,
                watchdog_s=0.1 if point == "slow" else None)
  futs = _submit_apsp(eng, 2)
  assert eng.run_until_idle() == 0
  for fut in futs:
    with pytest.raises(exc):
      fut.result()
  snap = eng.metrics_snapshot()
  assert snap["counters"]["failed"] == 2
  assert snap["counters"]["completed"] == 0
  assert set(snap["batch_failures_by_kind"]) == {kind}
  assert not eng._inflight
  inj.clear()
  fut = eng.submit(apsp_request(graphs.weighted_digraph(10, 0.3, seed=9)))
  eng.run_until_idle()
  assert fut.result().value.shape == (10, 10)


# ---------------------------------------------------------------------------
# bisection isolates a single poisoned request
# ---------------------------------------------------------------------------


def test_single_poisoned_request_in_16_batch_fails_alone(engines):
  inj = FaultInjector()
  eng = engines(max_batch=16, faults=inj, transient_retries=1,
                breaker_threshold=None)
  futs = _submit_apsp(eng, 16, nodes=12)
  poisoned_rid = futs[5].request.request_id
  inj.arm(FaultRule(point="execute", mode="persistent",
                    request_ids=frozenset({poisoned_rid})))
  assert eng.run_until_idle() == 15
  for i, fut in enumerate(futs):
    if i == 5:
      with pytest.raises(InjectedFault):
        fut.result()
    else:
      np.testing.assert_array_equal(fut.result().value, _apsp_want(i, 12))
  snap = eng.metrics_snapshot()
  assert snap["counters"]["completed"] == 15
  assert snap["counters"]["failed"] == 1
  assert snap["counters"]["retries"] > 0
  assert not eng._inflight
  names = [ev["name"] for ev in _trace_events(eng) if ev.get("ph") == "i"]
  assert "batch_bisect" in names and "batch_fail" in names
  # O(log B): a 16-wide poison needs ~log2(16) = 4 bisections
  assert 4 <= names.count("batch_bisect") <= 8
  # attempts = failed + successful sub-batches, within (r+1)·(2B−1)
  attempts = sum(snap["batch_failures_by_kind"].values()) + eng.stats().batches
  assert attempts <= 2 * (2 * 16 - 1)


def test_bisect_disabled_fails_whole_batch(engines):
  inj = FaultInjector()
  eng = engines(max_batch=4, faults=inj, transient_retries=1, bisect=False,
                breaker_threshold=None)
  futs = _submit_apsp(eng, 4)
  inj.arm(FaultRule(point="execute", mode="persistent",
                    request_ids=frozenset({futs[0].request.request_id})))
  assert eng.run_until_idle() == 0
  for fut in futs:
    with pytest.raises(InjectedFault):
      fut.result()


def test_rate_faults_never_fail_innocents(engines):
  """Chaos mode: a 20% execute fault rate with bisection and fresh per-half
  retry budgets completes every request (nobody is actually poisoned)."""
  inj = FaultInjector([FaultRule(point="execute", mode="rate", rate=0.2)],
                      seed=3)
  eng = engines(max_batch=8, faults=inj, transient_retries=2,
                breaker_threshold=None)
  futs = _submit_apsp(eng, 16)
  eng.run_until_idle()
  assert all(f.result().value.shape == (10, 10) for f in futs)
  snap = eng.metrics_snapshot()
  assert snap["counters"]["failed"] == 0
  assert snap["counters"]["completed"] == 16


# ---------------------------------------------------------------------------
# retry accounting: once-per-request outcomes, balanced spans, no re-stamp
# ---------------------------------------------------------------------------


def test_retry_does_not_double_count_or_restamp_deadlines(engines):
  inj = FaultInjector([FaultRule(point="execute", mode="transient", count=1)])
  eng = engines(max_batch=4, faults=inj, transient_retries=1,
                breaker_threshold=None, clock=FakeClock())
  futs = _submit_apsp(eng, 4, deadline_s=30.0)
  deadlines = [f.request.deadline_at for f in futs]
  assert eng.run_until_idle() == 4
  assert [f.request.deadline_at for f in futs] == deadlines
  snap = eng.metrics_snapshot()
  assert snap["counters"]["completed"] == 4   # once per request, not per try
  assert snap["counters"]["submitted"] == 4
  assert snap["counters"]["retries"] == 1
  assert eng.admission.snapshot()["inflight"] == {}
  events = _trace_events(eng)
  for fut in futs:
    rid = fut.request.request_id
    mine = [ev for ev in events
            if ev.get("ph") in ("b", "e") and ev.get("id") == rid]
    queued = [ev["ph"] for ev in mine if ev["name"] == "queued"]
    execute = [ev["ph"] for ev in mine if ev["name"] == "execute"]
    assert queued == ["b", "e"]
    assert execute == ["b", "e"] * (len(execute) // 2) and execute
  outcomes = [ev["args"]["outcome"] for ev in events
              if ev.get("name") == "execute" and ev.get("ph") == "e"
              and "outcome" in ev.get("args", {})]
  assert "retried" in outcomes and "done" in outcomes


def test_service_window_includes_retry_time(engines):
  """queue/service metrics measure what the caller experienced: the service
  window spans from the original pick through the final successful
  attempt, the backoff sleep included (a lower bound, so no flake)."""
  inj = FaultInjector([FaultRule(point="execute", mode="transient", count=1)])
  eng = engines(max_batch=2, faults=inj, transient_retries=1,
                breaker_threshold=None, retry_backoff_s=0.05)
  futs = _submit_apsp(eng, 2)
  eng.run_until_idle()
  assert all(f.done() for f in futs)
  snap = eng.metrics_snapshot()
  svc = snap["buckets"][next(iter(snap["buckets"]))]["service_ms"]
  assert svc["p50"] >= 50.0


# ---------------------------------------------------------------------------
# watchdog: a hung batch fails instead of wedging the loop
# ---------------------------------------------------------------------------


def test_watchdog_times_out_hung_batch(engines):
  inj = FaultInjector([FaultRule(point="slow", mode="transient", count=1,
                                 delay_s=2.0)])
  eng = engines(max_batch=2, faults=inj, transient_retries=0, bisect=False,
                breaker_threshold=None, watchdog_s=0.05)
  futs = _submit_apsp(eng, 2)
  t0 = time.perf_counter()
  assert eng.run_until_idle() == 0
  assert time.perf_counter() - t0 < 1.5   # did not serve the 2 s stall
  for fut in futs:
    with pytest.raises(BatchTimeoutError, match="watchdog"):
      fut.result()
  assert eng.metrics_snapshot()["batch_failures_by_kind"] == {"timeout": 1}
  # the next batch of the bucket completes, while the abandoned one sleeps
  nxt = _submit_apsp(eng, 2)
  assert eng.run_until_idle() == 2
  for i, fut in enumerate(nxt):
    np.testing.assert_array_equal(fut.result().value, _apsp_want(i))
  assert eng.join_abandoned(timeout=10.0) == 0


def test_watchdog_disabled_runs_inline(engines):
  inj = FaultInjector([FaultRule(point="slow", mode="persistent",
                                 delay_s=0.02)])
  eng = engines(max_batch=2, faults=inj, breaker_threshold=None)
  futs = _submit_apsp(eng, 2)
  assert eng.run_until_idle() == 2         # slow but correct, no timeout
  assert all(f.result().value.shape == (10, 10) for f in futs)
  assert eng._abandoned == []


# ---------------------------------------------------------------------------
# breaker re-dispatch, bit-identical results, probe close, /healthz
# ---------------------------------------------------------------------------


def test_breaker_cycle_redispatch_probe_and_health(engines):
  clock = FakeClock()
  inj = parse_fault_spec("execute:persistent:backend=xla")
  eng = engines(backend="xla", max_batch=4, faults=inj,
                fallback_backends=("vector",), breaker_threshold=2,
                transient_retries=1, breaker_probe_s=0.05, clock=clock)
  futs = _submit_apsp(eng, 8)
  assert eng.run_until_idle() == 8   # the breaker opened mid-recovery

  ref_eng = engines(backend="vector", max_batch=4)
  ref_futs = _submit_apsp(ref_eng, 8)
  ref_eng.run_until_idle()
  for fut, ref in zip(futs, ref_futs):
    np.testing.assert_array_equal(fut.result().value, ref.result().value)

  snap = eng.observability_state()
  assert ("xla", "open") in {(c["backend"], c["state"])
                             for c in snap["breakers"]}
  with ObservabilityServer(eng, port=0) as srv:
    status, body = _http_get(srv.url + "/healthz")
    assert status == 503
    health = json.loads(body)
    assert health["status"] == "degraded"
    assert health["open_breakers"][0]["backend"] == "xla"
    status, text = _http_get(srv.url + "/metrics")
    assert status == 200
    assert 'serve_breaker_state{' in text and 'backend="xla"' in text
    assert 'serve_batch_failures_total{kind="execute"}' in text
    assert "serve_retries_total" in text

    # the fault clears; after the cooldown on the engine clock the next
    # pick probes the primary arm, which closes the breaker
    inj.clear()
    clock.t += 0.06
    fut = eng.submit(apsp_request(graphs.weighted_digraph(10, 0.3, seed=42)))
    eng.run_until_idle()
    assert fut.result().value.shape == (10, 10)
    cell = [c for c in eng.resilience.snapshot() if c["backend"] == "xla"][0]
    assert cell["state"] == "closed"
    assert cell["closes"] >= 1 and cell["probes"] >= 1
    status, body = _http_get(srv.url + "/healthz")
    assert status == 200
    assert json.loads(body)["status"] == "ok"
    assert json.loads(body)["open_breakers"] == []

  names = [ev["name"] for ev in _trace_events(eng) if ev.get("ph") == "i"]
  assert {"breaker_open", "breaker_probe", "breaker_close"} <= set(names)


def test_fallback_chain_ends_at_the_plain_arm(engines):
  """Cost-ranked fallbacks (no override) end at 'vector', and a dead
  primary and second arm still serve through it."""
  inj = parse_fault_spec("execute:persistent:backend=xla;"
                         "execute:persistent:backend=pallas")
  eng = engines(backend="xla", max_batch=2, faults=inj,
                breaker_threshold=1, transient_retries=2,
                breaker_probe_s=60.0, clock=FakeClock())
  futs = _submit_apsp(eng, 2)
  eng.run_until_idle()
  for i, fut in enumerate(futs):
    np.testing.assert_array_equal(fut.result().value, _apsp_want(i))
  key = next(iter(eng._fallback_arms_memo))
  assert [a[0] for a in eng._fallback_arms(key)] == ["pallas", "vector"]


def test_megakernel_fallback_is_for_closure_buckets_only(engines):
  eng = engines(backend="xla", fallback_backends=("megakernel", "vector"))
  closure = request_bucket(apsp_request(graphs.weighted_digraph(10, 0.3)))
  a = np.ones((6, 6), np.float32)
  mmo = request_bucket(tserve.mmo_request(a, a, op="minplus"))
  assert [b for b, _, _ in eng._fallback_arms(closure)] == ["megakernel",
                                                            "vector"]
  assert [b for b, _, _ in eng._fallback_arms(mmo)] == ["vector"]


def test_breaker_disabled_keeps_failing_in_place(engines):
  inj = parse_fault_spec("execute:persistent:backend=vector")
  eng = engines(max_batch=2, faults=inj, transient_retries=0, bisect=False,
                breaker_threshold=None)
  futs = _submit_apsp(eng, 2)
  assert eng.run_until_idle() == 0
  for fut in futs:
    with pytest.raises(InjectedFault):
      fut.result()
  assert eng.observability_state()["breakers"] == []


# ---------------------------------------------------------------------------
# parity with the reference engine: one stream, one spec, one seed
# ---------------------------------------------------------------------------


def _stream_specs(seed, count):
  rng = np.random.default_rng(seed)
  kinds = ("apsp", "reach", "mmo", "mma", "knn")
  return [(kinds[i % len(kinds)], int(rng.integers(9, 30)),
           int(rng.integers(2 ** 31))) for i in range(count)]


def _request(api, spec):
  kind, n, seed = spec
  if kind == "apsp":
    return api.apsp_request(graphs.weighted_digraph(n, 0.3, seed=seed))
  if kind == "reach":
    return api.reachability_request(graphs.boolean_digraph(n, 0.1, seed=seed))
  if kind == "knn":
    ref, qry = graphs.knn_points(4 * n, n, 16, seed=seed)
    return api.knn_request(qry, ref, k=4)
  rng = np.random.default_rng(seed)
  a = rng.standard_normal((n, n)).astype(np.float32)
  b = rng.standard_normal((n, n)).astype(np.float32)
  return api.mmo_request(a, b, op="minplus" if kind == "mmo" else "mma")


_PARITY = {
    "transient": ("execute:transient:2;compile:transient:1", {}),
    "rate": ("execute:rate:0.3;nonfinite:rate:0.1", dict(transient_retries=2)),
    "poison": ("nonfinite:persistent:rid=3;execute:persistent:rid=7",
               dict(max_batch=8)),
    "breaker": ("execute:persistent:backend=xla@closure",
                dict(fallback_backends=("vector",), breaker_threshold=2)),
    "no_bisect": ("execute:rate:0.4", dict(bisect=False)),
}


def _run_parity(api, spec, knobs, seed, specs, extra):
  clock = FakeClock()
  kw = dict(backend="xla", max_batch=4, clock=clock, retry_backoff_s=0.0,
            faults=api.parse_fault_spec(spec, seed=seed))
  kw.update(knobs)
  if api is tserve:
    kw["device"] = "cpu"
  eng = api.MMOEngine(**kw)
  futs = [eng.submit(_request(api, s)) for s in specs]
  eng.run_until_idle()
  # the fault clears, the cooldown passes on the fake clock, more traffic
  # comes: open breakers probe and close
  eng.faults.clear()
  clock.t += 1.0
  futs += [eng.submit(_request(api, s)) for s in extra]
  eng.run_until_idle()
  outcomes = []
  for f in futs:
    try:
      outcomes.append(("done", f.result()))
    except Exception as e:  # noqa: BLE001 — the outcome is the comparison
      outcomes.append((type(e).__name__, None))
  snap = eng.metrics_snapshot()
  names = [ev["name"] for ev in eng.export_trace()["traceEvents"]]
  counters = dict(snap["counters"])
  if api is tserve:
    # the port stamps each batch's stages where the reference apportions
    # squaring slices: compare what both record
    assert counters.pop("syncs") > 0 and counters.pop("d2h_bytes") > 0
    names = [n for n in names if n not in STAGES and n != "thread_name"]
  else:
    names = [n for n in names if not n.startswith("squaring_iter")]
  return {"outcomes": outcomes, "counters": counters,
          "kinds": snap["batch_failures_by_kind"],
          "breakers": eng.resilience.snapshot(),
          "names": names,
          "fired": eng.faults.stats()["fired"]}


@pytest.mark.parametrize("case", sorted(_PARITY))
def test_fault_stream_matches_the_reference_engine(case):
  spec, knobs = _PARITY[case]
  specs, extra = _stream_specs(5, 14), _stream_specs(6, 6)
  want = _run_parity(jserve, spec, knobs, 11, specs, extra)
  got = _run_parity(tserve, spec, knobs, 11, specs, extra)
  for k in ("counters", "kinds", "breakers", "names", "fired"):
    assert got[k] == want[k], k
  assert [o for o, _ in got["outcomes"]] == [o for o, _ in want["outcomes"]]
  assert any(o != "done" for o, _ in got["outcomes"]) or got["kinds"]
  for (kind, _, _), (o, g), (_, w) in zip(specs + extra, got["outcomes"],
                                          want["outcomes"]):
    if o != "done":
      continue
    assert g.value.shape == w.value.shape
    if kind in ("apsp", "reach", "mmo"):
      np.testing.assert_array_equal(g.value, np.asarray(w.value))
      assert g.extras.keys() == w.extras.keys()
      if "iterations" in g.extras:
        assert g.extras["iterations"] == w.extras["iterations"]
    else:
      np.testing.assert_allclose(g.value, np.asarray(w.value), rtol=1e-5,
                                 atol=1e-4)
