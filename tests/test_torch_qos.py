"""The port's QoS layer against the reference: policies, the batch cap,
admission, deadlines and metrics, on the CPU.

Parity first: one seeded script of adds and picks through both packages'
``BucketScheduler`` under each policy (the same ``predict_seconds`` hook)
must take the same batches, fail the same requests fast and compute the
same batch caps; one script of submissions through both packages'
``AdmissionController`` must give the same verdicts and snapshots; one
mixed stream through both engines under ``conftest.FakeClock`` must give the
same results (KNN distances within rtol 1e-5 / atol 1e-4, as in
tests/test_torch_serve_mmo.py) and the same expired and rejected ids.  Then
the reference's QoS pins, on the port.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import FakeClock  # noqa: E402
from repro import serve_mmo as jserve  # noqa: E402
from repro import tuning as jtune  # noqa: E402
from repro_torch import serve_mmo as tserve  # noqa: E402
from repro_torch.apps import graphs  # noqa: E402
from repro_torch.serve_mmo.scheduler import (BucketScheduler,  # noqa: E402
                                             FifoBucketScheduler,
                                             contract_shape, request_bucket)
from repro_torch.tuning import CostTable  # noqa: E402

RNG = np.random.default_rng(0)
TENANTS = ("a", "b", "c")


def _mmo(n, **qos):
  a = RNG.standard_normal((n, n)).astype(np.float32)
  b = RNG.standard_normal((n, n)).astype(np.float32)
  return tserve.mmo_request(a, b, op="mma", **qos)


def _request(api, spec):
  """One request from a plain spec, so both packages get the same arrays."""
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
  b = rng.standard_normal((n, n)).astype(np.float32)
  return api.mmo_request(a, b, op="minplus", **qos)


def _specs(seed, count, kinds=("apsp", "reach", "knn", "mmo")):
  rng = np.random.default_rng(seed)
  out = []
  for _ in range(count):
    kind = kinds[int(rng.integers(len(kinds)))]
    qos = {"tenant": TENANTS[int(rng.integers(3))]}
    if rng.random() < 0.5:
      qos["deadline_s"] = float(rng.choice([0.05, 0.3, 2.0, 50.0]))
    if rng.random() < 0.3:
      qos["priority"] = int(rng.integers(1, 3))
    out.append((kind, int(rng.choice([9, 12, 20, 30])),
                int(rng.integers(2 ** 31)), qos))
  return out


def _predict(key) -> float:
  """One deterministic prediction hook for both packages' schedulers."""
  return 0.01 * key.shape[0] / 8.0 + (0.05 if key.kind == "closure" else 0.0)


def _policy(api, name):
  if name == "fair":
    return api.FairSharePolicy(weights={"a": 2, "b": 1, "c": 3})
  return name


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap_s", [None, 0.08])
@pytest.mark.parametrize("policy", ["fifo", "deadline", "fair"])
def test_scheduler_script_matches_the_reference(policy, cap_s):
  clock = {"t": 0.0}
  scheds = {}
  for name, api, mod in (("ref", jserve, jserve.scheduler),
                         ("port", tserve, None)):
    cls = mod.BucketScheduler if mod is not None else BucketScheduler
    s = cls(policy=_policy(api, policy), max_batch=4,
            clock=lambda: clock["t"], max_batch_seconds=cap_s,
            deadline_lookback_s=0.5)
    s.predict_seconds = _predict
    scheds[name] = (s, api)
  rng = np.random.default_rng(11)
  specs = _specs(12, 60)
  log = {"ref": [], "port": []}
  rid = 0
  for step in range(120):
    clock["t"] += float(rng.choice([0.0, 0.01, 0.1, 0.4]))
    if specs and rng.random() < 0.55:
      spec = specs.pop()
      for name, (s, api) in scheds.items():
        req = _request(api, spec)
        req.request_id = rid
        s.add(req)
      rid += 1
      continue
    for name, (s, _) in scheds.items():
      now = clock["t"]
      caps = sorted((tuple(k), s.policy.batch_cap(k, s, now))
                    for k in s.pending_buckets())
      picked = s.next_batch(now=now)
      batch = (None if picked is None else
               (tuple(picked[0]), [r.request_id for r in picked[1]]))
      expired = sorted(r.request_id for r in s.take_expired())
      log[name].append((caps, batch, expired,
                        s.deadline_traffic_active(now), len(s)))
  assert log["port"] == log["ref"]
  assert any(entry[2] for entry in log["port"]), "no request expired"
  if cap_s is not None and policy != "fair":
    assert any(c < 4 for entry in log["port"] for _, c in entry[0])


@pytest.mark.parametrize("limits", [
    dict(max_queue=3),
    dict(tenant_quota=2),
    dict(tenant_quota={"a": 1, "c": 3}),
    dict(max_backlog_s=0.5),
    dict(max_queue=5, tenant_quota=3, max_backlog_s=1.0),
])
def test_admission_script_matches_the_reference(limits):
  ctrl = {"ref": jserve.AdmissionController(**limits),
          "port": tserve.AdmissionController(**limits)}
  rng = np.random.default_rng(len(str(limits)))
  live = {"ref": [], "port": []}
  verdicts = {"ref": [], "port": []}
  for i in range(80):
    r, u = rng.random(), rng.random()
    spec = ("mmo", 9, i, {"tenant": TENANTS[int(rng.integers(3))]})
    cost = float(rng.uniform(0.0, 0.4))
    for name, api in (("ref", jserve), ("port", tserve)):
      c = ctrl[name]
      if r < 0.6:
        req = _request(api, spec)
        v = c.try_admit(req, cost_s=cost)
        verdicts[name].append(v)
        if v is None:
          live[name].append([req, "queued"])
      elif live[name]:
        j = int(u * len(live[name]))
        req, state = live[name][j]
        if state == "queued":
          c.on_dequeue(req)
          live[name][j][1] = "executing"
        else:
          c.on_done(req)
          live[name].pop(j)
    assert ctrl["port"].snapshot() == ctrl["ref"].snapshot()
  assert verdicts["port"] == verdicts["ref"]
  assert any(v is not None for v in verdicts["port"]), "nothing rejected"
  assert ctrl["port"].unbounded is False


def _shared_table(specs):
  """One measured table for both engines, a row per bucket of the stream,
  so both price every request the same way (the two priors differ)."""
  table = CostTable(device="test")
  for spec in specs:
    key = request_bucket(_request(tserve, spec))
    m, k, n = contract_shape(key)
    table.record(key.op, (m, k, n), key.dtypes[0], "xla", (512,),
                 2e-2 * (m * k * n) ** (1 / 3) / 8.0)
  return table


def _drive(eng, api, events, clock):
  """Submit and step as the script says; the clock moves a fixed step per
  engine step, outside the engine."""
  futs = []
  for ev in events:
    if ev == "step":
      eng.step()
      clock.t += 0.15
    else:
      futs.append(eng.submit(_request(api, ev)))
  while eng.step():
    clock.t += 0.15
  eng.run_until_idle()
  return futs


@pytest.mark.parametrize("policy", ["fifo", "deadline", "fair"])
def test_engine_stream_matches_the_reference(policy):
  specs = _specs(21, 24)
  rng = np.random.default_rng(22)
  events = []
  for spec in specs:
    events.append(spec)
    if rng.random() < 0.35:
      events.append("step")
  table = _shared_table(specs)
  jtable = jtune.CostTable.from_json(table.to_json())
  kw = dict(backend="xla", max_batch=4, max_queue=7, max_backlog_s=1.5,
            tenant_quota={"c": 3})
  jclock, tclock = FakeClock(), FakeClock()
  jeng = jserve.MMOEngine(policy=_policy(jserve, policy), clock=jclock,
                          cost_table=jtable, **kw)
  teng = tserve.MMOEngine(policy=_policy(tserve, policy), clock=tclock,
                          cost_table=table, device="cpu", **kw)
  jfuts = _drive(jeng, jserve, events, jclock)
  tfuts = _drive(teng, tserve, events, tclock)
  assert [f.state for f in tfuts] == [f.state for f in jfuts]
  states = {f.state for f in tfuts}
  assert {"done", "rejected", "expired"} <= states
  for jf, tf, spec in zip(jfuts, tfuts, [e for e in events if e != "step"]):
    if tf.state != "done":
      with pytest.raises((tserve.RejectedError,
                          tserve.DeadlineExceededError)):
        tf.result()
      continue
    g, r = tf.result(), jf.result()
    assert g.value.shape == r.value.shape and g.value.dtype == r.value.dtype
    if spec[0] == "knn":
      np.testing.assert_array_equal(g.extras["indices"], r.extras["indices"])
      np.testing.assert_allclose(g.value, r.value, rtol=1e-5, atol=1e-4)
    else:
      np.testing.assert_array_equal(g.value, r.value)
      assert g.extras == r.extras
  jst, tst = jeng.stats(), teng.stats()
  assert (tst.completed, tst.rejected, tst.expired) == (
      jst.completed, jst.rejected, jst.expired)
  assert teng.admission.snapshot() == jeng.admission.snapshot()
  assert (teng.metrics_snapshot()["counters"]
          == jeng.metrics_snapshot()["counters"])
  assert (teng.metrics_snapshot()["rejected_by_reason"]
          == jeng.metrics_snapshot()["rejected_by_reason"])


# ---------------------------------------------------------------------------
# deadline policy beats FIFO under bulk interference (scheduling alone)
# ---------------------------------------------------------------------------


def _interference_p99(policy):
  """p99 latency of small deadline-tagged requests submitted behind a
  burst of bulk closures.  Every batch takes one fixed step of the fake
  clock, added by a wrapper around each built batch function here in the
  test, so the ratio is the scheduling's and not the host's."""
  clock = FakeClock()
  eng = tserve.MMOEngine(backend="xla", max_batch=4, policy=policy,
                         clock=clock, device="cpu")
  build = eng.cache.get_or_compile

  def timed_build(*a, **kw):
    fn = build(*a, **kw)

    def run(*args):
      clock.t += 0.1  # one batch's service time
      return fn(*args)
    return run

  eng.cache.get_or_compile = timed_build
  eng.prewarm([tserve.apsp_request(graphs.weighted_digraph(40, 0.3, seed=0)),
               _mmo(12)])
  bulk = [eng.submit(tserve.apsp_request(
      graphs.weighted_digraph(40 + (i % 3), 0.3, seed=i), tenant="bulk"))
      for i in range(12)]
  urgent = [eng.submit(_mmo(12, deadline_s=60.0, priority=1,
                            tenant="interactive")) for _ in range(8)]
  eng.run_until_idle()
  recs = {r.request_id: r for r in eng._records}
  lat = [recs[f.request.request_id].latency_s for f in urgent]
  assert all(f.state == "done" for f in bulk + urgent)
  return float(np.percentile(lat, 99))


def test_deadline_p99_at_least_2x_better_than_fifo_under_bulk():
  fifo = _interference_p99("fifo")
  deadline = _interference_p99("deadline")
  assert deadline * 2.0 <= fifo, (
      f"deadline-policy p99 {deadline:.2f}s not 2x better than FIFO "
      f"{fifo:.2f}s under bulk interference")


# ---------------------------------------------------------------------------
# policies (scheduler level), the reference's pins on the port
# ---------------------------------------------------------------------------


def test_make_policy_rejects_unknown():
  with pytest.raises(ValueError, match="unknown policy"):
    tserve.make_policy("lifo")
  p = tserve.DeadlinePolicy()
  assert tserve.make_policy(p) is p
  from repro_torch.serve_mmo.policy import POLICIES
  assert set(POLICIES) == {"fifo", "deadline", "fair"}


def test_deadline_policy_prefers_deadline_bucket_over_older_bulk():
  sched = BucketScheduler(policy="deadline", max_batch=4)
  bulk = [tserve.apsp_request(graphs.weighted_digraph(12, 0.3, seed=i))
          for i in range(3)]
  for r in bulk:
    sched.add(r)
  urgent = _mmo(12, deadline_s=10.0)
  sched.add(urgent)
  assert sched.next_batch()[1] == [urgent]
  assert sched.next_batch()[1] == bulk


def test_deadline_policy_priority_tiers_and_deadline_order():
  sched = BucketScheduler(policy="deadline", max_batch=4)
  low = tserve.apsp_request(graphs.weighted_digraph(12, 0.3, seed=0))
  high = _mmo(12, priority=5)
  sched.add(low)
  sched.add(high)
  assert sched.next_batch()[1] == [high]
  assert sched.next_batch()[1] == [low]
  sched = BucketScheduler(policy="deadline", max_batch=1, clock=FakeClock())
  late, soon = _mmo(12, deadline_s=50.0), _mmo(12, deadline_s=5.0)
  sched.add(late)
  sched.add(soon)
  assert sched.next_batch(now=0.0)[1] == [soon]
  assert sched.next_batch(now=0.0)[1] == [late]


def test_deadline_policy_fails_fast_hopeless_requests():
  sched = BucketScheduler(policy="deadline", max_batch=4, clock=FakeClock())
  sched.predict_seconds = lambda key: 100.0
  hopeless, fine = _mmo(12, deadline_s=1.0), _mmo(12)
  sched.add(hopeless)
  sched.add(fine)
  assert sched.next_batch(now=0.0)[1] == [fine]
  assert sched.take_expired() == [hopeless]
  assert len(sched) == 0


def test_already_expired_requests_diverted_under_fifo_too():
  clock = FakeClock()
  sched = FifoBucketScheduler(max_batch=4, clock=clock)
  doomed, ok = _mmo(12, deadline_s=1.0), _mmo(12)
  sched.add(doomed)
  sched.add(ok)
  clock.t = 2.0
  assert sched.next_batch()[1] == [ok]
  assert sched.take_expired() == [doomed]


def test_fair_share_weighted_round_robin_across_tenants():
  sched = BucketScheduler(
      policy=tserve.FairSharePolicy(weights={"a": 2, "b": 1}), max_batch=1)
  for _ in range(4):
    sched.add(_mmo(12, tenant="a"))
  for _ in range(4):
    sched.add(_mmo(24, tenant="b"))
  order = []
  while (picked := sched.next_batch()) is not None:
    order.append(picked[1][0].tenant)
  assert order == ["a", "a", "b", "a", "a", "b", "b", "b"]


def test_fair_share_batch_may_carry_other_tenants():
  sched = BucketScheduler(policy="fair", max_batch=4)
  mine, theirs = _mmo(12, tenant="a"), _mmo(12, tenant="b")
  sched.add(mine)
  sched.add(theirs)
  assert sched.next_batch()[1] == [mine, theirs]
  assert sched.next_batch() is None


def test_fair_share_refunds_turns_that_serve_the_tenant_nothing():
  sched = BucketScheduler(policy="fair", max_batch=2)
  for _ in range(4):
    sched.add(_mmo(12, tenant="a"))
  sched.add(_mmo(12, tenant="b"))
  for _ in range(3):
    sched.add(_mmo(24, tenant="c"))
  served = []
  while (picked := sched.next_batch()) is not None:
    served.append([r.tenant for r in picked[1]])
  assert served == [["a", "a"], ["a", "a"], ["b"], ["c", "c"], ["c"]]


def test_fair_share_drops_drained_tenants_and_survives_cleared_buckets():
  policy = tserve.FairSharePolicy()
  sched = BucketScheduler(policy=policy, max_batch=8)
  for i in range(5):
    sched.add(_mmo(12, tenant=f"user-{i}"))
  while sched.next_batch() is not None:
    pass
  assert policy._order == [] and policy._queues == {}
  sched.add(_mmo(12, tenant="user-3"))
  assert [r.tenant for r in sched.next_batch()[1]] == ["user-3"]
  sched = BucketScheduler(policy="fair", max_batch=2)
  sched.add(_mmo(12, tenant="a"))
  sched.add(_mmo(24, tenant="b"))
  sched._buckets.clear()
  assert sched.next_batch() is None and len(sched) == 0


def test_heap_pick_matches_linear_scan_reference():
  rng = np.random.default_rng(42)
  sched = FifoBucketScheduler(max_batch=2)

  def linear_reference():
    best_key, best_seq = None, None
    for key, q in sched._buckets.items():
      if q and (best_seq is None or q[0].seq < best_seq):
        best_key, best_seq = key, q[0].seq
    return best_key

  for _ in range(300):
    if rng.random() < 0.6 or len(sched) == 0:
      sched.add(_mmo(int(rng.integers(8, 80))))
    else:
      expect = linear_reference()
      assert sched.next_batch()[0] == expect
  while len(sched):
    expect = linear_reference()
    assert sched.next_batch()[0] == expect


def _bulk_sched(clock, max_batch_seconds, per_request_s=1.0, **kw):
  sched = BucketScheduler(policy="deadline", max_batch=8, clock=clock,
                          max_batch_seconds=max_batch_seconds, **kw)
  sched.predict_seconds = lambda key: per_request_s
  return sched


def test_batch_cap_binds_only_with_deadline_traffic():
  clock = FakeClock()
  sched = _bulk_sched(clock, max_batch_seconds=2.0)
  for _ in range(8):
    sched.add(_mmo(12))
  assert len(sched.next_batch()[1]) == 8  # pure bulk: full batches
  sched = _bulk_sched(clock, max_batch_seconds=3.0)  # 3 s / 1 s → 3 → 2
  for _ in range(8):
    sched.add(_mmo(12))
  sched.add(_mmo(24, deadline_s=60.0))
  assert [r.shape[0] for r in sched.next_batch()[1]] == [24]
  assert len(sched.next_batch()[1]) == 2  # the power-of-two floor of 3
  sched = _bulk_sched(clock, max_batch_seconds=0.5)
  for _ in range(4):
    sched.add(_mmo(12))
  sched.add(_mmo(24, deadline_s=60.0))
  sched.next_batch()
  assert len(sched.next_batch()[1]) == 1  # never zero


def test_batch_cap_recency_window_expires():
  clock = FakeClock()
  sched = _bulk_sched(clock, max_batch_seconds=2.0, deadline_lookback_s=1.0)
  sched.add(_mmo(24, deadline_s=60.0))
  sched.next_batch()
  for _ in range(8):
    sched.add(_mmo(12))
  clock.t = 0.5
  assert sched.deadline_traffic_active(clock.t)
  assert len(sched.next_batch()[1]) == 2
  clock.t = 2.0
  assert not sched.deadline_traffic_active(clock.t)
  assert len(sched.next_batch()[1]) == 6


@pytest.mark.parametrize("bad", [lambda k: 0.0, lambda k: float("inf"),
                                 None])
def test_batch_cap_survives_bad_predictions(bad):
  sched = BucketScheduler(policy="deadline", max_batch=4, clock=FakeClock(),
                          max_batch_seconds=1.0)
  sched.predict_seconds = bad
  sched.add(_mmo(24, deadline_s=60.0))
  sched.next_batch()
  for _ in range(4):
    sched.add(_mmo(12))
  assert len(sched.next_batch()[1]) == 4


@pytest.mark.parametrize("kw", [dict(max_batch=0),
                                dict(max_batch_seconds=0.0)])
def test_scheduler_validation(kw):
  with pytest.raises(ValueError):
    BucketScheduler(**kw)


# ---------------------------------------------------------------------------
# the engine: deadlines, fail-fast, the batch cap, admission, metrics
# ---------------------------------------------------------------------------


def test_engine_expires_queued_request_past_deadline():
  clock = FakeClock()
  eng = tserve.MMOEngine(backend="xla", max_batch=4, clock=clock,
                         device="cpu")
  doomed = eng.submit(_mmo(12, deadline_s=1.0))
  ok = eng.submit(_mmo(12))
  clock.t = 5.0
  eng.run_until_idle()
  assert doomed.state == "expired"
  with pytest.raises(tserve.DeadlineExceededError,
                     match="missed its 1s deadline"):
    doomed.result()
  assert ok.result().value.shape == (12, 12)
  st = eng.stats()
  assert st.expired == 1 and st.completed == 1
  assert eng.pending() == 0 and eng.admission.queued == 0
  assert dict(eng.admission.inflight) == {}
  snap = eng.metrics_snapshot()
  assert snap["counters"]["expired"] == 1
  assert snap["counters"]["completed"] == 1


def test_engine_deadline_policy_fails_fast_infeasible():
  table = CostTable(device="test")
  table.record("mma", (16, 16, 16), "float32", "xla", (512,), 100.0)
  eng = tserve.MMOEngine(backend="auto", max_batch=4, policy="deadline",
                         cost_table=table, clock=FakeClock(), device="cpu")
  hopeless = eng.submit(_mmo(12, deadline_s=1.0))
  fine = eng.submit(_mmo(12, deadline_s=600.0))
  eng.run_until_idle()
  assert hopeless.state == "expired" and fine.state == "done"
  with pytest.raises(tserve.DeadlineExceededError):
    hopeless.result()


def test_preemption_deadline_met_with_cap_missed_without():
  """An urgent request arriving mid-bulk-burst meets its deadline under the
  service-time batch cap and misses it without (the reference's pin, on
  the fake clock: the batch's predicted duration is added after it)."""
  table = CostTable(device="test")
  table.record("minplus", (16, 16, 16), "float32", "xla", (512,), 0.25)
  table.record("mma", (16, 16, 16), "float32", "xla", (512,), 0.01)

  def run(max_batch_seconds):
    clock = FakeClock()
    eng = tserve.MMOEngine(backend="xla", max_batch=8, policy="deadline",
                           cost_table=table, clock=clock, device="cpu",
                           max_batch_seconds=max_batch_seconds,
                           deadline_lookback_s=60.0)
    first = eng.submit(_mmo(12, deadline_s=10.0, priority=1))
    bulk = [eng.submit(tserve.apsp_request(
        graphs.weighted_digraph(12, 0.3, seed=i), tenant="bulk"))
        for i in range(8)]
    assert eng.step() == 1 and first.state == "done"
    served = eng.step()
    clock.t = 0.5
    urgent = eng.submit(_mmo(12, deadline_s=2.5, priority=1))
    clock.t = float(served) * 1.0
    eng.step()
    eng.run_until_idle()
    assert all(f.state == "done" for f in bulk)
    return served, urgent

  served, urgent = run(max_batch_seconds=None)
  assert served == 8 and urgent.state == "expired"
  served, urgent = run(max_batch_seconds=2.0)
  assert served == 2 and urgent.state == "done"
  assert urgent.result().value.shape == (12, 12)


def test_admission_max_queue_bounds_depth():
  eng = tserve.MMOEngine(backend="xla", max_batch=4, max_queue=4,
                         device="cpu")
  futs = [eng.submit(_mmo(12)) for _ in range(10)]
  rejected = [f for f in futs if f.state == "rejected"]
  assert len(rejected) == 6 and len(eng.scheduler) == 4
  assert eng.admission.queued == 4
  for f in rejected:
    with pytest.raises(tserve.RejectedError, match="queue full"):
      f.result()
  assert eng.run_until_idle() == 4
  st = eng.stats()
  assert st.rejected == 6 and st.completed == 4
  assert "rejected=6" in st.summary()
  assert eng.submit(_mmo(12)).state == "pending"
  assert eng.metrics_snapshot()["rejected_by_reason"] == {"queue_full": 6}


def test_admission_tenant_quota_in_flight():
  eng = tserve.MMOEngine(backend="xla", max_batch=4,
                         tenant_quota={"noisy": 2}, device="cpu")
  f1 = eng.submit(_mmo(12, tenant="noisy"))
  eng.submit(_mmo(12, tenant="noisy"))
  f3 = eng.submit(_mmo(12, tenant="noisy"))
  quiet = eng.submit(_mmo(12, tenant="quiet"))
  assert f3.state == "rejected" and quiet.state == "pending"
  with pytest.raises(tserve.RejectedError, match="over quota"):
    f3.result()
  eng.run_until_idle()
  assert f1.result().value.shape == (12, 12)
  assert eng.submit(_mmo(12, tenant="noisy")).state == "pending"
  assert eng.admission.rejections == {"tenant_quota": 1}


def test_admission_predicted_backlog_seconds():
  table = CostTable(device="test")
  table.record("mma", (16, 16, 16), "float32", "xla", (512,), 10.0)
  table.record("minplus", (16, 16, 16), "float32", "xla", (512,), 1e-4)
  eng = tserve.MMOEngine(backend="auto", max_batch=4, cost_table=table,
                         max_backlog_s=15.0, device="cpu")
  f1, f2 = eng.submit(_mmo(12)), eng.submit(_mmo(12))
  assert f1.state == "pending" and f2.state == "rejected"
  with pytest.raises(tserve.RejectedError, match="predicted backlog"):
    f2.result()
  cheap = eng.submit(tserve.apsp_request(graphs.weighted_digraph(12, 0.3,
                                                                 seed=0)))
  assert cheap.state == "pending"
  assert eng.admission.backlog_s == pytest.approx(10.0 + 4e-4, rel=1e-6)
  eng.run_until_idle()
  assert eng.admission.backlog_s == pytest.approx(0.0, abs=1e-12)


def test_predict_request_seconds_fixed_backend_reads_table():
  table = CostTable(device="test")
  table.record("mma", (16, 16, 16), "float32", "vector", (128,), 7.0)
  table.record("minplus", (16, 16, 16), "float32", "vector", (128,), 2.0)
  eng = tserve.MMOEngine(backend="vector", cost_table=table, device="cpu")
  assert eng.predict_request_seconds(request_bucket(_mmo(12))) == \
      pytest.approx(7.0)
  ck = request_bucket(tserve.apsp_request(graphs.weighted_digraph(12, 0.3,
                                                                  seed=0)))
  assert eng.predict_request_seconds(ck) == pytest.approx(2.0 * 4)


def test_admission_controller_unbounded_and_validation():
  adm = tserve.AdmissionController()
  assert adm.unbounded
  req = _mmo(12)
  assert adm.try_admit(req) is None
  adm.on_dequeue(req)
  adm.on_done(req)
  assert adm.queued == 0 and dict(adm.inflight) == {}
  with pytest.raises(ValueError, match="max_queue"):
    tserve.AdmissionController(max_queue=0)
  with pytest.raises(ValueError, match="max_backlog_s"):
    tserve.AdmissionController(max_backlog_s=0.0)


def test_auto_engine_dispatches_closures_over_the_closure_pool():
  """backend='auto' lets the fused arm compete for closure buckets only;
  results equal the arm each bucket resolves to."""
  table = CostTable(device="test")
  table.record("minplus", (16, 16, 16), "float32", "megakernel", (4,), 1e-9)
  table.record("minplus", (16, 16, 16), "float32", "pallas", (), 1e-3)
  table.record("mma", (16, 16, 16), "float32", "vector", (128,), 1e-9)
  eng = tserve.MMOEngine(backend="auto", cost_table=table, device="cpu")
  w = graphs.weighted_digraph(12, 0.3, seed=5)
  a = np.ones((12, 12), np.float32)
  fc = eng.submit(tserve.apsp_request(w))
  fm = eng.submit(tserve.mmo_request(a, a, op="minplus"))
  fv = eng.submit(tserve.mmo_request(a, a, op="mma"))
  eng.run_until_idle()
  decisions = {(k.kind, k.op): d for k, d in eng._decisions.items()}
  assert decisions == {("closure", "minplus"): ("megakernel", (4,)),
                       ("mmo", "minplus"): ("pallas", ()),
                       ("mmo", "mma"): ("vector", (128,))}
  want = tserve.MMOEngine(backend="pallas", device="cpu")
  wc = want.submit(tserve.apsp_request(w))
  wm = want.submit(tserve.mmo_request(a, a, op="minplus"))
  np.testing.assert_array_equal(fc.result().value, wc.result().value)
  assert fc.result().extras == wc.result().extras
  np.testing.assert_array_equal(fm.result().value, wm.result().value)
  np.testing.assert_array_equal(fv.result().value, a @ a)


def test_rolling_window_percentiles_and_eviction():
  w = tserve.RollingWindow(size=4)
  assert w.percentile(50) is None
  for v in (1.0, 2.0, 3.0, 4.0, 100.0):
    w.add(v)
  assert w.count == 5
  assert sorted(w.values()) == [2.0, 3.0, 4.0, 100.0]
  assert w.percentile(0) == 2.0 and w.percentile(100) == 100.0
  with pytest.raises(ValueError):
    tserve.RollingWindow(size=0)
  h = tserve.LogHistogram()
  for v in (1e-6, 3e-3, float("nan"), 100.0):
    h.add(v)
  counts, total, n = h.state()
  assert n == 3 and counts[0] == 1 and counts[-1] == 1
  assert total == pytest.approx(100.003)


def test_metrics_snapshot_midrun_under_background_loop():
  eng = tserve.MMOEngine(backend="xla", max_batch=4, device="cpu")
  eng.prewarm([tserve.apsp_request(graphs.weighted_digraph(12, 0.3, seed=0))])
  eng.start()
  try:
    futs = [eng.submit(tserve.apsp_request(
        graphs.weighted_digraph(10 + (i % 4), 0.3, seed=i)))
        for i in range(24)]
    mid = eng.metrics_snapshot()
    assert mid["counters"]["submitted"] == 24
    assert mid["counters"]["rejected"] == 0
    assert 0 <= mid["queue_depth"] <= 24
    for f in futs:
      f.result(timeout=120)
  finally:
    eng.stop()
  done = eng.metrics_snapshot()
  assert done["counters"]["completed"] == 24 and done["queue_depth"] == 0
  (label,) = [k for k in done["buckets"] if k.startswith("closure/minplus")]
  b = done["buckets"][label]
  assert b["completed"] == 24
  assert b["service_ms"]["p50"] <= b["service_ms"]["p99"]
  assert b["queue_ms"]["p99"] >= 0.0


def test_metrics_snapshot_concurrent_with_serving_is_safe():
  eng = tserve.MMOEngine(backend="xla", max_batch=4, device="cpu")
  eng.prewarm([_mmo(12)])
  eng.start()
  seen, errs = [], []

  def poll():
    try:
      for _ in range(50):
        seen.append(eng.metrics_snapshot()["counters"]["completed"])
        time.sleep(0.002)
    except Exception as e:  # noqa: BLE001
      errs.append(e)

  t = threading.Thread(target=poll)
  t.start()
  try:
    futs = [eng.submit(_mmo(12)) for _ in range(32)]
    for f in futs:
      f.result(timeout=120)
  finally:
    t.join(timeout=60)
    eng.stop()
  assert not t.is_alive() and not errs
  assert seen == sorted(seen)


@pytest.mark.parametrize("policy", ["fifo", "deadline", "fair"])
def test_engine_results_correct_under_every_policy(policy):
  from repro_torch.apps import solvers
  eng = tserve.MMOEngine(backend="xla", max_batch=4, policy=policy,
                         device="cpu")
  ws = {n: graphs.weighted_digraph(n, 0.3, seed=n) for n in (9, 11, 13)}
  futs = {n: eng.submit(tserve.apsp_request(w, tenant=f"t{n % 2}",
                                            deadline_s=600.0))
          for n, w in ws.items()}
  eng.run_until_idle()
  for n, w in ws.items():
    ref, _ = solvers.apsp(w, device="cpu", backend="xla")
    np.testing.assert_allclose(futs[n].result().value, ref.numpy(),
                               atol=1e-5)


def test_request_bucket_ignores_qos_fields():
  w = graphs.weighted_digraph(12, 0.3, seed=0)
  assert (request_bucket(tserve.apsp_request(w))
          == request_bucket(tserve.apsp_request(w, tenant="x", priority=3,
                                                deadline_s=1.0)))


def test_launch_serve_mmo_qos_flags_on_cpu(tmp_path, capsys):
  """launch/serve_mmo.py's QoS and tuning flags: auto dispatch tuned on
  the device, the deadline policy with adaptive predictions and the batch
  cap, a persisted cost table, and metrics snapshots as JSON lines."""
  import json
  from repro_torch.launch import serve_mmo as tlaunch
  table, metrics = tmp_path / "table.json", tmp_path / "metrics.jsonl"
  argv = ["--device", "cpu", "--backend", "auto", "--autotune",
          "--cost-table", str(table), "--policy", "deadline", "--adaptive",
          "--deadline-s", "0.25", "--max-batch-seconds", "0.02",
          "--max-queue", "64", "--tenant-quota", "32", "--rate", "40",
          "--duration", "0.4", "--sizes", "12,20", "--max-batch", "4",
          "--metrics-every", "0.1", "--metrics-file", str(metrics)]
  assert tlaunch.main(argv) == 0
  out = capsys.readouterr().out
  assert "policy=deadline" in out and "auto dispatch" in out
  assert "'failed': 0" in out and "adaptive estimator" in out
  assert CostTable.load(table).counts()["measured"] > 0
  lines = metrics.read_text().splitlines()
  assert lines and all(line.startswith("[serve_mmo][metrics] ")
                       for line in lines)
  snap = json.loads(lines[-1].split(" ", 1)[1])
  assert snap["admission"]["limits"]["max_queue"] == 64
  with pytest.raises(SystemExit):  # a missing table needs --autotune
    tlaunch.main(["--device", "cpu", "--backend", "auto", "--cost-table",
                  str(tmp_path / "none.json")])
