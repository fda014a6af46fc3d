"""The port's request arena and the engine's arena mode, on the CPU.

Every case of the shared closure parity corpus goes through the slot
lifecycle — standalone and inside ``MMOEngine(mode="arena")`` — and must
equal the reference's batched fixpoint under the parity policy (bit-exact
on the min/max rings and orand; mma within rtol 1e-5 / atol 1e-4, its
iteration counts exact) and the port's own batch path bit for bit on every
ring.  The lifecycle pins (mid-flight admission with zero cache misses,
the slot's trace span, full/backfill, reset, bad parameters), the chaos
pins (a NaN slot fails alone, a transient tick fault is retried, a spent
budget fails the residents) and the hypothesis model test follow
tests/test_arena.py and tests/test_property_arena.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fixtures import closure_corpus as corpus  # noqa: E402
from repro.serve_mmo import RequestArena as JArena  # noqa: E402
from repro.serve_mmo import closure_request as j_closure_request  # noqa: E402
from repro.serve_mmo.scheduler import request_bucket as j_bucket  # noqa: E402
from repro_torch.core import closure as tcl  # noqa: E402
from repro_torch.serve_mmo import (FaultInjector, FaultRule,  # noqa: E402
                                   InjectedFault, MMOEngine,
                                   NonFiniteResultError, RequestArena,
                                   apsp_request, closure_request)
from repro_torch.serve_mmo.cache import ExecutableCache  # noqa: E402
from repro_torch.serve_mmo.scheduler import (BucketKey,  # noqa: E402
                                             request_bucket)

EXACT = ("minplus", "maxplus", "minmul", "maxmul", "minmax", "maxmin",
         "orand")
SOLVERS = {"leyzorek": tcl.batched_leyzorek_closure,
           "bellman_ford": tcl.batched_bellman_ford_closure}
ENGINE_CASES = [c for c in corpus.CORPUS if c.engine_ok]


def assert_parity(got, want, op):
  if op in EXACT:
    np.testing.assert_array_equal(got, want)
  else:
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _requests(case, api=closure_request):
  return [api(g, op=case.op, algorithm=case.algorithm, prepared=True)
          for g in case.graphs]


def _drain(arena, pending):
  """Admit-when-free / tick / sweep until everything evicts."""
  done = {}
  pending = list(pending)
  while pending or arena.live_slots():
    while pending and arena.free_slots():
      arena.admit(pending.pop(0))
    arena.tick()
    for ev in arena.sweep():
      assert id(ev.request) not in done, "request evicted twice"
      done[id(ev.request)] = ev
  return done


def _port_batch(case):
  """The port's per-iteration batch path on the kernel arm."""
  stack, valid = corpus.stacked(case)
  out, it = SOLVERS[case.algorithm](
      torch.from_numpy(np.array(stack)), op=case.op, backend="pallas",
      valid_n=torch.from_numpy(np.array(valid)), max_iters=case.max_iters)
  return out.numpy(), it.numpy()


@pytest.mark.parametrize("case", corpus.CORPUS, ids=corpus.CASE_IDS)
def test_corpus_parity_arena(case):
  """Capacity 2, so some requests wait for an eviction and enter an arena
  whose other slot is mid-fixpoint."""
  ref_out, ref_it = corpus.reference(case)
  port_out, port_it = _port_batch(case)
  reqs = _requests(case)
  arena = RequestArena(request_bucket(reqs[0]), capacity=2, g=3,
                       max_iters=case.max_iters, device="cpu")
  done = _drain(arena, reqs)
  for i, r in enumerate(reqs):
    ev, n = done[id(r)], case.sizes[i]
    assert ev.iterations == int(ref_it[i]) == int(port_it[i])
    assert_parity(ev.value, ref_out[i, :n, :n], case.op)
    np.testing.assert_array_equal(ev.value, port_out[i, :n, :n])


@pytest.mark.parametrize("case", corpus.CORPUS, ids=corpus.CASE_IDS)
def test_corpus_parity_with_the_reference_arena(case):
  """The same lifecycle through the reference's arena (interpret mode)."""
  jreqs = _requests(case, j_closure_request)
  jarena = JArena(j_bucket(jreqs[0]), capacity=2, g=3,
                  max_iters=case.max_iters, interpret=True)
  want = _drain(jarena, jreqs)
  reqs = _requests(case)
  got = _drain(RequestArena(request_bucket(reqs[0]), capacity=2, g=3,
                            max_iters=case.max_iters, device="cpu"), reqs)
  for jr, r in zip(jreqs, reqs):
    w, g = want[id(jr)], got[id(r)]
    assert (g.slot, g.iterations) == (w.slot, w.iterations)
    assert_parity(g.value, w.value, case.op)


@pytest.mark.parametrize("case", ENGINE_CASES,
                         ids=[c.name for c in ENGINE_CASES])
def test_corpus_parity_engine_arena_mode(case):
  """Scheduler → admission → slots → futures, against the port's batch
  mode (validation off so the NaN-edge case flows through as data)."""
  ref_out, ref_it = corpus.reference(case)
  arena_eng = MMOEngine(mode="arena", arena_capacity=2, arena_g=3,
                        validate_results=False, device="cpu")
  batch_eng = MMOEngine(backend="pallas", validate_results=False,
                        device="cpu")
  futs = [arena_eng.submit(r) for r in _requests(case)]
  bfuts = [batch_eng.submit(r) for r in _requests(case)]
  arena_eng.run_until_idle()
  batch_eng.run_until_idle()
  for i, (f, bf) in enumerate(zip(futs, bfuts)):
    res, want, n = f.result(), bf.result(), case.sizes[i]
    assert res.extras["iterations"] == int(ref_it[i])
    assert res.extras == want.extras
    assert_parity(res.value, ref_out[i, :n, :n], case.op)
    np.testing.assert_array_equal(res.value, want.value)
  assert arena_eng.arena_stats()[next(iter(arena_eng.arena_stats()))][
      "evicted"] == len(case.graphs)


def _line(n, seed):
  return corpus.line_graph(n, seed=seed)


def test_midflight_admission_zero_cache_misses():
  """After prewarm, a request arriving while the arena is mid-fixpoint joins
  the running buffer at the next tick: no build, and its result equals the
  batch path's."""
  eng = MMOEngine(mode="arena", arena_capacity=4, arena_g=2, device="cpu")
  built = eng.prewarm([apsp_request(_line(14, 0),
                                    algorithm="bellman_ford")])
  assert built == 3  # admit / tick / read
  misses0 = eng.cache.misses
  fa = eng.submit(apsp_request(_line(14, 1), algorithm="bellman_ford"))
  eng.step()  # admit A + first tick: the fixpoint is now running
  (arena,) = eng._arenas.values()
  assert arena.live_slots() == 1 and not fa.done()
  fb = eng.submit(apsp_request(_line(13, 2), algorithm="bellman_ford"))
  eng.run_until_idle()
  assert eng.cache.misses == misses0, "mid-flight admission built a program"
  batch = MMOEngine(device="cpu")
  want = batch.submit(apsp_request(_line(13, 2), algorithm="bellman_ford"))
  np.testing.assert_array_equal(fb.result().value, want.result().value)
  assert fb.result().extras == want.result().extras
  assert fa.result().extras["iterations"] == 13
  assert arena.stats()["ticks"] >= 7  # 13 iterations at g = 2


def test_arena_mode_background_loop_and_mixed_buckets():
  """The serving loop keeps ticking while slots are live (the queue alone
  is empty), and non-closure heads still batch."""
  eng = MMOEngine(mode="arena", arena_capacity=2, arena_g=1, device="cpu")
  eng.start()
  a = np.ones((6, 6), np.float32)
  from repro_torch.serve_mmo import mmo_request
  futs = [eng.submit(apsp_request(_line(10, s), algorithm="bellman_ford"))
          for s in range(3)] + [eng.submit(mmo_request(a, a, op="minplus"))]
  got = [f.result(timeout=60) for f in futs]
  eng.stop()
  assert [g.extras["iterations"] for g in got[:3]] == [9, 9, 9]
  np.testing.assert_array_equal(got[3].value, np.full((6, 6), 2.0))
  assert eng.stats().completed == 4


def test_nan_slot_fails_alone():
  bad = _line(9, 4)
  bad[0, 1] = np.nan
  eng = MMOEngine(mode="arena", arena_capacity=4, arena_g=3, device="cpu")
  poisoned = eng.submit(apsp_request(bad, algorithm="bellman_ford"))
  neighbor = eng.submit(apsp_request(_line(9, 5), algorithm="bellman_ford"))
  eng.run_until_idle()
  with pytest.raises(NonFiniteResultError):
    poisoned.result()
  assert neighbor.result().extras["iterations"] == 8


def test_failed_tick_fails_residents_and_the_arena_recovers(monkeypatch):
  eng = MMOEngine(mode="arena", arena_capacity=2, arena_g=4, device="cpu")
  fut = eng.submit(apsp_request(_line(10, 7), algorithm="bellman_ford"))

  def boom(self):
    raise RuntimeError("tick failed")

  monkeypatch.setattr(RequestArena, "tick", boom)
  eng.run_until_idle()
  with pytest.raises(RuntimeError, match="tick failed"):
    fut.result()
  (arena,) = eng._arenas.values()
  assert arena.live_slots() == 0 and not eng._inflight
  monkeypatch.undo()
  ok = eng.submit(apsp_request(_line(10, 8), algorithm="bellman_ford"))
  eng.run_until_idle()
  assert ok.result().extras["iterations"] == 9


def test_arena_trace_slot_lifecycle():
  """The flight recorder carries the admit → tick×k → evict span: an
  execute slice opening with the slot index, arena_tick X-events, and the
  eviction closing the slice with the measured iteration count."""
  eng = MMOEngine(mode="arena", arena_capacity=2, arena_g=2, device="cpu")
  fut = eng.submit(apsp_request(_line(10, 3), algorithm="bellman_ford"))
  eng.run_until_idle()
  ev = eng.export_trace()["traceEvents"]
  begins = [e for e in ev if e.get("ph") == "b" and e["name"] == "execute"]
  assert begins and "slot" in begins[0]["args"]
  ticks = [e for e in ev if e.get("name") == "arena_tick"]
  assert len(ticks) >= 2  # bellman_ford on a 10-line at g=2 needs several
  ends = [e for e in ev if e.get("ph") == "e" and e["name"] == "execute"]
  assert ends and ends[-1]["args"]["outcome"] == "done"
  assert ends[-1]["args"]["iterations"] == fut.result().extras["iterations"]


# ---------------------------------------------------------------------------
# chaos pins — fault injection through the arena path (tests/test_arena.py)
# ---------------------------------------------------------------------------


def _batch_want(w):
  """The port's batch path, fault-free, for one Bellman-Ford request."""
  fut = MMOEngine(backend="pallas", device="cpu").submit(
      apsp_request(w, algorithm="bellman_ford"))
  return fut.result()


def test_nan_poisoned_slot_fails_alone():
  """A slot the ``nonfinite`` fault poisons is evicted as failed without
  freezing or corrupting its live neighbour, which equals batch mode."""
  faults = FaultInjector([FaultRule(point="nonfinite", backend="arena",
                                    request_ids={0})])
  eng = MMOEngine(mode="arena", arena_capacity=4, arena_g=3, faults=faults,
                  device="cpu")
  poisoned = eng.submit(apsp_request(_line(12, 4), algorithm="bellman_ford"))
  neighbor = eng.submit(apsp_request(_line(12, 5), algorithm="bellman_ford"))
  eng.run_until_idle()
  with pytest.raises(NonFiniteResultError):
    poisoned.result()
  want = _batch_want(_line(12, 5))
  np.testing.assert_array_equal(neighbor.result().value, want.value)
  assert neighbor.result().extras == want.extras
  snap = eng.metrics_snapshot()
  assert snap["counters"]["failed"] == 1
  assert snap["counters"]["completed"] == 1
  assert snap["batch_failures_by_kind"] == {"nonfinite": 1}


def test_arena_tick_retry_accounting():
  """A transient execute fault on one tick: the slots stay resident, the
  next step retries the tick whole, everything completes, with a counted
  retry and the breaker's failure cleared by the success."""
  faults = FaultInjector([FaultRule(point="execute", backend="arena",
                                    mode="transient", count=1)])
  eng = MMOEngine(mode="arena", arena_capacity=2, arena_g=4, faults=faults,
                  transient_retries=1, retry_backoff_s=0.0, device="cpu")
  fut = eng.submit(apsp_request(_line(10, 6), algorithm="bellman_ford"))
  eng.run_until_idle()
  want = _batch_want(_line(10, 6))
  np.testing.assert_array_equal(fut.result().value, want.value)
  assert fut.result().extras == want.extras
  snap = eng.metrics_snapshot()
  assert snap["counters"]["retries"] >= 1
  assert snap["counters"]["completed"] == 1
  assert snap["counters"]["failed"] == 0
  (cell,) = eng.resilience.snapshot()
  assert (cell["backend"], cell["consecutive_failures"]) == ("arena", 0)


def test_arena_tick_failure_budget_fails_residents():
  """A persistent execute fault spends the transient budget: every resident
  fails together, the arena resets, and traffic after the fault clears
  completes."""
  faults = FaultInjector([FaultRule(point="execute", backend="arena")])
  eng = MMOEngine(mode="arena", arena_capacity=2, arena_g=4, faults=faults,
                  transient_retries=1, retry_backoff_s=0.0, device="cpu")
  futs = [eng.submit(apsp_request(_line(10, s), algorithm="bellman_ford"))
          for s in (7, 9)]
  eng.run_until_idle()
  for fut in futs:
    with pytest.raises(InjectedFault):
      fut.result()
  assert next(iter(eng._arenas.values())).live_slots() == 0
  assert not eng._inflight
  faults.clear("execute")
  ok = eng.submit(apsp_request(_line(10, 8), algorithm="bellman_ford"))
  eng.run_until_idle()
  assert ok.result().extras["iterations"] == 9


def test_arena_refuses_non_closure_and_bad_params():
  key = BucketKey(kind="mmo", op="minplus", shape=(8, 8, 8),
                  dtypes=("float32",), params=(False,))
  with pytest.raises(ValueError, match="closure"):
    RequestArena(key, device="cpu")
  ckey = request_bucket(apsp_request(_line(8, 0)))
  with pytest.raises(ValueError, match="capacity"):
    RequestArena(ckey, capacity=0, device="cpu")
  with pytest.raises(ValueError, match="g must"):
    RequestArena(ckey, g=0, device="cpu")
  arena = RequestArena(ckey, device="cpu")
  with pytest.raises(ValueError, match="exceeds"):
    arena.admit(apsp_request(_line(9, 0)))
  with pytest.raises(ValueError, match="arena_capacity"):
    MMOEngine(mode="arena", arena_capacity=0, device="cpu")


def test_arena_full_refuses_and_backfills():
  req = apsp_request(_line(8, 1))
  arena = RequestArena(request_bucket(req), capacity=1, g=8, device="cpu")
  slot = arena.admit(req)
  assert arena.free_slots() == 0
  with pytest.raises(RuntimeError, match="arena full"):
    arena.admit(apsp_request(_line(8, 2)))
  arena.tick()
  (ev,) = arena.sweep()
  assert ev.slot == slot and arena.free_slots() == 1
  again = apsp_request(_line(7, 3))  # backfill reseeds the stale flags
  assert arena.admit(again) == slot
  arena.tick()
  (ev2,) = arena.sweep()
  assert ev2.request is again and ev2.iterations > 0


def test_arena_reset_returns_residents():
  cache = ExecutableCache()
  reqs = [apsp_request(_line(8, s)) for s in (4, 5)]
  arena = RequestArena(request_bucket(reqs[0]), capacity=4, g=1,
                       cache=cache, device="cpu")
  for r in reqs:
    arena.admit(r)
  arena.tick()
  victims = arena.reset()
  assert set(map(id, victims)) == set(map(id, reqs))
  assert arena.live_slots() == 0 and arena.free_slots() == 4
  done = _drain(arena, [apsp_request(_line(8, 6))])
  assert len(done) == 1
  st = arena.stats()
  assert (st["admitted"], st["evicted"], st["ticks"]) == (3, 1, 4)
  assert cache.misses == 3


def test_arena_refuses_a_tick_with_no_resident():
  arena = RequestArena(request_bucket(apsp_request(_line(8, 0))),
                       device="cpu")
  assert arena.tick() is False and arena.sweep() == []


# ---------------------------------------------------------------------------
# random slot lifecycles vs a host model (tests/test_property_arena.py)
# ---------------------------------------------------------------------------

_POOL_NB = 8
_POOL = []  # (weights, n, closure, iterations) from the port's batch path
for _i, _n in enumerate((5, 6, 7, 8, 6, 8)):
  _w = _line(_n, 100 + _i)
  _adj = tcl.prepare_adjacency(torch.from_numpy(_w), op="minplus").numpy()
  _out, _it = tcl.batched_bellman_ford_closure(
      torch.from_numpy(tcl.pad_adjacency(_adj, _POOL_NB, op="minplus"))[None],
      op="minplus", backend="pallas",
      valid_n=torch.tensor([_n], dtype=torch.int32))
  _POOL.append((_w, _n, _out[0, :_n, :_n].numpy(), int(_it[0])))


class _ModelArena:
  """Predicts the arena's observable lifecycle from each request's batch
  iteration count and the per-tick budget:
  iters' = min(ref_iters, max_iters, iters + g), evicted once iters equals
  ref_iters or reaches max_iters."""

  def __init__(self, capacity, g, max_iters):
    self.capacity, self.g, self.max_iters = capacity, g, max_iters
    self.slots = {}  # slot -> [pool index, iterations done]

  def admit(self, slot, pool_idx):
    assert slot not in self.slots, "admit landed on a live slot"
    assert len(self.slots) < self.capacity, "capacity exceeded"
    self.slots[slot] = [pool_idx, 0]

  def tick(self):
    for state in self.slots.values():
      state[1] = min(_POOL[state[0]][3], self.max_iters, state[1] + self.g)

  def done_slots(self):
    return {s for s, (pi, it) in self.slots.items()
            if it == _POOL[pi][3] or it >= self.max_iters}


def _random_lifecycle(capacity, g, picks, ops):
  pending = [(apsp_request(_POOL[i][0], algorithm="bellman_ford"), i)
             for i in picks]
  arena = RequestArena(request_bucket(pending[0][0]), capacity=capacity,
                       g=g, cache=_PROPERTY_CACHE, device="cpu")
  model = _ModelArena(capacity, g, arena.max_iters)
  completions, admitted = {}, []
  schedule = list(ops) + ["admit", "tick", "sweep"] * (
      len(pending) * (arena.max_iters // g + 2))
  for op in schedule:
    if op == "admit":
      if not pending or arena.free_slots() == 0:
        continue
      req, pool_idx = pending.pop(0)
      model.admit(arena.admit(req), pool_idx)
      admitted.append(id(req))
    elif op == "tick":
      assert arena.tick() == bool(model.slots)
      model.tick()
    else:
      evictions = arena.sweep()
      assert {ev.slot for ev in evictions} == model.done_slots()
      for ev in evictions:
        pool_idx, iters_done = model.slots.pop(ev.slot)
        assert ev.iterations == iters_done
        np.testing.assert_array_equal(ev.value, _POOL[pool_idx][2])
        assert id(ev.request) not in completions, "request completed twice"
        completions[id(ev.request)] = pool_idx
  assert not pending and not model.slots and arena.live_slots() == 0
  assert sorted(completions) == sorted(admitted)
  assert sorted(completions.values()) == sorted(picks)
  st = arena.stats()
  assert st["admitted"] == st["evicted"] == len(picks)


_PROPERTY_CACHE = ExecutableCache()  # each (capacity, g) builds once

try:
  from hypothesis import given, settings, strategies as st
except ImportError:  # the property test needs hypothesis
  given = None

if given is not None:

  @settings(max_examples=25, deadline=None)
  @given(capacity=st.integers(1, 3), g=st.integers(1, 3),
         picks=st.lists(st.integers(0, len(_POOL) - 1), min_size=1,
                        max_size=5),
         ops=st.lists(st.sampled_from(["admit", "tick", "sweep"]),
                      min_size=1, max_size=30))
  def test_random_lifecycle_matches_model(capacity, g, picks, ops):
    _random_lifecycle(capacity, g, picks, ops)

else:

  def test_random_lifecycle_matches_model():
    pytest.skip("needs hypothesis")
