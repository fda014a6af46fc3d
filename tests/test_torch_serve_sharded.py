"""Sharded bucket serving: mesh routing, dispatch's mesh rows, the batched
schedules inside the engine.

Counterpart of tests/test_serve_sharded.py, test by test.  Its quick tests
run on a trivial (1, 1) mesh, the whole sharded path on one shard; its
multi-device suite (``test_sharded_serving_suite``, one case per section)
runs on 8 CPU shards, the single-controller mesh the port uses on cards
too.  Routing decisions are also held to the reference engine's on the
same (1, 1) placement problem.  Beyond the reference: a megakernel
decision on a mesh-routed closure bucket runs its shards on 'pallas' (K1)
where the reference's fall back to 'xla'.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import serve_mmo as jserve  # noqa: E402
from repro import tuning as jtune  # noqa: E402
from repro.serve_mmo.scheduler import request_bucket as j_request_bucket  # noqa: E402
from repro_torch import tuning as ttune  # noqa: E402
from repro_torch.apps import graphs, solvers  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import mmo_batched, mmo_reference  # noqa: E402
from repro_torch.core import pad_adjacency, prepare_adjacency  # noqa: E402
from repro_torch.core import semiring as sr_mod  # noqa: E402
from repro_torch.core.closure import batched_leyzorek_closure  # noqa: E402
from repro_torch.launch import serve_mmo as tlaunch  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.serve_mmo import (MMOEngine, apsp_request,  # noqa: E402
                                   mmo_request)
from repro_torch.serve_mmo import batching  # noqa: E402
from repro_torch.serve_mmo.scheduler import request_bucket  # noqa: E402


def _mesh11():
  return make_host_mesh(1, devices=["cpu"])


def _mesh24():
  return make_host_mesh(8, model=4, devices=["cpu"] * 8)


def _engine(**kw):
  kw.setdefault("backend", "xla")
  return MMOEngine(device="cpu", **kw)


def _apsp(w):
  return solvers.apsp(w, device="cpu")[0].numpy()


# ---------------------------------------------------------------------------
# sharded prior + dispatch mesh rows (host-side, no devices)
# ---------------------------------------------------------------------------


def test_ring_traffic_bytes_model():
  from repro.roofline.collectives import ring_traffic_bytes as jring
  from repro_torch.roofline.collectives import ring_traffic_bytes
  assert ring_traffic_bytes("all-reduce", 100.0, 4) == pytest.approx(150.0)
  assert ring_traffic_bytes("all-gather", 100.0, 4) == pytest.approx(75.0)
  assert ring_traffic_bytes("collective-permute", 100.0, 4) == 100.0
  for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute"):
    for n in (1, 2, 8):
      assert ring_traffic_bytes(kind, 96.0, n) == jring(kind, 96.0, n)
  with pytest.raises(ValueError):
    ring_traffic_bytes("gossip", 1.0, 2)


@pytest.mark.parametrize("schedule", ["dp", "kspan", "summa", "ring"])
def test_sharded_prior_finite_and_positive(schedule):
  s = ttune.sharded_prior_seconds("minplus", (256, 256, 256), "float32",
                                  schedule, (2, 4))
  assert 0.0 < s < 1.0
  with pytest.raises(ValueError):
    ttune.sharded_prior_seconds("minplus", (256,) * 3, "float32", "nope",
                                (2, 4))


def test_prior_crossover_small_local_big_sharded():
  """Sharding loses on small contractions and wins on big ones (the
  port's H100 prior with NVLink and the measured per-call overhead).  On
  the 'xla' arm's bytes-bound minplus dp and SUMMA come within 1 % of each
  other at 512³; the contraction schedules must beat the local prior too."""
  small = ttune.resolve("minplus", 16, 16, 16, "float32",
                        table=ttune.CostTable(), mesh_shape=(2, 4))
  assert small.backend in ("xla", "vector", "pallas")
  big = ttune.resolve("minplus", 512, 512, 512, "float32",
                      table=ttune.CostTable(), mesh_shape=(2, 4))
  assert big.backend in ttune.SCHEDULE_ARMS
  assert big.cfg == (2, 4)
  local = ttune.prior_seconds("minplus", (512,) * 3, "float32", "xla")
  assert min(ttune.sharded_prior_seconds("minplus", (512,) * 3, "float32",
                                         s, (2, 4))
             for s in ("kspan", "summa", "ring")) < local


def test_measured_mesh_row_beats_unmeasured_prior_arm():
  for tune in (ttune, jtune):  # the same decisions in both packages
    t = tune.CostTable(device="test")
    t.record("minplus", (16, 16, 16), "float32", "xla", (512,), 1.0)
    t.record("minplus", (16, 16, 16), "float32", "kspan", (2, 4), 1e-6)
    d = tune.resolve("minplus", 16, 16, 16, "float32", table=t,
                     mesh_shape=(2, 4))
    assert (d.backend, tuple(d.cfg), d.source) == ("kspan", (2, 4),
                                                   "measured")
    d2 = tune.resolve("minplus", 16, 16, 16, "float32", table=t,
                      mesh_shape=(2, 4), schedules=("summa",))
    assert d2.backend == "xla"
    with pytest.raises(ValueError):
      tune.resolve("minplus", 16, 16, 16, "float32", table=t,
                   mesh_shape=(2, 4), schedules=("gossip",))


def test_resolve_without_mesh_unchanged():
  t = ttune.CostTable(device="test")
  t.record("minplus", (16, 16, 16), "float32", "vector", (128,), 1e-6)
  assert ttune.resolve("minplus", 16, 16, 16, "float32",
                       table=t).backend == "vector"


# ---------------------------------------------------------------------------
# engine routing (trivial (1, 1) mesh — the whole sharded path on one shard)
# ---------------------------------------------------------------------------


def test_schedule_fits_divisibility():
  mesh = _mesh11()
  assert tdist.schedule_fits("summa", 16, 16, 16, mesh)
  assert tdist.schedule_fits("dp", 17, 23, 3, mesh)
  assert not tdist.schedule_fits("nope", 16, 16, 16, mesh)


def test_engine_requires_mesh_for_pinned_schedule():
  with pytest.raises(ValueError, match="needs a mesh"):
    _engine(schedule="summa")
  with pytest.raises(ValueError, match="unknown schedule"):
    _engine(schedule="suma")
  with pytest.raises(ValueError, match="unknown schedule"):
    _engine(mesh=_mesh11(), schedule="suma")


def test_router_threshold_and_pinned_schedule():
  """The port's placements equal the reference engine's on the same
  buckets, thresholds and pins."""
  jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                            ("data", "model"))
  w = graphs.weighted_digraph(10, 0.3, seed=0)
  a = np.zeros((12, 12), np.float32)
  cases = [(dict(schedule="summa", shard_flops=1e12), "apsp", "local"),
           (dict(schedule="summa", shard_flops=0.0), "apsp", "summa"),
           (dict(schedule="ring", shard_flops=0.0), "apsp", "local"),
           (dict(schedule="ring", shard_flops=0.0), "mmo", "ring"),
           (dict(schedule="dp", shard_flops=0.0), "apsp", "dp"),
           (dict(schedule="local", shard_flops=0.0), "mmo", "local")]
  for kw, kind, want in cases:
    t_req = (apsp_request(w) if kind == "apsp"
             else mmo_request(a, a, op="minplus"))
    j_req = (jserve.apsp_request(w) if kind == "apsp"
             else jserve.mmo_request(a, a, op="minplus"))
    eng = _engine(mesh=_mesh11(), **kw)
    ref = jserve.MMOEngine(backend="xla", mesh=jmesh, **kw)
    got = eng.resolve_schedule(request_bucket(t_req))
    assert got == ref.resolve_schedule(j_request_bucket(j_req)) == want
  eng4 = _engine(mesh=_mesh11(), schedule="dp", shard_flops=0.0)
  key = request_bucket(apsp_request(w))
  assert eng4.resolve_placement(key, 3)[2] == "dp"  # rb % 1 == 0


def test_auto_schedule_reads_the_mesh_rows():
  """schedule='auto' routes by the table's mesh rows: a measured row that
  beats the local rows takes the bucket, in both packages."""
  w = graphs.weighted_digraph(10, 0.3, seed=0)
  t = ttune.CostTable(device="test")
  t.record("minplus", (16, 16, 16), "float32", "xla", (512,), 1e-3)
  t.record("minplus", (16, 16, 16), "float32", "summa", (1, 1), 1e-5)
  eng = _engine(mesh=_mesh11(), schedule="auto", shard_flops=0.0,
                cost_table=t)
  assert eng.resolve_schedule(request_bucket(apsp_request(w))) == "summa"
  t2 = ttune.CostTable(device="test")
  t2.record("minplus", (16, 16, 16), "float32", "xla", (512,), 1e-6)
  t2.record("minplus", (16, 16, 16), "float32", "summa", (1, 1), 1e-5)
  eng2 = _engine(mesh=_mesh11(), schedule="auto", shard_flops=0.0,
                 cost_table=t2)
  assert eng2.resolve_schedule(request_bucket(apsp_request(w))) == "local"


def test_sharded_and_local_executables_never_collide():
  eng = _engine(mesh=_mesh11(), schedule="summa", shard_flops=0.0)
  key = request_bucket(apsp_request(graphs.weighted_digraph(10, 0.3,
                                                            seed=0)))
  local_key = eng._exec_key(key, 1, "xla", (), "local")
  shard_key = eng._exec_key(key, 1, "xla", (), "summa")
  assert local_key != shard_key
  assert local_key[-1] is None and shard_key[-1] == (("data", 1),
                                                      ("model", 1))


def test_engine_sharded_path_matches_solver_on_trivial_mesh():
  eng = _engine(mesh=_mesh11(), schedule="summa", shard_flops=0.0,
                max_batch=4)

  def traffic():
    futs = [eng.submit(apsp_request(graphs.weighted_digraph(n, 0.3, seed=n)))
            for n in (9, 11, 13)]
    eng.run_until_idle()
    return futs

  futs = traffic()
  assert set(eng._schedules.values()) == {"summa"}
  for fut, n in zip(futs, (9, 11, 13)):
    np.testing.assert_array_equal(
        fut.result().value, _apsp(graphs.weighted_digraph(n, 0.3, seed=n)))
  misses = eng.cache.misses
  assert misses > 0
  futs2 = traffic()  # steady state: sharded functions are reused
  assert eng.cache.misses == misses
  assert all(f.done() for f in futs2)


def test_prewarm_sharded_matches_step():
  eng = _engine(mesh=_mesh11(), schedule="summa", shard_flops=0.0,
                max_batch=2)
  eng.prewarm([apsp_request(graphs.weighted_digraph(10, 0.3, seed=0))])
  misses = eng.cache.misses
  eng.submit(apsp_request(graphs.weighted_digraph(12, 0.3, seed=1)))
  eng.run_until_idle()
  assert eng.cache.misses == misses


# ---------------------------------------------------------------------------
# the port's own pins
# ---------------------------------------------------------------------------


def test_megakernel_decision_runs_mesh_shards_on_pallas(monkeypatch):
  """A 'megakernel' decision on a mesh-routed closure bucket runs the
  schedule's shards on 'pallas' (K1) and never the fused K2 arm; the
  result equals the fused arm's bit for bit."""
  seen = []
  real = tdist.mmo_sharded_batched

  def spy(*args, **kw):
    seen.append(kw["backend"])
    return real(*args, **kw)

  def no_k2(*args, **kw):
    raise AssertionError("the fused arm ran on a mesh-routed bucket")

  w = graphs.weighted_digraph(20, 0.2, seed=3)
  want = _engine(backend="megakernel").submit(apsp_request(w)).result()
  monkeypatch.setattr(tdist, "mmo_sharded_batched", spy)
  monkeypatch.setattr("repro_torch.core.closure._megakernel_fixpoint", no_k2)
  eng = _engine(backend="megakernel", mesh=_mesh24(), schedule="summa",
                shard_flops=0.0)
  got = eng.submit(apsp_request(w)).result()
  assert eng.resolve_placement(request_bucket(apsp_request(w)), 1) == (
      "megakernel", (), "summa")
  assert seen and set(seen) == {"pallas"}
  np.testing.assert_array_equal(got.value, want.value)
  assert got.extras["iterations"] == want.extras["iterations"]
  key = request_bucket(apsp_request(w))
  fn = batching.make_batch_fn(key, backend="megakernel", device="cpu",
                              mesh=_mesh24(), schedule="summa")
  stacked = batching.to_device(batching.stack_batch(key, [apsp_request(w)]),
                               "cpu")
  np.testing.assert_array_equal(fn(*stacked)[0][0, :20, :20].numpy(),
                                want.value)


def test_auto_megakernel_row_runs_dp_shards_on_pallas_first_time(
    monkeypatch):
  """Under backend='auto' a megakernel row (its cfg is K2's G) wins a
  closure bucket; pinned to dp on a 4-shard mesh, each batch of 4 runs
  sharded on its first attempt, its shards on 'pallas' with no block
  config: no failed attempt, no retry, no fallback arm."""
  seen = []
  real = tdist.sharded_closure_batched

  def spy(*args, **kw):
    seen.append((kw["schedule"], kw["backend"], kw["block"]))
    return real(*args, **kw)

  monkeypatch.setattr(tdist, "sharded_closure_batched", spy)
  t = ttune.CostTable(device="test")
  t.record("minplus", (16, 16, 16), "float32", "xla", (512,), 1e-3)
  t.record("minplus", (16, 16, 16), "float32", "pallas", (), 1e-3)
  t.record("minplus", (16, 16, 16), "float32", "megakernel", (8,), 1e-6)
  mesh = make_host_mesh(4, model=2, devices=["cpu"] * 4)
  eng = _engine(backend="auto", cost_table=t, mesh=mesh, schedule="dp",
                shard_flops=0.0, max_batch=4)
  ws = [graphs.weighted_digraph(n, 0.3, seed=n) for n in (9, 10, 11, 13)]
  for _ in range(2):  # the estimator records the warm batch
    futs = [eng.submit(apsp_request(w)) for w in ws]
    eng.run_until_idle()
    for fut, w in zip(futs, ws):
      np.testing.assert_array_equal(fut.result().value, _apsp(w))
  key = request_bucket(apsp_request(ws[0]))
  assert eng.resolve_placement(key, 4) == ("megakernel", (8,), "dp")
  assert seen == [("dp", "pallas", ())] * 2
  snap = eng.metrics.snapshot()
  assert snap["counters"]["retries"] == 0
  assert snap["counters"]["failed"] == 0
  assert snap["batch_failures_by_kind"] == {}
  cells = eng.estimator.snapshot()["cells"]
  assert cells and all(label.endswith("|megakernel|dp") for label in cells)


def test_mesh_arm_names_the_schedule():
  """Breakers, the estimator and the flight recorder name the schedule
  that served a mesh-routed bucket; its first fallback is the same backend
  on the local path."""
  from repro_torch.serve_mmo import parse_fault_spec
  eng = _engine(mesh=_mesh11(), schedule="summa", shard_flops=0.0,
                faults=parse_fault_spec("execute:transient:1"),
                retry_backoff_s=0.0)
  w = graphs.weighted_digraph(10, 0.3, seed=0)
  for _ in range(2):  # the first attempt fails once and is retried
    eng.submit(apsp_request(w))
    eng.run_until_idle()
  key = request_bucket(apsp_request(w))
  assert eng._fallback_arms(key)[0] == ("xla", (), "local")
  cells = eng.estimator.snapshot()["cells"]
  assert any(label.endswith("|xla|summa") for label in cells), cells
  assert [(c["backend"], c["schedule"]) for c in
          eng.resilience.snapshot()] == [("xla", "summa")]
  spans = [e for e in eng.export_trace()["traceEvents"]
           if e.get("args", {}).get("schedule")]
  assert spans and {e["args"]["schedule"] for e in spans} == {"summa"}


def test_launcher_mesh_flags():
  argv = ["--device", "cpu", "--rate", "40", "--duration", "0.25",
          "--sizes", "12", "--no-warmup"]
  assert tlaunch.main(argv + ["--mesh", "1,1", "--schedule", "summa",
                              "--shard-flops", "0"]) == 0
  with pytest.raises(SystemExit):
    tlaunch.main(argv + ["--mesh", "2,2"])  # one CPU device exists
  with pytest.raises(SystemExit):
    tlaunch.main(argv + ["--schedule", "summa"])  # no mesh


# ---------------------------------------------------------------------------
# the multi-device suite, on 8 CPU shards
# ---------------------------------------------------------------------------


def _suite_schedules_allops():
  """Every registered op: batched schedules == local batched path (min/max
  and or bit-identical, the (+)-rings within 1e-4), with and without
  ragged k_valid."""
  mesh = _mesh24()
  rng = np.random.default_rng(0)
  r, m, k, n = 3, 16, 32, 24
  for op in sr_mod.ALL_OPS:
    sr = sr_mod.get(op)
    a = rng.standard_normal((r, m, k)).astype(np.float32)
    b = rng.standard_normal((r, k, n)).astype(np.float32)
    c = rng.standard_normal((r, m, n)).astype(np.float32)
    if op in ("minmul", "maxmul"):
      a, b = np.abs(np.tanh(a)), np.abs(np.tanh(b))
    if sr.boolean:
      a, b, c = a > 0.3, b > 0.3, c > 0.8
    kv = np.asarray([k, k - 8, k - 16], np.int32)
    pa, pb = sr_mod.contraction_pads(op)
    if sr.boolean:
      pa = pb = False
    for i, kk in enumerate(kv):
      a[i, :, kk:] = pa
      b[i, kk:, :] = pb
    a, b, c, kvt = (torch.from_numpy(x) for x in (a, b, c, kv))
    local = mmo_batched(a, b, c, op=op, backend="xla", k_valid=kvt)
    for fn in (tdist.mmo_kspan_batched, tdist.summa_mmo_batched,
               tdist.ring_mmo_batched):
      got = fn(a, b, c, op=op, mesh=mesh, k_valid=kvt)
      if sr.oplus in (torch.minimum, torch.maximum, torch.logical_or):
        assert torch.equal(got, local), (op, fn.__name__)
      else:
        np.testing.assert_allclose(got.numpy(), local.numpy(), atol=1e-4)
      nokv = fn(a, b, c, op=op, mesh=mesh)
      np.testing.assert_allclose(nokv.to(torch.float64).numpy(),
                                 mmo_reference(a, b, c, op=op).to(
                                     torch.float64).numpy(), atol=1e-4)


def _suite_dp_mmo():
  mesh = _mesh24()
  rng = np.random.default_rng(1)
  m, k, n = 16, 32, 24
  a = rng.standard_normal((8, m, k)).astype(np.float32)
  b = rng.standard_normal((8, k, n)).astype(np.float32)
  kv = np.asarray([k - 8 * (i % 3) for i in range(8)], np.int32)
  pa, pb = sr_mod.contraction_pads("minplus")
  for i, kk in enumerate(kv):
    a[i, :, kk:] = pa
    b[i, kk:, :] = pb
  a, b, kvt = torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(kv)
  got = tdist.mmo_dp_batched(a, b, op="minplus", mesh=mesh, k_valid=kvt)
  want = mmo_batched(a, b, op="minplus", backend="xla", k_valid=kvt)
  assert torch.equal(got, want)
  with pytest.raises(ValueError):
    tdist.mmo_dp_batched(a[:3], b[:3], op="minplus", mesh=mesh)


def _closure_stack(rng, sizes, nb):
  ws = []
  for n in sizes:
    w = rng.uniform(1, 10, (n, n)).astype(np.float32)
    w = np.where(rng.random((n, n)) < 0.6, np.inf, w)
    ws.append(prepare_adjacency(torch.from_numpy(w), op="minplus").numpy())
  stack = np.stack([pad_adjacency(w, nb, op="minplus") for w in ws])
  return torch.from_numpy(stack), torch.tensor(sizes, dtype=torch.int32)


def _suite_sharded_closure():
  mesh = _mesh24()
  rng = np.random.default_rng(2)
  stack, valid = _closure_stack(rng, [20, 26, 32], 32)
  loc, it_l = batched_leyzorek_closure(stack, op="minplus", backend="xla",
                                       valid_n=valid)
  sh, it_s = tdist.sharded_closure_batched(stack, op="minplus", mesh=mesh,
                                           valid_n=valid)
  assert torch.equal(sh, loc) and torch.equal(it_s, it_l)
  stack8, valid8 = _closure_stack(rng, [20, 26, 32, 24, 30, 22, 28, 32], 32)
  loc8, it_l8 = batched_leyzorek_closure(stack8, op="minplus",
                                         backend="xla", valid_n=valid8)
  dp8, it_d8 = tdist.sharded_closure_batched(stack8, op="minplus",
                                             mesh=mesh, schedule="dp",
                                             valid_n=valid8)
  assert torch.equal(dp8, loc8) and torch.equal(it_d8, it_l8)


def _suite_engine_routing():
  """16-buckets (2·16³ ≈ 8e3 flops) stay local, 64-buckets (5e5) go to
  SUMMA; results equal the solvers'."""
  eng = _engine(mesh=_mesh24(), schedule="summa", shard_flops=1e5,
                max_batch=4)
  small = {n: graphs.weighted_digraph(n, 0.3, seed=n) for n in (9, 12)}
  big = {n: graphs.weighted_digraph(n, 0.25, seed=n) for n in (49, 60)}
  futs = {n: eng.submit(apsp_request(w))
          for n, w in {**small, **big}.items()}
  eng.run_until_idle()
  scheds = {k.shape[0]: s for k, s in eng._schedules.items()}
  assert scheds == {16: "local", 64: "summa"}, scheds
  for n, w in {**small, **big}.items():
    np.testing.assert_array_equal(futs[n].result().value, _apsp(w))


def _suite_prewarm_zero_retrace():
  eng = _engine(mesh=_mesh24(), schedule="summa", shard_flops=1e5,
                max_batch=4)
  eng.prewarm([apsp_request(graphs.weighted_digraph(n, 0.25, seed=0))
               for n in (50, 10)])
  misses = eng.cache.misses
  for i in range(6):
    eng.submit(apsp_request(graphs.weighted_digraph(45 + i, 0.25, seed=i)))
    eng.submit(apsp_request(graphs.weighted_digraph(9 + i, 0.3, seed=i)))
  eng.run_until_idle()
  assert eng.cache.misses == misses


def _suite_dp_engine():
  """Full batches shard on dp; a batch of 3 pads to 4, which does not
  divide 8 shards, and runs locally."""
  eng = _engine(mesh=_mesh24(), schedule="dp", shard_flops=1e5, max_batch=8)
  ws = {n: graphs.weighted_digraph(n, 0.25, seed=n) for n in range(49, 57)}
  futs = {n: eng.submit(apsp_request(w)) for n, w in ws.items()}
  eng.run_until_idle()
  assert set(eng._schedules.values()) == {"dp"}
  for n, w in ws.items():
    np.testing.assert_array_equal(futs[n].result().value, _apsp(w))
  eng4 = _engine(mesh=_mesh24(), schedule="dp", shard_flops=1e5, max_batch=8)
  futs4 = [eng4.submit(apsp_request(
      graphs.weighted_digraph(50 + i, 0.25, seed=i))) for i in range(3)]
  eng4.run_until_idle()
  for i, f in enumerate(futs4):
    np.testing.assert_array_equal(
        f.result().value, _apsp(graphs.weighted_digraph(50 + i, 0.25,
                                                        seed=i)))
  (key4,) = eng4._schedules
  assert eng4._schedules[key4] == "dp"
  assert eng4.resolve_placement(key4, 4)[2] == "local"
  assert eng4.resolve_placement(key4, 8)[2] == "dp"


_SUITE = {"schedules_allops": _suite_schedules_allops,
          "dp_mmo": _suite_dp_mmo,
          "sharded_closure": _suite_sharded_closure,
          "engine_routing": _suite_engine_routing,
          "prewarm_zero_retrace": _suite_prewarm_zero_retrace,
          "dp_engine": _suite_dp_engine}


@pytest.mark.parametrize("section", sorted(_SUITE))
def test_sharded_serving_suite(section):
  _SUITE[section]()
