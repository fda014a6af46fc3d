"""The port's cost table, dispatch and autotuner against the reference.

Tables are exchanged as JSON both ways: the signature strings are shared,
so a table either package wrote must give the other the same ``best`` and
``resolve`` decisions at every point.  The port's prior is its own (an H100
roofline, ``repro_torch/roofline/hw.py``) and is held to the kernel bounds
``chip_smoke.py`` reports; ``backend="auto"`` must return exactly what the
arm it resolves to returns.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import tuning as jtune  # noqa: E402
from repro_torch import tuning as ttune  # noqa: E402
from repro_torch.core.mmo import mmo  # noqa: E402
from repro_torch.roofline import hw  # noqa: E402
from repro_torch.tuning import autotune as tauto  # noqa: E402
from repro_torch.tuning import cost_table as tct  # noqa: E402
from repro_torch.tuning import dispatch as tdispatch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OPS = ("mma", "minplus", "maxmin", "maxmul", "orand", "addnorm")
SHAPES = ((16, 16, 16), (8, 16, 8), (64, 64, 64), (9, 30, 17))


def _dtype(op):
  return "bool" if op == "orand" else "float32"


@pytest.mark.parametrize("point", [
    ("minplus", (9, 11, 13), "float32", "vector", (128,)),
    ("mma", (64, 64, 64), "float32", "xla", (512,)),
    ("orand", (16, 16, 16), "bool", "pallas", ()),
    ("maxmin", (100, 7, 300), "float32", "megakernel", (4,)),
    ("addnorm", (4096, 16, 16384), "float32", "xla", (512,)),
])
def test_signature_matches_the_reference(point):
  assert tct.signature(*point) == jtune.signature(*point)


def test_signature_buckets_raw_shapes_and_reads_torch_dtypes():
  s1 = ttune.signature("minplus", (9, 11, 13), "float32", "vector", (128,))
  assert s1 == ttune.signature("minplus", (16, 16, 16), torch.float32,
                               "vector", (128,))
  assert tct.bucket_shape((9, 11, 13)) == (16, 16, 16)
  assert ttune.signature("minplus", (17, 16, 16), "float32", "vector",
                         (128,)) != s1
  assert "|bfloat16|" in ttune.signature("mma", (8, 8, 8), torch.bfloat16,
                                         "pallas")


def test_json_round_trip(tmp_path):
  t = ttune.CostTable(device="cpu:test")
  t.record("mma", (64, 64, 64), "float32", "xla", (512,), 1.5e-4)
  t.record("minplus", (9, 11, 13), "float32", "vector", (128,), 2.5e-4)
  t.record("orand", (16, 16, 16), "bool", "pallas", (), 3e-3,
           source="prior")
  path = tmp_path / "table.json"
  t.save(path)
  back = ttune.CostTable.load(path)
  assert back.device == t.device and back.version == ttune.SCHEMA_VERSION
  assert back.entries == t.entries
  doc = json.loads(path.read_text())
  assert doc["schema_version"] == ttune.SCHEMA_VERSION
  assert list(doc["entries"]) == sorted(doc["entries"])


@pytest.mark.parametrize("doc,match", [
    ({"schema_version": 999, "entries": {}}, "schema_version"),
    ({"schema_version": 1, "entries": {"mma|64x64x64|float32|xla|-": {
        "seconds": -1.0, "source": "measured"}}}, "seconds"),
    ({"schema_version": 1, "entries": {"mma|64x64x64|float32|xla|-": {
        "seconds": 1.0, "source": "guessed"}}}, "source"),
])
def test_from_json_rejects_bad_tables(doc, match):
  with pytest.raises(ValueError, match=match):
    ttune.CostTable.from_json(json.dumps(doc))


def test_measured_beats_prior_precedence():
  t = ttune.CostTable()
  point = ("minplus", (16, 16, 16), "float32", "vector", (128,))
  assert t.record(*point, 1.0, source="prior")
  assert t.record(*point, 2.0, source="measured")
  assert t.lookup(*point).seconds == 2.0
  assert not t.record(*point, 0.5, source="prior")
  assert t.lookup(*point).source == "measured"
  assert t.record(*point, 3.0, source="measured")
  assert t.lookup(*point).seconds == 3.0
  with pytest.raises(ValueError, match="source"):
    t.record(*point, 1.0, source="guess")
  with pytest.raises(ValueError, match="seconds"):
    t.record(*point, float("inf"))


def test_best_is_argmin_with_deterministic_ties():
  t = ttune.CostTable()
  t.record("minplus", (16, 16, 16), "float32", "xla", (512,), 2e-4)
  t.record("minplus", (16, 16, 16), "float32", "vector", (128,), 1e-4)
  t.record("minplus", (16, 16, 16), "float32", "vector", (512,), 3e-4)
  t.record("minplus", (16, 16, 16), "float32", "pallas", (), 1e-4)
  d = t.best("minplus", (10, 12, 14), "float32")
  assert (d.backend, d.cfg, d.seconds) == ("vector", (128,), 1e-4)
  d = t.best("minplus", (16, 16, 16), "float32",
             backends=("pallas", "vector"))
  assert d.backend == "pallas"  # the tie breaks toward the earlier arm
  assert t.best("minplus", (16, 16, 16), "float32",
                backends=("xla",)).backend == "xla"
  t.record("minplus", (16, 16, 16), "float32", "megakernel", (4,), 1e-5)
  assert t.best("minplus", (16, 16, 16), "float32").backend == "vector"
  assert t.best("minplus", (16, 16, 16), "float32",
                backends=ttune.CLOSURE_BACKENDS).backend == "megakernel"
  assert t.best("minplus", (64, 64, 64), "float32") is None
  assert ttune.resolve("minplus", 64, 64, 64, "float32",
                       table=t) == ttune.Decision("xla", (), float("inf"),
                                                  "default")
  assert t.counts() == {"measured": 5, "prior": 0}


def _seeded_reference_table():
  """A reference table: its dry-prior sweep (TPU v5e priors) with a seeded
  share of rows overwritten by made-up measurements."""
  table = jtune.tune(dry_prior=True, ops=OPS, shapes=SHAPES)
  rng = np.random.default_rng(5)
  for sig in sorted(table.entries):
    if rng.random() < 0.4:
      op, shape, dtype, backend, cfg = sig.split("|")
      m, k, n = (int(d) for d in shape.split("x"))
      cfg_t = () if cfg == "-" else tuple(int(c) for c in cfg.split("x"))
      table.record(op, (m, k, n), dtype, backend, cfg_t,
                   float(rng.uniform(1e-6, 1e-3)))
  return table


def _seeded_port_table():
  table = ttune.tune(dry_prior=True, ops=OPS, shapes=SHAPES)
  rng = np.random.default_rng(6)
  for sig in sorted(table.entries):
    if rng.random() < 0.4:
      op, shape, dtype, backend, cfg = sig.split("|")
      m, k, n = (int(d) for d in shape.split("x"))
      cfg_t = () if cfg == "-" else tuple(int(c) for c in cfg.split("x"))
      table.record(op, (m, k, n), dtype, backend, cfg_t,
                   float(rng.uniform(1e-6, 1e-3)))
  return table


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("pool", [None, "closure"])
def test_tables_cross_load_with_the_same_decisions(writer, pool):
  """A table either package wrote loads in the other and gives the same
  best and resolve decisions at every point, for the per-contraction pool
  and the closure pool alike."""
  if writer == "reference":
    src = _seeded_reference_table()
    other = ttune.CostTable.from_json(src.to_json())
  else:
    src = _seeded_port_table()
    other = jtune.CostTable.from_json(src.to_json())
  assert other.entries.keys() == src.entries.keys()
  backends = ttune.CLOSURE_BACKENDS if pool else None
  for op in OPS:
    for shape in SHAPES + ((32, 32, 32),):
      want = src.best(op, shape, _dtype(op), backends=backends)
      got = other.best(op, shape, _dtype(op), backends=backends)
      assert (got is None) == (want is None)
      if want is not None:
        assert tuple(got) == tuple(want), (op, shape)
      j = jtune.resolve(op, *shape, _dtype(op), table=(
          src if writer == "reference" else other), backends=backends)
      t = ttune.resolve(op, *shape, _dtype(op), table=(
          other if writer == "reference" else src), backends=backends)
      assert tuple(t) == tuple(j), (op, shape)


@pytest.mark.parametrize("backend", ["auto", "xla", "vector", "pallas"])
def test_contraction_seconds_matches_the_reference_on_measured_rows(backend):
  """With a measured row at the point, both packages' static prediction is
  that row (priors differ by design: TPU v5e against H100)."""
  j = jtune.CostTable(device="test")
  j.record("minplus", (16, 16, 16), "float32", "xla", (512,), 3e-4)
  j.record("minplus", (16, 16, 16), "float32", "vector", (128,), 2e-4)
  j.record("minplus", (16, 16, 16), "float32", "pallas", (), 5e-4)
  t = ttune.CostTable.from_json(j.to_json())
  from repro.tuning import dispatch as jdispatch
  want = jdispatch.contraction_seconds("minplus", 12, 12, 12, "float32",
                                       backend=backend, table=j)
  got = tdispatch.contraction_seconds("minplus", 12, 12, 12, "float32",
                                      backend=backend, table=t)
  assert got == want


def test_prior_of_k1_minplus_4096_is_its_bound():
  """PERF.md's K1 bound at minplus 4096³, 4.108 ms at 1.98 GHz (two
  CUDA-core instructions per term, 132 SMs × 128 lanes), plus one launch."""
  assert hw.SM_CLOCK_HZ == 1.98e9
  prior = ttune.prior_seconds("minplus", (4096,) * 3, np.float32, "pallas")
  assert prior - hw.LAUNCH_OVERHEAD_S == pytest.approx(4.108e-3, abs=5e-7)
  assert prior - hw.LAUNCH_OVERHEAD_S == hw.cuda_core_seconds(4096.0 ** 3)
  # mma at 3×TF32 on the tensor cores: PERF.md's 0.833 ms
  mma = ttune.prior_seconds("mma", (4096,) * 3, "float32", "pallas")
  assert mma - hw.LAUNCH_OVERHEAD_S == pytest.approx(0.833e-3, abs=5e-7)


def test_sm_clock_is_settable():
  prior = ttune.prior_seconds("minplus", (512,) * 3, "float32", "pallas")
  try:
    hw.set_sm_clock(0.99e9)
    slow = ttune.prior_seconds("minplus", (512,) * 3, "float32", "pallas")
  finally:
    hw.set_sm_clock(1.98e9)
  assert slow - hw.LAUNCH_OVERHEAD_S == pytest.approx(
      2 * (prior - hw.LAUNCH_OVERHEAD_S))
  with pytest.raises(ValueError):
    hw.set_sm_clock(0.0)


def test_prior_orders_the_arms():
  p = ttune.prior_seconds
  # the matmul rewrite beats the broadcast-reduce; rings without one tie
  assert p("mma", (256,) * 3, "float32", "xla") < p(
      "mma", (256,) * 3, "float32", "vector")
  assert p("minplus", (256,) * 3, "float32", "xla", (128,)) == p(
      "minplus", (256,) * 3, "float32", "vector", (128,))
  # big min/max contractions belong on the kernel; tiny ones do not pay a
  # launch on the prior alone
  assert p("minplus", (1024,) * 3, "float32", "pallas") < p(
      "minplus", (1024,) * 3, "float32", "xla")
  assert p("minplus", (8,) * 3, "float32", "xla") < p(
      "minplus", (8,) * 3, "float32", "pallas")
  # the fused arm amortizes bytes and the launch over G steps
  assert p("minplus", (64,) * 3, "float32", "megakernel", (8,)) < p(
      "minplus", (64,) * 3, "float32", "megakernel", (2,)) < p(
      "minplus", (64,) * 3, "float32", "pallas")
  assert p("minplus", (64,) * 3, "float32", "arena") == p(
      "minplus", (64,) * 3, "float32", "megakernel", (8,))
  with pytest.raises(ValueError, match="backend"):
    p("minplus", (8,) * 3, "float32", "dp")


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("winner", ["xla", "vector", "pallas"])
def test_auto_mmo_returns_the_resolved_arm_exactly(op, winner):
  rng = np.random.default_rng(7 * OPS.index(op) + len(winner))
  a = rng.standard_normal((13, 14)).astype(np.float32)
  b = rng.standard_normal((14, 11)).astype(np.float32)
  c = rng.standard_normal((13, 11)).astype(np.float32)
  if op == "orand":
    a, b, c = a > 0.3, b > 0.3, c > 0.8
  a, b, c = torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)
  t = ttune.CostTable(device="test")
  for backend in ("xla", "vector", "pallas"):
    cfg = () if backend == "pallas" else (8,)
    t.record(op, (13, 14, 11), _dtype(op), backend, cfg,
             1e-6 if backend == winner else 1.0)
  want = mmo(a, b, c, op=op, backend=winner,
             block=() if winner == "pallas" else (8,))
  with ttune.use_cost_table(t):
    d = ttune.resolve(op, 13, 14, 11, a.dtype)
    got = mmo(a, b, c, op=op, backend="auto")
  assert d.backend == winner and d.source == "measured"
  assert got.dtype == want.dtype
  assert torch.equal(got, want)


def test_auto_without_a_table_runs_xla():
  a = torch.randn(9, 7, generator=torch.Generator().manual_seed(0))
  with ttune.use_cost_table(None):
    assert ttune.resolve("minplus", 9, 7, 9, a.dtype).backend == "xla"
    got = mmo(a, a.T, op="minplus", backend="auto")
  assert torch.equal(got, mmo(a, a.T, op="minplus", backend="xla"))


def test_auto_ignores_a_pallas_tile_from_the_reference():
  """A table the reference measured carries a (bm, bn, bk) tile on its
  'pallas' rows; the port's kernel chooses its own, so auto drops it."""
  j = jtune.CostTable(device="tpu")
  j.record("minplus", (16, 16, 16), "float32", "pallas", (128, 128, 128),
           1e-9)
  a = torch.randn(12, 12, generator=torch.Generator().manual_seed(1))
  with ttune.use_cost_table(ttune.CostTable.from_json(j.to_json())):
    got = mmo(a, a, op="minplus", backend="auto")
  assert torch.equal(got, mmo(a, a, op="minplus", backend="pallas"))
  with pytest.raises(NotImplementedError, match="shape rule"):
    mmo(a, a, op="minplus", backend="pallas", block=(128, 128, 128))


def test_env_var_table_round_trip(tmp_path, monkeypatch):
  """$REPRO_TORCH_COST_TABLE ships a table into dispatch; the reference's
  $REPRO_COST_TABLE does not steer the port; use_cost_table(None) still
  means no table under the port's variable."""
  t = ttune.CostTable(device="env")
  t.record("minplus", (16, 16, 16), "float32", "vector", (128,), 1e-6)
  path = tmp_path / "env_table.json"
  t.save(path)
  assert tdispatch.ENV_VAR == "REPRO_TORCH_COST_TABLE"
  monkeypatch.setenv("REPRO_COST_TABLE", str(path))
  tdispatch.clear_cost_table()
  try:
    assert tdispatch.get_cost_table() is None
    monkeypatch.setenv(tdispatch.ENV_VAR, str(path))
    tdispatch.clear_cost_table()
    loaded = tdispatch.get_cost_table()
    assert loaded is not None and len(loaded) == 1
    assert ttune.resolve("minplus", 16, 16, 16, "float32").backend == "vector"
    with ttune.use_cost_table(None):
      assert tdispatch.get_cost_table() is None
      assert ttune.resolve("minplus", 16, 16, 16, "float32").backend == "xla"
    assert tdispatch.get_cost_table() is loaded
  finally:
    monkeypatch.delenv(tdispatch.ENV_VAR)
    tdispatch.clear_cost_table()


@pytest.mark.parametrize("schedules", [None, ("dp",), ("summa", "ring")])
def test_resolve_places_a_bucket_on_a_mesh(schedules):
  """resolve(mesh_shape=…) returns a schedule decision with the mesh shape
  as its cfg where a measured mesh row beats the local rows, and the local
  decision where none does."""
  t = ttune.CostTable(device="test")
  t.record("minplus", (64, 64, 64), "float32", "pallas", (), 1e-3)
  pool = schedules or ttune.SCHEDULE_ARMS
  t.record("minplus", (64, 64, 64), "float32", pool[-1], (2, 4), 1e-4)
  d = ttune.resolve("minplus", 64, 64, 64, "float32", table=t,
                    mesh_shape=(2, 4), schedules=schedules)
  assert (d.backend, d.cfg, d.source) == (pool[-1], (2, 4), "measured")
  t.record("minplus", (64, 64, 64), "float32", "pallas", (), 1e-5)
  d = ttune.resolve("minplus", 64, 64, 64, "float32", table=t,
                    mesh_shape=(2, 4), schedules=schedules)
  assert d.backend == "pallas"


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_mesh_rows_cross_load_with_the_same_decisions(writer):
  """A table with mesh rows, written by either package, gives both
  packages the same placement wherever its rows are measured."""
  rng = np.random.default_rng(3)
  mk = jtune.CostTable if writer == "reference" else ttune.CostTable
  t = mk(device="test")
  points = [("minplus", (64, 64, 64)), ("orand", (16, 16, 16)),
            ("addnorm", (4096, 16, 16384))]
  for op, shape in points:
    for backend, cfg in (("xla", (512,)), ("vector", (128,)),
                         ("pallas", ())):
      t.record(op, shape, _dtype(op), backend, cfg,
               float(rng.uniform(1e-5, 1e-3)))
    for sched in ttune.SCHEDULE_ARMS:
      t.record(op, shape, _dtype(op), sched, (2, 4),
               float(rng.uniform(1e-5, 1e-3)))
  text = t.to_json()
  jt, tt = jtune.CostTable.from_json(text), ttune.CostTable.from_json(text)
  for op, shape in points:
    for pool in (None, ("dp", "summa")):
      want = jtune.resolve(op, *shape, _dtype(op), table=jt,
                           mesh_shape=(2, 4), schedules=pool)
      got = ttune.resolve(op, *shape, _dtype(op), table=tt,
                          mesh_shape=(2, 4), schedules=pool)
      assert (got.backend, got.cfg, got.seconds) == (
          want.backend, tuple(want.cfg), want.seconds)


def test_dry_prior_sweep_covers_every_arm(tmp_path):
  table = ttune.tune(dry_prior=True, shapes=((16, 16, 16), (8, 16, 8)))
  assert table.device == "prior-only"
  assert table.counts()["measured"] == 0 and len(table) > 0
  arms = {sig.split("|")[3] for sig in table.entries}
  assert arms == {"xla", "vector", "pallas", "megakernel"}
  # megakernel rows only at square closure points on rings with a ⊗ identity
  assert all(sig.split("|")[1] == "16x16x16" and not sig.startswith("addnorm")
             for sig in table.entries if "|megakernel|" in sig)
  path = tmp_path / "prior.json"
  table.save(path)
  assert len(ttune.CostTable.load(path)) == len(table)


def test_tune_measures_on_the_cpu():
  assert tauto.default_backends("cpu") == ("xla", "vector")
  assert tauto.default_backends("cuda") == ("xla", "vector", "pallas",
                                            "megakernel")
  table = ttune.tune(ops=("minplus", "orand"), shapes=((8, 8, 8),),
                     device="cpu", iters=2, warmup=1)
  assert table.device == "cpu"
  measured = {sig for sig, e in table.entries.items()
              if e.source == "measured"}
  assert {sig.split("|")[3] for sig in measured} == {"xla", "vector"}
  assert all(0.0 < table.entries[s].seconds < 10.0 for s in measured)


def test_measure_points_on_the_cpu():
  s = tauto.measure_point("minplus", (16, 16, 16), "float32", "pallas", (),
                          device="cpu", iters=2, warmup=1)
  g = tauto.measure_megakernel_point("minplus", (16, 16, 16), "float32",
                                     (4,), device="cpu", iters=1, warmup=0)
  assert 0.0 < s < 10.0 and 0.0 < g < 10.0
  with pytest.raises(ValueError, match="square"):
    tauto.measure_megakernel_point("minplus", (16, 8, 16), "float32", (4,),
                                   device="cpu")


def test_tune_for_requests_sweeps_the_reference_points():
  """One request stream gives both tuners the same (op, bucket, dtype)
  points; the port's 'pallas' rows carry no tile."""
  from repro import serve_mmo as jserve
  from repro_torch import serve_mmo as tserve
  from repro_torch.apps import graphs
  rng = np.random.default_rng(3)
  payloads = []
  for i in range(8):
    n = int(rng.integers(9, 40))
    payloads.append(("apsp" if i % 2 else "mmo", n, int(rng.integers(1e6))))

  def reqs(api):
    out = []
    for kind, n, s in payloads:
      if kind == "apsp":
        out.append(api.apsp_request(graphs.weighted_digraph(n, 0.3, seed=s)))
      else:
        a = np.random.default_rng(s).standard_normal((n, n)).astype(
            np.float32)
        out.append(api.mmo_request(a, a, op="maxmin"))
    return out

  j = jtune.tune_for_requests(reqs(jserve), dry_prior=True)
  t = ttune.tune_for_requests(reqs(tserve), dry_prior=True)
  assert t.device == "prior-only"
  def points(table):
    return {tuple(sig.split("|")[:3]) for sig in table.entries}
  assert points(t) == points(j)
  assert {sig.split("|")[4] for sig in t.entries if "|pallas|" in sig} == {
      "-"}


def test_autotune_cli_dry_prior(tmp_path):
  out = tmp_path / "cli_table.json"
  env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
  proc = subprocess.run(
      [sys.executable, "-m", "repro_torch.tuning.autotune", "--dry-prior",
       "--ops", "minplus,orand", "--shapes", "16x16x16,32x8x16",
       "--out", str(out)],
      env=env, capture_output=True, text=True, timeout=120, cwd=tmp_path)
  assert proc.returncode == 0, proc.stderr
  assert "0 measured" in proc.stdout and "device=prior-only" in proc.stdout
  table = ttune.CostTable.load(out)
  assert table.counts()["measured"] == 0
  assert table.lookup("minplus", (16, 16, 16), "float32", "megakernel",
                      (8,)) is not None
  bad = subprocess.run(
      [sys.executable, "-m", "repro_torch.tuning.autotune", "--dry-prior",
       "--shapes", "16x16", "--out", str(out)],
      env=env, capture_output=True, text=True, timeout=120, cwd=tmp_path)
  assert bad.returncode == 2 and "MxKxN" in bad.stderr


def test_tuner_defaults_to_the_card(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="cuda"):
    ttune.tune(ops=("minplus",), shapes=((8, 8, 8),))
  with pytest.raises(RuntimeError, match="cuda"):
    tauto.measure_point("minplus", (8, 8, 8), "float32", "xla", ())
  assert ttune.tune(ops=("minplus",), shapes=((8, 8, 8),),
                    dry_prior=True).counts()["prior"] > 0


def test_tune_mesh_records_rows_on_a_cpu_mesh():
  """tune_mesh records the sharded prior for every (point, schedule) and a
  measurement where the schedule divides the point; its dry-prior sweep
  writes the reference's mesh-row signatures."""
  from repro_torch.launch.mesh import make_host_mesh
  mesh = make_host_mesh(8, model=4, devices=["cpu"] * 8)
  t = ttune.tune_mesh(dims=(2, 4), mesh=mesh, ops=("minplus",),
                      shapes=((16, 16, 16), (16, 2, 16)), iters=1, warmup=0)
  assert t.device == "cpu"
  fits = {s: t.lookup("minplus", (16, 16, 16), "float32", s, (2, 4)).source
          for s in ttune.SCHEDULE_ARMS}
  assert fits == {s: "measured" for s in ttune.SCHEDULE_ARMS}
  narrow = t.lookup("minplus", (16, 2, 16), "float32", "kspan", (2, 4))
  assert narrow.source == "measured"  # K = 2 buckets to 8, which splits
  dry = ttune.tune_mesh(dims=(2, 4), ops=("minplus", "orand"),
                        shapes=((16, 16, 16),), dry_prior=True)
  ref = jtune.tune_mesh(dims=(2, 4), ops=("minplus", "orand"),
                        shapes=((16, 16, 16),), dry_prior=True)
  assert set(dry.entries) == set(ref.entries)
  assert dry.counts() == {"measured": 0, "prior": 8}
  with pytest.raises(ValueError, match="unknown schedule"):
    ttune.tune_mesh(dims=(2, 4), schedules=("gossip",), dry_prior=True)
  with pytest.raises(ValueError, match="is not"):
    ttune.tune_mesh(dims=(4, 2), mesh=mesh, ops=("minplus",),
                    shapes=((16, 16, 16),))


def test_autotune_cli_mesh(tmp_path):
  out = tmp_path / "mesh_table.json"
  assert tauto.main(["--dry-prior", "--mesh", "2,4", "--ops", "minplus",
                     "--shapes", "16x16x16", "--schedules", "dp,summa",
                     "--out", str(out)]) == 0
  table = ttune.CostTable.load(out)
  assert table.lookup("minplus", (16, 16, 16), "float32", "summa",
                      (2, 4)) is not None
  assert table.lookup("minplus", (16, 16, 16), "float32", "ring",
                      (2, 4)) is None
  with pytest.raises(SystemExit):  # eight devices asked, the CPU is one
    tauto.main(["--device", "cpu", "--mesh", "2,4", "--out", str(out)])
  with pytest.raises(SystemExit):
    tauto.main(["--dry-prior", "--mesh", "2", "--out", str(out)])
