"""The port's distributed schedules against the reference's own.

The reference runs once per module, in a subprocess with 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``) and meshes built
with ``jax.sharding.Mesh`` (whose axes are Auto: ``jax.make_mesh`` makes
Explicit ones that its shard_map schedules refuse).  It writes its outputs
for a seeded numpy corpus; the port runs the same corpus on 8 CPU shards
(``make_host_mesh(devices=["cpu"] * 8)``), with each shard's contraction on
``'pallas'`` (K1's plain version on the CPU) and on ``'xla'``.

Parity: the min/max rings and orand bit for bit, outputs and per-request
iteration counts; mma and addnorm within rtol 1e-5 / atol 1e-4, K1's
declared tolerance (the K-chunks are summed in another order).  The
reference's dp closure does not run under this JAX (its shard_mapped
``while`` carry trips the varying-axes check), so the port's dp closure is
held to both packages' local batched closures, which it must equal exactly.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import closure as tcl  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import mmo_reference  # noqa: E402
from repro_torch.core import semiring as sr_mod  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_host_mesh  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
OPS = ("minplus", "maxmin", "orand", "mma", "addnorm")
EXACT = ("minplus", "maxmin", "orand")
MESHES = ((2, 4), (1, 8), (8, 1))
BACKENDS = ("pallas", "xla")
R, M, K, N = 8, 16, 32, 24
# live K per request: on the (1, 8) mesh's 4-lane chunks, 1 leaves seven
# shards at k_valid = 0, 9 leaves five
KV = np.asarray([32, 24, 17, 9, 4, 1, 31, 12], np.int32)
UNBATCHED = ("mmo_kspan", "summa_mmo", "ring_mmo")
CL_OPS = ("minplus", "maxmin", "orand")
CL_SIZES = (20, 26, 32, 24, 30, 22, 28, 32)
CL_NB = 32
TOL = dict(rtol=1e-5, atol=1e-4)


def _pads(op):
  return {"minplus": (np.inf, np.inf), "maxmin": (-np.inf, -np.inf),
          "orand": (False, False)}.get(op, (0.0, 0.0))


def _mmo_corpus(seed=0) -> dict:
  """(R, M, K) × (R, K, N) ⊕ (R, M, N) per ring, K lanes past KV padded."""
  rng = np.random.default_rng(seed)
  out = {}
  for op in OPS:
    a = rng.standard_normal((R, M, K)).astype(np.float32)
    b = rng.standard_normal((R, K, N)).astype(np.float32)
    c = rng.standard_normal((R, M, N)).astype(np.float32)
    if op == "orand":
      a, b, c = a > 0.3, b > 0.3, c > 0.8
    pa, pb = _pads(op)
    for i, k in enumerate(KV):
      a[i, :, k:] = pa
      b[i, k:, :] = pb
    out[f"{op}/a"], out[f"{op}/b"], out[f"{op}/c"] = a, b, c
  return out


def _closure_corpus(seed=1) -> dict:
  """A prepared, padded (8, 32, 32) adjacency stack per ring (sizes
  CL_SIZES, pads as isolated vertices)."""
  rng = np.random.default_rng(seed)
  out = {}
  for op in CL_OPS:
    stack = []
    for n in CL_SIZES:
      if op == "orand":
        w = rng.random((n, n)) < 0.08
        big = np.zeros((CL_NB, CL_NB), bool)
        miss, self_value = False, True
      else:
        w = rng.uniform(1, 10, (n, n)).astype(np.float32)
        miss, self_value = (np.inf, 0.0) if op == "minplus" else (0.0, np.inf)
        w = np.where(rng.random((n, n)) < 0.8, miss, w).astype(np.float32)
        big = np.full((CL_NB, CL_NB), miss, np.float32)
      np.fill_diagonal(w, self_value)
      big[:n, :n] = w
      big[np.arange(n, CL_NB), np.arange(n, CL_NB)] = self_value
      stack.append(big)
    out[op] = np.stack(stack)
  return out


_SCRIPT = textwrap.dedent("""
    import os, sys
    # two cores at most: the run is compile-bound, and the other test
    # workers (host-clock tests among them) keep the rest
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:2])
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.core import distributed as dist
    from repro.core.closure import (batched_bellman_ford_closure,
                                    batched_leyzorek_closure)

    src, dst = sys.argv[1], sys.argv[2]
    inp = dict(np.load(src))
    kv = jnp.asarray(inp["kv"])
    valid = jnp.asarray(inp["valid"])
    ops = [str(x) for x in inp["ops"]]
    cl_ops = [str(x) for x in inp["cl_ops"]]
    out = {}

    def mesh_of(shape):
        return Mesh(np.array(jax.devices()).reshape(shape),
                    ("data", "model"))

    for shape in [tuple(int(d) for d in s) for s in inp["meshes"]]:
        mesh = mesh_of(shape)
        for op in ops:
            a, b, c = (jnp.asarray(inp[f"{op}/{x}"]) for x in "abc")
            for s in dist.SCHEDULES:
                out[f"b/{shape}/{op}/{s}"] = np.asarray(
                    dist.mmo_sharded_batched(a, b, c, op=op, schedule=s,
                                             mesh=mesh, backend="xla",
                                             k_valid=kv))
            if shape == (2, 4):
                for fn in (dist.mmo_kspan, dist.summa_mmo, dist.ring_mmo):
                    out[f"u/{op}/{fn.__name__}"] = np.asarray(
                        fn(a[0], b[0], c[0], op=op, mesh=mesh,
                           backend="xla"))

    mesh = mesh_of((2, 4))
    for op in cl_ops:
        x = jnp.asarray(inp[f"cl/{op}"])
        for alg, fn in (("leyzorek", batched_leyzorek_closure),
                        ("bellman_ford", batched_bellman_ford_closure)):
            o, it = fn(x, op=op, backend="xla", valid_n=valid)
            out[f"local/{op}/{alg}"], out[f"local/{op}/{alg}/it"] = (
                np.asarray(o), np.asarray(it))
        for s in ("kspan", "summa", "ring"):
            o, it = dist.sharded_closure_batched(x, op=op, mesh=mesh,
                                                 schedule=s, valid_n=valid)
            out[f"cl/{op}/{s}"], out[f"cl/{op}/{s}/it"] = (
                np.asarray(o), np.asarray(it))
        out[f"ley/{op}"] = np.asarray(dist.distributed_leyzorek(
            x[2], op=op, mesh=mesh, backend="xla"))
    try:
        dist.sharded_closure_batched(jnp.asarray(inp["cl/minplus"]),
                                     op="minplus", mesh=mesh, schedule="dp",
                                     valid_n=valid)
        out["dp_closure_ran"] = np.asarray(True)
    except TypeError:
        out["dp_closure_ran"] = np.asarray(False)
    np.savez(dst, **out)
    print("REFERENCE_OK")
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
  """The reference's outputs on the corpus, from one subprocess run."""
  d = tmp_path_factory.mktemp("distributed")
  inp = dict(_mmo_corpus())
  inp.update({f"cl/{op}": x for op, x in _closure_corpus().items()})
  inp.update(kv=KV, valid=np.asarray(CL_SIZES, np.int32),
             ops=np.asarray(OPS), cl_ops=np.asarray(CL_OPS),
             meshes=np.asarray(MESHES))
  np.savez(d / "in.npz", **inp)
  env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
  r = subprocess.run([sys.executable, "-c", _SCRIPT, str(d / "in.npz"),
                      str(d / "out.npz")], capture_output=True, text=True,
                     env=env, timeout=600)
  assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, r.stderr[-3000:]
  return dict(np.load(d / "out.npz"))


def _mesh(shape) -> Mesh:
  return make_host_mesh(shape[0] * shape[1], model=shape[1],
                        devices=["cpu"] * 8)


def _operands(op):
  corpus = _mmo_corpus()
  return tuple(torch.from_numpy(corpus[f"{op}/{x}"]) for x in "abc")


def _assert_parity(got: np.ndarray, want: np.ndarray, op: str):
  assert got.dtype == want.dtype and got.shape == want.shape
  if op in EXACT:
    np.testing.assert_array_equal(got, want)
  else:
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES)
def test_host_mesh_shape_and_order(shape):
  devs = [f"cpu:{i}" for i in range(8)]
  mesh = make_host_mesh(8, model=shape[1], devices=devs)
  assert mesh.shape == {"data": shape[0], "model": shape[1]}
  assert mesh.size == 8 and mesh.axis_names == ("data", "model")
  assert [str(d) for d in mesh.flat] == devs  # row-major, as jax's reshape
  assert mesh == make_host_mesh(8, model=shape[1], devices=devs)
  assert len({mesh, make_host_mesh(8, model=shape[1], devices=devs)}) == 1


def test_host_mesh_refusals():
  with pytest.raises(ValueError, match="only 1 exist"):
    make_host_mesh(2, device="cpu")  # one CPU device: no quiet repeats
  assert make_host_mesh(1, device="cpu").size == 1
  with pytest.raises(ValueError, match="do not split"):
    make_host_mesh(6, model=4, devices=["cpu"] * 6)
  with pytest.raises(ValueError, match="one type"):
    Mesh((("cpu", "cuda:0"),))
  with pytest.raises(ValueError, match="grid"):
    Mesh((("cpu", "cpu"), ("cpu",)))
  with pytest.raises(Exception):
    make_host_mesh(1, device="cpu").devices = ()  # frozen


@pytest.mark.parametrize("op", sr_mod.ALL_OPS)
def test_oplus_allreduce_every_ring(op):
  """⊕ of one part per shard, on every shard: + in the parts' dtype, min
  and max elementwise, or as logical or."""
  sr = sr_mod.get(op)
  rng = np.random.default_rng(5)
  parts = [rng.standard_normal((3, 5)).astype(np.float32) for _ in range(4)]
  if sr.boolean:
    parts = [p > 0.5 for p in parts]
  got = sr_mod.oplus_allreduce(sr, [torch.from_numpy(p) for p in parts])
  want = parts[0]
  for p in parts[1:]:
    want = {"add": np.add, "minimum": np.minimum, "maximum": np.maximum,
            "logical_or": np.logical_or}[sr.oplus.__name__](want, p)
  assert len(got) == 4
  for g in got:
    assert g.dtype == torch.from_numpy(parts[0]).dtype
    np.testing.assert_array_equal(g.numpy(), want)
  one = sr_mod.oplus_reduce_parts(sr, [torch.from_numpy(p) for p in parts])
  np.testing.assert_array_equal(one.numpy(), want)


@pytest.mark.parametrize("schedule,want", [("dp", 8), ("summa", 8),
                                           ("kspan", 4), ("ring", 16)])
def test_shard_contractions_per_call(monkeypatch, schedule, want):
  """On the (2, 4) mesh dp and SUMMA contract on all 8 shards; kspan and
  ring on the one line of 4 shards along the model axis (ring in 4 steps),
  not on the replica line the SPMD form also runs."""
  calls = []
  real = tdist._mmo

  def spy(a, *args, **kw):
    calls.append(a.device)
    return real(a, *args, **kw)

  monkeypatch.setattr(tdist, "_mmo", spy)
  rng = np.random.default_rng(3)
  a = torch.from_numpy(rng.standard_normal((8, 16, 32)).astype(np.float32))
  b = torch.from_numpy(rng.standard_normal((8, 32, 16)).astype(np.float32))
  mesh = make_host_mesh(8, model=4, devices=["cpu"] * 8)
  got = tdist.mmo_sharded_batched(a, b, op="minplus", schedule=schedule,
                                  mesh=mesh, backend="xla")
  assert len(calls) == want
  np.testing.assert_array_equal(
      got.numpy(), mmo_reference(a, b, None, op="minplus").numpy())


def test_k_valid_rebases_to_zero_on_later_shards():
  """The corpus reaches the kernel's k_valid = 0 edge: on the (1, 8) mesh
  a request with one live lane leaves seven of eight K-chunks empty."""
  kv = torch.from_numpy(KV)
  live = [tdist._rebase(kv, i * 4, 4, "cpu") for i in range(8)]
  zeros = sum(int((x == 0).sum()) for x in live)
  assert [int(x[5]) for x in live] == [1, 0, 0, 0, 0, 0, 0, 0]
  assert sum(int(x.sum()) for x in live) == int(kv.sum()) and zeros > 8


# ---------------------------------------------------------------------------
# contraction schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("schedule", tdist.SCHEDULES)
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("shape", MESHES)
def test_batched_schedule_matches_reference(ref, shape, op, schedule,
                                            backend):
  a, b, c = _operands(op)
  got = tdist.mmo_sharded_batched(a, b, c, op=op, schedule=schedule,
                                  mesh=_mesh(shape), backend=backend,
                                  k_valid=torch.from_numpy(KV))
  _assert_parity(got.numpy(), ref[f"b/{shape}/{op}/{schedule}"], op)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("fn", UNBATCHED)
@pytest.mark.parametrize("op", OPS)
def test_unbatched_schedule_matches_reference(ref, op, fn, backend):
  a, b, c = _operands(op)
  got = getattr(tdist, fn)(a[0], b[0], c[0], op=op, mesh=_mesh((2, 4)),
                           backend=backend)
  _assert_parity(got.numpy(), ref[f"u/{op}/{fn}"], op)


def test_dp_refuses_a_request_axis_that_does_not_divide():
  a, b, _ = _operands("minplus")
  with pytest.raises(ValueError, match="divisible"):
    tdist.mmo_dp_batched(a[:3], b[:3], op="minplus", mesh=_mesh((2, 4)))
  with pytest.raises(ValueError, match="unknown schedule"):
    tdist.mmo_sharded_batched(a, b, op="minplus", schedule="gossip",
                              mesh=_mesh((2, 4)))


def test_schedule_fits_divisibility():
  mesh = _mesh((2, 4))
  assert tdist.schedule_fits("summa", 16, 32, 16, mesh)
  assert not tdist.schedule_fits("summa", 16, 2, 16, mesh)
  assert tdist.schedule_fits("kspan", 3, 8, 5, mesh)
  assert not tdist.schedule_fits("ring", 3, 8, 6, mesh)
  assert tdist.schedule_fits("dp", 17, 23, 3, mesh)
  assert not tdist.schedule_fits("nope", 16, 16, 16, mesh)
  a, b, _ = _operands("minplus")
  with pytest.raises(ValueError, match="split evenly"):
    tdist.mmo_kspan_batched(a[:, :, :30], b[:, :30], op="minplus",
                            mesh=mesh)


# ---------------------------------------------------------------------------
# sharded closures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("schedule", ("kspan", "summa", "ring"))
@pytest.mark.parametrize("op", CL_OPS)
def test_sharded_closure_matches_reference(ref, op, schedule, backend):
  x = torch.from_numpy(_closure_corpus()[op])
  got, iters = tdist.sharded_closure_batched(
      x, op=op, mesh=_mesh((2, 4)), schedule=schedule, backend=backend,
      valid_n=torch.tensor(CL_SIZES, dtype=torch.int32))
  np.testing.assert_array_equal(got.numpy(), ref[f"cl/{op}/{schedule}"])
  np.testing.assert_array_equal(iters.numpy(),
                                ref[f"cl/{op}/{schedule}/it"])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("algorithm", ("leyzorek", "bellman_ford"))
@pytest.mark.parametrize("op", CL_OPS)
def test_dp_closure_equals_both_local_closures(ref, op, algorithm, backend):
  """One fixpoint per shard, output for output and count for count the
  local batched closure of either package (the counts differ per request,
  so the shards stop at different steps)."""
  assert not bool(ref["dp_closure_ran"])  # the reference's own dp fails
  x = torch.from_numpy(_closure_corpus()[op])
  valid = torch.tensor(CL_SIZES, dtype=torch.int32)
  got, iters = tdist.sharded_closure_batched(
      x, op=op, algorithm=algorithm, mesh=_mesh((2, 4)), schedule="dp",
      backend=backend, valid_n=valid)
  solver = (tcl.batched_leyzorek_closure if algorithm == "leyzorek"
            else tcl.batched_bellman_ford_closure)
  local, local_iters = solver(x, op=op, backend=backend, valid_n=valid)
  assert torch.equal(got, local) and torch.equal(iters, local_iters)
  np.testing.assert_array_equal(got.numpy(), ref[f"local/{op}/{algorithm}"])
  np.testing.assert_array_equal(iters.numpy(),
                                ref[f"local/{op}/{algorithm}/it"])
  assert len(set(iters.tolist())) > 1


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("op", CL_OPS)
def test_distributed_leyzorek_matches_reference(ref, op, backend):
  x = torch.from_numpy(_closure_corpus()[op][2])
  got = tdist.distributed_leyzorek(x, op=op, mesh=_mesh((2, 4)),
                                   backend=backend)
  np.testing.assert_array_equal(got.numpy(), ref[f"ley/{op}"])


def test_sharded_closure_refusals():
  x = torch.from_numpy(_closure_corpus()["minplus"])
  mesh = _mesh((2, 4))
  with pytest.raises(ValueError, match="divisible"):
    tdist.sharded_closure_batched(x[:3], op="minplus", mesh=mesh,
                                  schedule="dp")
  with pytest.raises(ValueError, match="single-device"):
    tdist.sharded_closure_batched(x, op="minplus", mesh=mesh,
                                  schedule="summa", backend="megakernel")
  with pytest.raises(ValueError, match="unknown schedule"):
    tdist.sharded_closure_batched(x, op="minplus", mesh=mesh,
                                  schedule="gossip")
