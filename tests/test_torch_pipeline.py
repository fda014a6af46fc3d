"""The port's GPipe schedule (``models/pipeline.py``) on the CPU.

The port runs on ``make_host_mesh(devices=["cpu"] * 8)``, a (4, 2) mesh
with axes ("stage", "data"), and is held to the sequential layers and to
the reference's ``pipeline``.  The reference runs once per module in a
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` on
a ``jax.sharding.Mesh`` (Auto axes; ``jax.make_mesh``'s Explicit axes are
refused by its ``shard_map`` under JAX 0.9.0, which is why
tests/test_pipeline.py is red), on tests/test_pipeline.py's construction:
S 4 stages of 3 tanh layers, D 16, M 6 microbatches of 2 rows, the rows
sharded over "data".

Tolerances: forward 1e-5 and gradients 1e-4, tests/test_pipeline.py's own
against the sequential layers; the same against the reference's pipeline
(both sum the same f32 products, XLA's and PyTorch's CPU kernels in other
orders).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import pipeline as tpipe  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
S, LPS, D, M, MB = 4, 3, 16, 6, 2
L = S * LPS

_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.models.pipeline import pipeline, split_stages

    S, LPS, D, M, MB = 4, 3, 16, 6, 2
    L = S * LPS
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("stage", "data"))
    rng = np.random.default_rng(0)
    W = jnp.asarray(rng.standard_normal((L, D, D)) / np.sqrt(D), jnp.float32)
    X = jnp.asarray(rng.standard_normal((M, MB, D)), jnp.float32)

    def layer(x, w):
        return jnp.tanh(x @ w), None

    def stage_fn(w_stage, x):
        y, _ = jax.lax.scan(layer, x, w_stage)
        return y

    def run(Wst, X):
        with mesh:
            return pipeline(stage_fn, mesh, axis="stage", in_spec=P("stage"),
                            x_spec=P(None, "data"))(Wst, X)

    staged = split_stages(W, S)
    fwd = run(staged, X)
    gw, gx = jax.grad(lambda w, x: (run(w, x) ** 2).sum(), (0, 1))(staged, X)
    np.savez(sys.argv[1], w=np.asarray(W), x=np.asarray(X),
             fwd=np.asarray(fwd), gw=np.asarray(gw).reshape(L, D, D),
             gx=np.asarray(gx))
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
  out = tmp_path_factory.mktemp("pipeline") / "ref.npz"
  env = dict(os.environ, PYTHONPATH=SRC)
  r = subprocess.run([sys.executable, "-c", _SCRIPT, str(out)],
                     capture_output=True, text=True, env=env, timeout=600)
  assert r.returncode == 0, r.stderr[-3000:]
  with np.load(out) as z:
    return {k: z[k] for k in z.files}


def _stage_fn(w_stage, x):
  for w in w_stage:
    x = torch.tanh(x @ w)
  return x


def _sequential(w, x):
  for layer in w:
    x = torch.tanh(x @ layer)
  return x


def _mesh():
  return make_host_mesh(devices=["cpu"] * 8, axis_names=("stage", "data"))


def _inputs(seed=0):
  rng = np.random.default_rng(seed)
  w = (rng.standard_normal((L, D, D)) / np.sqrt(D)).astype(np.float32)
  x = rng.standard_normal((M, MB, D)).astype(np.float32)
  return w, x


def _port(w, x, x_spec):
  wt = torch.from_numpy(w).requires_grad_(True)
  xt = torch.from_numpy(x).requires_grad_(True)
  run = tpipe.pipeline(_stage_fn, _mesh(), axis="stage", in_spec=("stage",),
                       x_spec=x_spec)
  y = run(tpipe.split_stages(wt, S), xt)
  gw, gx = torch.autograd.grad((y ** 2).sum(), (wt, xt))
  return y.detach().numpy(), gw.numpy(), gx.numpy()


def test_split_stages_and_bubble_fraction():
  w = torch.arange(L * 2 * 3, dtype=torch.float32).reshape(L, 2, 3)
  staged = tpipe.split_stages({"w": w, "b": [w[:, 0]]}, S)
  assert staged["w"].shape == (S, LPS, 2, 3)
  assert staged["b"][0].shape == (S, LPS, 3)
  assert torch.equal(staged["w"][1, 2], w[5])
  with pytest.raises(ValueError, match="stages"):
    tpipe.split_stages(w, 5)
  assert abs(tpipe.bubble_fraction(4, 6) - 3 / 9) < 1e-9
  assert tpipe.bubble_fraction(1, 8) == 0.0


@pytest.mark.parametrize("x_spec", [(None, "data"), ()], ids=str)
def test_forward_and_gradients_match_the_sequential_layers(x_spec):
  w, x = _inputs(seed=1)
  y, gw, gx = _port(w, x, x_spec)
  wt = torch.from_numpy(w).requires_grad_(True)
  xt = torch.from_numpy(x).requires_grad_(True)
  ref = _sequential(wt, xt)
  rgw, rgx = torch.autograd.grad((ref ** 2).sum(), (wt, xt))
  np.testing.assert_allclose(y, ref.detach().numpy(), rtol=0, atol=1e-5)
  np.testing.assert_allclose(gw, rgw.numpy(), rtol=0, atol=1e-4)
  np.testing.assert_allclose(gx, rgx.numpy(), rtol=0, atol=1e-4)


def test_forward_and_gradients_match_the_reference_pipeline(reference):
  w, x = reference["w"], reference["x"]
  for got, want in zip((w, x), _inputs()):   # the same seeded draws
    np.testing.assert_array_equal(got, want)
  y, gw, gx = _port(w, x, (None, "data"))
  np.testing.assert_allclose(y, reference["fwd"], rtol=0, atol=1e-5)
  np.testing.assert_allclose(gw, reference["gw"], rtol=0, atol=1e-4)
  np.testing.assert_allclose(gx, reference["gx"], rtol=0, atol=1e-4)


def test_each_stage_runs_on_its_line_and_the_result_on_the_input_device():
  """Stage s's parameter slice reaches the devices of line s along
  'stage', and every tick applies every stage: S · (M + S − 1) stage
  calls per data line."""
  mesh = _mesh()
  seen = []

  def stage_fn(w_stage, x):
    seen.append((w_stage.device, x.device, float(w_stage[0, 0, 0])))
    return _stage_fn(w_stage, x)
  w, x = _inputs(seed=2)
  wt = torch.from_numpy(w)
  y = tpipe.pipeline(stage_fn, mesh, x_spec=(None, "data"))(
      tpipe.split_stages(wt, S), torch.from_numpy(x))
  assert len(seen) == mesh.shape["data"] * S * (M + S - 1)
  assert {d for d, _, _ in seen} == {torch.device("cpu")}
  assert {round(v, 6) for _, _, v in seen} == {round(float(w[s * LPS, 0, 0]),
                                                     6) for s in range(S)}
  assert y.shape == x.shape and y.device == torch.device("cpu")


def test_bad_specs_and_shapes_are_refused():
  mesh = _mesh()
  w, x = _inputs()
  staged = tpipe.split_stages(torch.from_numpy(w), S)
  with pytest.raises(ValueError, match="axis"):
    tpipe.pipeline(_stage_fn, mesh, axis="model")
  with pytest.raises(ValueError, match="in_spec"):
    tpipe.pipeline(_stage_fn, mesh, in_spec=("data",))
  with pytest.raises(ValueError, match="x_spec"):
    tpipe.pipeline(_stage_fn, mesh, x_spec=("data",))
  with pytest.raises(ValueError, match="stages"):
    tpipe.pipeline(_stage_fn, mesh)(tpipe.split_stages(
        torch.from_numpy(w), 2), torch.from_numpy(x))
  with pytest.raises(ValueError, match="rows"):
    tpipe.pipeline(_stage_fn, mesh, x_spec=(None, "data"))(
        staged, torch.from_numpy(x[:, :1]))
