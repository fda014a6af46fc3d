"""The LM's sharding rules as metadata (``repro_torch.models.common``,
``launch/mesh.py``, ``launch/specs.py``) against the reference's, and the
meta-device build that draws nothing.

The reference's specs come from ``jax.eval_shape`` trees of the full
configs (no mesh is needed); the port's from ``zoo.param_tree`` of a model
built with ``zoo.init(cfg, None, device="meta")``.  The port keeps one dict
per layer where the reference stacks a leading layer axis: each layer's
spec must equal the stacked spec without its first entry, which is always
``None``.
"""
import functools

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as ref_configs  # noqa: E402
from repro.launch import mesh as ref_mesh  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.models import common as ref_cm  # noqa: E402
from repro.models import zoo as ref_zoo  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import specs as sp  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import zoo  # noqa: E402

ARCHS = configs.list_archs()
MESHES = (False, True)  # multi_pod


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
  cfg = ref_configs.get_config(arch)
  return jax.eval_shape(functools.partial(ref_zoo.init, cfg),
                        jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
  return zoo.param_tree(sp.init_meta(configs.get_config(arch)))


def _flat_ref(tree, prefix=""):
  out = {}
  for k, v in tree.items():
    p = f"{prefix}/{k}" if prefix else k
    if isinstance(v, dict):
      out.update(_flat_ref(v, p))
    else:
      out[p] = v
  return out


def _flat_port(tree, prefix="", layer=None):
  """{(path without layer index, layer or None): leaf}."""
  out = {}
  for k, v in tree.items():
    p = f"{prefix}/{k}" if prefix else k
    if isinstance(v, dict):
      out.update(_flat_port(v, p, layer))
    elif isinstance(v, list):
      for i, sub in enumerate(v):
        out.update(_flat_port(sub, p, i))
    else:
      out[(p, layer)] = v
  return out


@pytest.mark.parametrize("multi_pod", MESHES, ids=("single", "multi"))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_like_equals_the_reference(arch, multi_pod):
  ref_cfg = ref_configs.get_config(arch)
  ref_par = ref_mesh.make_parallelism(multi_pod=multi_pod)
  ref = _flat_ref(ref_cm.specs_like(_ref_shapes(arch), ref_cfg, ref_par))
  ref_shapes = _flat_ref(_ref_shapes(arch))
  cfg = configs.get_config(arch)
  par = mesh_mod.make_parallelism(multi_pod=multi_pod)
  params = _port_params(arch)
  port = _flat_port(cm.specs_like(params, cfg, par))
  leaves = _flat_port(params)
  assert {p for p, _ in port} == set(ref)
  layers = {}
  for (path, layer), spec in port.items():
    want = tuple(ref[path])
    assert isinstance(spec, tuple)
    if layer is None:
      assert spec == want, path
      assert tuple(leaves[(path, None)].shape) == ref_shapes[path].shape
    else:
      assert want[0] is None, f"stacked {path} shards its layer axis"
      assert spec == want[1:], (path, layer)
      assert (tuple(leaves[(path, layer)].shape)
              == ref_shapes[path].shape[1:])
      layers.setdefault(path, set()).add(layer)
  for path, seen in layers.items():
    assert len(seen) == ref_shapes[path].shape[0], path


def test_the_expert_rule_applies_to_the_stacked_shape():
  """spec_for on a layer's (E, D, F) leaf would give four entries; the
  stacked (L, E, D, F) shape gives four and the layer takes the last
  three."""
  cfg = configs.get_config("mixtral-8x7b")
  par = mesh_mod.make_parallelism()
  assert len(cm.spec_for("blocks/moe/experts/w1", (8, 4096, 14336), cfg,
                         par)) == 4
  specs = cm.specs_like(_port_params("mixtral-8x7b"), cfg, par)
  assert specs["blocks"][0]["moe"]["experts"]["w1"] == (None, "data",
                                                        "model")
  assert specs["blocks"][5]["moe"]["experts"]["w2"] == (None, "model",
                                                        "data")


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_the_reference(arch):
  ref_cfg = ref_configs.get_config(arch)
  cfg = configs.get_config(arch)
  for multi_pod in MESHES:
    ref_par = ref_mesh.make_parallelism(multi_pod=multi_pod)
    par = mesh_mod.make_parallelism(multi_pod=multi_pod)
    for name, shape in configs.SHAPES.items():
      ref_shape = ref_configs.SHAPES[name]
      assert (shape.name, shape.seq_len, shape.global_batch, shape.kind) == (
          ref_shape.name, ref_shape.seq_len, ref_shape.global_batch,
          ref_shape.kind)
      got = sp.batch_specs(cfg, shape, par)
      want = ref_specs.batch_specs(ref_cfg, ref_shape, ref_par)
      assert got == {k: tuple(v) for k, v in want.items()}
      for seq in (None, False):
        got = _flat_ref(sp.cache_specs(cfg, par, shape, seq_sharded=seq))
        want = _flat_ref(ref_specs.cache_specs(ref_cfg, ref_par, ref_shape,
                                               seq_sharded=seq))
        assert got == {k: tuple(v) for k, v in want.items()}
      assert sp.cache_max_len(cfg, shape) == ref_specs.cache_max_len(
          ref_cfg, ref_shape)
      b = sp.batch_shapes(cfg, shape)
      rb = ref_specs.batch_shapes(ref_cfg, ref_shape)
      assert {k: tuple(v.shape) for k, v in b.items()} == {
          k: tuple(v.shape) for k, v in rb.items()}
    assert sp.logits_spec(cfg, par) == tuple(ref_specs.logits_spec(
        ref_cfg, ref_par))


def test_shapes_and_skip_rules_equal_the_reference():
  assert configs.LONG_OK == ref_configs.LONG_OK
  assert list(configs.SHAPES) == list(ref_configs.SHAPES)
  assert configs.cells() == ref_configs.cells()
  assert "full-attention" in configs.skip_reason("granite-8b", "long_500k")
  assert configs.skip_reason("mamba2-780m", "long_500k") is None


@pytest.mark.parametrize("multi_pod", MESHES, ids=("single", "multi"))
@pytest.mark.parametrize("fsdp", (True, False))
def test_parallelism_equals_the_reference(multi_pod, fsdp):
  par = mesh_mod.make_parallelism(multi_pod=multi_pod, fsdp=fsdp,
                                  remat="full")
  ref = ref_mesh.make_parallelism(multi_pod=multi_pod, fsdp=fsdp,
                                  remat="full")
  for field in ("data_axes", "model_axis", "tp_size", "dp_size", "fsdp",
                "seq_shard_decode", "remat"):
    assert getattr(par, field) == getattr(ref, field)
  assert par.dp == ref.dp and par.tp == ref.tp
  assert par.fsdp_axis == ref.fsdp_axis
  for b in (1, 16, 32, 128, 256):
    assert par.dp_for(b) == ref.dp_for(b)
  assert par.dp == (("pod", "data") if multi_pod else "data")
  assert par.dp_for(1) is None


def test_production_meshes_are_abstract():
  single = mesh_mod.make_production_mesh()
  multi = mesh_mod.make_production_mesh(multi_pod=True)
  assert isinstance(single, mesh_mod.AbstractMesh)
  assert single.shape == {"data": 16, "model": 16} and single.size == 256
  assert single.axis_names == ("data", "model")
  assert multi.shape == {"pod": 2, "data": 16, "model": 16}
  assert multi.size == 512 and list(multi.shape) == ["pod", "data", "model"]
  small = mesh_mod.AbstractMesh((2, 2), ("data", "model"))
  assert small.size == 4 and hash(small) == hash(
      mesh_mod.AbstractMesh((2, 2), ("data", "model")))
  with pytest.raises(ValueError):
    mesh_mod.AbstractMesh((2, 2), ("data", "data"))


def test_a_runnable_mesh_keeps_two_axes():
  with pytest.raises(ValueError, match="AbstractMesh"):
    mesh_mod.Mesh((("cpu", "cpu"), ("cpu", "cpu")),
                  axis_names=("pod", "data", "model"))
  m = mesh_mod.make_host_mesh(devices=["cpu"] * 4)
  assert m.shape == {"data": 2, "model": 2}


def test_constraints_return_their_input():
  x = torch.ones(2, 3, 4)
  assert cm.act_axes() == (None, None)
  with cm.activation_sharding(("data", "model", None)):
    assert cm.act_axes() == ("data", "model")
    assert cm.constrain_acts(x) is x
    assert cm.constrain(x, ("data", None, None)) is x
  with cm.activation_sharding((("pod", "data"), "model", None)):
    assert cm.act_axes() == (("pod", "data"), "model")
  assert cm.act_axes() == (None, None)


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_init_draws_nothing(arch):
  """Every parameter of the full config is an empty meta tensor, no RNG
  moves, and the smoke config's meta build has the drawn build's
  shapes."""
  rng = torch.get_rng_state()
  full = zoo.init(configs.get_config(arch), None, device="meta")
  assert all(p.is_meta for p in full.parameters())
  assert torch.equal(torch.get_rng_state(), rng)
  smoke = configs.get_config(arch, smoke=True)
  meta = zoo.param_tree(zoo.init(smoke, None, device="meta"))
  drawn = zoo.param_tree(zoo.init(smoke, torch.Generator().manual_seed(0),
                                  device="cpu"))
  shapes = {k: (tuple(v.shape), v.dtype)
            for k, v in cm.tree_paths(meta).items()}
  assert shapes == {k: (tuple(v.shape), v.dtype)
                    for k, v in cm.tree_paths(drawn).items()}
  with pytest.raises(ValueError, match="meta"):
    zoo.init(smoke, None, device="cpu")
