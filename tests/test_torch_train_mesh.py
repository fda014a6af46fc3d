"""The port's training on a mesh (``train/sharded.py``, ``make_train_step``
with ``mesh=`` and the three knobs, sharded AdamW and checkpoints, the
driver's ``--shards``) on the CPU.

The port runs on ``make_host_mesh(8, model=2, devices=["cpu"] * 8)``, a
(4, 2) mesh of CPU shards, and is held to the reference's
``make_train_step`` jitted on a ``jax.sharding.Mesh`` of 8 host devices
shaped (4, 2) (Auto axes; ``jax.make_mesh``'s Explicit axes are refused by
the reference under JAX 0.9.0), with the parameters and both moments
placed by ``specs_like`` and the batch's rows sharded over "data".  The
reference runs once per module in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``: tinyllama under
every knob, and the MoE, SSM, hybrid and enc-dec families with
``grad_specs``, three steps each on the same weights (the reference's
``zoo.init``, carried over by ``convert.from_reference``) and the same
numpy batches.

Tolerances are tests/test_torch_train.py's: the loss rtol 1e-5 in f32 and
2e-2 in bf16, the grad norm 1e-5 and 5e-2, the parameters after the first
step within 2·lr.  Against the port's one-device step, each step is also
taken by that step from a copy of the mesh's state, and its first moments
held within 1e-5 of each leaf's largest and its parameters within 2·lr.
The MoE aux is the mean of the lines' (a declared difference: the
reference's router takes its fractions over the whole batch), so
mixtral's aux, grad norm and later losses are held to the port's
one-device step at accum = 4, the number of data lines, and its first
loss to the reference's.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import Shape  # noqa: E402
from repro_torch.launch import dryrun as tdryrun  # noqa: E402
from repro_torch.launch.dryrun import (_leaves_with_specs,  # noqa: E402
                                       local_bytes)
from repro_torch.launch.mesh import AbstractMesh, make_host_mesh  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import hybrid as thybrid  # noqa: E402
from repro_torch.models import placement  # noqa: E402
from repro_torch.models import zoo as tzoo  # noqa: E402
from repro_torch.roofline.collectives import CollectiveCounter  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import sharded  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
STEPS, ROWS, SEQ, LR = 3, 8, 32, 1e-3
# name → (arch, dtype, (grad_specs, zero2, grad_comm_bf16), accum, remat)
CASES = {
    "tiny_plain": ("tinyllama-1.1b", "bf16", (0, 0, 0), 1, "none"),
    "tiny_specs": ("tinyllama-1.1b", "bf16", (1, 0, 0), 1, "none"),
    "tiny_zero2": ("tinyllama-1.1b", "bf16", (1, 1, 0), 1, "none"),
    "tiny_comm": ("tinyllama-1.1b", "bf16", (1, 0, 1), 1, "none"),
    "tiny_all_accum2": ("tinyllama-1.1b", "bf16", (1, 1, 1), 2, "none"),
    "tiny_remat": ("tinyllama-1.1b", "bf16", (1, 0, 0), 1, "full"),
    "mixtral": ("mixtral-8x7b", "f32", (1, 0, 0), 1, "none"),
    "mamba2": ("mamba2-780m", "f32", (1, 0, 0), 1, "none"),
    "zamba2": ("zamba2-7b", "f32", (1, 0, 0), 1, "none"),
    "seamless": ("seamless-m4t-large-v2", "f32", (1, 0, 0), 1, "none"),
}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": (1e-5, 1e-5), "bf16": (2e-2, 5e-2)}  # (loss, grad norm)

_SCRIPT = textwrap.dedent("""
    import os, sys
    # two cores: the reference's compiles would take every core the
    # tier-1 run's other workers are timing on
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:2])
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.models import common as cm
    from repro.models import zoo
    from repro.train import make_train_step, optimizer as jopt

    STEPS, ROWS, SEQ, LR = {steps}, {rows}, {seq}, {lr}
    CASES = {cases}
    DT = {{"f32": jnp.float32, "bf16": jnp.bfloat16}}

    def batch(cfg, t):
      rng = np.random.default_rng(100 + t)
      toks = rng.integers(0, cfg.vocab, (ROWS, SEQ), dtype=np.int32)
      b = {{"tokens": toks, "labels": toks}}
      if cfg.family == "encdec":
        b["src_embeds"] = rng.standard_normal(
            (ROWS, cfg.src_len, cfg.d_model)).astype(np.float32)
      return b

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
    par = cm.Parallelism(data_axes=("data",), tp_size=2)
    out = {{}}
    for name, (arch, dt, (gs, z2, cb), accum, remat) in CASES.items():
      cfg = configs.get_config(arch, smoke=True).replace(dtype=DT[dt])
      params = zoo.init(cfg, jax.random.PRNGKey(0))
      specs = cm.specs_like(params, cfg, par)
      ns = lambda s: jax.tree.map(lambda sp: NamedSharding(mesh, sp), s,
                                  is_leaf=lambda x: isinstance(x, P))
      oc = jopt.AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)
      step = make_train_step(cfg, oc, accum=accum, remat=remat,
                             grad_specs=specs if gs else None,
                             zero2=bool(z2), grad_comm_bf16=bool(cb))
      with mesh:
        state = (jax.device_put(params, ns(specs)),
                 jax.device_put(jopt.init_opt_state(params),
                                ns({{"m": specs, "v": specs, "step": P()}})))
        fn = jax.jit(step)
        for t in range(STEPS):
          b = jax.device_put(batch(cfg, t), NamedSharding(mesh, P("data")))
          state, m = fn(state, b)
          for k in ("loss", "aux_loss", "grad_norm", "lr"):
            out[f"{{name}}/{{t}}/{{k}}"] = np.asarray(m[k], np.float64)
          if t == 0:
            for i, leaf in enumerate(jax.tree.leaves(state[0])):
              out[f"{{name}}/p/{{i}}"] = np.asarray(leaf, np.float32)
    np.savez(sys.argv[1], **out)
""")


# the smoke sizes gain nothing from more threads, and the tier-1 run's
# workers share the host's cores
ONE_THREAD = {"OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
  out = tmp_path_factory.mktemp("train_mesh") / "ref.npz"
  script = _SCRIPT.format(steps=STEPS, rows=ROWS, seq=SEQ, lr=LR,
                          cases=repr(CASES))
  env = dict(os.environ, PYTHONPATH=SRC, **ONE_THREAD)
  r = subprocess.run([sys.executable, "-c", script, str(out)],
                     capture_output=True, text=True, env=env, timeout=900)
  assert r.returncode == 0, r.stderr[-3000:]
  with np.load(out) as z:
    return {k: z[k] for k in z.files}


# --- helpers -----------------------------------------------------------------


def _mesh():
  return make_host_mesh(8, model=2, devices=["cpu"] * 8)


def _par(mesh):
  return tcm.Parallelism(data_axes=("data",), tp_size=mesh.shape["model"])


def _batch(cfg, t):
  """The reference script's batch of step ``t``."""
  rng = np.random.default_rng(100 + t)
  toks = rng.integers(0, cfg.vocab, (ROWS, SEQ), dtype=np.int32)
  b = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
  if cfg.family == "encdec":
    b["src_embeds"] = torch.from_numpy(rng.standard_normal(
        (ROWS, cfg.src_len, cfg.d_model)).astype(np.float32))
  return b


def _model(arch, dtype="f32"):
  """(torch cfg, the port model with the reference's zoo.init(key 0)
  weights, the reference's parameters)."""
  jd, td = DTYPES[dtype]
  jcfg = jconfigs.get_config(arch, smoke=True).replace(dtype=jd)
  tcfg = tconfigs.get_config(arch, smoke=True).replace(dtype=td)
  jparams = jzoo.init(jcfg, jax.random.PRNGKey(0))
  model = convert.from_reference(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
  return tcfg, model, jparams


def _oc():
  return topt.AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)


def _sharded(tcfg, model, mesh):
  params = tzoo.param_tree(model)
  specs = tcm.specs_like(params, tcfg, _par(mesh))
  return sharded.shard_state(params, specs, mesh), specs


def _stacked(tree):
  """A port parameter tree in the reference's stacked layout, as numpy,
  in jax.tree.leaves order."""
  def stack(t):
    if isinstance(t, dict):
      return {k: stack(v) for k, v in t.items()}
    if isinstance(t, list):
      return jax.tree.map(lambda *xs: np.stack(xs), *[stack(x) for x in t])
    return t.detach().float().numpy()
  return jax.tree.leaves(stack(tree))


def _run(step, state, cfg, steps=STEPS):
  out = []
  for t in range(steps):
    state, m = step(state, _batch(cfg, t))
    out.append({k: float(v) for k, v in m.items()})
  return state, out


# --- against the reference on a (4, 2) mesh ----------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_step_matches_the_reference(reference, name):
  arch, dtype, (gs, z2, cb), accum, remat = CASES[name]
  tcfg, model, _ = _model(arch, dtype)
  mesh = _mesh()
  state, specs = _sharded(tcfg, model, mesh)
  step = tsteps.make_train_step(tcfg, _oc(), accum=accum, mesh=mesh,
                                remat=remat,
                                grad_specs=specs if gs else None,
                                zero2=bool(z2), grad_comm_bf16=bool(cb))
  loss_tol, norm_tol = TOL[dtype]
  first = None
  for t in range(STEPS):
    state, m = step(state, _batch(tcfg, t))
    if t == 0:
      first = _stacked(sharded.gather_tree(state.master, "cpu"))
    want = {k: float(reference[f"{name}/{t}/{k}"])
            for k in ("loss", "aux_loss", "grad_norm", "lr")}
    np.testing.assert_allclose(float(m["lr"]), want["lr"], rtol=1e-6)
    # the MoE's aux gradient is the lines' (held to accum = 4 below): its
    # parameters move otherwise, so only its first loss is the reference's
    if t == 0 or not tcfg.n_experts:
      np.testing.assert_allclose(float(m["loss"]), want["loss"],
                                 rtol=loss_tol, err_msg=f"step {t}")
    if not tcfg.n_experts:
      np.testing.assert_allclose(float(m["grad_norm"]), want["grad_norm"],
                                 rtol=norm_tol, err_msg=f"step {t}")
      assert float(m["aux_loss"]) == want["aux_loss"] == 0.0
  for i, got in enumerate(first):
    np.testing.assert_allclose(got, reference[f"{name}/p/{i}"],
                               atol=2 * LR, err_msg=f"leaf {i}")
  assert int(state.step) == STEPS


def test_moe_aux_is_the_mean_of_the_lines():
  """mixtral on the (4, 2) mesh: each line routes its own 2 rows, so the
  aux (and through it the grad norm) is the port's one-device step's at
  accum = 4; the loss equals the one-device accum = 1 step's."""
  tcfg, model, _ = _model("mixtral-8x7b")
  mesh = _mesh()
  state, _ = _sharded(tcfg, model, mesh)
  _, got = _run(tsteps.make_train_step(tcfg, _oc(), mesh=mesh), state, tcfg)
  tcfg, m4, _ = _model("mixtral-8x7b")
  _, want = _run(tsteps.make_train_step(tcfg, _oc(), accum=4),
                 (m4, topt.init_opt_state(tzoo.param_tree(m4))), tcfg)
  tcfg, m1, _ = _model("mixtral-8x7b")
  _, one = tsteps.make_train_step(tcfg, _oc())(
      (m1, topt.init_opt_state(tzoo.param_tree(m1))), _batch(tcfg, 0))
  for g, w in zip(got, want):
    for k in ("loss", "aux_loss", "grad_norm"):
      np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
  assert got[0]["aux_loss"] > 0
  np.testing.assert_allclose(got[0]["loss"], float(one["loss"]), rtol=1e-5)


def test_the_model_axis_shards_compute(monkeypatch):
  """Every mesh position runs its line's rows forward (and so backward) on
  its own part of the model: its H/tp query heads and the kv heads they
  group over, its slice of the MLP width and its vocab piece, never a
  whole leaf that the specs cut over the model axis."""
  tcfg, model, _ = _model("tinyllama-1.1b")
  mesh = _mesh()
  state, _ = _sharded(tcfg, model, mesh)
  tp = mesh.shape["model"]
  calls, heads = [], []
  forward = tzoo.forward
  flash = tattn.flash_xla

  def spy(m, cfg, batch, **kw):
    if not isinstance(m, tzoo.ShardedLM):
      pos = tcm.position()
      shapes = {p: tuple(t.shape) for p, t in
                tcm.tree_paths(tzoo.param_tree(m)).items()}
      calls.append((None if pos is None else pos.rank,
                    batch["tokens"].shape[0], shapes))
    return forward(m, cfg, batch, **kw)

  def flash_spy(q, k, v, *a, **kw):
    heads.append((tcm.position().rank, q.shape[2], k.shape[2]))
    return flash(q, k, v, *a, **kw)
  monkeypatch.setattr(tzoo, "forward", spy)
  monkeypatch.setattr(tattn, "flash_xla", flash_spy)
  tsteps.make_train_step(tcfg, _oc(), accum=2, mesh=mesh)(
      state, _batch(tcfg, 0))
  lines = mesh.shape["data"]
  assert sorted(c[0] for c in calls) == sorted(list(range(tp)) * lines * 2)
  assert {c[1] for c in calls} == {ROWS // 2 // lines}
  d, f, h, kv, hd = (tcfg.d_model, tcfg.d_ff, tcfg.n_heads, tcfg.n_kv_heads,
                     tcfg.hd)
  vp = tsteps.tf_mod.padded_vocab(tcfg)
  for _, _, shapes in calls:
    assert shapes["embed"] == shapes["lm_head"] == (vp // tp, d)
    for i in range(tcfg.n_layers):
      layer = {k.split("/", 2)[2]: v for k, v in shapes.items()
               if k.startswith(f"blocks/{i}/")}
      assert layer["attn/wq"] == (d, h // tp, hd)
      assert layer["attn/wk"] == layer["attn/wv"] == (d, kv // tp, hd)
      assert layer["attn/wo"] == (h // tp, hd, d)
      assert layer["mlp/w1"] == layer["mlp/w3"] == (d, f // tp)
      assert layer["mlp/w2"] == (f // tp, d)
  assert sorted(heads) == sorted([(j, h // tp, kv // tp) for j in range(tp)]
                                 * lines * 2 * tcfg.n_layers)


REMAT_CASES = [(arch, remat) for arch in ("tinyllama-1.1b", "mixtral-8x7b",
                                          "mamba2-780m", "zamba2-7b")
               for remat in ("full", "dots")] + [
                   ("seamless-m4t-large-v2", "full")]


def _remat_spy(monkeypatch):
  """Record every checkpointed region's runs: (region index on its
  position, rank, line, whether the run replays, the position's split
  flag), and the meetings held off the positions' threads."""
  runs, off_thread = [], []
  run_layer = tsteps.tf_mod.run_layer
  meet = tcm.LineGroup.meet
  seen = {}

  def spy(layer, remat, *args, **kw):
    pos = tcm.position()
    if remat == "none" or pos is None:
      return run_layer(layer, remat, *args, **kw)
    key = (pos.line, pos.rank)
    region = seen[key] = seen.get(key, -1) + 1

    def counted(*a, **k):
      here = tcm.position()
      runs.append((region, None if here is None else here.rank,
                   None if here is None else here.line,
                   here is not None and isinstance(here.group, tcm._Replay),
                   None if here is None else here.split))
      return layer(*a, **k)
    return run_layer(counted, remat, *args, **kw)

  def meet_spy(self, *args, **kw):
    if tcm.position() is None:
      off_thread.append(1)
    return meet(self, *args, **kw)
  monkeypatch.setattr(tsteps.tf_mod, "run_layer", spy)
  monkeypatch.setattr(tcm.LineGroup, "meet", meet_spy)
  return runs, off_thread, seen


def _one_step(arch, remat, monkeypatch=None):
  tcfg, model, _ = _model(arch)
  mesh = _mesh()
  state, _ = _sharded(tcfg, model, mesh)
  spied = None if monkeypatch is None else _remat_spy(monkeypatch)
  state, m = tsteps.make_train_step(tcfg, _oc(), mesh=mesh, remat=remat)(
      state, _batch(tcfg, 0))
  pieces = [x.pieces[p] for x in topt._leaves(state.master)
            for p in sorted(x.pieces)]
  return m, pieces, spied


@pytest.mark.parametrize("arch,remat", REMAT_CASES)
def test_remat_on_a_tensor_parallel_mesh_is_bit_equal(arch, remat,
                                                      monkeypatch):
  """remat 'full' and 'dots' on the (4, 2) mesh in f32: loss, grad norm
  and every master piece after one step bit-equal to the 'none' step, as
  many meetings, none of them off the positions' threads (the backward
  holds none), and each checkpointed layer run twice — the forward, then
  the recompute on the forward's position, replaying its meetings.  The
  SSM and hybrid stacks and the enc-dec keep every activation under
  'dots', as the reference's do: their layers run once."""
  want, want_pieces, _ = _one_step(arch, "none")
  got, pieces, (runs, off_thread, regions) = _one_step(arch, remat,
                                                       monkeypatch)
  for k in ("loss", "grad_norm", "aux_loss"):
    assert float(got[k]) == float(want[k]), k
  assert got["meetings"] == want["meetings"]
  assert len(pieces) == len(want_pieces)
  for a, b in zip(pieces, want_pieces):
    assert torch.equal(a, b)
  assert not off_thread
  keeps_all = remat == "dots" and arch in ("mamba2-780m", "zamba2-7b")
  assert not regions if keeps_all else regions
  for (line, rank), last in regions.items():
    for region in range(last + 1):
      mine = [r for r in runs if r[:3] == (region, rank, line)]
      assert [r[3] for r in mine] == [False, True]
      assert mine[0][4] == mine[1][4]


def test_the_recompute_replays_on_the_forwards_position(monkeypatch):
  """Inside the backward a recomputed layer sees a copy of the position
  its forward ran on, as it was when the layer began: its rank, its line
  and the split of its stream (``activation_sharding`` on), with groups
  that replay the recorded meetings; without it the layer would take the
  one-device path on the position's slices.  Each recompute runs to its
  end, so every layer's gathered weights are released (checkpoint's early
  stop would skip the layer's release hook)."""
  tcfg, model, _ = _model("tinyllama-1.1b")
  mesh = _mesh()
  state, _ = _sharded(tcfg, model, mesh)
  runs, off_thread, regions = _remat_spy(monkeypatch)
  hooks = []
  for name in ("_gather_layer", "_release_layer"):
    def counted(*args, hook=getattr(tzoo, name), name=name):
      hooks.append(name)
      return hook(*args)
    monkeypatch.setattr(tzoo, name, counted)
  with tcm.activation_sharding(("data", "model", None)):
    tsteps.make_train_step(tcfg, _oc(), mesh=mesh, remat="full")(
        state, _batch(tcfg, 0))
  assert hooks.count("_gather_layer") == hooks.count("_release_layer") \
      == 2 * tcfg.n_layers * 8
  replays = [r for r in runs if r[3]]
  assert len(replays) == len(runs) // 2 == tcfg.n_layers * 8
  assert all(r[1] is not None for r in runs)
  assert {r[4] for r in replays} == {False, True}   # the first block splits
  assert sorted(r[:3] for r in replays) == sorted(
      r[:3] for r in runs if not r[3])
  assert not off_thread and len(regions) == 8


# kv heads that tp does not divide: one kv head over 2 positions, and 2 kv
# heads over 4 (each shared by two positions' single query heads)
KV_CASES = {"1kv_tp2": (1, 2), "2kv_tp4": (2, 4)}


@pytest.mark.parametrize("case", list(KV_CASES))
def test_kv_heads_that_tp_does_not_divide(case):
  """tinyllama with its kv projections replicated over the model axis
  (``spec_for``'s GQA rule): each position computes with the kv heads its
  query heads read, their gradients sum over the positions, and three f32
  steps stay within rtol 1e-5 (loss, grad norm) and 2·lr (parameters) of
  the one-device step, with every model-axis replica bit-equal."""
  n_kv, tp = KV_CASES[case]
  tcfg, m1, _ = _model("tinyllama-1.1b")
  tcfg = tcfg.replace(n_kv_heads=n_kv)
  params = tzoo.param_tree(m1)
  for layer in params["blocks"]:
    for name in ("wk", "wv"):
      layer["attn"][name] = layer["attn"][name][:, :n_kv].contiguous()
  m1 = tzoo.from_params(tcfg, params)
  m2 = tzoo.from_params(tcfg, topt.tree_map(torch.clone, params))
  one, want = _run(tsteps.make_train_step(tcfg, _oc()),
                   (m1, topt.init_opt_state(tzoo.param_tree(m1))), tcfg)
  mesh = make_host_mesh(8, model=tp, devices=["cpu"] * 8)
  state, specs = _sharded(tcfg, m2, mesh)
  assert specs["blocks"][0]["attn"]["wk"] == ("data", None, None)
  state, got = _run(tsteps.make_train_step(tcfg, _oc(), mesh=mesh), state,
                    tcfg)
  for g, w in zip(got, want):
    for k in ("loss", "grad_norm"):
      np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
  for a, b in zip(topt._leaves(sharded.gather_tree(state.master, "cpu")),
                  topt._leaves(tzoo.param_tree(one[0]))):
    np.testing.assert_allclose(a.numpy(), b.detach().numpy(), atol=2 * LR)
  _assert_replicas_equal(state)


def _assert_replicas_equal(state):
  for tree in (state.master, state.m, state.v):
    for x in topt._leaves(tree):
      for group in x.owners().values():
        for pos in group[1:]:
          assert torch.equal(x.pieces[pos], x.pieces[group[0]])


def _row_parallel_per_forward(cfg) -> int:
  """Row-parallel projections per forward: 2 per transformer block, 1 per
  SSM layer, 2 per encoder and 3 per decoder layer of the enc-dec."""
  if cfg.family == "ssm":
    return cfg.n_layers
  if cfg.family == "hybrid":
    return cfg.n_layers + 2 * thybrid.layout(cfg)[1]
  if cfg.family == "encdec":
    return 3 * cfg.dec_layers + 2 * cfg.enc_layers
  return 2 * cfg.n_layers


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mixtral-8x7b",
                                  "mamba2-780m", "zamba2-7b",
                                  "seamless-m4t-large-v2"])
def test_row_parallel_meetings_match_the_dry_run(arch):
  """The collectives one step of two microbatches holds on the (4, 2)
  mesh, counted by ``roofline.collectives.CollectiveCounter``: on position
  (0, 0) the row-parallel sums (2 per transformer block, 1 per SSM layer,
  2 per encoder and 3 per decoder layer of the enc-dec), the embedding's
  sum, the gated norms' statistics and the loss's three (B, S) terms, each
  with its transposed collective in the backward but the loss's max and
  Σ exp (computed without a gradient), which is 2 × ``meetings`` − 1 per
  microbatch: the backward holds no meeting of its own.  Under remat
  "full" the step holds the same meetings (the recompute replays them)
  and every part cut along ``data`` is gathered twice per microbatch as
  under "none" (forward, then the regather or the recompute's gather;
  the enc-dec's decoder gathers its unused cross-attention wk and wv in
  the recompute too): the counted gathers equal the dry run's model of
  the same cell on every position, and every model-axis replica is
  bit-equal after the step."""
  tcfg, model, _ = _model(arch)
  mesh = _mesh()
  meetings = {}
  for remat in ("none", "full"):
    state, _ = _sharded(tcfg, model, mesh)
    step = tsteps.make_train_step(tcfg, _oc(), accum=2, mesh=mesh,
                                  remat=remat)
    with CollectiveCounter() as c:
      _, m = step(state, _batch(tcfg, 0))
    first = [x for x in c.of((0, 0))
             if x.term not in ("fsdp_all_gather", "grad_reduce_scatter",
                               "grad_all_reduce")]
    ssm = tcfg.n_layers if tcfg.family in ("ssm", "hybrid") else 0
    per_term = {t: sum(x.times for x in first if x.term == t)
                for t in {x.term for x in first}}
    assert per_term == {
        "tp_all_reduce": 2 * 2 * _row_parallel_per_forward(tcfg),
        "tp_embed_all_reduce": 2 * 2,
        "tp_stats_all_reduce": 2 * (5 + 2 * ssm)}
    assert len(first) == 2 * m["meetings"] - 2
    meetings[remat] = sorted(
        (x.term, x.kind, x.nbytes) for x in first)
    fields = {f.name: getattr(tcfg, f.name)
              for f in dataclasses.fields(tcfg) if f.name != "name"}
    cell = tdryrun.build_cell(
        arch, Shape("train_smoke", SEQ, ROWS, "train"),
        AbstractMesh((4, 2), ("data", "model")), remat=remat, accum=2,
        act_seq_shard=False, cfg_overrides=fields)
    want = sum(x.times for x in tdryrun.step_collectives(cell)
               if x.term == "fsdp_all_gather")
    assert c.count("fsdp_all_gather") == mesh.size * want
    if arch == "tinyllama-1.1b":   # 7 parts × 2 layers, gathered twice
      assert want == 7 * tcfg.n_layers * 2 * 2
    _assert_replicas_equal(state)
  assert meetings["none"] == meetings["full"]


def test_the_dry_run_charges_the_long_500k_column_meeting():
  """zamba2-7b's long_500k decode cell on the single-pod mesh (data 16,
  model 16): B = 1 does not split over data, whose 16 positions divide
  its 32 kv heads, so each data line attends 2 heads of each of its 13
  shared-block applications, merged over the model axis, and the column
  assembles all 32 in f32; ahead of them the new row's heads (2 query and
  2 kv heads per model position, q, k and v in bf16) meet over the model
  axis; by hand."""
  from repro_torch.roofline.collectives import ring_traffic_bytes
  cell = tdryrun.build_cell("zamba2-7b", "long_500k", "single")
  cfg = cell.cfg
  assert (cfg.n_heads, cfg.n_kv_heads, cfg.hd) == (32, 32, 112)
  terms, axis_bytes, _ = tdryrun.collective_model(cell)
  apps = 13
  assert terms["decode_heads_all_gather"] == apps * ring_traffic_bytes(
      "all-gather", 1 * 32 * 112 * 4, 16)
  assert terms["decode_attn_all_reduce"] == apps * (
      ring_traffic_bytes("all-gather", 16 * 1 * (2 + 2 * 2) * 112 * 2, 16)
      + ring_traffic_bytes("all-reduce", 1 * 2 * (112 + 2) * 4, 16))
  assert terms["decode_heads_all_gather"] == pytest.approx(
      13 * 15 / 16 * 14336)
  assert axis_bytes["data"] == (terms["fsdp_all_gather"]
                                + terms["decode_heads_all_gather"])
  mixtral = tdryrun.build_cell("mixtral-8x7b", "long_500k", "single")
  # 8 kv heads do not divide over 16 data positions: no 2-D cut
  assert tdryrun.collective_model(mixtral)[0][
      "decode_heads_all_gather"] == 0


# --- against the port's one-device step --------------------------------------

ARCHS = ["tinyllama-1.1b", "mamba2-780m", "zamba2-7b",
         "seamless-m4t-large-v2", "chameleon-34b"]


def _held_copy(state):
  """The one-device state of a copy of a mesh state: its gathered master,
  moments and count, cloned (``gather_leaf`` returns a whole piece as it
  is)."""
  tree = topt.tree_map(lambda x: x.clone(), state.gathered("cpu"))
  return tree["params"], tree["opt"]


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_equals_the_one_device_step(arch):
  """Three f32 steps on the same weights and batches: the losses, grad
  norms and lr within rtol 1e-5 of the free-running one-device step's.
  At each step the one-device step started from a copy of the mesh's
  state (master, both moments, count; at the first step that is the
  common start) gives the same first moments, within 1e-5 of each leaf's
  largest, and the same parameters within 2·lr.

  The parameters are not held free-running after the first step: AdamW
  turns a gradient near zero (|g| ~ eps = 1e-8) into an update of up to
  lr whatever its size, so an f32 sum-order difference there moves a
  parameter by a good part of lr, and the next step takes its gradients
  at other points (zamba2's embedding row 365 ended 2.08e-3 apart after
  three steps)."""
  tcfg, m1, _ = _model(arch)
  free = (m1, topt.init_opt_state(tzoo.param_tree(m1)))
  one = tsteps.make_train_step(tcfg, _oc())
  _, m2, _ = _model(arch)
  mesh = _mesh()
  state, _ = _sharded(tcfg, m2, mesh)
  step = tsteps.make_train_step(tcfg, _oc(), mesh=mesh)
  for t in range(STEPS):
    params, opt = _held_copy(state)
    (model, opt), _ = one((tzoo.from_params(tcfg, params), opt),
                          _batch(tcfg, t))
    free, want = one(free, _batch(tcfg, t))
    state, got = step(state, _batch(tcfg, t))
    for k in ("loss", "grad_norm", "lr"):
      np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                 err_msg=f"step {t + 1} {k}")
    held = state.gathered("cpu")
    for i, (a, b) in enumerate(zip(topt._leaves(held["opt"]["m"]),
                                   topt._leaves(opt["m"]))):
      np.testing.assert_allclose(
          a.numpy(), b.numpy(), rtol=0, atol=1e-5 * float(b.abs().max()),
          err_msg=f"step {t + 1}: first moment of leaf {i}")
    for a, b in zip(topt._leaves(held["params"]),
                    topt._leaves(tzoo.param_tree(model))):
      np.testing.assert_allclose(a.numpy(), b.detach().numpy(),
                                 atol=2 * LR, err_msg=f"step {t + 1}")


def test_accum_and_knobs_on_a_mesh_equal_the_one_device_step():
  """accum 2 with grad_specs and zero2 (bf16 compute): the mesh's lines
  differentiate the same bf16 copies as the one-device step, so the loss
  is the one-device step's within the f32 tolerance."""
  tcfg, m1, _ = _model("tinyllama-1.1b", "bf16")
  params = tzoo.param_tree(m1)
  specs = tcm.specs_like(params, tcfg, _par(_mesh()))
  _, want = _run(tsteps.make_train_step(tcfg, _oc(), accum=2,
                                        grad_specs=specs, zero2=True),
                 (m1, topt.init_opt_state(params)), tcfg, steps=1)
  _, m2, _ = _model("tinyllama-1.1b", "bf16")
  mesh = _mesh()
  state, specs = _sharded(tcfg, m2, mesh)
  _, got = _run(tsteps.make_train_step(tcfg, _oc(), accum=2, mesh=mesh,
                                       grad_specs=specs, zero2=True),
                state, tcfg, steps=1)
  np.testing.assert_allclose(got[0]["loss"], want[0]["loss"], rtol=1e-5)
  np.testing.assert_allclose(got[0]["grad_norm"], want[0]["grad_norm"],
                             rtol=1e-2)


# --- the sharded state -------------------------------------------------------


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mixtral-8x7b",
                                  "zamba2-7b", "seamless-m4t-large-v2"])
def test_pieces_have_local_bytes_and_no_whole_cut_leaf(arch):
  """Each position holds, leaf by leaf, the piece ``local_bytes`` reckons
  (ceil-sized, the last along a dimension shorter); no position holds a
  whole leaf whose spec cuts it, and replicas are copies."""
  tcfg, model, _ = _model(arch)
  mesh = _mesh()
  state, specs = _sharded(tcfg, model, mesh)
  pairs = list(_leaves_with_specs(tzoo.param_tree(model), specs))
  leaves, spec_list = [t for t, _ in pairs], [s for _, s in pairs]
  cut = 0
  masters = [x for x, _ in _leaves_with_specs(state.master, specs)]
  for x, t, spec in zip(masters, leaves, spec_list, strict=True):
    factor = max(1, _factor(spec, mesh))
    for pos in sharded.positions(mesh):
      p = x.pieces[pos]
      assert p.device == mesh.devices[pos[0]][pos[1]]
      assert p.dtype == torch.float32
      assert torch.equal(p, t[x.box(pos)].float())
      full = all(b.stop - b.start == -(-d // f) for b, d, f in zip(
          x.box(pos), t.shape, _factors(spec, mesh)))
      if full:
        assert p.numel() * 4 == local_bytes(t.float(), spec, mesh.shape)
      if factor > 1:
        assert p.numel() < t.numel()
    cut += factor > 1
    ptrs = {p.data_ptr() for p in x.pieces.values() if p.numel()}
    assert len(ptrs) == sum(1 for p in x.pieces.values() if p.numel())
  assert cut > 0
  # positions (0, 0) hold full ceil-sized pieces of every leaf
  want = sum(local_bytes(t.float(), s, mesh.shape)
             for t, s in zip(leaves, spec_list))
  assert sharded.tree_local_bytes(state.master, (0, 0)) == want
  assert want < sum(t.numel() * 4 for t in leaves) / 2
  assert state.local_bytes((0, 0)) == 3 * want


def _factors(spec, mesh):
  return [int(np.prod([mesh.shape[a] for a in placement.names(e)]))
          for e in spec]


def _factor(spec, mesh):
  return int(np.prod(_factors(spec, mesh)))


def test_a_dimension_that_does_not_divide_is_cut_ceil_sized():
  mesh = _mesh()
  t = torch.arange(10 * 3, dtype=torch.float32).reshape(10, 3)
  x = sharded.shard_leaf(t, ("data", "model"), mesh)
  rows = [x.box((i, 0))[0] for i in range(4)]
  assert [(s.start, s.stop) for s in rows] == [(0, 3), (3, 6), (6, 9),
                                               (9, 10)]
  cols = [x.box((0, j))[1] for j in range(2)]
  assert [(s.start, s.stop) for s in cols] == [(0, 2), (2, 3)]
  assert torch.equal(sharded.gather_leaf(x, "cpu"), t)
  # ("data", "model") on one dimension: eight pieces, data major
  y = sharded.shard_leaf(torch.arange(16.0), (("data", "model"),), mesh)
  assert [float(y.pieces[(i, j)][0]) for i in range(4) for j in range(2)] \
      == [2.0 * k for k in range(8)]
  assert torch.equal(sharded.gather_leaf(y, "cpu", torch.bfloat16),
                     torch.arange(16.0).to(torch.bfloat16))
  with pytest.raises(ValueError, match="axis"):
    sharded.shard_leaf(t, ("pod", None), mesh)
  with pytest.raises(ValueError, match="spec"):
    sharded.shard_leaf(t, ("data",), mesh)


def test_reduce_scatter_sums_lines_and_rounds_the_copy():
  """``PositionGrads``: a leaf cut over the model axis takes each
  position's part into the owners' pieces (and their replicas along data),
  summed over the lines; a replicated one sums the line's positions over
  their boxes in position order at ``flush`` and adds the sum into every
  replica, which stay copies; bf16 rounds each copy."""
  mesh = _mesh()
  like = sharded.shard_tree({"w": torch.zeros(8, 4), "s": torch.zeros(8)},
                            {"w": (None, "model"), "s": ("data",)}, mesh)
  g1, g2 = torch.randn(2, 8, 4), torch.randn(2, 8)
  for bf16 in (False, True):
    sink = sharded.PositionGrads(like, "model", bf16=bf16)
    acc = sink.acc
    for i in range(mesh.shape["data"]):
      for j in range(2):
        box = (slice(0, 8), slice(2 * j, 2 * j + 2))
        sink.add("w", (i, j), box, g1[i % 2][box])
        sink.add("s", (i, j), (slice(4 * j, 4 * j + 4),),
                 g2[i % 2][4 * j:4 * j + 4])
      sink.flush()
    rnd = (lambda t: t.to(torch.bfloat16).float()) if bf16 else (
        lambda t: t)
    assert torch.equal(sharded.gather_leaf(acc["w"], "cpu"),
                       rnd(g1[0]) + rnd(g1[1]) + rnd(g1[0]) + rnd(g1[1]))
    assert torch.equal(sharded.gather_leaf(acc["s"], "cpu"),
                       rnd(g2[0]) + rnd(g2[1]) + rnd(g2[0]) + rnd(g2[1]))
    # the replicas along "model" are copies of the same sum
    assert acc["s"].pieces[(0, 0)].data_ptr() != \
        acc["s"].pieces[(0, 1)].data_ptr()
    assert torch.equal(acc["s"].pieces[(0, 0)], acc["s"].pieces[(0, 1)])


def test_replicas_stay_equal_and_adamw_matches_one_device():
  """Three steps on the mesh: every replica of a piece stays bit-equal, and
  the sharded AdamW leaves the moments of the one-device update."""
  tcfg, m1, _ = _model("tinyllama-1.1b")
  opt1 = topt.init_opt_state(tzoo.param_tree(m1))
  (_, opt1), _ = _run(tsteps.make_train_step(tcfg, _oc()), (m1, opt1), tcfg)
  _, m2, _ = _model("tinyllama-1.1b")
  mesh = _mesh()
  state, _ = _sharded(tcfg, m2, mesh)
  state, _ = _run(tsteps.make_train_step(tcfg, _oc(), mesh=mesh), state,
                  tcfg)
  for tree in (state.master, state.m, state.v):
    for x in topt._leaves(tree):
      for group in x.owners().values():
        for pos in group[1:]:
          assert torch.equal(x.pieces[pos], x.pieces[group[0]])
  for name in ("m", "v"):
    for a, b in zip(topt._leaves(sharded.gather_tree(getattr(state, name),
                                                     "cpu")),
                    topt._leaves(opt1[name])):
      np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-8)
  assert int(state.step) == int(opt1["step"]) == STEPS


def test_grad_specs_on_a_mesh_must_be_the_states():
  tcfg, model, _ = _model("tinyllama-1.1b")
  mesh = _mesh()
  state, specs = _sharded(tcfg, model, mesh)
  other = tcm.specs_like(tzoo.param_tree(model), tcfg,
                         tcm.Parallelism(data_axes=("data",), tp_size=2,
                                         fsdp=False))
  step = tsteps.make_train_step(tcfg, _oc(), mesh=mesh, grad_specs=other)
  with pytest.raises(ValueError, match="grad_specs"):
    step(state, _batch(tcfg, 0))
  with pytest.raises(TypeError, match="ShardedState"):
    tsteps.make_train_step(tcfg, _oc(), mesh=mesh)(
        (model, topt.init_opt_state(tzoo.param_tree(model))),
        _batch(tcfg, 0))
  with pytest.raises(ValueError, match="data lines"):
    tsteps.make_train_step(tcfg, _oc(), mesh=mesh)(
        state, {k: v[:6] for k, v in _batch(tcfg, 0).items()})


# --- the knobs on one device -------------------------------------------------

KNOBS = {"specs": ((1, 0, 0), 1), "zero2": ((1, 1, 0), 1),
         "comm": ((1, 0, 1), 1), "all_accum2": ((1, 1, 1), 2)}


@pytest.mark.parametrize("knob", list(KNOBS))
def test_one_device_knobs_match_the_reference(knob):
  """tinyllama in bf16, one step: the reference's step with the same knobs,
  jitted on a (1, 1) mesh of this process's one device (its specs need a
  mesh to name), in-process."""
  (gs, z2, cb), accum = KNOBS[knob]
  tcfg, model, jparams = _model("tinyllama-1.1b", "bf16")
  jcfg = jconfigs.get_config("tinyllama-1.1b", smoke=True).replace(
      dtype=jnp.bfloat16)
  jspecs = jcm.specs_like(jparams, jcfg, jcm.Parallelism(
      data_axes=("data",), tp_size=1))
  joc = jopt.AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)
  jstep = jmake_train_step(jcfg, joc, accum=accum,
                           grad_specs=jspecs if gs else None,
                           zero2=bool(z2), grad_comm_bf16=bool(cb))
  b = _batch(tcfg, 0)
  jb = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
  with Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model")):
    (jnew, _), jm = jax.jit(jstep)((jparams, jopt.init_opt_state(jparams)),
                                   jb)
  tspecs = tcm.specs_like(tzoo.param_tree(model), tcfg, tcm.Parallelism(
      data_axes=("data",), tp_size=1))
  step = tsteps.make_train_step(tcfg, _oc(), accum=accum,
                                grad_specs=tspecs if gs else None,
                                zero2=bool(z2), grad_comm_bf16=bool(cb))
  (model, _), tm = step((model, topt.init_opt_state(
      tzoo.param_tree(model))), b)
  np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                             rtol=2e-2)
  np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                             rtol=5e-2)
  for a, got in zip(jax.tree.leaves(jnew),
                    _stacked(tzoo.param_tree(model))):
    np.testing.assert_allclose(got, np.asarray(a, np.float32), atol=2 * LR)
  assert isinstance(jspecs["embed"], PartitionSpec)


@pytest.mark.parametrize("on_mesh", [False, True], ids=["one_device", "mesh"])
def test_zero2_without_grad_specs_is_a_no_op(on_mesh):
  """As in the reference (``zero2 and grad_specs is not None``): the step
  with zero2 alone is the plain step, bit for bit."""
  tcfg, _, _ = _model("tinyllama-1.1b", "bf16")
  runs = []
  for kw in ({}, {"zero2": True}):
    _, model, _ = _model("tinyllama-1.1b", "bf16")
    if on_mesh:
      mesh = _mesh()
      state, _ = _sharded(tcfg, model, mesh)
      step = tsteps.make_train_step(tcfg, _oc(), mesh=mesh, **kw)
    else:
      state = (model, topt.init_opt_state(tzoo.param_tree(model)))
      step = tsteps.make_train_step(tcfg, _oc(), **kw)
    _, ms = _run(step, state, tcfg, steps=2)
    runs.append(ms)
  assert runs[0] == runs[1]


def test_zero2_differentiates_the_compute_copy():
  """On one device with grad_specs, zero2 moves the gradients (they come
  from bf16 leaves) and grad_comm_bf16 rounds them, as the reference's
  do; grad_specs alone changes nothing."""
  tcfg, _, _ = _model("tinyllama-1.1b", "bf16")
  norms = {}
  for label, kw in (("plain", {}), ("specs", {"grad_specs": {}}),
                    ("zero2", {"grad_specs": {}, "zero2": True}),
                    ("comm", {"grad_comm_bf16": True})):
    _, model, _ = _model("tinyllama-1.1b", "bf16")
    _, m = tsteps.make_train_step(tcfg, _oc(), **kw)(
        (model, topt.init_opt_state(tzoo.param_tree(model))),
        _batch(tcfg, 0))
    norms[label] = float(m["grad_norm"])
  assert norms["specs"] == norms["plain"]
  assert norms["zero2"] != norms["plain"]
  assert norms["comm"] != norms["plain"]
  np.testing.assert_allclose(norms["zero2"], norms["plain"], rtol=5e-2)


# --- checkpoints across meshes and the driver --------------------------------


def test_a_checkpoint_crosses_between_a_mesh_and_one_device(tmp_path):
  tcfg, model, _ = _model("zamba2-7b")
  mesh = _mesh()
  state, specs = _sharded(tcfg, model, mesh)
  state, _ = _run(tsteps.make_train_step(tcfg, _oc(), mesh=mesh), state,
                  tcfg, steps=1)
  ckpt.save(str(tmp_path / "mesh"), 1, state)
  # on one device
  _, other, _ = _model("zamba2-7b")
  params = tzoo.param_tree(other)
  back, step = ckpt.restore(str(tmp_path / "mesh"), template={
      "params": params, "opt": topt.init_opt_state(params)})
  assert step == 1
  want = state.gathered("cpu")
  for a, b in zip(topt._leaves(back), topt._leaves(want)):
    assert torch.equal(torch.as_tensor(a), b)
  # back onto a (2, 2) mesh from the one-device tree
  ckpt.save(str(tmp_path / "one"), 1, back)
  mesh22 = make_host_mesh(4, model=2, devices=["cpu"] * 4)
  state22, _ = _sharded(tcfg, other, mesh22)
  again, _ = ckpt.restore(str(tmp_path / "one"), template=state22)
  assert again.mesh == mesh22
  for a, b in zip(topt._leaves(again.gathered("cpu")), topt._leaves(want)):
    assert torch.equal(a, b)
  # and it trains on: the same step on both meshes from the same state
  again, m22 = _run(tsteps.make_train_step(tcfg, _oc(), mesh=mesh22),
                    again, tcfg, steps=1)
  state, m42 = _run(tsteps.make_train_step(tcfg, _oc(), mesh=mesh), state,
                    tcfg, steps=1)
  np.testing.assert_allclose(m22[0]["loss"], m42[0]["loss"], rtol=1e-5)


def _run_train(args):
  return subprocess.run(
      [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu"]
      + args, capture_output=True, text=True, timeout=600,
      env=dict(os.environ, PYTHONPATH=SRC, **ONE_THREAD))


def _loss_of(stdout):
  line = [ln for ln in stdout.splitlines() if "loss=" in ln][-1]
  return float(line.split("loss=")[1].split()[0])


def test_kill_and_resume_on_a_mesh_through_the_driver(tmp_path):
  """``--shards 8`` (a (4, 2) mesh of CPU shards): killed at step 8 of 12
  and resumed, the run ends at the uninterrupted run's loss (rtol 1e-5);
  the step-8 checkpoint also resumes on one device, within rtol 1e-3."""
  common = ["--arch", "tinyllama-1.1b", "--smoke", "--steps", "12",
            "--batch", "4", "--seq", "32", "--lr", "1e-3", "--ckpt-every",
            "4", "--log-every", "12"]
  mesh = ["--shards", "8"]
  r = _run_train(common + mesh + ["--ckpt-dir", str(tmp_path / "ref")])
  assert r.returncode == 0, r.stderr
  assert "mesh data=4 x model=2 on cpu" in r.stdout
  crash = tmp_path / "crash"
  r1 = _run_train(common + mesh + ["--ckpt-dir", str(crash), "--fail-at",
                                   "8"])
  assert r1.returncode == 42, r1.stderr
  assert ckpt.latest_step(str(crash)) == 8
  shutil.copytree(crash, tmp_path / "one")
  r2 = _run_train(common + mesh + ["--ckpt-dir", str(crash), "--async-ckpt"])
  assert r2.returncode == 0, r2.stderr
  assert "resumed from step 8" in r2.stdout
  np.testing.assert_allclose(_loss_of(r2.stdout), _loss_of(r.stdout),
                             rtol=1e-5)
  assert ckpt.latest_step(str(crash)) == 12
  # the mesh run's step-8 checkpoint, resumed with no --shards
  r3 = _run_train(common + ["--ckpt-dir", str(tmp_path / "one")])
  assert r3.returncode == 0, r3.stderr
  assert "resumed from step 8" in r3.stdout
  assert "mesh data=1 x model=1 on cpu" in r3.stdout
  # steps 9-12 run one line of 4 rows, not 4 lines of 1: the bf16 GEMMs
  # sum in other orders (phase 17's 1e-3 on the card)
  np.testing.assert_allclose(_loss_of(r3.stdout), _loss_of(r.stdout),
                             rtol=1e-3)
