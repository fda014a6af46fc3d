"""Train, then serve, on the port (the reference's
tests/test_system.py::test_train_then_serve_roundtrip), on the CPU.

A smoke tinyllama trains 40 steps until its loss drops, on one device and
on a (4, 2) mesh of CPU shards (``make_host_mesh(8, model=2,
devices=["cpu"] * 8)``, the state cut by ``specs_like``); then
``launch.serve.Engine`` serves the trained weights (on the mesh, the
master gathered whole) and its greedy tokens must equal the model's own
argmax rollout over the full context, token for token, as the reference's
test requires."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.serve import Engine  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.train import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.train import make_train_step, sharded  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  """The smoke sizes gain nothing from more threads, and the tier-1 run's
  workers share the host's cores."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


@pytest.mark.parametrize("on_mesh", [False, True], ids=["one_device", "mesh"])
def test_train_then_serve_roundtrip(on_mesh):
  cfg = configs.get_config("tinyllama-1.1b", smoke=True)
  oc = AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=80)
  model = zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
  if on_mesh:
    mesh = make_host_mesh(8, model=2, devices=["cpu"] * 8)
    params = zoo.param_tree(model)
    state = sharded.shard_state(params, cm.specs_like(
        params, cfg, cm.Parallelism(data_axes=("data",), tp_size=2)), mesh)
    step = make_train_step(cfg, oc, mesh=mesh)
  else:
    state = (model, init_opt_state(zoo.param_tree(model)))
    step = make_train_step(cfg, oc)
  data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=48, global_batch=8,
                                seed=11))
  first = last = None
  for i in range(40):
    state, m = step(state, data.batch_at(i))
    if first is None:
      first = float(m["loss"])
    last = float(m["loss"])
  assert last < first

  if on_mesh:
    model = zoo.from_params(cfg, sharded.gather_tree(state.master, "cpu"))
  else:
    model = state[0]
  for p in model.parameters():
    p.requires_grad_(False)
  eng = Engine(cfg, model, max_len=64, impl="xla", device="cpu")
  rng = np.random.default_rng(0)
  prompts = rng.integers(0, cfg.vocab, (2, 16), dtype=np.int32)
  toks = eng.generate(prompts, 8)
  assert toks.shape == (2, 8)
  assert int(toks.max()) < cfg.vocab

  # engine output == manual full-context argmax rollout (greedy consistency)
  ctx = torch.from_numpy(prompts).long()
  manual = []
  with torch.no_grad():
    for _ in range(8):
      logits, _, _ = zoo.forward(model, cfg, {"tokens": ctx}, mode="train")
      nxt = torch.argmax(logits[:, -1], dim=-1)
      manual.append(nxt.numpy().astype(np.int32))
      ctx = torch.cat([ctx, nxt[:, None]], dim=1)
  manual = np.stack(manual, axis=1)
  assert np.array_equal(toks, manual), (toks, manual)
