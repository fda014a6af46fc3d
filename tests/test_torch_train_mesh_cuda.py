"""Tensor-parallel training on the card: the mesh step on a virtual 2 × 2
mesh of one card (``make_host_mesh(devices=["cuda:0"] * 4)``) against the
one-device step on the card, at the smoke sizes of the five families.

Every test here needs an NVIDIA GPU; each is marked ``cuda`` and skips
with a reason where there is none.  The file imports nothing of JAX:

    python -m pytest -q --noconftest -m cuda tests/test_torch_train_mesh_cuda.py

On the card the row-parallel partial products are bf16 products with an
f32 result (``out_dtype``), differentiated by ``common._F32Product``.
Tolerances are tests/test_torch_train_mesh.py's: three steps, loss rtol
1e-5 in f32 and 2e-2 in bf16, grad norm 1e-5 and 5e-2, the parameters
within 2·lr in f32; every model-axis replica bit-equal after the steps.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import sharded, steps  # noqa: E402

pytestmark = pytest.mark.cuda

LR, STEPS = 1e-3, 3
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 5e-2)}


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device("cuda")


def _batches(cfg):
  data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4,
                                seed=1))
  out = []
  for t in range(STEPS):
    b = data.batch_at(t)
    if cfg.family == "encdec":
      g = torch.Generator().manual_seed(t)
      b["src_embeds"] = torch.randn((4, cfg.src_len, cfg.d_model),
                                    generator=g)
    out.append(b)
  return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mixtral-8x7b",
                                  "mamba2-780m", "zamba2-7b",
                                  "seamless-m4t-large-v2"])
def test_mesh_step_on_the_card_equals_one_device(cuda, arch, dtype):
  cfg = configs.get_config(arch, smoke=True).replace(dtype=dtype)
  oc = opt.AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)
  batches = _batches(cfg)
  model = zoo.init(cfg, torch.Generator().manual_seed(0), "cpu").to(cuda)
  params = zoo.param_tree(model)
  mesh = make_host_mesh(4, model=2, devices=["cuda:0"] * 4)
  specs = cm.specs_like(params, cfg, cm.Parallelism(data_axes=("data",),
                                                    tp_size=2))
  state = sharded.shard_state(params, specs, mesh)
  one = (model, opt.init_opt_state(params))
  one_step = steps.make_train_step(cfg, oc)
  mesh_step = steps.make_train_step(cfg, oc, mesh=mesh)
  loss_tol, norm_tol = TOL[dtype]
  for t, b in enumerate(batches):
    one, want = one_step(one, b)
    state, got = mesh_step(state, b)
    if t == 0 or not cfg.n_experts:  # the MoE aux is the lines' mean
      assert float(got["loss"]) == pytest.approx(float(want["loss"]),
                                                 rel=loss_tol)
    if not cfg.n_experts:
      assert float(got["grad_norm"]) == pytest.approx(
          float(want["grad_norm"]), rel=norm_tol)
  if dtype == torch.float32 and not cfg.n_experts:
    for a, c in zip(opt._leaves(sharded.gather_tree(state.master, "cpu")),
                    opt._leaves(zoo.param_tree(one[0]))):
      torch.testing.assert_close(a, c.detach().cpu(), rtol=0, atol=2 * LR)
  for tree in (state.master, state.m, state.v):
    for x in opt._leaves(tree):
      for group in x.owners().values():
        for pos in group[1:]:
          assert torch.equal(x.pieces[pos], x.pieces[group[0]])
