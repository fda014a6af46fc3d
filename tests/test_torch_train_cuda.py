"""LM training on the card: the flash backward against autograd through
the chunks, and one train step on the card against the same step on the
CPU.

Every test here needs an NVIDIA GPU; each is marked ``cuda`` and skips
with a reason where there is none.  The file imports nothing of JAX:

    python -m pytest -q --noconftest -m cuda tests/test_torch_train_cuda.py

Tolerances: the flash backward at tinyllama's attention shape (B 2, S 2048,
H 32, KV 4, D 64) in f32 within 1e-4 of ``xla_autodiff`` (both sum over
2048 keys in f32, in other orders; TF32 off), in bf16 within 2e-2 (the
gradients round to bf16 once at the end, an ulp at magnitude 2-4); one
smoke train step in f32 on the card against the CPU: loss rtol 1e-5, grad
norm rtol 1e-4, parameters within 2·lr (the reference's own bound).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import steps  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_flash_backward_matches_autodiff_on_the_card(cuda, dtype, tol):
  g = torch.Generator(device=cuda).manual_seed(0)
  b, s, h, kv, d = 2, 2048, 32, 4, 64
  q = torch.randn((b, s, h, d), generator=g, device=cuda).to(dtype)
  k = torch.randn((b, s, kv, d), generator=g, device=cuda).to(dtype)
  v = torch.randn((b, s, kv, d), generator=g, device=cuda).to(dtype)
  dout = torch.randn((b, s, h, d), generator=g, device=cuda).to(dtype)
  grads = []
  for arm in ("flash", "autodiff"):
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    if arm == "flash":
      out = attn.flash_xla(*ts, True, None, d ** -0.5, 0, attn.FLASH_CHUNK)
    else:
      out, _ = attn._flash_fwd_impl(*ts, True, None, d ** -0.5, 0,
                                    attn.FLASH_CHUNK)
    out.backward(dout)
    grads.append([t.grad.float() for t in ts])
  for a, c in zip(*grads):
    assert bool(torch.isfinite(a).all())
    torch.testing.assert_close(a, c, rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-780m"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
  cfg = configs.get_config(arch, smoke=True).replace(dtype=torch.float32)
  oc = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
  batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4,
                                 seed=1)).batch_at(0)
  out = {}
  for dev in ("cpu", cuda):
    model = zoo.init(cfg, torch.Generator().manual_seed(0), "cpu").to(dev)
    state = (model, opt.init_opt_state(zoo.param_tree(model)))
    (model, _), m = steps.make_train_step(cfg, oc)(state, batch)
    out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]),
                     [p.detach().cpu() for p in model.parameters()])
  (l0, n0, p0), (l1, n1, p1) = out["cpu"], out[str(cuda)]
  assert l1 == pytest.approx(l0, rel=1e-5)
  assert n1 == pytest.approx(n0, rel=1e-4)
  for a, c in zip(p0, p1):
    torch.testing.assert_close(a, c, rtol=0, atol=2e-3)
