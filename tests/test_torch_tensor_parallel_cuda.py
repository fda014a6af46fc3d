"""Tensor-parallel serving on the card: K3 and K4 on each position's heads.

On a virtual (1, 2) mesh of cuda:0 (``make_host_mesh(2, model=2,
devices=["cuda:0"] * 2)``) the smoke configs of tinyllama-1.1b (K3),
mamba2-780m (K4) and zamba2-7b (both) prefill and decode on
``impl="pallas"``: each position launches the kernels once per layer on
its H/2 heads (twice the one-device launches in all), and the logits are
held to the one-device ``impl="pallas"`` run and to the mesh's plain arm
(``impl="xla"``), the engine's greedy tokens to the one-device engine's.

Every test here needs an NVIDIA GPU and ``nvcc``; each is marked ``cuda``
and skips with a reason where there is none.  The file imports nothing of
JAX:

    python -m pytest -q --noconftest -m cuda tests/test_torch_tensor_parallel_cuda.py

Tolerances: f32 rtol 1e-5 with an atol of 1e-5 of the largest magnitude
against one device on the same arm (the partial sums are added in another
order), 1e-4 against the plain arm (K3 and K4 sum in other orders than
their plain versions); bf16 rtol/atol 2e-2 (tests/test_torch_models.py).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import zoo  # noqa: E402

fa = importlib.import_module("repro_torch.kernels.flash_attention")

pytestmark = pytest.mark.cuda

ARCHS = ["tinyllama-1.1b", "mamba2-780m", "zamba2-7b"]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
B, S = 2, 32


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
  return torch.device("cuda")


def _setup(arch, dtype, cuda):
  cfg = configs.get_config(arch, smoke=True).replace(dtype=DTYPES[dtype])
  model = zoo.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
  toks = torch.from_numpy(np.random.default_rng(1).integers(
      0, cfg.vocab, (B, S))).to(cuda)
  mesh = make_host_mesh(2, model=2, devices=["cuda:0"] * 2)
  return cfg, model, toks, mesh


def _launches():
  return fa.flash_attention.launches, ssd.ssd_intra_chunk.launches


def _tol(dtype, want, plain=False):
  if dtype == "bf16":
    return dict(rtol=2e-2, atol=2e-2)
  r = 1e-4 if plain else 1e-5
  return dict(rtol=r, atol=r * float(want.abs().max()))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_each_position_launches_the_kernels_on_its_heads(cuda, arch, dtype):
  cfg, model, toks, mesh = _setup(arch, dtype, cuda)
  on = zoo.shard(cfg, model, mesh)
  with torch.inference_mode(), cm.activation_sharding(("data", "model",
                                                       None)):
    k0 = _launches()
    want, _, _ = zoo.forward(model, cfg, {"tokens": toks}, mode="prefill",
                             impl="pallas")
    k1 = _launches()
    got, _, _ = zoo.forward(on, cfg, {"tokens": toks}, mode="prefill",
                            impl="pallas")
    k2 = _launches()
    plain, _, _ = zoo.forward(on, cfg, {"tokens": toks}, mode="prefill",
                              impl="xla")
    torch.cuda.synchronize()
    assert _launches() == k2
  one = (k1[0] - k0[0], k1[1] - k0[1])
  assert one[0] + one[1] > 0
  assert (k2[0] - k1[0], k2[1] - k1[1]) == (one[0] * 2, one[1] * 2)
  got, want, plain = (t[:, -1].float() for t in (got, want, plain))
  torch.testing.assert_close(got, want, **_tol(dtype, want))
  torch.testing.assert_close(got, plain, **_tol(dtype, plain, plain=True))


@pytest.mark.parametrize("arch", ARCHS)
def test_the_engine_on_a_mesh_generates_the_one_device_tokens(cuda, arch):
  cfg, model, toks, mesh = _setup(arch, "f32", cuda)
  one = serve.Engine(cfg, model, max_len=48, device=cuda)
  eng = serve.Engine(cfg, model, max_len=48, device=cuda, mesh=mesh)
  np.testing.assert_array_equal(eng.generate(toks, 8),
                                one.generate(toks, 8))
