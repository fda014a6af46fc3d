"""The APSP dry run's anchor on a card: one min-plus squaring
C ← C ⊕ (C ⊗ C) by SUMMA on a virtual 2 × 2 mesh of one card, each shard
a K1 launch.

Every test here needs an NVIDIA GPU and ``nvcc``; each is marked ``cuda``
and skips with a reason where there is none.  The file imports nothing of
JAX:

    python -m pytest -q --noconftest -m cuda tests/test_torch_dryrun_cuda.py

min-plus is a bit-exact ring: the squaring's rows 0–255 equal local K1's on
those rows, and K1's equal its plain version's, bit for bit.
"""
import importlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.apps import graphs  # noqa: E402
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.launch import dryrun_apsp  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, make_host_mesh  # noqa: E402
sm = importlib.import_module("repro_torch.kernels.semiring_mmo")

pytestmark = pytest.mark.cuda

V, ROWS = 4096, 256


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
  return torch.device("cuda")


def test_summa_squaring_rows_equal_local_k1(cuda):
  c = torch.from_numpy(graphs.weighted_digraph(V, 0.05, seed=3)).to(cuda)
  mesh = make_host_mesh(4, model=2, devices=["cuda:0"] * 4)
  before = sm.semiring_mmo.launches
  got = dist.summa_mmo(c, c, c, op="minplus", mesh=mesh, backend="pallas")
  torch.cuda.synchronize()
  assert sm.semiring_mmo.launches - before == mesh.size
  rows = c[None, :ROWS].contiguous()
  local = sm.semiring_mmo(rows, c[None], rows, op="minplus")[0]
  plain = sm.semiring_mmo_plain(rows, c[None], rows, op="minplus")[0]
  assert torch.equal(got[:ROWS], local)
  assert torch.equal(local, plain)
  # a squaring only shortens: no entry above C's, 0 on the diagonal
  assert bool((got <= c).all()) and not bool(got.diagonal().any())


def test_the_dry_run_bound_is_below_the_measurement(cuda):
  """K1's CUDA-core bound for the four shards, run one after another on
  one card, lies below the measured squaring."""
  c = torch.from_numpy(graphs.weighted_digraph(V, 0.05, seed=4)).to(cuda)
  mesh = make_host_mesh(4, model=2, devices=["cuda:0"] * 4)
  dist.summa_mmo(c, c, c, op="minplus", mesh=mesh, backend="pallas")
  e0 = torch.cuda.Event(enable_timing=True)
  e1 = torch.cuda.Event(enable_timing=True)
  e0.record()
  dist.summa_mmo(c, c, c, op="minplus", mesh=mesh, backend="pallas")
  e1.record()
  torch.cuda.synchronize()
  row = dryrun_apsp.run(V, AbstractMesh((2, 2), ("data", "model")))
  assert e0.elapsed_time(e1) / 1e3 > mesh.size * row["t_step_pallas_vpu"]
