"""K1 at the edges the mesh schedules give it, and the schedules on a card.

Every test here needs an NVIDIA GPU and ``nvcc``; each is marked ``cuda``
and skips with a reason where there is none.  The file imports nothing of
JAX:

    python -m pytest -q --noconftest -m cuda tests/test_torch_distributed_cuda.py

K-sharded schedules hand K1 requests whose K-chunk lies wholly past their
live lanes, so ``k_valid = 0``: the kernel must return C ⊕ (⊕-identity),
on the CUDA-core route (every ring but mma, both tile sizes) and on the
tensor-core route (mma: a split pass and no slab to sum).  The schedules
run on a virtual mesh of four shards of one card (``make_host_mesh(
devices=["cuda:0"] * 4)``): bit for bit equal to local K1 on the min/max
rings and orand, within rtol 1e-5 / atol 1e-4 on mma and addnorm.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import closure as cl  # noqa: E402
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.core import semiring as sr_mod  # noqa: E402
from repro_torch.core.mmo import mmo_batched  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
sm = importlib.import_module("repro_torch.kernels.semiring_mmo")

EXACT = ("minplus", "maxplus", "minmul", "maxmul", "minmax", "maxmin",
         "orand")
# (R, M, K, N): few tiles (the 64 × 64 CUDA-core instance) and many (128²)
SHAPES = [(3, 64, 96, 80), (8, 256, 128, 256)]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
  return torch.device("cuda")


def _dtypes(op):
  if sr_mod.get(op).boolean:
    return [torch.bool]
  return [torch.float32, torch.bfloat16, torch.float16, torch.int32]


def _operands(op, dtype, shape, device, seed=0):
  r, m, k, n = shape
  g = torch.Generator().manual_seed(seed)
  a, b, c = (torch.randn(r, m, k, generator=g), torch.randn(r, k, n,
                                                            generator=g),
             torch.randn(r, m, n, generator=g))
  if dtype == torch.bool:
    a, b, c = a > 0.5, b > 0.5, c > 1.0
  elif dtype == torch.int32:
    a, b, c = ((x * 100).round().to(torch.int32) for x in (a, b, c))
  else:
    a, b = a.to(dtype), b.to(dtype)
    c = c.to(sm.out_dtype(op, dtype))
  if dtype == torch.int32:
    c = c.to(sm.out_dtype(op, dtype))
  return a.to(device), b.to(device), c.to(device)


def _assert_parity(got, want, op):
  got = got.to(torch.float64).cpu().numpy()
  want = want.to(torch.float64).cpu().numpy()
  if op in EXACT:
    np.testing.assert_array_equal(got, want)
  else:
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("op", sr_mod.ALL_OPS)
def test_k1_with_k_valid_zero_returns_c(cuda, op, shape):
  """Requests with no live lane get C ⊕ (⊕-identity) = C exactly, beside
  requests with live lanes, on every dtype instance of the ring."""
  r, _, k, _ = shape
  kv = torch.tensor([0 if i % 2 == 0 else k - 7 * i for i in range(r)],
                    dtype=torch.int32, device=cuda)
  for dtype in _dtypes(op):
    a, b, c = _operands(op, dtype, shape, cuda)
    before = sm.semiring_mmo.launches
    got = sm.semiring_mmo(a, b, c, op=op, k_valid=kv)
    torch.cuda.synchronize()
    assert sm.semiring_mmo.launches == before + 1
    dead = kv == 0
    assert torch.equal(got[dead], c[dead].to(got.dtype)), (op, dtype)
    want = sm.semiring_mmo_plain(a, b, c, op=op, k_valid=kv)
    _assert_parity(got, want, op)
    # without C the dead requests hold the ⊕-identity itself
    got0 = sm.semiring_mmo(a, b, op=op, k_valid=kv)
    ident = sr_mod.get(op).identity_like(got0[dead].shape, got0.dtype,
                                         device=cuda)
    assert torch.equal(got0[dead], ident), (op, dtype)


@pytest.mark.parametrize("op", sr_mod.ALL_OPS)
def test_k1_all_requests_dead(cuda, op):
  a, b, c = _operands(op, torch.float32 if op != "orand" else torch.bool,
                      (4, 128, 64, 128), cuda, seed=3)
  kv = torch.zeros(4, dtype=torch.int32, device=cuda)
  got = sm.semiring_mmo(a, b, c, op=op, k_valid=kv)
  assert torch.equal(got, c.to(got.dtype))


def _virtual_mesh():
  return make_host_mesh(4, model=2, devices=["cuda:0"] * 4)


def test_host_mesh_takes_the_cards_present(cuda):
  n = torch.cuda.device_count()
  mesh = make_host_mesh(n, model=1)
  assert mesh.size == n and len(set(mesh.flat)) == n
  with pytest.raises(ValueError, match="exist"):
    make_host_mesh(n + 1, model=1)


@pytest.mark.parametrize("schedule", dist.SCHEDULES)
@pytest.mark.parametrize("op", sr_mod.ALL_OPS)
def test_schedule_on_virtual_mesh_matches_local_k1(cuda, op, schedule):
  """Each schedule's working shards run K1 (every shard for dp and SUMMA,
  the one line along the K axis for kspan, times its steps for ring) and
  agree with one local K1 launch; ragged k_valid leaves the second K-chunk
  empty for half the requests."""
  shape = (4, 128, 256, 192)
  dtype = torch.bool if op == "orand" else torch.float32
  a, b, c = _operands(op, dtype, shape, cuda, seed=5)
  kv = torch.tensor([256, 100, 37, 128], dtype=torch.int32, device=cuda)
  pa, pb = ((False, False) if op == "orand"
            else sr_mod.contraction_pads(op, dtype))
  live = torch.arange(256, device=cuda)[None, :] < kv[:, None]
  a = torch.where(live[:, None, :], a, pa)
  b = torch.where(live[:, :, None], b, pb)
  mesh = _virtual_mesh()
  want = mmo_batched(a, b, c, op=op, backend="pallas", k_valid=kv)
  before = sm.semiring_mmo.launches
  got = dist.mmo_sharded_batched(a, b, c, op=op, schedule=schedule,
                                 mesh=mesh, backend="pallas", k_valid=kv)
  torch.cuda.synchronize()
  cols = mesh.shape["model"]
  want_k1 = {"dp": mesh.size, "summa": mesh.size, "kspan": cols,
             "ring": cols * cols}[schedule]
  assert sm.semiring_mmo.launches - before == want_k1
  _assert_parity(got, want, op)


@pytest.mark.parametrize("schedule", dist.SCHEDULES)
def test_sharded_closure_on_virtual_mesh_equals_local(cuda, schedule):
  rng = np.random.default_rng(7)
  sizes = [40, 64, 51, 33]
  stack = []
  for n in sizes:
    w = rng.uniform(1, 10, (n, n)).astype(np.float32)
    w = np.where(rng.random((n, n)) < 0.9, np.inf, w).astype(np.float32)
    adj = cl.prepare_adjacency(torch.from_numpy(w), op="minplus").numpy()
    stack.append(cl.pad_adjacency(adj, 64, op="minplus"))
  x = torch.from_numpy(np.stack(stack)).to(cuda)
  valid = torch.tensor(sizes, dtype=torch.int32, device=cuda)
  want, want_it = cl.batched_leyzorek_closure(x, op="minplus",
                                              backend="pallas",
                                              valid_n=valid)
  got, it = dist.sharded_closure_batched(x, op="minplus",
                                         mesh=_virtual_mesh(),
                                         schedule=schedule, backend="pallas",
                                         valid_n=valid)
  assert torch.equal(got, want) and torch.equal(it, want_it)
