"""K2's CUDA kernel against its plain PyTorch version and against the K1
dispatch path, on the card.

Every test here needs an NVIDIA GPU and ``nvcc``; each is marked ``cuda``
and skips with a reason where there is none.  The file imports nothing of
JAX, so it runs on a machine that has only the port's dependencies:

    python -m pytest -q --noconftest -m cuda tests/test_torch_megakernel_cuda.py

Tolerances: K2 vs its plain version is bit-exact on the min/max rings and
orand, rtol 1e-5 / atol 1e-4 on mma (the plain version sums with torch's
reduction, the kernel with 3×TF32 on the tensor cores); K2 vs the K1
dispatch path is bit-identical on every ring, mma included, outputs and
iteration counts (both kernels contract with semiring_ring.cuh).
"""
import importlib
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import closure as cl  # noqa: E402
from repro_torch.kernels import closure_megakernel as mk  # noqa: E402
sm = importlib.import_module("repro_torch.kernels.semiring_mmo")

RINGS = ("mma", "minplus", "maxplus", "minmul", "maxmul", "minmax", "maxmin",
         "orand")
EXACT = RINGS[1:]
SOLVERS = {"leyzorek": cl.batched_leyzorek_closure,
           "bellman_ford": cl.batched_bellman_ford_closure}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
  return torch.device("cuda")


def rand_stack(op, n, r, seed=0):
  """(R, n, n) prepared adjacencies in ring ``op``'s conventions: missing
  edges at the ring's no-edge value, mma strictly upper-triangular so its
  closure stays finite."""
  rng = np.random.default_rng(seed)
  missing, _ = cl.closure_pad_values(op)
  if op == "orand":
    w = rng.random((r, n, n)) > 0.9
  else:
    w = rng.uniform(0.2, 1.5, (r, n, n)).astype(np.float32)
    if op == "mma":
      w = np.triu(0.1 * w, k=1).astype(np.float32)
    w = np.where(rng.random((r, n, n)) > 0.7, w,
                 np.float32(missing)).astype(w.dtype)
  return cl.prepare_adjacency(torch.from_numpy(w), op=op)


def assert_parity(got, want, op):
  got = got.float().cpu().numpy()
  want = want.float().cpu().numpy()
  if op in EXACT:
    np.testing.assert_array_equal(got, want)
  else:
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _chunk_operands(op, n, device, seed=0):
  """Four requests: ragged kv, budgets that differ, one frozen request."""
  c = rand_stack(op, n, 4, seed=seed).to(device).contiguous()
  kv = torch.tensor([n, max(1, n - 3), max(1, n // 2), n],
                    dtype=torch.int32, device=device)
  act = torch.tensor([1, 1, 1, 0], dtype=torch.int32, device=device)
  it = torch.tensor([0, 2, 5, 7], dtype=torch.int32, device=device)
  glim = torch.tensor([4, 2, 1, 4], dtype=torch.int32, device=device)
  return c, kv, act, it, glim


@pytest.mark.parametrize("n", [12, 64, 200])
@pytest.mark.parametrize("algorithm", ["leyzorek", "bellman_ford"])
@pytest.mark.parametrize("op", RINGS)
def test_chunk_matches_plain(cuda, op, algorithm, n):
  c, kv, act, it, glim = _chunk_operands(op, n, cuda, seed=n)
  adj = c if algorithm == "bellman_ford" else None
  before = mk.fixpoint_chunk.launches
  got = mk.fixpoint_chunk(c, adj, kv, act, it, glim, op=op, g_steps=4)
  torch.cuda.synchronize()
  assert mk.fixpoint_chunk.launches == before + 1
  want = mk.fixpoint_chunk_plain(c, adj, kv, act, it, glim, op=op,
                                 g_steps=4)
  assert got[0].dtype == want[0].dtype == c.dtype
  assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
  assert_parity(got[0], want[0], op)
  assert torch.equal(got[0][3], c[3])  # the frozen request did not move


def test_chunk_nan_edge_converges_like_plain(cuda):
  c = rand_stack("minplus", 64, 2, seed=3)
  c[0, 0, 1] = float("nan")
  c = c.to(cuda).contiguous()
  vec = torch.tensor([64, 64], dtype=torch.int32, device=cuda)
  ones = torch.ones(2, dtype=torch.int32, device=cuda)
  zeros = torch.zeros(2, dtype=torch.int32, device=cuda)
  glim = torch.full((2,), 64, dtype=torch.int32, device=cuda)
  got = mk.fixpoint_chunk(c, c, vec, ones, zeros, glim, op="minplus",
                          g_steps=64)
  want = mk.fixpoint_chunk_plain(c, c, vec, ones, zeros, glim, op="minplus",
                                 g_steps=64)
  assert got[2].tolist() == [0, 0] and int(got[1][0]) < 64
  assert torch.equal(got[1], want[1])
  assert_parity(got[0], want[0], "minplus")
  assert bool(torch.isnan(got[0][0]).any())


@pytest.mark.parametrize("g_steps", [0, 1])
def test_chunk_with_nothing_to_do_returns_its_input(cuda, g_steps):
  c, kv, act, it, glim = _chunk_operands("maxmin", 40, cuda)
  out, it2, act2 = mk.fixpoint_chunk(c, None, kv, act * 0, it, glim,
                                     op="maxmin", g_steps=g_steps)
  assert torch.equal(out, c) and torch.equal(it2, it)
  assert act2.sum() == 0


def test_chunk_bf16_matches_plain(cuda):
  c, kv, act, it, glim = _chunk_operands("minplus", 64, cuda, seed=5)
  c = c.to(torch.bfloat16)
  got = mk.fixpoint_chunk(c, None, kv, act, it, glim, op="minplus",
                          g_steps=4)
  want = mk.fixpoint_chunk_plain(c, None, kv, act, it, glim, op="minplus",
                                 g_steps=4)
  assert got[0].dtype == torch.bfloat16
  assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("algorithm", ["leyzorek", "bellman_ford"])
@pytest.mark.parametrize("op", RINGS)
def test_fused_arm_is_the_k1_dispatch_path_bit_for_bit(cuda, op, algorithm):
  adj = rand_stack(op, 96, 3, seed=7).to(cuda)
  valid = torch.tensor([96, 70, 33], dtype=torch.int32, device=cuda)
  for i, v in enumerate(valid.tolist()):  # isolated-vertex padding past v
    adj[i] = torch.from_numpy(cl.pad_adjacency(
        adj[i, :v, :v].cpu().numpy(), 96, op=op)).to(cuda)
  k1_before = sm.semiring_mmo.launches
  want, want_it = SOLVERS[algorithm](adj, op=op, backend="pallas",
                                     valid_n=valid)
  assert sm.semiring_mmo.launches > k1_before
  k1_before, k2_before = sm.semiring_mmo.launches, mk.fixpoint_chunk.launches
  got, it = SOLVERS[algorithm](adj, op=op, fixpoint_backend="megakernel",
                               megakernel_g=3, valid_n=valid)
  assert sm.semiring_mmo.launches == k1_before
  assert mk.fixpoint_chunk.launches > k2_before
  assert torch.equal(it, want_it)
  # bit-identical, NaN included (minmul's cyclic closures reach 0·inf)
  assert got.dtype == want.dtype
  assert bool(torch.all((got == want) | (got.isnan() & want.isnan())))


def test_wrapper_refuses_non_contiguous_and_addnorm(cuda):
  c, kv, act, it, glim = _chunk_operands("minplus", 16, cuda)
  with pytest.raises(ValueError, match="contiguous"):
    mk.fixpoint_chunk(c.transpose(1, 2), None, kv, act, it, glim,
                      op="minplus", g_steps=1)
  with pytest.raises(ValueError, match="⊗-identity"):
    mk.fixpoint_chunk(c, None, kv, act, it, glim, op="addnorm", g_steps=1)


@pytest.mark.parametrize("op", RINGS)
def test_fused_arm_is_the_dispatch_path_on_both_tile_instances(cuda, op):
  """Four requests of n = 1536: a step with all four live takes 128×128
  tiles (two waves of the grid or more), with fewer live it may take 64×64;
  both arms must still agree bit for bit.  mma's weights are scaled by 1/n
  so that its closure converges in f32."""
  r, n = 4, 1536
  adj = rand_stack(op, n, r, seed=11)
  if op == "mma":
    adj = adj / n
  adj = adj.to(cuda)
  want_tile = (128, 128)
  assert mk.tile_shape(op, adj.dtype, r, n) == want_tile
  if op != "mma":
    assert mk.tile_shape(op, adj.dtype, 1, 200) == (64, 64)
  solve = SOLVERS["leyzorek"]
  want, want_it = solve(adj, op=op, backend="pallas")
  got, it = solve(adj, op=op, fixpoint_backend="megakernel", megakernel_g=3)
  torch.cuda.synchronize()
  assert torch.equal(it, want_it)
  assert torch.equal(torch.isnan(got), torch.isnan(want))
  assert torch.equal(torch.nan_to_num(got.float()),
                     torch.nan_to_num(want.float()))
