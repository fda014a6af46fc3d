"""The port's closure solvers against the reference's.

The batched fixpoint runs all 22 cases of the shared closure parity corpus
(tests/fixtures/closure_corpus.py) on each of the port's arms; outputs and
per-request iteration counts must equal the reference's batched fixpoint
exactly on the min/max rings and orand, and within rtol 1e-5 / atol 1e-4
on mma (whose sums run in another order; its iteration counts stay exact).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fixtures import closure_corpus  # noqa: E402
from repro.core import closure as jcl  # noqa: E402
from repro_torch.core import closure as tcl  # noqa: E402

EXACT = ("minplus", "maxplus", "minmul", "maxmul", "minmax", "maxmin",
         "orand")
SOLVERS = {"leyzorek": tcl.batched_leyzorek_closure,
           "bellman_ford": tcl.batched_bellman_ford_closure}


def assert_parity(got, want, op):
  if op in EXACT:
    np.testing.assert_array_equal(got, want)
  else:
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("backend", ["xla", "vector", "pallas"])
@pytest.mark.parametrize("case", closure_corpus.CORPUS,
                         ids=closure_corpus.CASE_IDS)
def test_corpus_batched_fixpoint_matches_reference(case, backend):
  stack, valid = closure_corpus.stacked(case)
  want, want_iters = closure_corpus.reference(case)
  got, iters = SOLVERS[case.algorithm](
      torch.from_numpy(np.array(stack)), op=case.op, backend=backend,
      valid_n=torch.from_numpy(np.array(valid)), max_iters=case.max_iters)
  assert iters.dtype == torch.int32
  np.testing.assert_array_equal(iters.numpy(), want_iters)
  assert_parity(got.numpy(), want, case.op)


@pytest.mark.parametrize("algorithm", ["leyzorek", "bellman_ford"])
@pytest.mark.parametrize("check", [True, False])
@pytest.mark.parametrize("op", ["minplus", "maxmin", "orand", "maxmul"])
def test_single_closure_matches_reference(algorithm, check, op):
  adj = closure_corpus.rand_adj(op, 11, 1, seed=5)[0]
  jfn = getattr(jcl, f"{algorithm}_closure")
  tfn = getattr(tcl, f"{algorithm}_closure")
  want, want_it = jfn(jnp.asarray(adj), op=op, backend="xla",
                      check_convergence=check)
  got, it = tfn(torch.from_numpy(adj), op=op, backend="pallas",
                check_convergence=check)
  assert int(it) == int(want_it)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("op", ["minplus", "maxplus", "maxmin", "orand"])
def test_floyd_warshall_matches_reference(op):
  adj = closure_corpus.rand_adj(op, 10, 1, seed=6)[0]
  want = jcl.floyd_warshall(jnp.asarray(adj), op=op)
  got = tcl.floyd_warshall(torch.from_numpy(adj), op=op)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_changed_is_inf_and_nan_aware():
  old = torch.tensor([1.0, float("inf"), float("-inf"), float("nan")])
  assert not bool(tcl._changed(old.clone(), old))
  assert bool(tcl._changed(torch.tensor([1.0, float("inf"), float("inf"),
                                         float("nan")]), old))
  b = torch.tensor([True, False])
  assert not bool(tcl._changed(b.clone(), b))
  assert bool(tcl._changed(~b, b))
  stack = torch.stack([old, old])[:, None, :]
  new = stack.clone()
  new[1, 0, 0] = 2.0
  assert tcl._batched_changed(new, stack).tolist() == [False, True]


@pytest.mark.parametrize("op", [op for op in closure_corpus.IDENTITY_RINGS])
def test_pad_values_and_padding_match_reference(op):
  assert tcl.closure_pad_values(op) == jcl.closure_pad_values(op)
  adj = closure_corpus.rand_adj(op, 5, 1, seed=1)[0]
  np.testing.assert_array_equal(tcl.pad_adjacency(adj, 8, op=op),
                                jcl.pad_adjacency(adj, 8, op=op))
  w = np.random.default_rng(2).uniform(0.5, 2.0, (6, 6)).astype(np.float32)
  if op == "orand":
    w = w > 1.2
  np.testing.assert_array_equal(
      tcl.prepare_adjacency(torch.from_numpy(w), op=op).numpy(),
      np.asarray(jcl.prepare_adjacency(jnp.asarray(w), op=op)))


def test_addnorm_closure_refused():
  with pytest.raises(ValueError, match="⊗-identity"):
    tcl.closure_pad_values("addnorm")
  with pytest.raises(ValueError):
    tcl.pad_adjacency(np.zeros((3, 3), np.float32), 4, op="addnorm")


def test_pad_adjacency_refuses_shrinking():
  with pytest.raises(ValueError, match="cannot pad"):
    tcl.pad_adjacency(np.zeros((5, 5), np.float32), 4, op="minplus")


def test_megakernel_arm_raises_until_k2_is_ported():
  """K2 is ported (tests/test_torch_megakernel.py holds the fused arm); what
  still raises is an unknown fixpoint_backend and a stack that is not
  (R, n, n)."""
  adj = torch.zeros(1, 4, 4)
  for solver in SOLVERS.values():
    with pytest.raises(ValueError, match="fixpoint_backend"):
      solver(adj, op="minplus", fixpoint_backend="fused")
    with pytest.raises(ValueError, match="R, n, n"):
      solver(torch.zeros(4, 4), op="minplus")
