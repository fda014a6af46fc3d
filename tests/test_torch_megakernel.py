"""The port's fused closure fixpoint (K2's plain version on the CPU).

All 22 cases of the shared closure parity corpus
(tests/fixtures/closure_corpus.py) go through the port's
``fixpoint_backend="megakernel"`` arm and are held against:

  (a) the reference's ``megakernel_fixpoint`` in interpret mode, under the
      parity policy: outputs and iteration counts bit-exact on the min/max
      rings and orand; mma outputs within rtol 1e-5 / atol 1e-4 (the two
      packages sum in other orders), its iteration counts exact;
  (b) the port's own per-iteration ('dispatch', 'pallas' arm) path, bit for
      bit on every ring, mma included — the port's closure paths share one
      contraction routine;
  (c) chunk lengths 3 and 4 on the "cap" case, whose cap neither divides.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fixtures import closure_corpus  # noqa: E402
from repro.kernels import closure_megakernel as jmk  # noqa: E402
from repro_torch.core import closure as tcl  # noqa: E402
from repro_torch.kernels import closure_megakernel as tmk  # noqa: E402

EXACT = ("minplus", "maxplus", "minmul", "maxmul", "minmax", "maxmin",
         "orand")
SOLVERS = {"leyzorek": tcl.batched_leyzorek_closure,
           "bellman_ford": tcl.batched_bellman_ford_closure}
CAP = next(c for c in closure_corpus.CORPUS if c.name.startswith("cap-"))


def assert_parity(got, want, op):
  if op in EXACT:
    np.testing.assert_array_equal(got, want)
  else:
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _torch_stack(case):
  stack, valid = closure_corpus.stacked(case)
  return torch.from_numpy(np.array(stack)), torch.from_numpy(np.array(valid))


def _fused(case, g=3):
  stack, valid = _torch_stack(case)
  return SOLVERS[case.algorithm](stack, op=case.op,
                                 fixpoint_backend="megakernel",
                                 megakernel_g=g, valid_n=valid,
                                 max_iters=case.max_iters)


@pytest.mark.parametrize("case", closure_corpus.CORPUS,
                         ids=closure_corpus.CASE_IDS)
def test_corpus_fused_matches_reference_megakernel(case):
  stack, valid = closure_corpus.stacked(case)
  want, want_it = jmk.megakernel_fixpoint(
      stack, op=case.op, algorithm=case.algorithm, max_iters=case.max_iters,
      valid_n=valid, g=3, interpret=True)
  got, it = _fused(case)
  assert it.dtype == torch.int32
  np.testing.assert_array_equal(it.numpy(), np.asarray(want_it))
  assert got.dtype == torch.from_numpy(np.array(want)).dtype
  assert_parity(got.numpy(), np.asarray(want), case.op)


@pytest.mark.parametrize("case", closure_corpus.CORPUS,
                         ids=closure_corpus.CASE_IDS)
def test_corpus_fused_is_the_dispatch_path_bit_for_bit(case):
  stack, valid = _torch_stack(case)
  want, want_it = SOLVERS[case.algorithm](stack, op=case.op,
                                          backend="pallas", valid_n=valid,
                                          max_iters=case.max_iters)
  got, it = _fused(case)
  np.testing.assert_array_equal(it.numpy(), want_it.numpy())
  np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("g", [3, 4])
def test_cap_case_with_chunks_that_do_not_divide_it(g):
  """max_iters = 7 on a line whose natural trip count is longer: every
  chunk length stops exactly at the cap."""
  want, want_it = closure_corpus.reference(CAP)
  got, it = _fused(CAP, g=g)
  assert int(it[0]) == CAP.max_iters == int(want_it[0])
  np.testing.assert_array_equal(got.numpy(), want)


def test_backend_alias_routes_to_the_fused_arm(monkeypatch):
  adj = torch.from_numpy(closure_corpus.rand_adj("minplus", 8, 2, seed=3))
  calls = []
  real = tmk.fixpoint_chunk

  def counting(*args, **kw):
    calls.append(kw["g_steps"])
    return real(*args, **kw)

  monkeypatch.setattr(tmk, "fixpoint_chunk", counting)
  a, a_it = tcl.batched_leyzorek_closure(adj, op="minplus",
                                         backend="megakernel")
  b, b_it = tcl.batched_leyzorek_closure(adj, op="minplus",
                                         fixpoint_backend="megakernel",
                                         megakernel_g=1)
  assert calls[0] == 3 and set(calls[1:]) == {1}  # ⌈log2 8⌉ = 3 < g = 8
  np.testing.assert_array_equal(a.numpy(), b.numpy())
  np.testing.assert_array_equal(a_it.numpy(), b_it.numpy())


def test_one_host_read_per_chunk(monkeypatch):
  """The driver reads the active flags once per chunk: a 10-vertex line
  under Bellman-Ford runs 9 iterations, so g = 4 takes three chunks."""
  w = closure_corpus.line_graph(10, seed=0)
  adj = tcl.prepare_adjacency(torch.from_numpy(w), op="minplus")[None]
  launches = []
  real = tmk.fixpoint_chunk
  monkeypatch.setattr(tmk, "fixpoint_chunk",
                      lambda *a, **kw: launches.append(1) or real(*a, **kw))
  _, it = tcl.batched_bellman_ford_closure(adj, op="minplus",
                                           fixpoint_backend="megakernel",
                                           megakernel_g=4)
  assert int(it[0]) == 9 and len(launches) == 3


@pytest.mark.parametrize("op", closure_corpus.IDENTITY_RINGS)
def test_chunk_geometry_matches_reference(op):
  got = tmk.chunk_geometry(op, 12)
  want = jmk.chunk_geometry(op, 12, interpret=True)
  assert (got.missing, got.self_value) == (want.missing, want.self_value)
  assert got.np_ == 12  # the kernel masks ragged tiles: no slab padding
  want_dtype = torch.bool if want.was_bool else torch.float32
  assert got.acc_dtype == want_dtype


def test_chunk_geometry_keeps_bf16_on_the_min_max_rings():
  assert tmk.chunk_geometry("minplus", 8, torch.bfloat16).acc_dtype == (
      torch.bfloat16)
  assert tmk.chunk_geometry("mma", 8, "bfloat16").acc_dtype == torch.float32


def test_addnorm_is_refused():
  with pytest.raises(ValueError, match="⊗-identity"):
    tmk.chunk_geometry("addnorm", 8)
  with pytest.raises(ValueError, match="⊗-identity"):
    tcl.batched_leyzorek_closure(torch.zeros(1, 8, 8), op="addnorm",
                                 fixpoint_backend="megakernel")


@pytest.mark.parametrize("algorithm,n", [("leyzorek", 1), ("leyzorek", 9),
                                         ("bellman_ford", 7)])
def test_fixpoint_iters_matches_reference(algorithm, n):
  assert tmk.fixpoint_iters(algorithm, n) == jmk.fixpoint_iters(algorithm, n)


def test_pad_closure_adds_isolated_vertices():
  x = torch.from_numpy(closure_corpus.rand_adj("maxmin", 5, 2, seed=4))
  got = tmk._pad_closure(x, 8, 0.0, float("inf"))
  want = jmk._pad_closure(jnp.asarray(x.numpy()), 8, 0.0, float("inf"))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  assert tmk._pad_closure(x, 5, 0.0, 1.0) is x


def test_chunk_freezes_requests_by_act_and_glim():
  """Per-request gating: a frozen request (act 0) and a zero budget keep
  their iterate and counter; the live ones advance by their own budgets."""
  x = torch.from_numpy(np.stack([closure_corpus.line_graph(9, seed=s)
                                 for s in range(4)]))
  x = tcl.prepare_adjacency(x, op="minplus").contiguous()
  kv = torch.full((4,), 9, dtype=torch.int32)
  act = torch.tensor([1, 0, 1, 1], dtype=torch.int32)
  it = torch.tensor([0, 5, 2, 0], dtype=torch.int32)
  glim = torch.tensor([4, 4, 0, 2], dtype=torch.int32)
  out, it2, act2 = tmk.fixpoint_chunk(x, x, kv, act, it, glim,
                                      op="minplus", g_steps=4)
  assert it2.tolist() == [4, 5, 2, 2] and act2.tolist() == [1, 0, 1, 1]
  assert torch.equal(out[1], x[1]) and torch.equal(out[2], x[2])
  assert it.tolist() == [0, 5, 2, 0]  # inputs untouched
  one, _, _ = tmk.fixpoint_chunk(x[3:], x[3:], kv[3:], act[3:], it[3:],
                                 glim[3:], op="minplus", g_steps=2)
  assert torch.equal(out[3], one[0])


@pytest.mark.parametrize("kw,exc", [
    (dict(c=torch.zeros(2, 3, 4)), ValueError),
    (dict(c=torch.zeros(2, 4, 4, dtype=torch.float64)), TypeError),
    (dict(kv=torch.zeros(2, dtype=torch.int64)), TypeError),
    (dict(act=torch.zeros(3, dtype=torch.int32)), TypeError),
    (dict(adj=torch.zeros(2, 5, 5)), ValueError),
    (dict(op="addnorm"), ValueError),
])
def test_chunk_refuses_bad_operands(kw, exc):
  args = dict(c=torch.zeros(2, 4, 4), adj=None,
              kv=torch.zeros(2, dtype=torch.int32),
              act=torch.zeros(2, dtype=torch.int32),
              it=torch.zeros(2, dtype=torch.int32),
              glim=torch.zeros(2, dtype=torch.int32), op="minplus")
  args.update(kw)
  op = args.pop("op")
  with pytest.raises(exc):
    tmk.fixpoint_chunk(*args.values(), op=op, g_steps=1)


def test_bad_driver_arguments_raise():
  adj = torch.zeros(1, 4, 4)
  with pytest.raises(ValueError, match="g must"):
    tmk.megakernel_fixpoint(adj, op="minplus", g=0)
  with pytest.raises(ValueError, match="algorithm"):
    tmk.megakernel_fixpoint(adj, op="minplus", algorithm="dijkstra")
  with pytest.raises(ValueError, match="R, n, n"):
    tmk.megakernel_fixpoint(torch.zeros(4, 4), op="minplus")
