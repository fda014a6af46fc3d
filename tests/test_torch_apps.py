"""The port's eight application solvers against repro.apps.solvers.

Same seeded inputs (the port's own copy of apps/graphs.py must generate the
reference's bytes), n in 32–64.  Closures are exact with equal iteration
counts; KNN uses integer coordinates so distances are exact in every arm
and ties are plentiful: indices must follow lax.top_k's order (ties to the
lower index).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.apps import graphs as jgraphs  # noqa: E402
from repro.apps import solvers as js  # noqa: E402
from repro_torch.apps import graphs as tgraphs  # noqa: E402
from repro_torch.apps import solvers as ts  # noqa: E402

CLOSURE_APPS = {
    # app: (input generator, kwargs)
    "apsp": ("weighted_digraph", dict(density=0.1)),
    "aplp": ("dag", dict(density=0.2)),
    "mcp": ("capacity_graph", dict(density=0.1)),
    "maxrp": ("reliability_graph", dict(density=0.1)),
    "minrp": ("reliability_graph", dict(density=0.2, maximize=False)),
    "mst": ("undirected_weighted", dict(density=0.1)),
    "gtc": ("boolean_digraph", dict(density=0.05)),
}


@pytest.mark.parametrize("name", sorted(
    n for n in dir(jgraphs) if not n.startswith("_")
    and callable(getattr(jgraphs, n)) and n != "annotations"))
def test_graph_generators_are_byte_identical(name):
  jf, tf = getattr(jgraphs, name), getattr(tgraphs, name)
  if name == "knn_points":
    for x, y in zip(jf(40, 9, 5, seed=3), tf(40, 9, 5, seed=3)):
      np.testing.assert_array_equal(x, y)
  else:
    np.testing.assert_array_equal(jf(33, seed=3), tf(33, seed=3))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("app", sorted(CLOSURE_APPS))
@pytest.mark.parametrize("n", [32, 57])
def test_closure_app_matches_reference(app, n, backend):
  gen, kw = CLOSURE_APPS[app]
  x = getattr(tgraphs, gen)(n, seed=n, **kw)
  want, want_it = js.ALL_APPS[app](x, backend="xla")
  got, it = ts.ALL_APPS[app](x, backend=backend, device="cpu")
  assert int(it) == int(want_it)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("algorithm", ["bellman_ford", "floyd_warshall"])
def test_apsp_algorithms_match_reference(algorithm):
  w = tgraphs.weighted_digraph(40, 0.1, seed=4)
  want, want_it = js.apsp(w, backend="xla", algorithm=algorithm)
  got, it = ts.apsp(w, algorithm=algorithm, device="cpu")
  assert int(it) == int(want_it)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mst_edges_match_reference():
  w = tgraphs.undirected_weighted(48, 0.1, seed=8)
  want, _ = js.mst_edges(w, backend="xla")
  got, _ = ts.mst_edges(w, device="cpu")
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  assert int(got.sum()) == 2 * (48 - 1)  # a spanning tree, both directions


@pytest.mark.parametrize("backend", ["pallas", "xla", "vector"])
@pytest.mark.parametrize("k", [1, 5, 16])
def test_knn_with_ties_matches_reference(backend, k):
  rng = np.random.default_rng(k)
  ref = rng.integers(0, 3, (48, 3)).astype(np.float32)  # many exact ties
  qry = rng.integers(0, 3, (37, 3)).astype(np.float32)
  want_d, want_i = js.knn(ref, qry, k=k, backend="xla")
  got_d, got_i = ts.knn(ref, qry, k=k, backend=backend, device="cpu")
  np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
  np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_smallest_k_breaks_ties_to_the_lower_index():
  d2 = torch.tensor([[3.0, 1.0, 1.0, 0.0, 1.0, 0.0]])
  vals, idx = ts.smallest_k(d2, 4)
  assert idx.tolist() == [[3, 5, 1, 2]]
  assert vals.tolist() == [[0.0, 0.0, 1.0, 1.0]]


def test_solvers_default_to_the_card(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="cuda"):
    ts.apsp(tgraphs.weighted_digraph(8, seed=0))
