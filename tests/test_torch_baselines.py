"""The port's classic-algorithm baselines, and its eight solvers held to them.

``repro_torch.apps.baselines`` is the port's own numpy copy of
``repro.apps.baselines``: on the same seeded inputs every function gives
the reference's output exactly.  Then the port's eight SIMD²-ized solvers
on the CPU are validated against a *different* algorithm, as
tests/test_apps.py does for the reference: at its sizes, under its
tolerances, on every arm.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.apps import baselines as jbl  # noqa: E402
from repro_torch.apps import baselines as tbl  # noqa: E402
from repro_torch.apps import graphs  # noqa: E402
from repro_torch.apps import solvers as sv  # noqa: E402

N = 40
BACKENDS = ("pallas", "xla", "vector")

# baseline name -> its input from the seeded generators
_INPUTS = {
    "apsp_np": lambda: (np.where(np.eye(N, dtype=bool), 0,
                                 graphs.weighted_digraph(N, 0.25, seed=11)),),
    "aplp_np": lambda: (graphs.dag(N, 0.25, seed=12),),
    "maxcp_np": lambda: (graphs.capacity_graph(N, 0.25, seed=13),),
    "maxrp_np": lambda: (graphs.reliability_graph(N, 0.25, seed=14,
                                                  maximize=True),),
    "minrp_np": lambda: (graphs.reliability_graph(N, 0.25, seed=15,
                                                  maximize=False),),
    "gtc_np": lambda: (graphs.boolean_digraph(64, 0.05, seed=17),),
    "kruskal_mst_np": lambda: (graphs.undirected_weighted(32, 0.3, seed=16),),
    "minimax_paths_np": lambda: (graphs.undirected_weighted(32, 0.3,
                                                            seed=16),),
    "knn_np": lambda: graphs.knn_points(200, 40, 24, seed=18) + (8,),
}


def test_every_baseline_is_covered():
  public = {n for n in dir(jbl) if n.endswith("_np")}
  assert public == set(_INPUTS) | {"floyd_warshall_np"}


@pytest.mark.parametrize("name", sorted(_INPUTS))
def test_baseline_matches_the_reference_exactly(name):
  args = _INPUTS[name]()
  want = getattr(jbl, name)(*args)
  got = getattr(tbl, name)(*args)
  if isinstance(want, tuple):
    for g, w in zip(got, want):
      if isinstance(w, set):
        assert g == w
      else:
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
  else:
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ring", [(np.minimum, np.add), (np.maximum,
                                                         np.minimum)])
def test_floyd_warshall_np_matches_the_reference(ring):
  w = graphs.weighted_digraph(24, 0.3, seed=3)
  np.testing.assert_array_equal(tbl.floyd_warshall_np(w, *ring),
                                jbl.floyd_warshall_np(w, *ring))


def _check_paths(got, ref, atol=1e-4):
  g = np.asarray(got, np.float64)
  fin = np.isfinite(ref)
  np.testing.assert_allclose(g[fin], ref[fin], atol=atol, rtol=1e-5)
  assert np.array_equal(~np.isfinite(g), ~fin)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("algorithm", ["leyzorek", "bellman_ford",
                                       "floyd_warshall"])
def test_apsp(algorithm, backend):
  w = graphs.weighted_digraph(N, 0.25, seed=11)
  ref = tbl.apsp_np(np.where(np.eye(N, dtype=bool), 0, w))
  got, _ = sv.apsp(w, algorithm=algorithm, backend=backend, device="cpu")
  _check_paths(got, ref)


@pytest.mark.parametrize("backend", BACKENDS)
def test_aplp(backend):
  w = graphs.dag(N, 0.25, seed=12)
  ref = tbl.aplp_np(w)
  got, _ = sv.aplp(w, backend=backend, device="cpu")
  g = np.asarray(got, np.float64)
  fin = np.isfinite(ref)
  np.testing.assert_allclose(g[fin], ref[fin], atol=1e-4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_maxcp(backend):
  c = graphs.capacity_graph(N, 0.25, seed=13)
  ref = tbl.maxcp_np(c)
  got, _ = sv.maxcp(c, backend=backend, device="cpu")
  fin = np.isfinite(ref)
  np.testing.assert_allclose(got.numpy()[fin], ref[fin], atol=1e-4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_maxrp(backend):
  p = graphs.reliability_graph(N, 0.25, seed=14, maximize=True)
  got, _ = sv.maxrp(p, backend=backend, device="cpu")
  np.testing.assert_allclose(got.numpy(), tbl.maxrp_np(p), atol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_minrp(backend):
  p = graphs.reliability_graph(N, 0.25, seed=15, maximize=False)
  got, _ = sv.minrp(p, backend=backend, device="cpu")
  _check_paths(got, tbl.minrp_np(p), atol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_mst_minimax_and_edges(backend):
  w = graphs.undirected_weighted(32, 0.3, seed=16)
  mm_ref = tbl.minimax_paths_np(w)
  mm, _ = sv.mst_minimax(w, backend=backend, device="cpu")
  off = ~np.eye(32, dtype=bool)
  fin = np.isfinite(mm_ref) & off
  np.testing.assert_allclose(mm.numpy()[fin], mm_ref[fin], atol=1e-4)
  edges_ref, _ = tbl.kruskal_mst_np(w)
  in_mst, _ = sv.mst_edges(w, backend=backend, device="cpu")
  got = {(min(i, j), max(i, j))
         for i, j in zip(*np.nonzero(in_mst.numpy()))}
  assert got == edges_ref


@pytest.mark.parametrize("backend", BACKENDS)
def test_gtc(backend):
  adj = graphs.boolean_digraph(64, 0.05, seed=17)
  got, _ = sv.gtc(adj, backend=backend, device="cpu")
  assert np.array_equal(got.numpy(), tbl.gtc_np(adj))


@pytest.mark.parametrize("backend", BACKENDS)
def test_knn(backend):
  ref_pts, qry = graphs.knn_points(200, 40, 24, seed=18)
  d_ref, i_ref = tbl.knn_np(ref_pts, qry, 8)
  d_got, i_got = sv.knn(ref_pts, qry, k=8, backend=backend, device="cpu")
  assert np.array_equal(i_got.numpy(), i_ref)
  np.testing.assert_allclose(d_got.numpy(), d_ref, rtol=1e-3, atol=1e-3)


def test_convergence_check_early_exit():
  """Leyzorek with its convergence check stops well before lg|V| on a
  short-diameter graph (paper §6.4)."""
  w = graphs.weighted_digraph(64, 0.9, seed=20)  # dense → diameter ~1-2
  _, it_conv = sv.apsp(w, convergence=True, device="cpu")
  _, it_max = sv.apsp(w, convergence=False, device="cpu")
  assert int(it_conv) <= int(it_max)
  assert int(it_conv) <= 4
