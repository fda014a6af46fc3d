"""Table-1 extras in the port: matrix inverse (mma) and k-means (addnorm).

The reference's two cases (tests/test_extras.py) on the port's solvers,
then parity with ``repro.apps.extras`` on the same inputs.  k-means starts
from the indices the reference drew (``jax.random.choice`` with its seed),
passed in as ``init_idx``; its assignments must then be equal, and the
centroids and inertia within addnorm's tolerance (sums in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.apps import extras as jx  # noqa: E402
from repro_torch.apps import extras as tx  # noqa: E402

BACKENDS = ("pallas", "xla", "vector")


def _spd(n, seed):
  rng = np.random.default_rng(seed)
  a = rng.standard_normal((n, n)).astype(np.float32)
  return a @ a.T + n * np.eye(n, dtype=np.float32)  # well-conditioned SPD


def _clusters(seed):
  rng = np.random.default_rng(seed)
  centers = np.array([[0, 0], [8, 8], [-8, 8]], np.float32)
  pts = np.concatenate([
      c + 0.3 * rng.standard_normal((50, 2)).astype(np.float32)
      for c in centers])
  return centers, pts


def _reference_init(n, k, seed=0):
  """The indices the reference's kmeans draws for its first centroids."""
  key = jax.random.PRNGKey(seed)
  return np.asarray(jax.random.choice(key, n, (k,), replace=False))


@pytest.mark.parametrize("backend", BACKENDS)
def test_newton_inverse(backend):
  a = _spd(24, 11)
  inv, resid = tx.newton_inverse(a, backend=backend, device="cpu")
  np.testing.assert_allclose(inv.numpy(), np.linalg.inv(a), rtol=1e-3,
                             atol=1e-4)
  assert float(resid) < 1e-3


@pytest.mark.parametrize("backend", BACKENDS)
def test_kmeans_recovers_clusters(backend):
  """The reference's case, from the reference's initial centroids (Lloyd's
  algorithm finds a local optimum that depends on them)."""
  centers, pts = _clusters(12)
  cents, assign, inertia = tx.kmeans(pts, k=3, iters=25, backend=backend,
                                     init_idx=_reference_init(len(pts), 3),
                                     device="cpu")
  # every found centroid is within 0.5 of a true center, each cluster pure
  d = np.linalg.norm(cents.numpy()[:, None] - centers[None],
                     axis=-1).min(axis=1)
  assert (d < 0.5).all(), cents
  assign = assign.numpy()
  for g in range(3):
    grp = assign[g * 50:(g + 1) * 50]
    assert (grp == grp[0]).all()
  assert float(inertia) < 0.3 ** 2 * 2 * 150 * 3  # loose noise bound


@pytest.mark.parametrize("iters", [1, 32])
def test_newton_inverse_matches_the_reference(iters):
  a = _spd(20, 3)
  want, want_r = jx.newton_inverse(jnp.asarray(a), iters=iters,
                                   backend="xla")
  got, got_r = tx.newton_inverse(a, iters=iters, device="cpu")
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                             atol=1e-6)
  np.testing.assert_allclose(float(got_r), float(want_r), rtol=1e-3,
                             atol=1e-6)


def test_newton_inverse_counts_two_mmos_per_step(monkeypatch):
  calls = []
  real = tx.mmo
  monkeypatch.setattr(tx, "mmo", lambda *a, **k: calls.append(k["op"])
                      or real(*a, **k))
  tx.newton_inverse(_spd(8, 1), iters=5, device="cpu")
  assert calls == ["mma"] * (2 * 5 + 1)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("iters", [0, 3, 25])
def test_kmeans_matches_the_reference_from_its_initial_indices(iters,
                                                               backend):
  _, pts = _clusters(12)
  init = _reference_init(len(pts), 3)
  want_c, want_a, want_i = jx.kmeans(jnp.asarray(pts), k=3, iters=iters,
                                     backend="xla")
  got_c, got_a, got_i = tx.kmeans(pts, k=3, iters=iters, init_idx=init,
                                  backend=backend, device="cpu")
  assert got_a.dtype == torch.int32
  np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
  np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5,
                             atol=1e-4)
  # a sum of N distances, each within addnorm's atol
  np.testing.assert_allclose(float(got_i), float(want_i), rtol=1e-5,
                             atol=len(pts) * 1e-4)


def test_kmeans_draws_its_initial_indices_from_a_generator():
  _, pts = _clusters(12)
  g = torch.Generator().manual_seed(5)
  want = torch.randperm(len(pts), generator=g)[:3]
  got = tx.kmeans(pts, k=3, iters=0, generator=torch.Generator().manual_seed(
      5), device="cpu")
  np.testing.assert_array_equal(got[0].numpy(), pts[want.numpy()])
  by_seed = tx.kmeans(pts, k=3, iters=0, seed=5, device="cpu")
  assert torch.equal(by_seed[0], got[0])
  with pytest.raises(ValueError, match="k=3"):
    tx.kmeans(pts, k=3, init_idx=[0, 1], device="cpu")
