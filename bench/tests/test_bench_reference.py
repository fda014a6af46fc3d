"""The plain reference against brute force at 8-32 vertices."""
from __future__ import annotations

import itertools
import math

import numpy as np
import pytest
import torch

from bench.reference import closure as ref_closure
from bench.reference import knn as ref_knn


def _graph(n, density, seed):
  rng = np.random.default_rng(seed)
  w = rng.uniform(1.0, 10.0, (n, n)).astype(np.float32)
  w[rng.random((n, n)) >= density] = np.inf
  np.fill_diagonal(w, 0.0)
  return w


def _floyd(w):
  d = w.astype(np.float64).copy()
  n = d.shape[0]
  for k in range(n):
    d = np.minimum(d, d[:, k:k + 1] + d[k:k + 1, :])
  return d


@pytest.mark.parametrize("n,density", [(8, 0.3), (16, 0.15), (32, 0.08)])
def test_minplus_closure_equals_floyd_warshall(n, density):
  w = _graph(n, density, n)
  got, needed, run = ref_closure.closure(torch.from_numpy(w), "minplus")
  want = _floyd(w)
  np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-6)
  assert run <= ref_closure.squaring_cap(n)
  assert needed <= run <= needed + 1
  # one squaring fewer than needed is not yet the closure
  if needed:
    d = torch.from_numpy(w)
    for _ in range(needed - 1):
      d = ref_closure.square(d, "minplus")
    assert not torch.equal(d, got)


def test_a_closed_graph_needs_no_squaring():
  closed, _, _ = ref_closure.closure(torch.from_numpy(_graph(12, 0.5, 1)),
                                     "minplus")
  _, needed, run = ref_closure.closure(closed, "minplus")
  assert (needed, run) == (0, 1)


def test_orand_closure_is_reachability():
  rng = np.random.default_rng(4)
  a = rng.random((10, 10)) < 0.15
  np.fill_diagonal(a, True)
  got, _, _ = ref_closure.closure(torch.from_numpy(a), "orand")
  reach = a.copy()
  for k, i, j in itertools.product(range(10), repeat=3):
    reach[i, j] |= reach[i, k] and reach[k, j]
  np.testing.assert_array_equal(got.numpy(), reach)


def test_knn_reference_equals_brute_force():
  rng = np.random.default_rng(9)
  q = rng.standard_normal((12, 5)).astype(np.float32)
  r = rng.standard_normal((30, 5)).astype(np.float32)
  d = ref_knn.distances(torch.from_numpy(q), torch.from_numpy(r))
  for i, j in itertools.product(range(12), range(30)):
    want = math.fsum((float(q[i, t]) - float(r[j, t])) ** 2
                     for t in range(5))
    assert float(d[i, j]) == pytest.approx(want, rel=1e-12)
  vals, idx = ref_knn.smallest(d, 4)
  for i in range(12):
    order = sorted(range(30), key=lambda j: float(d[i, j]))[:4]
    assert idx[i].tolist() == order
  pair = ref_knn.pair_distances(torch.from_numpy(q), torch.from_numpy(r), idx)
  torch.testing.assert_close(pair, vals)
