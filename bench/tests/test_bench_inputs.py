"""The generator repeats exactly for one seed and differs across seeds."""
from __future__ import annotations

import numpy as np
import torch

from bench.lib import inputs, spec

CPU = torch.device("cpu")


def _pool(seed):
  cell = spec.load_cell("apsp-bulk")
  cell.config["request"]["n"] = 40
  st = dict(cell.traffic["streams"][0], pool=3)
  return inputs.closed_pool(cell.config, st, 0, seed, CPU)


def _urgent(seed, seconds=3.0):
  cell = spec.load_cell("apsp-urgent")
  st = cell.traffic["streams"][1]
  return inputs.open_schedule(cell.config, st, 1, seed, seconds, CPU), st


def test_a_pool_repeats_for_one_seed_and_differs_across_seeds():
  big = 2 ** 31 + 977
  a, b, c = _pool(big), _pool(big), _pool(big + 1)
  for x, y in zip(a, b):
    np.testing.assert_array_equal(x.arrays["adj"], y.arrays["adj"])
  assert not np.array_equal(a[0].arrays["adj"], c[0].arrays["adj"])
  adj = a[0].arrays["adj"]
  assert adj.dtype == np.float32 and adj.shape == (40, 40)
  assert np.all(np.diag(adj) == 0.0)
  finite = adj[np.isfinite(adj) & ~np.eye(40, dtype=bool)]
  assert finite.min() >= 1.0 and finite.max() <= 10.0


def test_the_urgent_stream_keeps_its_set_of_gaps_and_sizes_across_seeds():
  (s1, st), (s2, _), (s3, _) = _urgent(5), _urgent(5), _urgent(6)
  rate, seconds = st["rate_per_s"], 3.0
  assert len(s1.due_s) == round(rate * seconds)
  assert np.all(np.diff(s1.due_s) > 0)
  assert 0.0 < s1.due_s[0] and s1.due_s[-1] < seconds
  np.testing.assert_array_equal(s1.due_s, s2.due_s)
  np.testing.assert_allclose(np.sort(np.diff(s1.due_s, prepend=0.0)),
                             np.sort(np.diff(s3.due_s, prepend=0.0)))
  n1 = sorted(p.size[0] for p in s1.payloads)
  n3 = sorted(p.size[0] for p in s3.payloads)
  assert n1 == n3 and 200 <= n1[0] and n1[-1] <= 256
  assert [p.size for p in s1.payloads] != [p.size for p in s3.payloads]
  for x, y in zip(s1.payloads, s2.payloads):
    np.testing.assert_array_equal(x.arrays["adj"], y.arrays["adj"])


def test_knn_points_repeat_for_one_seed():
  cell = spec.load_cell("knn-bulk")
  cell.config["request"].update(queries=8, corpus=32)
  st = dict(cell.traffic["streams"][0], pool=2)
  a = inputs.closed_pool(cell.config, st, 0, 11, CPU)
  b = inputs.closed_pool(cell.config, st, 0, 11, CPU)
  c = inputs.closed_pool(cell.config, st, 0, 12, CPU)
  np.testing.assert_array_equal(a[1].arrays["corpus"], b[1].arrays["corpus"])
  assert not np.array_equal(a[1].arrays["corpus"], c[1].arrays["corpus"])
  assert a[0].arrays["queries"].shape == (8, 16)


def test_a_clients_pool_order_covers_the_pool_evenly():
  order = inputs.pool_order(inputs.client_rng(3, 0, 1), 5)
  first = [next(order) for _ in range(15)]
  assert sorted(first) == sorted(list(range(5)) * 3)
