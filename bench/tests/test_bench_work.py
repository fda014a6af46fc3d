"""The counted work against shapes worked by hand."""
from __future__ import annotations

import pytest

from bench.lib import work


def test_minplus_closure_work():
  terms, nbytes = work.closure_work(4096, "minplus", "float32", 4)
  assert terms == 4 * 4096 ** 3
  assert nbytes == 4 * 2 * 4096 * 4096 * 4
  # two instructions per term at 132 x 128 lanes x 1.98 GHz
  one = work.ops_seconds("minplus", "float32", 4096 ** 3)
  assert one == pytest.approx(2 * 4096 ** 3 / (132 * 128 * 1.98e9))
  assert one == pytest.approx(4.108e-3, rel=1e-3)
  # ops bound: the iterate's bytes take 1 % of the issue time
  assert nbytes / work.PEAK_BYTES_S < 0.01 * work.ops_seconds(
      "minplus", "float32", terms)


def test_addnorm_knn_work_is_bytes_bound():
  terms, nbytes = work.knn_work(4096, 16384, 16)
  assert terms == 4096 * 16384 * 16
  assert nbytes == (4096 + 16384) * 16 * 4 + 4096 * 16384 * 4
  assert work.ops_seconds("addnorm", "float32", terms) < nbytes / 3.35e12
  assert nbytes / work.PEAK_BYTES_S == pytest.approx(0.0805e-3, rel=2e-3)


def test_no_closure_work_where_nothing_changed():
  assert work.closure_work(256, "minplus", "float32", 0) == (0.0, 0.0)
