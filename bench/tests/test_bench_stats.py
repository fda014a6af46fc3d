"""Rates over the whole window and tails in which a failure is late."""
from __future__ import annotations

import math

import pytest

from bench.lib import stats


def test_nearest_rank_counts_a_failure_as_infinitely_late():
  lat = [float(i) for i in range(1, 101)]
  assert stats.nearest_rank(lat, 95) == 95.0
  failed = lat[:94] + [math.inf] * 6
  assert stats.nearest_rank(failed, 95) == math.inf
  failed = lat[:95] + [math.inf] * 5
  assert stats.nearest_rank(failed, 95) == 95.0
  with pytest.raises(ValueError):
    stats.nearest_rank([], 95)


def test_window_credit_sums_to_the_rate_over_the_whole_window():
  # one client, back-to-back requests of 0.3 s from t = -0.1: the window
  # [0, 3] holds 10 requests' worth of time, whatever the edges cut
  starts = [-0.1 + 0.3 * i for i in range(12)]
  credit = sum(stats.window_credit(s, s + 0.3, 0.0, 3.0) for s in starts)
  assert credit == pytest.approx(10.0)
  assert stats.window_credit(5.0, 6.0, 0.0, 3.0) == 0.0
  assert stats.window_credit(1.0, 1.0, 0.0, 3.0) == 1.0

