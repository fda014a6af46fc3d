"""The port's copy of the analytical area/power model (paper Table 5).

It is numpy only, so the parity is exact: the fitted primitive areas, every
table, every public function at every op subset and width the tables use.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import area_model as jam  # noqa: E402
from repro_torch.core import area_model as tam  # noqa: E402

OPS = ("mma",) + tuple(jam._PAPER_5A)


def test_fitted_coefficients_are_the_reference_bits():
  np.testing.assert_array_equal(tam._COEF, jam._COEF)
  np.testing.assert_array_equal(tam._fit(), jam._fit())


@pytest.mark.parametrize("table", ["table5a", "table5b", "table5c",
                                   "fidelity"])
def test_tables_match_the_reference(table):
  assert getattr(tam, table)() == getattr(jam, table)()


@pytest.mark.parametrize("width", [8, 16, 32, 64])
@pytest.mark.parametrize("op", OPS)
def test_unit_and_dedicated_areas_match(op, width):
  assert tam.unit_area(["mma", op], width) == jam.unit_area(["mma", op],
                                                            width)
  if op != "mma":
    assert tam.dedicated_area(op, width) == jam.dedicated_area(op, width)


@pytest.mark.parametrize("ops", [["mma"], ["mma", "minplus", "maxplus"],
                                 ["minmax", "maxmin", "orand"], list(OPS)])
def test_power_matches(ops):
  assert tam.power_w(ops) == jam.power_w(ops)


@pytest.mark.parametrize("grid", [4, 8, 16])
def test_grid_scaling_matches(grid):
  assert tam.grid_scaling(grid) == jam.grid_scaling(grid)


def test_constants_and_chip_overhead_match():
  assert tam.ALL_OPS == jam.ALL_OPS
  assert tam.MMA_AREA_MM2 == jam.MMA_AREA_MM2
  assert tam.chip_overhead_fraction() == jam.chip_overhead_fraction()
  assert tam.fidelity()["n_targets"] == 27  # every published Table-5 number
