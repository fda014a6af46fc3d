"""Analytical area/power model reproducing paper Table 5 (SIMULATED).

The paper synthesizes RTL (Synopsys DC, FreePDK45) — a hardware gate on this
host — so we model it analytically and transparently: a SIMD² unit composes
primitive circuits (fp multiplier, adder, comparator, and-or array, squarer,
operand/result muxing, per-unit control).  Composition is linear in the
primitive areas, and the primitives follow standard gate-count scaling laws
with bit width (array multiplier/squarer ∝ w², linear datapaths ∝ w), so we
**fit the primitive areas by least squares against the paper's published
Table 5 rows** and report model-vs-paper fidelity per row.  The model then
generalizes to arbitrary op subsets / widths / grid sizes.

This file is the §6.1 artifact; benchmarks/area_table.py prints the tables
side-by-side with the paper's numbers and asserts aggregate fidelity.
Counterpart of ``repro/core/area_model.py``: the port keeps its own copy
(numpy only), and every public function and the fitted coefficients equal
the reference's.
"""
from __future__ import annotations

import numpy as np

# primitive index: mul, add, cmp, logic, sqr(+sub), mux(per extra op), ctrl
_PRIMS = ("mul", "add", "cmp", "logic", "sqr", "mux", "ctrl")
_NP = len(_PRIMS)

# circuits needed per op beyond operand latches: (⊗ stage, ⊕ stage).
# mma = mul + add (the baseline PE).  Ops reuse the baseline's mul/add where
# the semantics allow; rows list *additional* circuits when added to an MMA
# PE, and *all* circuits when built dedicated.
# repro: ignore[semiring-table-coverage] — extra-over-baseline: no mma row
_EXTRA = {   # added to an MMA PE (mul+add exist)
    "minplus": {"add": 1, "cmp": 1},   # ⊗-position adder + ⊕ comparator
    "maxplus": {"add": 1, "cmp": 1},
    "minmul":  {"cmp": 1},             # ⊗ reuses the multiplier
    "maxmul":  {"cmp": 1},
    "minmax":  {"cmp": 2},             # both stages are comparators
    "maxmin":  {"cmp": 2},
    "orand":   {"logic": 2},
    "addnorm": {"sqr": 1},             # |a−b|² datapath (sub folded in)
}
# repro: ignore[semiring-table-coverage] — dedicated units exclude the PE
_DEDICATED = {  # standalone unit (no mma circuits to reuse)
    "minplus": {"add": 2, "cmp": 1, "ctrl": 1},
    "maxplus": {"add": 2, "cmp": 1, "ctrl": 1},
    "minmul":  {"mul": 1, "cmp": 1, "add": 1, "ctrl": 1},
    "maxmul":  {"mul": 1, "cmp": 1, "add": 1, "ctrl": 1},
    "minmax":  {"cmp": 2, "ctrl": 1},
    "maxmin":  {"cmp": 2, "ctrl": 1},
    "orand":   {"logic": 2, "ctrl": 1},
    "addnorm": {"sqr": 1, "add": 1, "ctrl": 1},
}
_MMA = {"mul": 1, "add": 1}

# mirrored ops (max* given min*) share their comparator datapath: each extra
# op in an already-covered circuit class costs one mux.
_CLASSES = (("minplus", "maxplus"), ("minmul", "maxmul"),
            ("minmax", "maxmin"), ("orand",), ("addnorm",), ("mma",))


def _scale(w):
  """Per-primitive width scaling (relative to 16-bit)."""
  s = w / 16.0
  return np.array([s * s, s, s, s, s * s, s, 1.0])  # mul,add,cmp,logic,sqr,mux,ctrl


def _vec(counts: dict, w: int = 16) -> np.ndarray:
  v = np.zeros(_NP)
  for k, n in counts.items():
    v[_PRIMS.index(k)] = n
  return v * _scale(w)


def _combined_vec(ops, w: int = 16) -> np.ndarray:
  """Shared SIMD² unit: per class take the max member cost once; each extra
  member costs a mux."""
  ops = set(ops)
  v = _vec(_MMA, w)  # baseline PE always present
  for cls in _CLASSES:
    members = [o for o in cls if o in ops and o != "mma"]
    if not members:
      continue
    v = v + _vec(_EXTRA[members[0]], w)
    v[_PRIMS.index("mux")] += (len(members) - 1) * _scale(w)[_PRIMS.index(
        "mux")]
  return v


# --- calibration against published Table 5 ---------------------------------
# repro: ignore[semiring-table-coverage] — paper Table 5 has no mma row
_PAPER_5A = {"minplus": 1.21, "maxplus": 1.21, "minmul": 1.12,
             "maxmul": 1.12, "minmax": 1.01, "maxmin": 1.01, "orand": 1.04,
             "addnorm": 1.18}
_PAPER_5A_ALL = 1.69
# repro: ignore[semiring-table-coverage] — paper Table 5 has no mma row
_PAPER_5B = {"minplus": 0.26, "maxplus": 0.26, "minmul": 1.03,
             "maxmul": 1.03, "minmax": 0.06, "maxmin": 0.06, "orand": 0.08,
             "addnorm": 0.19}
_PAPER_5C = {8: (0.25, 0.69), 16: (1.0, 1.69), 32: (4.04, 6.42),
             64: (11.17, 17.01)}


def _fit() -> np.ndarray:
  rows, targets = [], []
  base = _vec(_MMA)  # normalizer: area(base)=1 enforced as a hard-ish row
  rows.append(base * 10.0)
  targets.append(1.0 * 10.0)
  for op, t in _PAPER_5A.items():
    rows.append(_combined_vec(["mma", op]))
    targets.append(t)
  rows.append(_combined_vec(["mma", *_PAPER_5A]))
  targets.append(_PAPER_5A_ALL)
  for op, t in _PAPER_5B.items():
    rows.append(_vec(_DEDICATED[op]))
    targets.append(t)
  for w, (t_mma, t_all) in _PAPER_5C.items():
    rows.append(_vec(_MMA, w))
    targets.append(t_mma)
    rows.append(_combined_vec(["mma", *_PAPER_5A], w))
    targets.append(t_all)
  A = np.asarray(rows)
  b = np.asarray(targets)
  # relative-error weighting: every published number counts equally
  wgt = 1.0 / np.maximum(np.abs(b), 0.05)
  A = A * wgt[:, None]
  b = b * wgt
  x, *_ = np.linalg.lstsq(A, b, rcond=None)
  # non-negativity: clip and re-solve on the support
  for _ in range(4):
    neg = x < 0
    if not neg.any():
      break
    x[neg] = 0.0
    keep = ~neg
    xk, *_ = np.linalg.lstsq(A[:, keep], b, rcond=None)
    x[keep] = xk
  x = np.maximum(x, 0.0)
  # renormalize so the 16-bit MMA unit is exactly 1.0
  x = x / float(base @ x)
  return x


_COEF = _fit()


def unit_area(ops, width: int = 16) -> float:
  """Area of a shared SIMD² unit (relative; 16-bit MMA-only ≡ 1.0)."""
  return float(_combined_vec(set(ops) | {"mma"}, width) @ _COEF)


def dedicated_area(op: str, width: int = 16) -> float:
  return float(_vec(_DEDICATED[op], width) @ _COEF)


ALL_OPS = ("mma",) + tuple(_PAPER_5A)
MMA_AREA_MM2 = 11.52


def table5a() -> dict:
  out = {"MMA only": (1.0, 1.0)}
  for op in _PAPER_5A:
    out[f"MMA + {op}"] = (round(unit_area(["mma", op]), 3), _PAPER_5A[op])
  out["MMA + All"] = (round(unit_area(ALL_OPS), 3), _PAPER_5A_ALL)
  return out


def table5b() -> dict:
  out = {op: (round(dedicated_area(op), 3), _PAPER_5B[op])
         for op in _PAPER_5B}
  tot = sum(dedicated_area(op) for op in _PAPER_5B)
  out["Total"] = (round(tot, 3), 2.96)
  return out


def table5c() -> dict:
  out = {}
  for w, (t_mma, t_all) in _PAPER_5C.items():
    out[f"MMA {w}b"] = (round(unit_area(["mma"], w), 3), t_mma)
    out[f"SIMD2 {w}b"] = (round(unit_area(ALL_OPS, w), 3), t_all)
  return out


def grid_scaling(grid_dim: int = 8) -> float:
  """8×8 vs 4×4 unit (paper: MMA 8×8 ≈ 7.5× the 4×4; overhead fraction
  constant).  PE area scales with PE count; the reduction tree adds
  log-depth wiring (~ +17% at 8×8 per the paper's 7.5×/4× ratio)."""
  pes = (grid_dim / 4.0) ** 2
  wiring = 1.0 + 0.17 * np.log2(grid_dim / 4.0)
  return float(pes * wiring)


def fidelity() -> dict:
  """Mean |model − paper| / paper across every published number."""
  errs = []
  for tbl in (table5a(), table5b(), table5c()):
    for model, paper in tbl.values():
      if paper:
        errs.append(abs(model - paper) / paper)
  return {"mean_rel_err": float(np.mean(errs)),
          "max_rel_err": float(np.max(errs)), "n_targets": len(errs)}


# --- power -------------------------------------------------------------------
_POWER_MMA_W = 3.74
_PAPER_EXTRA_W = 0.79


def power_w(ops) -> float:
  """Active power: switching ∝ area with lower activity on cmp/logic paths."""
  extra = unit_area(ops) - 1.0
  # calibrated single activity factor against the paper's +0.79 W
  act = _PAPER_EXTRA_W / (unit_area(ALL_OPS) - 1.0) / _POWER_MMA_W
  return _POWER_MMA_W + _POWER_MMA_W * act * extra


# --- full-chip scaling (paper §6.1 method) -----------------------------------
SM_AREA_MM2 = 3.75
SM_DIE_FRACTION = 0.502
UNIT_OVERHEAD_MM2_8N = 0.378  # paper's 45nm→8N scaled overhead


def chip_overhead_fraction() -> float:
  per_sm = UNIT_OVERHEAD_MM2_8N / SM_AREA_MM2
  return per_sm * SM_DIE_FRACTION
