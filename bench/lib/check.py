"""The comparison that decides ``correct``: every kept answer against the
plain reference, worked out again from the inputs the benchmark drew.

Numbers compared, each against the limit its configuration's ``checks``
block sets (a count's limit is 0):

  unanswered            requests sent in the window that never ended, or
                        ended in an error (a deadline expiry or an
                        admission refusal is a latency outcome, not a wrong
                        answer, and is not counted here)
  closure_rel_gap       max |served - reference| / max(|reference|, 1) over
                        the entries both hold finite
  closure_inf_mismatch  entries where one side is infinite and the other is
                        not, or infinite of the other sign; malformed answers
  closure_iters_off     answers whose reported squarings lie outside
                        [needed, needed + 1], clipped to [1, ceil(log2 n)]
  knn_dist_gap          max |served distance - float64 distance of the
                        served index| / max(float64 distance, 1)
  knn_set_gap           max over queries of (farthest served neighbour's
                        float64 distance - the true k-th smallest) /
                        max(true k-th, 1), at least 0
  knn_bad_rows          queries whose indices leave the corpus or repeat,
                        or whose distances are not ascending or finite
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bench.reference import closure as ref_closure
from bench.reference import knn as ref_knn

COUNTS = ("unanswered", "closure_inf_mismatch", "closure_iters_off",
          "knn_bad_rows")


@dataclasses.dataclass
class Verdict:
  numbers: dict        # name -> value
  limits: dict         # name -> limit
  wrong: set           # ids of observations whose answer was wrong
  checked: int         # answers compared
  squarings: dict      # id(payload) -> (needed, run) from the reference

  @property
  def correct(self) -> bool:
    return all(self.numbers[k] <= self.limits[k] for k in self.numbers)

  def as_dict(self) -> dict:
    return {k: {"value": self.numbers[k], "limit": self.limits[k]}
            for k in self.numbers}


def _closure_numbers(served: np.ndarray, want: torch.Tensor) -> tuple:
  """(rel_gap, inf_mismatch) of one served closure against the reference."""
  if served.shape != tuple(want.shape):
    return 0.0, 1
  got = torch.from_numpy(np.ascontiguousarray(served)).to(want.device)
  if want.dtype == torch.bool:
    return 0.0, int((got.to(torch.bool) != want).sum())
  got = got.to(torch.float64)
  ref = want.to(torch.float64)
  fin_g, fin_r = torch.isfinite(got), torch.isfinite(ref)
  both = fin_g & fin_r
  neither = ~fin_g & ~fin_r
  mismatch = int((~both & ~neither).sum()
                 + (neither & (torch.sign(got) != torch.sign(ref))).sum())
  if not bool(both.any()):
    return 0.0, mismatch
  gap = (got - ref).abs() / ref.abs().clamp_min(1.0)
  return float(gap[both].max()), mismatch


def check_closures(obs_list: list, device, limits: dict) -> tuple:
  """Reference every distinct closure problem the window completed; compare
  the kept answers.  Returns (numbers, wrong ids, checked, squarings)."""
  by_payload: dict = {}
  for o in obs_list:
    if o.payload.kind == "closure" and o.state == "done":
      by_payload.setdefault(id(o.payload), (o.payload, []))[1].append(o)
  rel_gap, inf_mismatch, iters_off, checked = 0.0, 0, 0, 0
  wrong, squarings = set(), {}
  for pid, (payload, group) in by_payload.items():
    adj = torch.from_numpy(payload.arrays["adj"]).to(device)
    want, needed, run = ref_closure.closure(adj, payload.op)
    squarings[pid] = (needed, run)
    lo = max(1, needed)
    for o in group:
      it = o.extras.get("iterations")
      bad = it is None or not lo <= int(it) <= run
      iters_off += int(bad)
      if o.keep:
        checked += 1
        g, m = _closure_numbers(o.value, want)
        rel_gap, inf_mismatch = max(rel_gap, g), inf_mismatch + m
        bad = bad or m > 0 or g > limits["closure_rel_gap"]
      if bad:
        wrong.add(id(o))
    del want, adj
  return ({"closure_rel_gap": rel_gap,
           "closure_inf_mismatch": inf_mismatch,
           "closure_iters_off": iters_off}, wrong, checked, squarings)


def _knn_numbers(payload, values: np.ndarray, indices: np.ndarray,
                 kth: torch.Tensor, q: torch.Tensor, r: torch.Tensor):
  """(dist_gap, set_gap, bad_rows) of one served KNN answer."""
  k = payload.params["k"]
  nq, nr = q.shape[0], r.shape[0]
  if values.shape != (nq, k) or indices.shape != (nq, k):
    return 0.0, 0.0, nq
  idx = torch.from_numpy(np.ascontiguousarray(indices)).to(q.device).long()
  val = torch.from_numpy(np.ascontiguousarray(values)).to(q.device).double()
  in_range = ((idx >= 0) & (idx < nr)).all(dim=1)
  srt = torch.sort(idx, dim=1).values
  unique = (srt[:, 1:] != srt[:, :-1]).all(dim=1)
  ascending = (val[:, 1:] >= val[:, :-1]).all(dim=1)
  finite = torch.isfinite(val).all(dim=1)
  ok = in_range & unique & ascending & finite
  bad_rows = int((~ok).sum())
  if not bool(ok.any()):
    return 0.0, 0.0, bad_rows
  d = ref_knn.pair_distances(q[ok], r, idx[ok])
  dist_gap = float(((val[ok] - d).abs() / d.clamp_min(1.0)).max())
  t = kth[ok]
  set_gap = float(((d.max(dim=1).values - t) / t.clamp_min(1.0))
                  .clamp_min(0.0).max())
  return dist_gap, set_gap, bad_rows


def check_knn(obs_list: list, device, limits: dict) -> tuple:
  by_payload: dict = {}
  for o in obs_list:
    if o.payload.kind == "knn" and o.state == "done" and o.keep:
      by_payload.setdefault(id(o.payload), (o.payload, []))[1].append(o)
  dist_gap = set_gap = 0.0
  bad_rows = checked = 0
  wrong = set()
  for payload, group in by_payload.values():
    q = torch.from_numpy(payload.arrays["queries"]).to(device)
    r = torch.from_numpy(payload.arrays["corpus"]).to(device)
    d = ref_knn.distances(q, r)
    kth = ref_knn.smallest(d, payload.params["k"]).values[:, -1]
    del d
    for o in group:
      checked += 1
      g, s, b = _knn_numbers(payload, o.value, o.extras.get("indices"),
                             kth, q, r)
      dist_gap, set_gap, bad_rows = (max(dist_gap, g), max(set_gap, s),
                                     bad_rows + b)
      if b or g > limits["knn_dist_gap"] or s > limits["knn_set_gap"]:
        wrong.add(id(o))
  return ({"knn_dist_gap": dist_gap, "knn_set_gap": set_gap,
           "knn_bad_rows": bad_rows}, wrong, checked)


def judge(obs_list: list, limits: dict, window: tuple, device) -> Verdict:
  """Compare every kept answer; ``limits`` is the configuration's
  ``checks`` block (one limit per number)."""
  t0, t1 = window
  sent = [o for o in obs_list if o.sent_s < t1]
  unanswered = sum(1 for o in sent
                   if o.state in ("pending", "failed"))
  numbers = {"unanswered": unanswered}
  wrong, checked, squarings = set(), 0, {}
  kinds = {o.payload.kind for o in obs_list}
  if "closure" in kinds:
    nums, w, c, squarings = check_closures(obs_list, device, limits)
    numbers.update(nums)
    wrong |= w
    checked += c
  if "knn" in kinds:
    nums, w, c = check_knn(obs_list, device, limits)
    numbers.update(nums)
    wrong |= w
    checked += c
  lim = {name: 0 if name in COUNTS else limits[name] for name in numbers}
  return Verdict(numbers, lim, wrong, checked, squarings)
