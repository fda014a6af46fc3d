"""Ring-model traffic of one collective: the formulas the sharded cost
prior (``tuning/cost_table.sharded_prior_seconds``) and the dry run's
collective model (``launch/dryrun.py``) charge.

Counterpart of ``repro/roofline/collectives.py``.  Per device, for a
collective over ``n`` shards moving ``bytes``:

    all-reduce          2·(n−1)/n · bytes     (reduce-scatter + all-gather)
    all-gather          (n−1)/n · out_bytes
    reduce-scatter      (n−1)/n · in_bytes
    all-to-all          (n−1)/n · bytes
    collective-permute  bytes                 (one hop)

``collective_bytes`` is the reference's parser of XLA's optimized HLO
text, copied: shapes like ``bf16[16,4096,128]`` give element counts (tuple
shapes sum), n is the op's replica-group size.  Torch emits no HLO, so the
port's dry run models its collectives in closed form instead; the parser
stays for HLO text that comes from elsewhere.

``CollectiveCounter`` is the port's counterpart of the reference's walk of
the compiled program (``repro/roofline/hlo_walk.py``, ``coll_breakdown``):
while one is on, every point where the port's single-controller mesh
moves a tensor between positions reports a ``Collective`` (``record``):
the meetings (``models/common.LineGroup.meet``, and the transposed
collective of each differentiable meeting when its gradient arrives in
the backward), the gathers of parts cut along ``data``
(``models/zoo.ShardedLM``: the forward's, the backward's regather or the
recompute's, zero2's copy) and the gradient sums that land in other
positions' pieces (``train/sharded.PositionGrads``).  ``ring_bytes``
reduces them, by the ring model, to the ``{term: bytes}`` and ``{axis
group: bytes}`` per device that ``launch/dryrun.collective_model`` gives
for a cell; the dry run's pod-scale cells keep their closed form, and the
counter is what holds that form to the step
(``tests/test_torch_dryrun_collectives.py``).  Scalar moves (the token
count, the losses, the grad norm's piece sums) are not collectives of the
model and are not recorded.
"""
from __future__ import annotations

import dataclasses
import re
from collections import defaultdict

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "token": 0, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{?\{([^}]*)\}")
_GROUPS_DIMS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")

_COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def ring_traffic_bytes(kind: str, nbytes: float, group_size: int) -> float:
  """Per-device ring-model traffic for one collective moving ``nbytes``."""
  n = max(group_size, 1)
  if kind == "all-reduce":
    return 2.0 * (n - 1) / n * nbytes
  if kind in ("all-gather", "reduce-scatter", "all-to-all"):
    return (n - 1) / n * nbytes
  if kind == "collective-permute":
    return float(nbytes)
  raise ValueError(f"unknown collective kind {kind!r}; one of {_COLL_KINDS}")


def _shape_bytes(text: str) -> int:
  """Sum tensor bytes over every dtype[shape] group in a type string."""
  total = 0
  for dt, dims in _SHAPE_RE.findall(text):
    if dt not in _DTYPE_BYTES:
      continue
    n = 1
    if dims:
      for d in dims.split(","):
        if d:
          n *= int(d)
    total += n * _DTYPE_BYTES[dt]
  return total


def _group_size(line: str) -> int:
  m = _GROUPS_DIMS_RE.search(line)
  if m:  # iota form [ngroups,group_size]
    return int(m.group(2))
  m = _GROUPS_RE.search(line)
  if m:
    return len([x for x in m.group(1).split(",") if x.strip() != ""])
  return 2


def collective_bytes(hlo_text: str) -> dict:
  """Returns {kind: per_device_bytes} + {'total': ...} (ring model)."""
  out = defaultdict(float)
  for line in hlo_text.splitlines():
    s = line.lstrip()
    # match "  %x = TYPE all-gather(...)" / "x = TYPE all-reduce-start(..."
    m = re.match(r"%?[\w\.\-]+\s*=\s*(\S+)\s+([a-z\-]+)", s)
    if not m:
      continue
    optype = m.group(2)
    kind = next((k for k in _COLL_KINDS if optype.startswith(k)), None)
    if kind is None or optype.endswith("-done"):
      continue
    ty = m.group(1)
    out[kind] += ring_traffic_bytes(kind, _shape_bytes(ty), _group_size(line))
    out[f"count:{kind}"] += 1
  out["total"] = sum(v for k, v in out.items()
                     if not k.startswith("count:") and k != "total")
  return dict(out)


# the dry run's collective terms (``launch/dryrun.py``'s docstring), in
# ``coll_breakdown``'s order
TERMS = ("fsdp_all_gather", "grad_reduce_scatter", "grad_all_reduce",
         "tp_all_reduce", "tp_embed_all_reduce", "tp_stats_all_reduce",
         "decode_attn_all_reduce", "decode_heads_all_gather")

# the collective whose ring traffic equals a collective's backward (the
# transposed collective moves the same bytes)
TRANSPOSE = {"all-reduce": "all-reduce", "all-gather": "reduce-scatter",
             "reduce-scatter": "all-gather"}


@dataclasses.dataclass(frozen=True)
class Collective:
  """One collective as one mesh position ``pos`` takes part in it, ``times``
  over: its dry-run ``term``, the axis group it runs over (``"data"``,
  ``"model"``, ``"pod+data"``), its ring ``kind``, the bytes the ring
  formula takes (an all-reduce's tensor, an all-gather's output, a
  reduce-scatter's input) and the positions in its ``group``."""

  term: str
  axis: str
  kind: str
  nbytes: float
  group: int
  pos: object = (0, 0)
  times: int = 1

  @property
  def ring_bytes(self) -> float:
    return self.times * ring_traffic_bytes(self.kind, self.nbytes,
                                           self.group)


def ring_totals(collectives) -> tuple:
  """({term: per-device bytes}, {axis group: per-device bytes}) of
  ``collectives`` (one device's), every term of ``TERMS`` present."""
  terms = dict.fromkeys(TERMS, 0.0)
  axes: dict = {}
  for c in collectives:
    b = c.ring_bytes
    terms[c.term] = terms.get(c.term, 0.0) + b
    axes[c.axis] = axes.get(c.axis, 0.0) + b
  return terms, axes


_ON: list = []   # the counters that are on


def counting() -> bool:
  """Whether a ``CollectiveCounter`` is on (a site may skip the work of
  describing its collective otherwise)."""
  return bool(_ON)


def record(term: str, axis: str, kind: str, nbytes: float, group: int,
           pos) -> None:
  """Report one collective position ``pos`` takes part in to every counter
  that is on (a no-op when none is).  Called from the positions' threads
  and autograd's."""
  if not _ON or group <= 1:
    return
  c = Collective(term, axis, kind, nbytes, group, pos)
  for counter in tuple(_ON):
    counter.collectives.append(c)


def tensor_bytes(value) -> int:
  """Bytes of a tensor or of a tuple of them."""
  if isinstance(value, (tuple, list)):
    return sum(tensor_bytes(v) for v in value)
  return value.numel() * value.element_size()


class CollectiveCounter:
  """Context manager: the collectives the port's mesh runs while it is on
  (``collectives``, every position's), and their ring-model bytes per
  device (``ring_bytes``: the first position's, whose pieces are the
  ceil-sized ones ``launch/dryrun.local_bytes`` reckons)."""

  def __init__(self):
    self.collectives: list = []

  def __enter__(self) -> "CollectiveCounter":
    _ON.append(self)
    return self

  def __exit__(self, *exc) -> bool:
    _ON.remove(self)
    return False

  def of(self, pos=(0, 0)) -> list:
    return [c for c in self.collectives if c.pos == pos]

  def count(self, term: str = None) -> int:
    """How many times the positions took part in ``term``'s collectives
    (all terms' when None)."""
    return sum(c.times for c in self.collectives
               if term is None or c.term == term)

  def ring_bytes(self, pos=(0, 0)) -> tuple:
    """``ring_totals`` of position ``pos``'s collectives."""
    return ring_totals(self.of(pos))
