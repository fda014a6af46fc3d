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
"""
from __future__ import annotations

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
