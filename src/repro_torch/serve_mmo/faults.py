"""Deterministic fault injection for the serving engine — the failure
taxonomy and the seedable harness that exercises it.

Counterpart of ``repro/serve_mmo/faults.py``, with the same rules, grammar
and seeded ``random.Random``, so one spec and one seed fire on the same
checks in both packages.  A ``FaultInjector`` holds named rules that fire
at the engine's injection points, deterministically (seeded RNG for
rate-mode rules, plain counters for transient ones), so a test or a chaos
run can replay the exact same failure schedule twice and assert the exact
same recovery.

Injection points (``POINTS``):

  ``compile``    — raise before the executable cache is consulted (a build
                   failure for this (bucket, batch, arm) that never
                   poisons the cache),
  ``execute``    — raise at the start of the watched device run (a
                   device-side execution failure; no kernel launches),
  ``nonfinite``  — overwrite the batch output with NaNs after execution (a
                   kernel producing garbage — the engine's result
                   validation must catch it, see ``batching.validate_finite``),
  ``slow``       — sleep ``delay_s`` inside the watched device run (a slow
                   or hung device computation — with the engine's watchdog
                   armed and ``delay_s`` past it, the batch times out
                   instead of wedging the serving loop).

Schedules (``mode``): ``persistent`` fires on every matching check until
``clear()``; ``transient`` fires on the first ``count`` matching checks;
``rate`` fires with probability ``rate`` from the injector's seeded RNG.

Scoping: ``match`` filters by bucket-label substring, ``backend`` pins the
rule to one arm (a K1 fault does not follow the request to the fallback —
this is what drives the circuit breaker's re-dispatch), and
``request_ids`` poisons specific requests (the rule fires only for batches
containing them — what batch bisection isolates).

``parse_fault_spec`` turns the ``--inject-faults`` CLI grammar into an
injector::

    execute:rate:0.02                 2% of execute checks fail
    execute:transient:3               first 3 execute checks fail
    compile:persistent@closure        every compile of a closure bucket
    execute:persistent:backend=xla    the xla arm is broken (breaker food)
    slow:transient:1:delay=0.2        one 200ms stall (watchdog food)

Rules are ';'-separated; each rule is ``point:mode[:arg][:k=v...][@match]``
where ``arg`` is the transient count or the rate probability.

``NonFiniteResultError`` lives in api.py and is re-exported here.  A real
device fault (an illegal address, say) is not one of these types: it is
labelled by the phase it escaped from, as any other exception, and it may
leave the CUDA context unusable for every arm (ROADMAP Queue 3).
"""
from __future__ import annotations

import dataclasses
import random
import threading
from typing import FrozenSet, Optional, Sequence

from repro_torch.serve_mmo.api import NonFiniteResultError

__all__ = ["POINTS", "FAILURE_KINDS", "ARM_FAILURE_KINDS", "FaultRule",
           "FaultInjector",
           "InjectedFault", "NonFiniteResultError", "BatchTimeoutError",
           "classify_failure", "parse_fault_spec"]

POINTS = ("compile", "execute", "nonfinite", "slow")
MODES = ("persistent", "transient", "rate")

# failure kinds the engine classifies batch failures into (the ``kind``
# label on serve_batch_failures_total)
FAILURE_KINDS = ("stack", "compile", "execute", "nonfinite", "timeout",
                 "split", "other")

# the kinds that implicate the executing ARM and feed its circuit breaker;
# stack/split/other are host-side and arm-independent — a poisoned operand
# would fail identically on every backend
ARM_FAILURE_KINDS = frozenset(("compile", "execute", "nonfinite", "timeout"))


class InjectedFault(RuntimeError):
  """An injected failure fired at ``point`` — raised by the engine's hook
  so the recovery machinery sees a real exception on the real code path."""

  def __init__(self, point: str, detail: str = ""):
    self.point = point
    super().__init__(f"injected {point} fault{': ' + detail if detail else ''}")


class BatchTimeoutError(RuntimeError):
  """The watchdog expired before the device returned the batch — the batch
  fails instead of wedging the serving loop.  Work already queued on the
  CUDA stream cannot be cancelled: it still runs, the next batch waits
  behind it, and its result is discarded."""

  def __init__(self, label: str, timeout_s: float):
    self.timeout_s = float(timeout_s)
    super().__init__(
        f"batch for {label} exceeded the {timeout_s:g}s watchdog")


def classify_failure(exc: BaseException, phase: str) -> str:
  """Map one batch-attempt exception to its failure kind: typed failures
  (validation, watchdog, injection) answer for themselves; anything else is
  labelled by the phase it escaped from (stack / compile / execute /
  split)."""
  if isinstance(exc, NonFiniteResultError):
    return "nonfinite"
  if isinstance(exc, BatchTimeoutError):
    return "timeout"
  if isinstance(exc, InjectedFault):
    return exc.point if exc.point in FAILURE_KINDS else "execute"
  return phase if phase in FAILURE_KINDS else "other"


@dataclasses.dataclass
class FaultRule:
  """One injection rule: where it fires (``point``), when (``mode`` +
  ``count``/``rate``), and what it targets (``match`` bucket substring,
  ``backend`` arm, ``request_ids`` poison set).  ``fired`` counts how many
  times it has gone off."""

  point: str
  mode: str = "persistent"
  count: int = 1                  # transient: checks that fire before clearing
  rate: float = 0.0               # rate: per-check fire probability
  match: str = ""                 # bucket-label substring ("" matches all)
  backend: str = ""               # arm filter ("" matches any arm)
  request_ids: FrozenSet[int] = frozenset()  # poison set (empty = whole batch)
  delay_s: float = 0.05           # slow: stall length
  fired: int = 0

  def __post_init__(self):
    if self.point not in POINTS:
      raise ValueError(f"point must be one of {POINTS}, got {self.point!r}")
    if self.mode not in MODES:
      raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
    if self.mode == "rate" and not 0.0 <= self.rate <= 1.0:
      raise ValueError(f"rate must be in [0, 1], got {self.rate}")
    if self.mode == "transient" and self.count < 1:
      raise ValueError(f"transient count must be >= 1, got {self.count}")
    self.request_ids = frozenset(int(r) for r in self.request_ids)


class FaultInjector:
  """Seedable, thread-safe fault decision engine.

  ``check(point, label=..., backend=..., request_ids=...)`` returns the
  first armed rule that matches and whose schedule says "fire now" (or
  None).  Transient rules count their own firings, rate rules draw from one
  seeded ``random.Random``, and the lock serializes both against the
  background serving loop."""

  def __init__(self, rules: Sequence[FaultRule] = (), *, seed: int = 0):
    self._lock = threading.Lock()
    self._rules: list[FaultRule] = list(rules)
    self._rng = random.Random(seed)
    self._fired_by_point = {p: 0 for p in POINTS}

  def arm(self, rule: FaultRule) -> FaultRule:
    with self._lock:
      self._rules.append(rule)
    return rule

  def clear(self, point: Optional[str] = None) -> int:
    """Drop all rules (or just one point's) — "the fault cleared".  Returns
    how many rules were removed."""
    with self._lock:
      keep = [r for r in self._rules
              if point is not None and r.point != point]
      removed = len(self._rules) - len(keep)
      self._rules = keep
      return removed

  def rules(self) -> list:
    with self._lock:
      return list(self._rules)

  def check(self, point: str, *, label: str = "", backend: str = "",
            request_ids: Sequence[int] = ()) -> Optional[FaultRule]:
    """Should this injection point fire for this (bucket, arm, batch)?
    Returns the firing rule (its ``delay_s``/``request_ids`` parameterize
    the fault) or None."""
    with self._lock:
      for rule in self._rules:
        if rule.point != point:
          continue
        if rule.match and rule.match not in label:
          continue
        if rule.backend and rule.backend != backend:
          continue
        if rule.request_ids and not rule.request_ids.intersection(request_ids):
          continue
        if rule.mode == "transient" and rule.fired >= rule.count:
          continue
        if rule.mode == "rate" and not self._rng.random() < rule.rate:
          continue
        rule.fired += 1
        self._fired_by_point[point] += 1
        return rule
      return None

  def stats(self) -> dict:
    with self._lock:
      return {
          "rules": len(self._rules),
          "fired": dict(self._fired_by_point),
          "fired_total": sum(self._fired_by_point.values()),
      }


def parse_fault_spec(spec: str, *, seed: int = 0) -> FaultInjector:
  """``--inject-faults`` grammar → FaultInjector (see module docstring).

  ``spec`` is ';'-separated rules, each
  ``point:mode[:arg][:key=value...][@match]`` — ``arg`` is the transient
  count or the rate probability; keys are ``delay`` (seconds, for slow),
  ``backend`` (arm filter), ``rid`` (comma-separated poison request ids).
  """
  rules = []
  for part in spec.split(";"):
    part = part.strip()
    if not part:
      continue
    match = ""
    if "@" in part:
      part, match = part.rsplit("@", 1)
    tokens = part.split(":")
    if not tokens or not tokens[0]:
      raise ValueError(f"empty fault rule in spec {spec!r}")
    kw: dict = {"point": tokens[0], "match": match}
    positional = []
    for tok in tokens[1:]:
      if "=" in tok:
        k, v = tok.split("=", 1)
        if k == "delay":
          kw["delay_s"] = float(v)
        elif k == "backend":
          kw["backend"] = v
        elif k == "rid":
          kw["request_ids"] = frozenset(int(x) for x in v.split(",") if x)
        else:
          raise ValueError(f"unknown fault rule key {k!r} in {part!r}")
      else:
        positional.append(tok)
    if positional:
      kw["mode"] = positional[0]
    if len(positional) > 1:
      if kw.get("mode") == "rate":
        kw["rate"] = float(positional[1])
      else:
        kw["count"] = int(positional[1])
    if len(positional) > 2:
      raise ValueError(f"too many positional tokens in fault rule {part!r}")
    rules.append(FaultRule(**kw))
  if not rules:
    raise ValueError(f"fault spec {spec!r} contains no rules")
  return FaultInjector(rules, seed=seed)
