"""Circuit breakers over the engine's dispatch arms — per (bucket, backend,
schedule), with cost-ranked fallback and half-open probes.

Counterpart of ``repro/serve_mmo/resilience.py``.  SIMD² keeps all nine
semiring ops on one substrate, so every bucket has sibling arms that
compute the same result: K1 ('pallas'), K2 for closures ('megakernel'),
the torch.matmul rewrites ('xla') and the blocked plain arm ('vector') —
bit for bit on the min/max rings and orand, within the parity policy on
mma.  When one arm fails persistently, its traffic moves to the next arm
of the fallback chain until the broken arm recovers.  Breakers key on
(bucket, backend, schedule): a kernel can fail at one shape and be right at
every other, so one breaker per backend would take healthy buckets down.

State machine (three-state breaker):

  closed     → normal dispatch; ``threshold`` CONSECUTIVE failures (any
               success resets the count) open it,
  open       → the arm is skipped; picks fall through to the next arm in
               the chain (ultimately 'vector').  After ``probe_after_s`` on
               the engine clock, the next pick runs ONE probe batch on the
               broken arm (half-open),
  half_open  → the probe is in flight; other picks keep using the
               fallback.  Probe success closes the breaker; probe failure
               re-opens it and restarts the cooldown.

A bisected sub-batch's failures feed the same breakers, so a persistently
failing arm opens during recovery and the retried sub-batches already land
on the fallback.  Every arm has its own executable-cache key, so
re-dispatch never collides with the primary's stored functions.

A breaker cannot recover from a sticky CUDA error (an illegal address
poisons the context for every arm on the card; ROADMAP Queue 3).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Sequence, Tuple

from repro_torch.serve_mmo.metrics import bucket_label

__all__ = ["CircuitBreaker", "ResilienceManager", "STATE_CLOSED",
           "STATE_OPEN", "STATE_HALF_OPEN", "STATE_GAUGE"]

STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half_open"
# serve_breaker_state gauge encoding
STATE_GAUGE = {STATE_CLOSED: 0, STATE_OPEN: 1, STATE_HALF_OPEN: 2}

# Arm = (backend, block cfg, schedule) — the placement the executable-cache
# key carries.  Breakers ignore the block cfg: their identity is (bucket,
# backend, schedule).
Arm = Tuple[str, tuple, str]


class CircuitBreaker:
  """One arm's breaker.  Not thread-safe on its own — the manager's lock
  guards all transitions."""

  __slots__ = ("state", "consecutive_failures", "opened_at", "opens",
               "closes", "probes")

  def __init__(self):
    self.state = STATE_CLOSED
    self.consecutive_failures = 0
    self.opened_at = 0.0
    self.opens = 0
    self.closes = 0
    self.probes = 0


class ResilienceManager:
  """Breaker registry + arm picker for one engine.

  ``pick`` walks [primary] + fallbacks and returns the first usable arm
  (with ``probe=True`` when it is a half-open probe of a broken arm);
  ``on_success`` / ``on_failure`` drive the state machine and return the
  transition (if any) so the engine can trace and count it.  ``threshold``
  None disables opening entirely — fail in place.
  """

  def __init__(self, *, threshold: Optional[int] = 5,
               probe_after_s: float = 0.25, clock=None):
    if threshold is not None and threshold < 1:
      raise ValueError(f"threshold must be >= 1 or None, got {threshold}")
    self.threshold = threshold
    self.probe_after_s = float(probe_after_s)
    self._clock = clock if clock is not None else time.perf_counter
    self._lock = threading.Lock()
    self._breakers: dict = {}  # (BucketKey, backend, schedule) → CircuitBreaker

  @staticmethod
  def _cell(key, arm: Arm) -> tuple:
    backend, _block, schedule = arm
    return (key, backend, schedule)

  def _get_locked(self, cell) -> CircuitBreaker:
    br = self._breakers.get(cell)
    if br is None:
      br = self._breakers[cell] = CircuitBreaker()
    return br

  # -- dispatch ---------------------------------------------------------------

  def pick(self, key, primary: Arm,
           fallbacks: Callable[[], Sequence[Arm]]) -> Tuple[Arm, bool]:
    """(arm to execute on, is_probe).  Closed arms win in chain order; an
    open arm past its cooldown turns this pick into its half-open probe;
    if every arm is broken the chain's last arm serves anyway."""
    if self.threshold is None:
      return primary, False
    with self._lock:
      if not self._breakers:  # steady state: no arm ever failed
        return primary, False
      now = self._clock()
      chain = [primary]
      chain_built = False
      i = 0
      while True:
        if i >= len(chain):
          if chain_built:
            return chain[-1], False  # every arm broken: serve on the last
          chain.extend(a for a in fallbacks() if a not in chain)
          chain_built = True
          if i >= len(chain):
            return chain[-1], False
        arm = chain[i]
        br = self._breakers.get(self._cell(key, arm))
        if br is None or br.state == STATE_CLOSED:
          return arm, False
        if br.state == STATE_OPEN and now - br.opened_at >= self.probe_after_s:
          br.state = STATE_HALF_OPEN
          br.probes += 1
          return arm, True
        i += 1

  # -- outcomes ---------------------------------------------------------------

  def on_success(self, key, arm: Arm) -> Optional[str]:
    """A batch attempt on ``arm`` succeeded.  Returns 'close' when this was
    the probe that recovered an open breaker (else None)."""
    if self.threshold is None:
      return None
    with self._lock:
      br = self._breakers.get(self._cell(key, arm))
      if br is None:
        return None
      was_half_open = br.state == STATE_HALF_OPEN
      br.consecutive_failures = 0
      if br.state != STATE_CLOSED:
        br.state = STATE_CLOSED
        br.closes += 1
      return "close" if was_half_open else None

  def on_failure(self, key, arm: Arm) -> Optional[str]:
    """A batch attempt on ``arm`` failed.  Returns 'open' when the breaker
    newly opened (threshold reached, or a half-open probe failed)."""
    if self.threshold is None:
      return None
    with self._lock:
      br = self._get_locked(self._cell(key, arm))
      br.consecutive_failures += 1
      if br.state == STATE_HALF_OPEN:
        br.state = STATE_OPEN       # the probe failed: cooldown restarts
        br.opened_at = self._clock()
        br.opens += 1
        return "open"
      if (br.state == STATE_CLOSED
          and br.consecutive_failures >= self.threshold):
        br.state = STATE_OPEN
        br.opened_at = self._clock()
        br.opens += 1
        return "open"
      return None

  # -- reading ----------------------------------------------------------------

  def snapshot(self) -> list:
    """All breaker cells (for exposition): bucket label + arm + state +
    counters, sorted for stable output."""
    with self._lock:
      cells = [((key, backend, schedule), br.state, br.consecutive_failures,
                br.opens, br.closes, br.probes)
               for (key, backend, schedule), br in self._breakers.items()]
    out = [{
        "bucket": bucket_label(key), "backend": backend,
        "schedule": schedule, "state": state,
        "consecutive_failures": fails, "opens": opens, "closes": closes,
        "probes": probes,
    } for (key, backend, schedule), state, fails, opens, closes, probes
        in cells]
    out.sort(key=lambda c: (c["bucket"], c["backend"], c["schedule"]))
    return out

  def open_arms(self) -> list:
    """The non-closed cells — what /healthz names when it answers 503
    degraded."""
    return [c for c in self.snapshot() if c["state"] != STATE_CLOSED]
