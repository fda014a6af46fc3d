"""Elasticity & straggler mitigation — the control-plane story at 1000+
nodes, exercised in simulation (tests/test_torch_elastic.py).

Counterpart of ``repro/launch/elastic.py``, host-level Python with an
injectable clock; nothing here touches a device.  An H100 host (a DGX or
HGX H100) holds 8 cards: ``plan_remesh``'s ``chips_per_host`` stays a
parameter.

Mechanisms (all host-level; the data-plane stays pure SPMD):

  * **Heartbeats + failure detection** — every host ticks a coordinator;
    a missed deadline marks the host suspect, two mark it dead.
  * **Checkpoint/restart re-meshing** — on membership change, the job
    restarts from LATEST with a new mesh shape chosen by ``plan_remesh``
    (largest (data × model) grid that the surviving hosts support with the
    model axis preserved — TP topology must stay intact, DP shrinks).
    Because the data pipeline is step-indexed and shard assignments are
    derived from (host_id, topology), a resize replays no data and skips
    none (see data/pipeline.py).
  * **Straggler mitigation** — per-step host durations feed an EWMA; hosts
    slower than ``threshold ×`` the fleet median for ``patience``
    consecutive steps are reported for eviction (at pod scale the scheduler
    replaces the VM; here the policy object is unit-tested against traces).
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Optional


@dataclasses.dataclass
class HostState:
  last_beat: float
  suspect: bool = False
  dead: bool = False
  ewma_ms: Optional[float] = None
  slow_streak: int = 0


class Coordinator:
  """Failure detector + straggler policy over host heartbeats."""

  def __init__(self, hosts, *, deadline_s: float = 10.0,
               straggler_threshold: float = 1.5, patience: int = 5,
               ewma_alpha: float = 0.2, clock=time.monotonic):
    self.clock = clock
    self.deadline_s = deadline_s
    self.threshold = straggler_threshold
    self.patience = patience
    self.alpha = ewma_alpha
    now = clock()
    self.hosts = {h: HostState(last_beat=now) for h in hosts}

  # -- failure detection -----------------------------------------------------
  def beat(self, host, step_ms: Optional[float] = None):
    st = self.hosts[host]
    st.last_beat = self.clock()
    st.suspect = st.dead = False
    if step_ms is not None:
      st.ewma_ms = (step_ms if st.ewma_ms is None
                    else self.alpha * step_ms + (1 - self.alpha) * st.ewma_ms)

  def sweep(self):
    """Advance failure detection; returns newly dead hosts."""
    now = self.clock()
    died = []
    for h, st in self.hosts.items():
      if st.dead:
        continue
      late = now - st.last_beat
      if late > 2 * self.deadline_s:
        st.dead = True
        died.append(h)
      elif late > self.deadline_s:
        st.suspect = True
    return died

  def alive(self):
    return [h for h, st in self.hosts.items() if not st.dead]

  # -- straggler policy --------------------------------------------------------
  def stragglers(self):
    vals = sorted(st.ewma_ms for st in self.hosts.values()
                  if st.ewma_ms is not None and not st.dead)
    if not vals:
      return []
    median = vals[len(vals) // 2]
    out = []
    for h, st in self.hosts.items():
      if st.dead or st.ewma_ms is None:
        continue
      if st.ewma_ms > self.threshold * median:
        st.slow_streak += 1
        if st.slow_streak >= self.patience:
          out.append(h)
      else:
        st.slow_streak = 0
    return out


def plan_remesh(n_hosts_alive: int, chips_per_host: int, model: int = 16):
  """Largest (data, model) mesh on the survivors with the TP axis intact.

  Returns (data, model) or None if even one TP group no longer fits."""
  chips = n_hosts_alive * chips_per_host
  if chips < model:
    return None
  data = chips // model
  # data must keep the global batch divisible; round down to a power of two
  p = 1
  while p * 2 <= data:
    p *= 2
  return (p, model)
