"""Scheduling policies: which bucket serves next, and in what order within.

Counterpart of ``repro/serve_mmo/policy.py``.  The scheduler
(``serve_mmo.scheduler.BucketScheduler``) owns request storage — one heap
per shape bucket — and delegates every ordering decision to a
``SchedulingPolicy``:

  * ``request_rank``  orders requests *within* a bucket (heap key prefix;
    submit seq always breaks ties, so equal-rank requests stay FIFO),
  * ``pick``          chooses which bucket's head batches next,
  * ``fail_fast``     may declare a just-popped request hopeless (its
    deadline cannot be met even if served immediately) so the engine fails
    it instead of burning a batch slot on a result nobody can use,
  * ``batch_cap``     bounds how many requests the next batch may carry —
    the service-time-aware preemption cap (``max_batch_seconds``): while
    deadline traffic is active, bulk batches are kept short enough that an
    urgent arrival never waits a full max_batch service time behind one.

Three implementations:

  FifoPolicy       — rank ``()``: strict FIFO within a bucket, oldest head
                     across buckets.  The engine default.
  DeadlinePolicy   — rank ``(-priority, deadline)``: higher priority tiers
                     first, then earliest absolute deadline (requests with
                     no deadline sort last, FIFO among themselves).  At pick
                     time a head whose deadline is infeasible — now plus the
                     predicted per-request service seconds already
                     overshoots it — fails fast.
  FairSharePolicy  — weighted round-robin across tenants: each pick serves
                     the bucket holding the current tenant's oldest queued
                     request, and a tenant with weight w gets w consecutive
                     picks before the turn passes.  Within the picked bucket
                     the batch is still FIFO (a batch is a *shape* unit and
                     may carry other tenants' requests along — that is free
                     batching, not a fairness violation).

Cross-bucket picking for the heap-ordered policies (FIFO, deadline) is an
O(log Q) lazy heap, not an O(buckets) scan: every queued request pushes one
``(rank, seq, bucket)`` heap record at add time, and because bucket heaps
share the same (rank, seq) order, a live top record is always its bucket's
current head.  Records whose request was already batched, expired, or lost
are discarded lazily at pick time (``taken`` flag / head-seq mismatch), so
pick cost stays flat as bucket diversity grows.
"""
from __future__ import annotations

import collections
import heapq
import math
from typing import Optional

__all__ = ["QueueEntry", "SchedulingPolicy", "FifoPolicy", "DeadlinePolicy",
           "FairSharePolicy", "POLICIES", "make_policy"]


class QueueEntry:
  """One queued request: ``rank`` is the policy's within-bucket order prefix
  (seq breaks ties), ``taken`` marks entries already removed from their
  bucket so auxiliary structures (pick heap, tenant queues) can skip them
  lazily instead of paying for eager deletion."""

  __slots__ = ("seq", "req", "rank", "taken")

  def __init__(self, seq: int, req, rank: tuple = ()):
    self.seq = seq
    self.req = req
    self.rank = rank
    self.taken = False

  def __lt__(self, other: "QueueEntry") -> bool:
    return (self.rank, self.seq) < (other.rank, other.seq)

  def __repr__(self) -> str:
    return (f"QueueEntry(seq={self.seq}, rank={self.rank}, "
            f"taken={self.taken})")


class SchedulingPolicy:
  """Base policy: heap-ordered bucket picking over ``request_rank``."""

  name = "base"

  def __init__(self):
    self._heap: list = []  # (rank, seq, BucketKey) — lazy, see module doc

  # -- ordering ----------------------------------------------------------------

  def request_rank(self, req, now: float) -> tuple:
    """Within-bucket order prefix for one request (seq breaks ties)."""
    return ()

  # -- lifecycle hooks ---------------------------------------------------------

  def on_add(self, entry: QueueEntry, key, sched) -> None:
    heapq.heappush(self._heap, (entry.rank, entry.seq, key))

  # -- picking -----------------------------------------------------------------

  def pick(self, sched, now: float) -> Optional[tuple]:
    """BucketKey whose head serves next, or None when nothing is queued.

    The top live heap record is always its bucket's current head: bucket
    heaps and this heap share the (rank, seq) order, so any record above a
    bucket's head would itself be that bucket's head.  Stale records (request
    batched/expired, or the bucket dict was externally cleared) are popped
    and dropped.
    """
    h = self._heap
    while h:
      _, seq, key = h[0]
      bucket = sched._buckets.get(key)
      if bucket and not bucket[0].taken and bucket[0].seq == seq:
        return key
      heapq.heappop(h)
    return None

  def fail_fast(self, entry: QueueEntry, key, sched, now: float) -> bool:
    """Whether a just-popped request should fail instead of execute."""
    return False

  def batch_cap(self, key, sched, now: float) -> int:
    """Most requests the next batch from ``key`` may carry — the
    service-time-aware preemption bound.

    With ``sched.max_batch_seconds`` set and deadline-tagged traffic active
    (queued, or seen within the scheduler's lookback window), the batch is
    bounded to the largest power of two whose *predicted* service time
    (``predict_seconds`` per request × batch size — live EWMA seconds when
    the engine runs adaptive) fits the cap, so a bulk batch on device can
    delay an urgent arrival by at most ~max_batch_seconds instead of a full
    max_batch service time.  Power-of-two flooring matters: the engine pads
    batches up to the next power of two and computes every padded slot, so
    an un-floored cap of e.g. 3 would execute 4 slots and overshoot the
    seconds budget it claims to honor.  Never caps below 1; without a cap
    (or predictor) the answer is ``sched.max_batch`` — the historical
    behavior, and full batching efficiency for pure-bulk workloads.
    """
    cap_s = getattr(sched, "max_batch_seconds", None)
    predict = getattr(sched, "predict_seconds", None)
    if (cap_s is None or predict is None
        or not sched.deadline_traffic_active(now)):
      return sched.max_batch
    per = predict(key)
    if not (per > 0.0 and math.isfinite(per)):
      return sched.max_batch
    allowed = int(cap_s / per)
    if allowed <= 1:
      return 1
    return min(sched.max_batch, 1 << (allowed.bit_length() - 1))

  def on_batch(self, key, batch, sched) -> None:
    """Called with every non-empty batch the scheduler built — feedback for
    policies whose pick bookkeeping depends on who actually got served."""


class FifoPolicy(SchedulingPolicy):
  """Strict FIFO within a bucket; across buckets, oldest head first — the
  no-starvation default (a hot bucket cannot shadow a cold one)."""

  name = "fifo"


class DeadlinePolicy(SchedulingPolicy):
  """Earliest-feasible-deadline first, priority tiers breaking ties.

  Rank is ``(-priority, deadline_at)`` — higher ``priority`` wins, then the
  earlier absolute deadline; requests without a deadline rank last within
  their tier and stay FIFO among themselves.  At pick time the policy asks
  the scheduler's ``predict_seconds`` hook (the engine wires it to the cost
  table's per-request service prediction — a lower bound on the serving
  batch's duration, see ``MMOEngine.predict_request_seconds``) whether the
  head can still make its deadline; a hopeless head fails fast so the batch
  slot goes to a request that can.
  """

  name = "deadline"

  def request_rank(self, req, now: float) -> tuple:
    deadline = req.deadline_at if req.deadline_at is not None else math.inf
    return (-int(req.priority), deadline)

  def fail_fast(self, entry: QueueEntry, key, sched, now: float) -> bool:
    deadline = entry.req.deadline_at
    if deadline is None:
      return False
    predict = getattr(sched, "predict_seconds", None)
    service_s = predict(key) if predict is not None else 0.0
    return now + service_s > deadline


class FairSharePolicy(SchedulingPolicy):
  """Weighted round-robin across tenants.

  Each tenant keeps a FIFO of its queued requests; a pick serves the bucket
  holding the current tenant's oldest request, and the tenant keeps the turn
  for ``weights[tenant]`` consecutive picks (default 1) before it passes.
  Tenants with nothing queued are skipped without consuming credit.  Taken
  entries (batched along with another tenant's pick, or expired) are skipped
  lazily at the queue front.
  """

  name = "fair"

  def __init__(self, weights: Optional[dict] = None):
    super().__init__()
    self.weights = dict(weights or {})
    self._queues: dict = {}  # tenant → deque[(QueueEntry, BucketKey)]
    self._order: list = []   # tenant ring, insertion order; drained → removed
    self._idx = 0            # ring position that holds the turn
    self._credit = 0         # picks the turn-holder has left
    self._last_pick: Optional[str] = None  # tenant charged for the last pick

  def on_add(self, entry: QueueEntry, key, sched) -> None:
    tenant = entry.req.tenant
    q = self._queues.get(tenant)
    if q is None:
      q = self._queues[tenant] = collections.deque()
      self._order.append(tenant)
    q.append((entry, key))

  def pick(self, sched, now: float) -> Optional[tuple]:
    while self._order:
      if self._idx >= len(self._order):
        self._idx = 0
      tenant = self._order[self._idx]
      q = self._queues[tenant]
      while q:
        entry, key = q[0]
        # skip taken entries AND orphans (an entry whose bucket vanished
        # without the scheduler popping it — e.g. the bucket dict was
        # externally cleared); returning an orphan would livelock
        # next_batch, which can only retry the pick
        if entry.taken or not sched._buckets.get(key):
          q.popleft()
          continue
        break
      if not q:
        # tenant drained — drop it from the ring entirely (it re-registers
        # on its next submit): a long-lived engine seeing unbounded tenant
        # churn must not accrete empty queues or O(ever-seen) pick scans
        del self._queues[tenant]
        self._order.pop(self._idx)
        self._credit = 0
        continue
      if self._credit <= 0:
        self._credit = max(1, int(self.weights.get(tenant, 1)))
      self._credit -= 1
      self._last_pick = tenant
      if self._credit <= 0:
        self._idx += 1  # next pick offers the turn to the next tenant
        if self._idx >= len(self._order):
          self._idx = 0
      return q[0][1]
    return None

  def on_batch(self, key, batch, sched) -> None:
    """Refund the turn when it bought the tenant nothing: the picked
    bucket's batch pops in FIFO order, so a tenant whose oldest entry sits
    behind >= max_batch other-tenant requests can be charged for batches
    that serve none of its work.  Refunding the credit (and keeping the
    turn) means each such batch still drains the bucket toward the
    tenant's entry without costing its share."""
    tenant, self._last_pick = self._last_pick, None
    if tenant is None or any(r.tenant == tenant for r in batch):
      return
    if tenant in self._queues:
      try:
        self._idx = self._order.index(tenant)
      except ValueError:  # pragma: no cover — _queues/_order stay in sync
        return
      self._credit += 1


POLICIES = {"fifo": FifoPolicy, "deadline": DeadlinePolicy,
            "fair": FairSharePolicy}


def make_policy(policy) -> SchedulingPolicy:
  """'fifo' | 'deadline' | 'fair' | a SchedulingPolicy instance (pass-through;
  a policy instance holds queue state, so it must not be shared across
  schedulers)."""
  if isinstance(policy, SchedulingPolicy):
    return policy
  cls = POLICIES.get(policy)
  if cls is None:
    raise ValueError(f"unknown policy {policy!r}; one of "
                     f"{tuple(POLICIES)} or a SchedulingPolicy instance")
  return cls()
