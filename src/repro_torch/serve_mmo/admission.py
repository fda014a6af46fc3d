"""Admission control: bound what the engine accepts instead of queueing it.

Counterpart of ``repro/serve_mmo/admission.py``.

An unbounded queue turns overload into unbounded latency — every request is
eventually served, long after anyone wants its answer.  The controller gives
``MMOEngine.submit`` three independent reasons to return an already-failed
future (``RejectedError``) instead of queueing:

  max_queue      — global queued-request cap: the classic depth bound.
  tenant_quota   — per-tenant *in-flight* cap (queued + executing, until the
                   future resolves): one chatty tenant cannot monopolize the
                   queue however fast it submits.  An int applies to every
                   tenant; a dict maps tenant → cap (missing tenants are
                   uncapped).
  max_backlog_s  — predicted-backlog bound, in *seconds of work*: each
                   admitted request is charged its predicted service
                   seconds (``MMOEngine.predict_request_seconds`` — on a
                   static engine the cost table's per-contraction answer
                   times the bucket's worst-case contraction count; on an
                   ``adaptive=True`` engine the live EWMA over measured
                   batch latencies, with measured closure convergence
                   counts correcting the cold-start prior — see
                   serve_mmo/estimator.py), and a request that would push
                   the queue's total predicted drain time past the bound
                   is rejected.  Queue *length* is a poor overload signal
                   when buckets differ by orders of magnitude in service
                   time (a 256³ closure vs a 16³ mmo); seconds-of-work is
                   the quantity latency SLOs are actually made of.  The
                   charge is stamped on the request at admit time and
                   released verbatim when it leaves the queue, so the
                   accounting stays exact even while the live estimate
                   drifts.

All counters are maintained by the engine under its lock — the controller
itself is plain state + arithmetic and is not independently thread-safe.
"""
from __future__ import annotations

import collections
from typing import Optional, Union

__all__ = ["AdmissionController"]


class AdmissionController:
  """Decides admit/reject at submit time and tracks the load counters the
  decision reads (queued count, per-tenant in-flight, predicted backlog)."""

  def __init__(self, *, max_queue: Optional[int] = None,
               tenant_quota: Union[int, dict, None] = None,
               max_backlog_s: Optional[float] = None):
    if max_queue is not None and max_queue < 1:
      raise ValueError(f"max_queue must be >= 1, got {max_queue}")
    if max_backlog_s is not None and not max_backlog_s > 0.0:
      raise ValueError(f"max_backlog_s must be > 0, got {max_backlog_s}")
    self.max_queue = max_queue
    self.tenant_quota = tenant_quota
    self.max_backlog_s = max_backlog_s
    self.queued = 0                         # admitted, not yet batched
    self.backlog_s = 0.0                    # predicted seconds to drain queue
    self.inflight = collections.Counter()   # tenant → queued + executing
    self.rejections = collections.Counter() # reason kind → count
    self.evaluations = 0                    # try_admit calls (admit + reject)

  @property
  def unbounded(self) -> bool:
    """True when no limit is configured — every request admits (the
    engine's default; also lets submit skip the cost prediction)."""
    return (self.max_queue is None and self.tenant_quota is None
            and self.max_backlog_s is None)

  def _quota_for(self, tenant: str) -> Optional[int]:
    if isinstance(self.tenant_quota, dict):
      return self.tenant_quota.get(tenant)
    return self.tenant_quota

  # -- the decision -----------------------------------------------------------

  def try_admit(self, req, cost_s: float = 0.0) -> Optional[tuple]:
    """Admit ``req`` (returns None, counters charged, ``req.predicted_s``
    stamped) or reject it (returns a ``(kind, reason)`` pair — the short
    kind for metrics, the human-readable reason for the error; nothing
    charged)."""
    self.evaluations += 1
    if self.max_queue is not None and self.queued >= self.max_queue:
      self.rejections["queue_full"] += 1
      return ("queue_full", f"queue full: {self.queued} queued >= "
                            f"max_queue={self.max_queue}")
    quota = self._quota_for(req.tenant)
    if quota is not None and self.inflight[req.tenant] >= quota:
      self.rejections["tenant_quota"] += 1
      return ("tenant_quota", f"tenant {req.tenant!r} over quota: "
                              f"{self.inflight[req.tenant]} in flight >= "
                              f"{quota}")
    if (self.max_backlog_s is not None
        and self.backlog_s + cost_s > self.max_backlog_s):
      self.rejections["backlog"] += 1
      return ("backlog", f"predicted backlog {self.backlog_s + cost_s:.3f}s"
                         f" > max_backlog_s={self.max_backlog_s:g} "
                         f"(prediction: {req.predicted_source})")
    req.predicted_s = float(cost_s)
    self.queued += 1
    self.backlog_s += req.predicted_s
    self.inflight[req.tenant] += 1
    return None

  # -- lifecycle accounting (engine-lock-held) --------------------------------

  def on_dequeue(self, req) -> None:
    """The request left the queue (batched for execution, or expired)."""
    self.queued = max(0, self.queued - 1)
    self.backlog_s = max(0.0, self.backlog_s - req.predicted_s)

  def on_done(self, req) -> None:
    """The request's future resolved (fulfilled, failed, or expired) —
    release its tenant in-flight slot."""
    left = self.inflight[req.tenant] - 1
    if left > 0:
      self.inflight[req.tenant] = left
    else:
      del self.inflight[req.tenant]

  def snapshot(self) -> dict:
    return {
        "queued": self.queued,
        "backlog_s": self.backlog_s,
        "inflight": dict(self.inflight),
        "rejections": dict(self.rejections),
        "evaluations": self.evaluations,
        "limits": {"max_queue": self.max_queue,
                   "tenant_quota": (dict(self.tenant_quota)
                                    if isinstance(self.tenant_quota, dict)
                                    else self.tenant_quota),
                   "max_backlog_s": self.max_backlog_s},
    }
