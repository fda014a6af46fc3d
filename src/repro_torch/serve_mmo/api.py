"""Problem requests and result futures for the MMO serving engine.

Counterpart of ``repro/serve_mmo/api.py``.  A request carries host (numpy)
arrays plus the static metadata the scheduler buckets on — the same arrays
the reference's constructors take, so one seeded payload drives both
engines.  Constructors normalize each application family onto three
executable kinds:

  'mmo'      — one raw D = C ⊕ (A ⊗ B) instruction,
  'closure'  — a semiring fixed point (APSP, reachability, reliability, MST
               bottleneck paths, …) via Leyzorek or Bellman-Ford,
  'knn'      — addnorm distance matrix + top-k.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np

from repro_torch.core import closure as cl_mod
from repro_torch.core import semiring as sr_mod

KINDS = ("mmo", "closure", "knn")
ALGORITHMS = ("leyzorek", "bellman_ford")
DEFAULT_TENANT = "default"


class RejectedError(RuntimeError):
  """The engine refused the request at submit time (admission control:
  serve_mmo/admission.py); nothing was queued."""


class DeadlineExceededError(TimeoutError):
  """The request's deadline passed while it was queued, so the engine
  dropped it without executing."""


class NonFiniteResultError(RuntimeError):
  """A batch produced NaN in the listed request slots; those results never
  reach callers (±inf is legitimate tropical output and passes)."""

  def __init__(self, label: str, slots):
    self.slots = list(slots)
    super().__init__(f"NaN in result slots {self.slots} of batch {label}")


@dataclasses.dataclass
class ProblemRequest:
  """One serving request.  ``arrays`` are host operands; ``shape`` is the
  logical problem shape the scheduler buckets on; ``params`` are static
  extras that must match within a bucket (algorithm, k, …).  ``deadline_s``
  is a latency budget in seconds from submit; ``tenant`` and ``priority``
  are read by the QoS policies and admission."""

  kind: str
  op: str
  arrays: dict
  shape: tuple
  params: tuple = ()
  tenant: str = DEFAULT_TENANT
  priority: int = 0
  deadline_s: Optional[float] = None
  # engine bookkeeping (assigned at submit)
  request_id: int = -1
  arrival_s: float = 0.0
  deadline_at: Optional[float] = None  # absolute engine-clock deadline
  predicted_s: float = 0.0             # admission's per-request cost charge
  # where predicted_s came from: 'static' (cost table / roofline × worst-case
  # trips), 'iterations' (static × measured convergence counts), or 'ewma'
  # (live measured service latency) — see serve_mmo/estimator.py
  predicted_source: str = "static"

  def __post_init__(self):
    if self.kind not in KINDS:
      raise ValueError(f"kind must be one of {KINDS}, got {self.kind!r}")
    if self.deadline_s is not None and not self.deadline_s > 0.0:
      raise ValueError(f"deadline_s must be positive, got {self.deadline_s}")
    sr_mod.get(self.op)  # validates the mnemonic


@dataclasses.dataclass
class MMOResult:
  """Engine output for one request: ``value`` is the primary array (D, the
  closure matrix, or the KNN distances); ``extras`` holds secondaries
  (closure iteration count, KNN indices)."""

  value: np.ndarray
  extras: dict = dataclasses.field(default_factory=dict)


class MMOFuture:
  """Async handle returned by ``MMOEngine.submit``.

  ``result()`` blocks: with the engine's background loop running it waits
  on the completion event; otherwise it drives ``engine.step`` until this
  request's bucket is served.  States: 'pending', then 'done', 'failed',
  'rejected' or 'expired'; ``result()`` raises the matching error for the
  non-'done' ones.
  """

  def __init__(self, engine, request: ProblemRequest):
    self._engine = engine
    self.request = request
    self._event = threading.Event()
    self._result: Optional[MMOResult] = None
    self._error: Optional[BaseException] = None
    self._state = "pending"

  def _fulfill(self, result: MMOResult):
    self._result = result
    self._state = "done"
    self._event.set()

  def _fail(self, err: BaseException):
    self._error = err
    if isinstance(err, RejectedError):
      self._state = "rejected"
    elif isinstance(err, DeadlineExceededError):
      self._state = "expired"
    else:
      self._state = "failed"
    self._event.set()

  @property
  def state(self) -> str:
    return self._state

  def done(self) -> bool:
    return self._event.is_set()

  def result(self, timeout: Optional[float] = None) -> MMOResult:
    """A request the scheduler lost surfaces as a RuntimeError; only a
    genuinely elapsed ``timeout`` raises TimeoutError."""
    if not self._event.is_set():
      self._engine._drive(self, timeout)
    if not self._event.is_set():
      within = "the allotted time" if timeout is None else f"{timeout:g}s"
      raise TimeoutError(
          f"request {self.request.request_id} not done within {within}")
    if self._error is not None:
      raise self._error
    return self._result


# ---------------------------------------------------------------------------
# request constructors
# ---------------------------------------------------------------------------


def _as2d(x, name: str) -> np.ndarray:
  x = np.asarray(x)
  if x.ndim != 2:
    raise ValueError(f"{name} must be 2-D, got shape {x.shape}")
  return x


def mmo_request(a, b, c=None, *, op: str = "mma",
                tenant: str = DEFAULT_TENANT, priority: int = 0,
                deadline_s: Optional[float] = None) -> ProblemRequest:
  """Raw D = C ⊕ (A ⊗ B) instruction request."""
  a, b = _as2d(a, "a"), _as2d(b, "b")
  if a.shape[1] != b.shape[0]:
    raise ValueError(f"contraction mismatch: {a.shape} @ {b.shape}")
  arrays = {"a": a, "b": b}
  if c is not None:
    c = _as2d(c, "c")
    if c.shape != (a.shape[0], b.shape[1]):
      raise ValueError(f"C shape {c.shape} != ({a.shape[0]},{b.shape[1]})")
    arrays["c"] = c
  return ProblemRequest(
      kind="mmo", op=op, arrays=arrays,
      shape=(a.shape[0], a.shape[1], b.shape[1]),
      params=("c" in arrays,),
      tenant=tenant, priority=priority, deadline_s=deadline_s)


def closure_request(weights, *, op: str, algorithm: str = "leyzorek",
                    prepared: bool = False,
                    tenant: str = DEFAULT_TENANT, priority: int = 0,
                    deadline_s: Optional[float] = None) -> ProblemRequest:
  """Semiring fixed-point request (APSP, reliability paths, MST, …).

  ``weights`` uses the ring's graph conventions (core/closure.py); with
  ``prepared=False`` the diagonal self values are filled in here.
  """
  if algorithm not in ALGORITHMS:
    raise ValueError(f"algorithm must be one of {ALGORITHMS}")
  w = _as2d(weights, "weights")
  if w.shape[0] != w.shape[1]:
    raise ValueError(f"adjacency must be square, got {w.shape}")
  sr = sr_mod.get(op)
  if sr.boolean:
    w = w.astype(bool)
  if not prepared:
    _, self_value = cl_mod.closure_pad_values(op)
    w = w.copy()
    np.fill_diagonal(w, True if sr.boolean else self_value)
  return ProblemRequest(kind="closure", op=op, arrays={"adj": w},
                        shape=(w.shape[0],), params=(algorithm,),
                        tenant=tenant, priority=priority,
                        deadline_s=deadline_s)


def apsp_request(weights, **kw) -> ProblemRequest:
  """All-pairs shortest paths: weights > 0, +inf where no edge."""
  return closure_request(weights, op="minplus", **kw)


def reachability_request(adj, **kw) -> ProblemRequest:
  """Transitive & reflexive closure of a boolean adjacency."""
  return closure_request(adj, op="orand", **kw)


def knn_request(queries, corpus, *, k: int,
                tenant: str = DEFAULT_TENANT, priority: int = 0,
                deadline_s: Optional[float] = None) -> ProblemRequest:
  """K-nearest corpus points per query (squared-L2, ascending)."""
  q, r = _as2d(queries, "queries"), _as2d(corpus, "corpus")
  if q.shape[1] != r.shape[1]:
    raise ValueError(f"dim mismatch: queries {q.shape} vs corpus {r.shape}")
  if not 0 < k <= r.shape[0]:
    raise ValueError(f"k={k} must be in [1, corpus rows={r.shape[0]}]")
  return ProblemRequest(kind="knn", op="addnorm",
                        arrays={"queries": q, "corpus": r},
                        shape=(q.shape[0], r.shape[0], q.shape[1]),
                        params=(k,),
                        tenant=tenant, priority=priority,
                        deadline_s=deadline_s)
