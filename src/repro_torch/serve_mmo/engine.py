"""The MMO serving engine: micro-batching over shape buckets, with QoS,
recovery and telemetry.

Counterpart of ``repro/serve_mmo/engine.py``, in both modes:
``mode="batch"`` serves each bucket batch to completion, and
``mode="arena"`` serves closure buckets from a device-resident slot buffer
(serve_mmo/arena.py) that admits requests between fused K2 ticks, while
other buckets still batch.  One engine owns a policy-driven bucket
scheduler (FIFO, deadline or fair share: serve_mmo/policy.py), an
admission controller (``max_queue`` / ``tenant_quota`` / ``max_backlog_s``:
serve_mmo/admission.py), a live metrics registry (``metrics_snapshot()``
works mid-run from any thread: serve_mmo/metrics.py), the service-time
estimator (serve_mmo/estimator.py), a flight recorder
(serve_mmo/observability.py), per-arm circuit breakers
(serve_mmo/resilience.py), an executable cache and the request
bookkeeping; it runs on one device (``device="cuda"`` by default, which
raises without a card), or with a ``mesh`` shards big buckets over it.
Two ways to run it:

  * synchronous — ``submit()`` then ``step()`` / ``run_until_idle()`` (or
    just ``future.result()``, which drives steps lazily);
  * background loop — ``start()`` spawns a serving thread that batches
    whatever is queued as fast as it drains; ``submit()`` is then fully
    async and ``future.result()`` blocks on the completion event.

Batches execute outside the queue lock, so a long closure batch never
blocks concurrent ``submit`` calls.  A failed batch does not fail every
co-batched request: the recovery driver retries it (``transient_retries``,
exponential backoff from ``retry_backoff_s``), then bisects it
(``bisect=True``), so one poisoned request fails alone while its siblings
complete.  Breakers re-dispatch a persistently failing arm's traffic to
its siblings, and ``watchdog_s`` bounds a batch's device run.  A failed
arena tick keeps its slots resident under the same retry budget; once the
budget is spent, every resident fails and the arena resets.  Results are
NaN-validated before any future is fulfilled (±inf is legitimate tropical
output).  ``faults`` takes a ``FaultInjector`` (serve_mmo/faults.py) that
drives each of these paths on the real code.

``backend="auto"`` resolves each bucket's arm and block config from the
cost table (``cost_table=``, else the process-global table: see
repro_torch.tuning.dispatch); closure buckets choose among
``CLOSURE_BACKENDS``, the fused arm included.  Every QoS feature reads one
number, the predicted seconds per request (``predict_request_seconds``):
the static per-contraction cost from the table or the H100 prior times the
bucket's trip count, or with ``adaptive=True`` the estimator's live EWMA
of measured service.  The first run of each batch function is kept out of
that EWMA (on a card it pays CUDA's lazy module load).

With a ``mesh`` (``launch.mesh.Mesh``), a second routing layer places each
bucket: a bucket whose per-request contraction reaches ``shard_flops``
runs as a batched distributed schedule over the mesh
(``core.distributed``: dp, kspan, SUMMA or ring, each shard's contraction
on the bucket's backend), smaller ones stay on ``device``.
``schedule="auto"`` picks the schedule from the cost table's mesh rows (the
sharded prior where they are unmeasured); a schedule name pins it.  The
(schedule, mesh) placement is part of the executable-cache key and of the
arm that breakers, the estimator, the flight recorder and the Prometheus
labels name.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import stamps as stage_hook
from repro_torch.core.mmo import BACKENDS
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.serve_mmo import batching
from repro_torch.serve_mmo.admission import AdmissionController
from repro_torch.serve_mmo.api import (DeadlineExceededError, MMOFuture,
                                       MMOResult, ProblemRequest,
                                       RejectedError)
from repro_torch.serve_mmo.arena import (DEFAULT_ARENA_G, DEFAULT_CAPACITY,
                                         RequestArena)
from repro_torch.serve_mmo.cache import ExecutableCache
from repro_torch.serve_mmo.estimator import Estimate, ServiceEstimator
from repro_torch.serve_mmo.faults import (ARM_FAILURE_KINDS,
                                          BatchTimeoutError, InjectedFault,
                                          NonFiniteResultError,
                                          classify_failure)
from repro_torch.serve_mmo.metrics import ServeMetrics, bucket_label
from repro_torch.serve_mmo.observability import (DEFAULT_TRACE_CAPACITY,
                                                 BatchStamps, FlightRecorder)
from repro_torch.serve_mmo.resilience import ResilienceManager
from repro_torch.serve_mmo.scheduler import (BucketScheduler, MIN_BUCKET,
                                             bucket_dim, contract_shape,
                                             request_bucket)

# the engine-wide backends: the per-contraction arms, the fused fixpoint
# arm, which serves closure buckets (others take 'pallas'), and 'auto'
ENGINE_BACKENDS = BACKENDS + ("megakernel", "auto")
MODES = ("batch", "arena")
# the schedule of a bucket that runs on the engine's own device
_LOCAL = "local"
# the arena's arm for breaker and estimator accounting: one per closure
# bucket, never re-dispatched (per-slot state isolates a poisoned request)
_ARENA = "arena"
_ARENA_ARM = (_ARENA, (), _LOCAL)


def _to_numpy(x) -> np.ndarray:
  return x.detach().cpu().numpy()


def _outputs_to_numpy(out):
  """The device-to-host copy of a batch's outputs: one synchronisation
  per output."""
  if isinstance(out, (tuple, list)):
    return tuple(_to_numpy(x) for x in out)
  return _to_numpy(out)


@dataclasses.dataclass
class RequestRecord:
  request_id: int
  kind: str
  op: str
  bucket: tuple
  batch_size: int
  arrival_s: float
  scheduled_s: float
  completed_s: float

  @property
  def latency_s(self) -> float:
    return self.completed_s - self.arrival_s


@dataclasses.dataclass
class EngineStats:
  completed: int
  batches: int
  mean_batch: float
  latencies_s: np.ndarray
  cache: dict
  rejected: int = 0
  expired: int = 0

  def percentile(self, q: float) -> float:
    if len(self.latencies_s) == 0:
      return float("nan")
    return float(np.percentile(self.latencies_s, q))

  def summary(self) -> str:
    if len(self.latencies_s):
      lat = (f"p50={self.percentile(50) * 1e3:.1f}ms "
             f"p99={self.percentile(99) * 1e3:.1f}ms")
    else:
      lat = "p50=n/a p99=n/a"
    return (f"completed={self.completed} batches={self.batches} "
            f"mean_batch={self.mean_batch:.2f} {lat} "
            f"rejected={self.rejected} expired={self.expired} "
            f"cache_hits={self.cache['hits']} "
            f"cache_misses={self.cache['misses']}")


class MMOEngine:
  """Serving engine for semiring problem requests (see api.py).

  ``backend`` is one of ``ENGINE_BACKENDS`` ('pallas' — the SIMD² unit
  kernel — by default; 'megakernel' runs closure buckets through the fused
  fixpoint K2 and every other bucket through 'pallas'; 'auto' resolves
  backend and block config per bucket from the cost table, memoized per
  bucket and baked into the executable-cache key).  ``max_batch`` bounds a
  batch and ``min_bucket`` floors the padded shape.  ``clock`` injects a
  monotonic time source for arrival/deadline/metrics bookkeeping.

  QoS: ``policy`` is 'fifo' (the default), 'deadline', 'fair' or a
  SchedulingPolicy instance; ``max_queue`` / ``tenant_quota`` /
  ``max_backlog_s`` configure admission (all None admits everything), or
  ``admission`` passes a controller.  Requests carrying ``deadline_s`` that
  are still queued past their deadline fail with ``DeadlineExceededError``
  under every policy.  ``adaptive=True`` answers the per-request prediction
  from the estimator (``estimator=`` to pass one); ``max_batch_seconds``
  caps bulk batches to about that many predicted seconds while deadline
  traffic is active (``deadline_lookback_s`` after the last one).
  ``metrics_window`` sizes the rolling latency windows.

  ``mesh`` (a ``launch.mesh.Mesh`` of the engine's device type),
  ``schedule`` ('auto', 'local' or one of ``core.distributed.SCHEDULES``)
  and ``shard_flops`` (the per-request contraction FLOPs from which a
  bucket may go to the mesh) configure sharded serving; see the module
  docstring.  A pinned schedule needs a mesh.

  ``mode="arena"`` serves closure buckets from one ``RequestArena`` each
  (``arena_capacity`` slots, ``arena_g`` fused iterations per tick): queued
  closure requests enter free slots the moment they reach the queue head,
  every live slot advances one K2 launch per step, and each request
  completes when its slot converges — whatever the arm ``backend`` names.

  Telemetry: ``trace`` (on by default) stamps request-lifecycle spans and
  each batch's stages (observability.py; the device stages from a pool of
  ``BatchStamps`` whose CUDA events are reused) into a ``FlightRecorder``
  of ``trace_capacity`` events (or ``tracer=``) and the stage histograms
  of the metrics; ``export_trace()`` returns Chrome trace-event JSON and
  ``observability_state()`` the document ``render_prometheus`` and the
  HTTP endpoint serve.

  Recovery: ``transient_retries`` whole-batch retries (``retry_backoff_s``
  doubling per attempt), then bisection (``bisect``); per-(bucket, arm)
  breakers open after ``breaker_threshold`` consecutive failures (None
  disables them) and probe after ``breaker_probe_s`` on the engine clock;
  traffic of an open arm moves to ``fallback_backends`` (default: 'xla' and
  'pallas' ranked by the cost table, then 'vector'); ``resilience`` passes
  a manager.  ``watchdog_s`` fails a batch whose device run (launches and
  the device-to-host copy that waits for them) outlasts it; the abandoned
  work still runs on the stream (``join_abandoned``).  ``faults`` takes a
  ``FaultInjector``.
  """

  def __init__(self, *, backend: str = "pallas", max_batch: int = 8,
               min_bucket: int = MIN_BUCKET, device=DEFAULT_DEVICE,
               cost_table=None, mesh=None, schedule: str = "auto",
               shard_flops: float = 1e8, policy="fifo",
               max_queue: Optional[int] = None, tenant_quota=None,
               max_backlog_s: Optional[float] = None,
               admission: Optional[AdmissionController] = None,
               clock=None, metrics_window: int = 512,
               adaptive: bool = False,
               estimator: Optional[ServiceEstimator] = None,
               max_batch_seconds: Optional[float] = None,
               deadline_lookback_s: Optional[float] = None,
               trace: bool = True,
               trace_capacity: int = DEFAULT_TRACE_CAPACITY,
               tracer: Optional[FlightRecorder] = None,
               faults=None, transient_retries: int = 1,
               retry_backoff_s: float = 0.002, bisect: bool = True,
               breaker_threshold: Optional[int] = 5,
               breaker_probe_s: float = 0.25,
               watchdog_s: Optional[float] = None,
               validate_results: bool = True,
               fallback_backends=None,
               resilience: Optional[ResilienceManager] = None,
               mode: str = "batch", arena_capacity: int = DEFAULT_CAPACITY,
               arena_g: int = DEFAULT_ARENA_G):
    from repro_torch.core import distributed as dist
    valid_schedules = ("auto", _LOCAL) + dist.SCHEDULES
    if schedule not in valid_schedules:
      raise ValueError(f"unknown schedule {schedule!r}; one of "
                       f"{valid_schedules}")
    if mesh is None and schedule not in ("auto", _LOCAL):
      raise ValueError(f"schedule {schedule!r} needs a mesh")
    if mode not in MODES:
      raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if backend not in ENGINE_BACKENDS:
      raise ValueError(f"unknown backend {backend!r}; one of "
                       f"{ENGINE_BACKENDS}")
    if arena_capacity < 1 or arena_g < 1:
      raise ValueError(f"arena_capacity and arena_g must be >= 1, got "
                       f"{arena_capacity} and {arena_g}")
    self.device = resolve_device(device)
    if mesh is not None and mesh.device_type != self.device.type:
      raise ValueError(f"a mesh of {mesh.device_type} devices cannot serve "
                       f"an engine on {self.device}")
    self.mesh = mesh
    self.schedule = schedule
    self.shard_flops = float(shard_flops)
    self._mesh_sig = None if mesh is None else tuple(
        (a, int(mesh.shape[a])) for a in mesh.axis_names)
    self._schedules: dict = {}  # BucketKey → 'local' | a mesh schedule
    self.backend = backend
    self.cost_table = cost_table
    self.mode = mode
    self.arena_capacity = int(arena_capacity)
    self.arena_g = int(arena_g)
    self.validate_results = bool(validate_results)
    self._clock = clock if clock is not None else time.perf_counter
    self._decisions: dict = {}  # BucketKey → (backend, block cfg)
    self._static_cost: dict = {}  # BucketKey → (contraction s, worst trips)
    self.adaptive = bool(adaptive)
    self.estimator = estimator if estimator is not None else ServiceEstimator()
    self.scheduler = BucketScheduler(policy=policy, min_bucket=min_bucket,
                                     max_batch=max_batch, clock=self._clock,
                                     max_batch_seconds=max_batch_seconds,
                                     deadline_lookback_s=deadline_lookback_s)
    self.scheduler.predict_seconds = self.predict_request_seconds
    if admission is None:
      admission = AdmissionController(max_queue=max_queue,
                                      tenant_quota=tenant_quota,
                                      max_backlog_s=max_backlog_s)
    self.admission = admission
    self.metrics = ServeMetrics(clock=self._clock, window=metrics_window)
    self.tracer = tracer if tracer is not None else FlightRecorder(
        capacity=trace_capacity, clock=self._clock, enabled=trace)
    self.cache = ExecutableCache()
    if transient_retries < 0:
      raise ValueError(f"transient_retries must be >= 0, "
                       f"got {transient_retries}")
    self.faults = faults
    self.transient_retries = int(transient_retries)
    self.retry_backoff_s = float(retry_backoff_s)
    self.bisect = bool(bisect)
    self.watchdog_s = None if watchdog_s is None else float(watchdog_s)
    self.fallback_backends = (None if fallback_backends is None
                              else tuple(fallback_backends))
    if resilience is None:
      resilience = ResilienceManager(threshold=breaker_threshold,
                                     probe_after_s=breaker_probe_s,
                                     clock=self._clock)
    self.resilience = resilience
    self._fallback_arms_memo: dict = {}  # BucketKey → tuple of arms
    self._abandoned: list = []  # watchdog workers of timed-out batches
    # stage stamps free for the next batch; a timed-out batch's set stays
    # with its abandoned worker
    self._stamp_pool: list = []
    # (bucket, size, pick time) of the batch last picked: what an expiry
    # in the queue waited behind
    self._in_service: Optional[tuple] = None
    self._lock = threading.RLock()
    self._work = threading.Condition(self._lock)
    self._idle = threading.Condition(self._lock)  # signaled: _pending empty
    self._records: list[RequestRecord] = []
    self._batches = 0
    self._rejected = 0
    self._expired = 0
    self._next_id = 0
    self._pending: dict[int, MMOFuture] = {}
    self._inflight: set[int] = set()  # popped from the queue, executing now
    self._arenas: dict = {}  # closure BucketKey → RequestArena
    self._arenas_ticked: set = set()  # arenas past their first (cold) tick
    self._arena_cold: set = set()  # request ids resident in a cold tick
    self._arena_failures: dict = {}  # closure BucketKey → failed ticks in a row
    self._thread: Optional[threading.Thread] = None
    self._running = False
    self._stopped = False  # stop() was called; submit refuses until start()

  # -- prediction --------------------------------------------------------------

  @staticmethod
  def _iteration_factor(key) -> float:
    """Contractions one request in this bucket runs: 1 for mmo/knn, the
    solver's worst-case trip count for closures (Leyzorek squares ~lg(nb)
    times, Bellman-Ford relaxes up to nb−1 times).  A cost-table row is one
    contraction; service predictions scale by this."""
    if key.kind != "closure":
      return 1.0
    (nb,) = key.shape
    (algorithm,) = key.params
    if algorithm == "bellman_ford":
      return float(max(1, nb - 1))
    return float(max(1, math.ceil(math.log2(nb))))

  def _static_point(self, key) -> tuple:
    """(per-contraction seconds, worst-case trips) for one bucket — the
    static prior the adaptive path corrects: ``tuning.dispatch.
    contraction_seconds`` (a measured table row when someone measured the
    point, else the H100 prior), memoized per bucket under the engine
    lock."""
    with self._lock:
      memo = self._static_cost.get(key)
      if memo is None:
        from repro_torch.tuning import dispatch as _dispatch
        m, k, n = contract_shape(key)
        # arena-mode closure buckets run on the arena arm, so their prior
        # prices slot-seconds there; the fused arm serves only closures
        backend = self.backend
        if self.mode == "arena" and key.kind == "closure":
          backend = _ARENA
        elif backend == "megakernel" and key.kind != "closure":
          backend = "pallas"
        _, _, s = _dispatch.contraction_seconds(
            key.op, m, k, n, key.dtypes[0], backend=backend,
            table=self.cost_table)
        memo = (s, self._iteration_factor(key))
        self._static_cost[key] = memo
      return memo

  def predict_request(self, key) -> Estimate:
    """Predicted service seconds for ONE request of this bucket, with its
    provenance.  Batch compute scales with occupied slots, so this is also
    the request's share of a batch and of the queue's backlog: what the
    deadline policy's feasibility check, backlog admission and the batch
    cap consume.  Non-adaptive engines answer the static prediction
    (per-contraction cost × worst-case trips); adaptive ones ask the
    estimator (warm EWMA, then static × measured iterations, then
    static)."""
    contraction_s, trips = self._static_point(key)
    if not self.adaptive:
      return Estimate(contraction_s * trips, "static")
    if self.mode == "arena" and key.kind == "closure":
      return self.estimator.predict(key, _ARENA, _LOCAL, contraction_s,
                                    trips)
    with self._lock:
      backend, _ = self.resolve_backend(key)
      schedule = self.resolve_schedule(key)
    return self.estimator.predict(key, backend, schedule, contraction_s,
                                  trips)

  def predict_request_seconds(self, key) -> float:
    """``predict_request`` without the provenance: the scheduler hook."""
    return self.predict_request(key).seconds

  # -- submission ------------------------------------------------------------

  def submit(self, req: ProblemRequest) -> MMOFuture:
    """Queue one request; returns its future.  Admission may refuse: the
    future then arrives already failed with ``RejectedError`` (state
    'rejected') and nothing was queued.  Raises RuntimeError after
    ``stop()`` until ``start()`` is called again."""
    fut = MMOFuture(self, req)
    with self._work:
      if self._stopped:
        raise RuntimeError(
            "submit() on a stopped engine: stop() shut the serving loop "
            "down; call start() to resume accepting requests")
      req.request_id = self._next_id
      self._next_id += 1
      req.arrival_s = self._clock()
      if req.deadline_s is not None and req.deadline_at is None:
        req.deadline_at = req.arrival_s + float(req.deadline_s)
      cost = 0.0
      if self.admission.max_backlog_s is not None:
        est = self.predict_request(
            request_bucket(req, self.scheduler.min_bucket))
        cost = est.seconds
        req.predicted_source = est.source
      verdict = self.admission.try_admit(req, cost_s=cost)
      if verdict is not None:
        kind, reason = verdict
        self._rejected += 1
        self.metrics.on_reject(kind)
        self.tracer.request_rejected(req.request_id, kind, kind=req.kind,
                                     op=req.op, tenant=req.tenant,
                                     t_s=req.arrival_s)
        fut._fail(RejectedError(
            f"request {req.request_id} ({req.kind}/{req.op}) rejected: "
            f"{reason}"))
        return fut
      self.metrics.on_submit()
      self.tracer.request_begin(req.request_id, kind=req.kind, op=req.op,
                                tenant=req.tenant, t_s=req.arrival_s)
      self.scheduler.add(req)
      self._pending[req.request_id] = fut
      self._work.notify()
    return fut

  def pending(self) -> int:
    with self._lock:
      return len(self._pending)

  # -- execution -------------------------------------------------------------

  @staticmethod
  def _batch_bucket(r: int) -> int:
    """Round the batch size up to a power of two: the request axis is
    bucketed like the problem axes, so one bucket spawns at most
    log2(max_batch)+1 executables instead of one per arrival count."""
    return bucket_dim(r, 1)

  def resolve_backend(self, key) -> tuple:
    """(backend, block cfg) for one bucket — the dispatch decision.

    Memoized: the first resolution a bucket gets is the one it keeps for
    the engine's lifetime (stable executable-cache keys).  The whole
    check-resolve-memoize sequence holds the engine lock, so ``prewarm`` on
    a caller thread and ``step`` on the serving loop cannot memoize two
    decisions for one bucket.  Under 'auto', closure buckets choose among
    ``CLOSURE_BACKENDS`` (the fused arm included) and other buckets among
    the per-contraction arms; the fused arm serves closure buckets only,
    so under 'megakernel' the others take the kernel arm.
    """
    with self._lock:
      dec = self._decisions.get(key)
      if dec is None:
        if self.backend == "auto":
          from repro_torch.tuning import dispatch as _dispatch
          m, k, n = contract_shape(key)
          pool = (_dispatch.CLOSURE_BACKENDS if key.kind == "closure"
                  else None)
          d = _dispatch.resolve(key.op, m, k, n, key.dtypes[0],
                                table=self.cost_table, backends=pool)
          # K1 chooses its own tile: a 'pallas' row's cfg does not apply
          dec = (d.backend, () if d.backend == "pallas" else d.cfg)
        elif self.backend == "megakernel" and key.kind != "closure":
          dec = ("pallas", ())
        else:
          dec = (self.backend, ())
        self._decisions[key] = dec
      return dec

  def resolve_schedule(self, key) -> str:
    """Mesh placement for one bucket: 'local' or a schedule name.
    Memoized under the engine lock like ``resolve_backend`` (stable cache
    keys); without a mesh every bucket is 'local'."""
    with self._lock:
      sched = self._schedules.get(key)
      if sched is None:
        sched = self._route(key)
        self._schedules[key] = sched
      return sched

  def _route(self, key) -> str:
    """The size-threshold router: a bucket whose per-request contraction is
    below ``shard_flops`` stays local.  Above it, a pinned ``schedule``
    runs where it divides onto the mesh; ``"auto"`` asks the cost table's
    mesh rows (the sharded prior where unmeasured) whether a schedule beats
    the local arm.  Closure buckets consider only dp (one independent
    fixpoint per shard) and SUMMA (the contraction schedule whose iterate
    stays sharded in place)."""
    if self.mesh is None or self.schedule == _LOCAL:
      return _LOCAL
    m, k, n = contract_shape(key)
    if 2.0 * m * k * n < self.shard_flops:
      return _LOCAL
    from repro_torch.core import distributed as dist
    fits = [s for s in dist.SCHEDULES
            if dist.schedule_fits(s, m, k, n, self.mesh)]
    if key.kind == "closure":
      fits = [s for s in fits if s in ("dp", "summa")]
    if self.schedule != "auto":
      return self.schedule if self.schedule in fits else _LOCAL
    if not fits:
      return _LOCAL
    from repro_torch.tuning import dispatch as _dispatch
    mesh_dims = tuple(s for _, s in self._mesh_sig)
    d = _dispatch.resolve(key.op, m, k, n, key.dtypes[0],
                          table=self.cost_table, mesh_shape=mesh_dims,
                          schedules=tuple(fits))
    return d.backend if d.backend in fits else _LOCAL

  def resolve_placement(self, key, rb: Optional[int] = None) -> tuple:
    """(backend, block cfg, schedule): the bucket's primary arm.  The
    backend doubles as each shard's contraction when the bucket goes to the
    mesh.  With ``rb`` (the padded batch size), dp falls back to 'local'
    for a batch that does not divide over the mesh's shards; rb is part of
    the executable-cache key, so the refinement is deterministic."""
    backend, block = self.resolve_backend(key)
    schedule = self.resolve_schedule(key)
    if schedule == "dp" and rb is not None and rb % self.mesh.size:
      schedule = _LOCAL
    return backend, block, schedule

  def _exec_key(self, key, rb: int, backend: str, block: tuple,
                schedule: str) -> tuple:
    """Executable-cache key: the placement is in it, so a bucket's sharded
    and local functions (or those of two meshes) never collide."""
    return (key, rb, backend, block, schedule,
            None if schedule == _LOCAL else self._mesh_sig)

  def _expire_locked(self, reqs) -> None:
    """Fail requests whose deadline passed while queued, or that the policy
    failed fast as hopeless.  Engine lock held.  The trace's ``queued`` end
    says how long each waited and which batch was in service (the last one
    picked: between batches, the one that just ended), with its pick
    time."""
    self._expired += len(reqs)
    args = None
    if self.tracer.enabled:
      now = self._clock()
      args = {}
      if self._in_service is not None:
        key, size, start_s = self._in_service
        args["in_service"] = {"bucket": bucket_label(key), "batch": size,
                              "start_s": start_s}
    for r in reqs:
      self.admission.on_dequeue(r)
      self.admission.on_done(r)
      self.metrics.on_expire(request_bucket(r, self.scheduler.min_bucket))
      if args is not None:
        args["waited_ms"] = (now - r.arrival_s) * 1e3
        self.tracer.request_end(r.request_id, "expired", executing=False,
                                args=args)
      fut = self._pending.pop(r.request_id, None)
      if fut is not None:
        fut._fail(DeadlineExceededError(
            f"request {r.request_id} ({r.kind}/{r.op}) missed its "
            f"{r.deadline_s:g}s deadline while queued"))
    if not self._pending:
      self._idle.notify_all()

  def step(self) -> int:
    """Serve one engine step; returns #requests completed.  Batch mode
    schedules + executes one bucket batch.  Arena mode admits queued
    closure requests into free slots, runs one batch step when the queue
    head is not closure traffic, then ticks every live arena and completes
    its evictions."""
    if self.mode == "arena":
      return self._step_arena()
    return self._step_batch()

  def _step_batch(self) -> int:
    """Schedule + execute one bucket batch; returns #requests completed.
    Requests whose deadline lapsed in the queue are failed here without
    costing a batch slot."""
    with self._lock:
      now = self._clock()
      picked = self.scheduler.next_batch(now=now)
      expired = self.scheduler.take_expired()
      if expired:
        self._expire_locked(expired)
      if picked is None:
        return 0
      key, reqs = picked
      for r in reqs:
        self.admission.on_dequeue(r)
      self._inflight.update(r.request_id for r in reqs)
      self._in_service = (key, len(reqs), now)
    scheduled_s = self._clock()
    try:
      return self._serve_batch(key, reqs, scheduled_s)
    except Exception as e:  # noqa: BLE001 — a fault in the recovery loop itself
      # must not leak in-flight requests (their futures would never end)
      with self._lock:
        leaked = [r for r in reqs if r.request_id in self._inflight]
      self._fail_requests(key, leaked, e)
      self.tracer.instant("batch_fail", cat="batch",
                          args={"bucket": bucket_label(key),
                                "error": type(e).__name__})
      return 0

  def _fail_requests(self, key, reqs, exc) -> None:
    """Terminally fail ``reqs`` with ``exc``: the once-per-request final
    accounting (inflight, admission, metrics, future).  The caller emits
    the trace events."""
    with self._lock:
      for r in reqs:
        self._inflight.discard(r.request_id)
        self._arena_cold.discard(r.request_id)
        self.admission.on_done(r)
        self.metrics.on_fail(key)
        fut = self._pending.pop(r.request_id, None)
        if fut is not None:
          fut._fail(exc)
      if not self._pending:
        self._idle.notify_all()

  def _serve_batch(self, key, reqs, scheduled_s: float) -> int:
    """The recovery driver: execute the picked batch, isolating failures by
    bounded retry + bisection so innocent co-batched requests complete.

    A LIFO stack of (sub-batch, retries left, attempt index) starts with
    the whole batch.  A failed sub-batch is retried whole under its
    ``transient_retries`` budget (exponential backoff); once the budget is
    spent it is bisected and each half re-enters the stack with a fresh
    budget.  A single poisoned request in a batch of B costs O(log B)
    extra launches, and attempts are bounded by (retries+1)·(2B−1).  Each
    sub-batch is re-bucketed to its own power of two, so bisection hits
    functions ``prewarm`` built.

    Final outcomes are accounted once per request, failure kinds, breaker
    transitions and phase spans once per attempt, and measured iterations
    from the first fixpoint that ran each request only (``observed``).
    Returns #requests completed."""
    label = bucket_label(key)
    observed: set = set()   # rids whose measured iterations were recorded
    stack = [(list(reqs), self.transient_retries, 0)]
    completed = 0
    while stack:
      sub, retries_left, attempt = stack.pop()
      if attempt > 0 and self.tracer.enabled:
        # a fresh execute slice per retried/bisected attempt — the failed
        # attempt closed the previous one with outcome 'retried'
        self.tracer.batch_attempt_begin([r.request_id for r in sub])
      try:
        results, info = self._attempt(
            key, sub, observed, scheduled_s if attempt == 0 else None)
      except Exception as e:  # noqa: BLE001 — classified + counted in _attempt
        will_retry = retries_left > 0
        will_bisect = not will_retry and self.bisect and len(sub) > 1
        if self.tracer.enabled:
          self.tracer.batch_attempt_fail(
              [r.request_id for r in sub],
              outcome="retried" if (will_retry or will_bisect) else "failed",
              picked_t_s=scheduled_s if attempt == 0 else None,
              args={"error": type(e).__name__})
        if will_retry:
          self.metrics.on_retry()
          backoff = self.retry_backoff_s * (2.0 ** min(attempt, 3))
          if backoff > 0.0:
            time.sleep(backoff)
          stack.append((sub, retries_left - 1, attempt + 1))
        elif will_bisect:
          mid = len(sub) // 2
          self.metrics.on_retry(2)
          if self.tracer.enabled:
            self.tracer.instant(
                "batch_bisect", cat="resilience",
                args={"bucket": label, "batch": len(sub),
                      "halves": [mid, len(sub) - mid],
                      "error": type(e).__name__})
          # each half gets the full transient budget, and the left half
          # runs first (LIFO)
          stack.append((sub[mid:], self.transient_retries, attempt + 1))
          stack.append((sub[:mid], self.transient_retries, attempt + 1))
        else:
          self._fail_requests(key, sub, e)
          self.tracer.instant("batch_fail", cat="batch",
                              args={"bucket": label, "batch": len(sub),
                                    "error": type(e).__name__})
        continue
      completed += self._complete_sub(key, sub, results, info, scheduled_s,
                                      emit_pick=attempt == 0)
    return completed

  def _trace_transition(self, transition, label: str, arm,
                        kind: Optional[str] = None) -> None:
    """A breaker opened or closed: one instant in the flight recorder."""
    if not self.tracer.enabled or transition not in ("open", "close"):
      return
    args = {"bucket": label, "backend": arm[0], "schedule": arm[2]}
    if transition == "open":
      args["kind"] = kind
    self.tracer.instant(f"breaker_{transition}", cat="resilience", args=args)

  def _attempt(self, key, reqs, observed: set, start_s: Optional[float]):
    """Execute one sub-batch once on the best arm available now.  Returns
    (results, info dict); raises the failure otherwise, classified, counted
    and fed to the arm's breaker.  ``start_s`` is the batch's pick time for
    the first attempt; retries stamp their own start.

    The watched device run holds the host-to-device copy, the launches and
    the device-to-host copy that waits for them: launches return before
    the kernels end, so a watchdog around the launches alone would never
    see a slow kernel.

    While the engine traces, a ``BatchStamps`` from the pool stamps each
    stage where it runs: the device stages' boundaries in the watched run
    (its fixpoint syncs and KNN selection through the ``core.stamps`` hook,
    installed in the thread that runs the batch function), the host stages
    around them.  It adds no synchronisation: the events' times are read
    after the output copies returned."""
    label = bucket_label(key)
    rids = [r.request_id for r in reqs]
    rb = self._batch_bucket(len(reqs))
    arm, probe = self.resilience.pick(key, self.resolve_placement(key, rb),
                                      lambda: self._fallback_arms(key))
    backend, block, schedule = arm
    if self.tracer.enabled and probe:
      self.tracer.instant("breaker_probe", cat="resilience",
                          args={"bucket": label, "backend": backend,
                                "schedule": schedule})
    faults = self.faults
    attempt_s = self._clock() if start_s is None else start_s
    stamps = self._take_stamps() if self.tracer.enabled else None
    phase = "stack"
    try:
      # fill the padded batch slots with copies of the last request — wasted
      # compute bounded at 2×, in exchange for a bounded executable set
      t0 = self._clock()
      stacked = batching.stack_batch(key, reqs + [reqs[-1]] * (rb - len(reqs)))
      h2d_bytes = sum(int(x.nbytes) for x in stacked)
      stacked_s = self._clock()
      if stamps is not None:
        stamps.span("stack", t0, stacked_s)
      phase = "compile"
      if faults is not None and faults.check("compile", label=label,
                                             backend=backend,
                                             request_ids=rids):
        # raised before the cache is consulted: an injected build failure
        # never leaves a broken entry behind
        raise InjectedFault("compile", label)
      misses_before = self.cache.misses
      exec_key = self._exec_key(key, rb, backend, block, schedule)
      compiled = self.cache.get_or_compile(
          exec_key,
          lambda: batching.make_batch_fn(key, backend=backend, block=block,
                                         device=self.device, mesh=self.mesh,
                                         schedule=schedule),
          stacked)
      cache_hit = self.cache.misses == misses_before
      # service observations start after the build, as the reference's
      # start after compiling
      executed_s = self._clock()
      phase = "execute"
      exec_fault = slow_rule = None
      if faults is not None:
        exec_fault = faults.check("execute", label=label, backend=backend,
                                  request_ids=rids)
        slow_rule = faults.check("slow", label=label, backend=backend,
                                 request_ids=rids)

      def run():
        if exec_fault is not None:
          raise InjectedFault("execute", label)
        if slow_rule is not None:
          time.sleep(slow_rule.delay_s)
        if stamps is None:
          out = compiled(*batching.to_device(stacked, self.device))
          # the device-to-host copy is the batch's synchronisation point
          return _outputs_to_numpy(out)
        stamps.boundary(stamps.H2D)
        args = batching.to_device(stacked, self.device)
        stamps.boundary(stamps.COMPUTE)
        stage_hook.install(stamps)
        try:
          out = compiled(*args)
        finally:
          stage_hook.clear()
        stamps.boundary(stamps.D2H)
        out = _outputs_to_numpy(out)
        stamps.boundary(stamps.END)
        return out

      out = self._call_with_watchdog(run, label)
      device_s = self._clock()
      d2h_bytes = (sum(int(x.nbytes) for x in out)
                   if isinstance(out, tuple) else int(out.nbytes))
      cold = self.cache.first_run(exec_key)
      if faults is not None:
        nf = faults.check("nonfinite", label=label, backend=backend,
                          request_ids=rids)
        if nf is not None:
          out = batching.poison_output(
              key, out,
              [i for i, r in enumerate(reqs)
               if not nf.request_ids or r.request_id in nf.request_ids])
      iters_live = None
      if key.kind == "closure":
        # measured convergence counts of the live slots (padded slots copy
        # the last request), recorded before validation can fail the batch,
        # and once per request across attempts
        iters_live = np.asarray(out[1])[:len(reqs)]
        fresh = [i for i, r in enumerate(reqs)
                 if r.request_id not in observed]
        if fresh:
          self.estimator.observe_iterations(key, iters_live[fresh])
          observed.update(reqs[i].request_id for i in fresh)
      if self.validate_results:
        t0 = self._clock()
        bad = batching.validate_finite(key, out, len(reqs))
        if stamps is not None:
          stamps.span("nan_scan", t0, self._clock())
        if bad:
          # NaN means the arm misbehaved (±inf is legitimate tropical output)
          raise NonFiniteResultError(label, bad)
      phase = "split"
      t0 = self._clock()
      results = batching.split_results(key, reqs, out)
      if stamps is not None:
        stamps.span("split", t0, self._clock())
      if len(results) != len(reqs):
        raise RuntimeError(f"split_results returned {len(results)} results "
                           f"for {len(reqs)} requests in {label}")
    except Exception as e:  # noqa: BLE001 — classify, count, feed the breaker
      if stamps is not None and not isinstance(e, BatchTimeoutError):
        # a timed-out batch's worker may still record into its stamps
        self._give_back_stamps(stamps)
      kind = classify_failure(e, phase)
      self.metrics.on_batch_failure(kind)
      # only arm-implicating kinds feed the breaker: a host-side stack/split
      # failure would fail identically on every arm
      if kind in ARM_FAILURE_KINDS:
        self._trace_transition(self.resilience.on_failure(key, arm), label,
                               arm, kind)
      raise
    completed_s = self._clock()
    stages = None
    if stamps is not None:
      stages = stamps.read(len(out) if isinstance(out, tuple) else 1)
      self._give_back_stamps(stamps)
    self._trace_transition(self.resilience.on_success(key, arm), label, arm)
    if not cold:
      # per padded slot, keyed by the arm that ran; a function's first run
      # (lazy module loads on a card) would inflate the EWMA
      self.estimator.observe_batch(key, backend, schedule, rb,
                                   completed_s - executed_s)
    info = {"start_s": attempt_s, "stacked_s": stacked_s,
            "executed_s": executed_s, "device_s": device_s,
            "completed_s": completed_s, "rb": rb, "h2d_bytes": h2d_bytes,
            "d2h_bytes": d2h_bytes, "cache_hit": cache_hit,
            "backend": backend, "schedule": schedule,
            "iters_live": iters_live, "stages": stages}
    return results, info

  def _take_stamps(self) -> BatchStamps:
    """A free ``BatchStamps`` from the pool (one is made only when none is
    free: the first batch, a batch beside another step's, or after a
    timed-out batch kept its set), reset for one batch."""
    with self._lock:
      stamps = self._stamp_pool.pop() if self._stamp_pool else None
    if stamps is None:
      stamps = BatchStamps(self.device, self._clock)
    stamps.begin()
    return stamps

  def _give_back_stamps(self, stamps: BatchStamps) -> None:
    with self._lock:
      self._stamp_pool.append(stamps)

  def _complete_sub(self, key, reqs, results, info, scheduled_s: float,
                    *, emit_pick: bool) -> int:
    """Complete one successful sub-batch attempt: trace emission, batch
    metrics and the once-per-request final accounting.  ``scheduled_s``
    stays the original pick time — queue and service windows measure what
    the caller experienced, retries included — while the phase spans use
    the attempt's own timestamps."""
    completed_s = info["completed_s"]
    if self.tracer.enabled:
      self.tracer.batch_complete(
          label=bucket_label(key), scheduled_s=info["start_s"],
          stacked_s=info["stacked_s"], executed_s=info["executed_s"],
          device_s=info["device_s"], completed_s=completed_s,
          backend=info["backend"], schedule=info["schedule"],
          batch=len(reqs), padded=info["rb"],
          h2d_bytes=info["h2d_bytes"], cache_hit=info["cache_hit"],
          request_ids=[r.request_id for r in reqs],
          arrivals_s=[r.arrival_s for r in reqs],
          iterations=info["iters_live"], emit_pick=emit_pick,
          stages=info["stages"])
    with self._lock:
      self._batches += 1
      self.metrics.on_batch(
          key,
          host_s=((info["stacked_s"] - info["start_s"])
                  + (completed_s - info["device_s"])),
          device_s=info["device_s"] - info["executed_s"],
          h2d_bytes=info["h2d_bytes"], d2h_bytes=info["d2h_bytes"],
          stages=info["stages"])
      for r, res in zip(reqs, results):
        self._inflight.discard(r.request_id)
        self._records.append(RequestRecord(
            request_id=r.request_id, kind=r.kind, op=r.op, bucket=tuple(key),
            batch_size=len(reqs), arrival_s=r.arrival_s,
            scheduled_s=scheduled_s, completed_s=completed_s))
        self.admission.on_done(r)
        self.metrics.on_complete(key, queue_s=scheduled_s - r.arrival_s,
                                 service_s=completed_s - scheduled_s)
        fut = self._pending.pop(r.request_id, None)
        if fut is not None:
          fut._fulfill(res)
      if not self._pending:
        self._idle.notify_all()
    return len(reqs)

  def _call_with_watchdog(self, fn, label: str):
    """Run ``fn`` under the engine watchdog (``watchdog_s``; None runs it
    inline).  On timeout the batch fails with ``BatchTimeoutError`` instead
    of wedging the serving loop.  The worker thread is abandoned: CUDA work
    already queued cannot be cancelled, so it still runs, the next batch on
    the stream waits behind it, and its result is discarded.  The worker
    launches on the engine's device (the current device is per thread)."""
    if self.watchdog_s is None:
      return fn()
    box: dict = {}
    done = threading.Event()

    def worker():
      try:
        if self.device.type == "cuda":
          with torch.cuda.device(self.device):
            box["out"] = fn()
        else:
          box["out"] = fn()
      except BaseException as e:  # noqa: BLE001 — marshalled to the caller
        box["exc"] = e
      finally:
        done.set()

    t = threading.Thread(target=worker, name="mmo-batch-watchdog",
                         daemon=True)
    t.start()
    if not done.wait(self.watchdog_s):
      with self._lock:
        self._abandoned = [w for w in self._abandoned if w.is_alive()] + [t]
      raise BatchTimeoutError(label, self.watchdog_s)
    if "exc" in box:
      raise box["exc"]
    return box["out"]

  def join_abandoned(self, timeout: Optional[float] = None) -> int:
    """Wait for the watchdog workers of timed-out batches to end (each at
    most ``timeout`` seconds); returns how many still run."""
    with self._lock:
      workers = list(self._abandoned)
    for t in workers:
      t.join(timeout)
    with self._lock:
      self._abandoned = [w for w in self._abandoned if w.is_alive()]
      return len(self._abandoned)

  def _fallback_arms(self, key) -> tuple:
    """Sibling arms for breaker re-dispatch, best first: every arm computes
    the same result for this bucket (the SIMD² property), so traffic can
    move between them.  A mesh-routed bucket's first sibling is its own
    backend on the local path (the same kernel without the mesh); then
    'xla' and 'pallas' (minus the primary) ranked by the cost table's
    seconds, then 'vector' — the blocked plain arm — last, all local.
    ``fallback_backends`` overrides the backend order outright
    ('megakernel' only for closure buckets, which alone can run it).
    Memoized per bucket: stable executable-cache keys."""
    with self._lock:
      memo = self._fallback_arms_memo.get(key)
      if memo is not None:
        return memo
      primary, block = self.resolve_backend(key)
      arms = []
      if self.resolve_schedule(key) != _LOCAL:
        arms.append((primary, block, _LOCAL))
      if self.fallback_backends is not None:
        order = [b for b in self.fallback_backends
                 if b != primary and (b != "megakernel"
                                      or key.kind == "closure")]
      else:
        from repro_torch.tuning import dispatch as _dispatch
        m, k, n = contract_shape(key)
        ranked = []
        for b in ("xla", "pallas"):
          if b == primary:
            continue
          try:
            _, _, s = _dispatch.contraction_seconds(
                key.op, m, k, n, key.dtypes[0], backend=b,
                table=self.cost_table)
          except Exception:  # noqa: BLE001 — an unpriceable arm is skipped
            continue
          ranked.append((s, b))
        ranked.sort()
        order = [b for _, b in ranked]
        if primary != "vector":
          order.append("vector")
      arms.extend((b, (), _LOCAL) for b in order)
      memo = tuple(arms)
      self._fallback_arms_memo[key] = memo
      return memo

  # -- arena mode ------------------------------------------------------------

  def _arena_for_locked(self, key) -> RequestArena:
    """One arena per closure bucket, created on first use.  Engine lock
    held."""
    arena = self._arenas.get(key)
    if arena is None:
      arena = RequestArena(key, capacity=self.arena_capacity, g=self.arena_g,
                           cache=self.cache, device=self.device,
                           clock=self._clock)
      self._arenas[key] = arena
      self._arena_failures[key] = 0
    return arena

  def _arena_live_locked(self) -> bool:
    """Whether any arena holds resident requests.  Engine lock held; part
    of every drain condition — an empty queue alone no longer means idle."""
    return any(a.live_slots() for a in self._arenas.values())

  def _step_arena(self) -> int:
    """One arena-mode step: admit → (batch step) → tick and evict."""
    completed = self._step_batch() if self._arena_admit_phase() else 0
    with self._lock:
      arenas = [(k, a) for k, a in self._arenas.items() if a.live_slots()]
    for key, arena in arenas:
      completed += self._tick_arena(key, arena)
    return completed

  def _arena_admit_phase(self) -> bool:
    """Move queued closure requests into free arena slots in the policy's
    bucket order.  Returns True when the queue head is not closure traffic
    (the caller then runs one batch step).  Admission stops at a full
    arena: its slots free up at the next sweep, so no more requests leave
    the queue than there are slots."""
    while True:
      with self._lock:
        now = self._clock()
        key = self.scheduler.peek_bucket(now)
        if key is None:
          return False
        if key.kind != "closure":
          return True
        arena = self._arena_for_locked(key)
        free = arena.free_slots()
        if free <= 0:
          return False
        taken = self.scheduler.take_from(key, free, now=now)
        expired = self.scheduler.take_expired()
        if expired:
          self._expire_locked(expired)
        label = bucket_label(key)
        for r in taken:
          self.admission.on_dequeue(r)
          self._inflight.add(r.request_id)
          if key not in self._arenas_ticked:
            self._arena_cold.add(r.request_id)
          slot = arena.admit(r, now=self._clock())
          self.tracer.arena_admit(r.request_id, slot=slot, bucket=label)

  def _tick_arena(self, key, arena) -> int:
    """One tick of one arena: the fault hooks, the fused chunk launch and
    the eviction sweep (its device-to-host copy waits for the tick) under
    the watchdog, then the tick's accounting — metrics, breaker, tracer —
    as the batch path's ``_attempt`` does per attempt."""
    label = bucket_label(key)
    rids = [r.request_id for r in arena.live_requests()]
    if not rids:
      return 0
    t0 = self._clock()
    try:
      slow_rule = None
      if self.faults is not None:
        if self.faults.check("execute", label=label, backend=_ARENA,
                             request_ids=rids):
          raise InjectedFault("execute", label)
        slow_rule = self.faults.check("slow", label=label, backend=_ARENA,
                                      request_ids=rids)

      def run():
        if slow_rule is not None:
          time.sleep(slow_rule.delay_s)
        arena.tick()
        return arena.sweep()

      evictions = self._call_with_watchdog(run, label)
    except Exception as e:  # noqa: BLE001 — classified + retried below
      self._arena_tick_failed(key, arena, e)
      return 0
    t1 = self._clock()
    self._trace_transition(self.resilience.on_success(key, _ARENA_ARM),
                           label, _ARENA_ARM)
    with self._lock:
      self._arena_failures[key] = 0
      self._batches += 1
      self._arenas_ticked.add(key)
      self.metrics.on_batch(key, host_s=0.0, device_s=t1 - t0, h2d_bytes=0)
    self.tracer.arena_tick(label, live=len(rids), evicted=len(evictions),
                           g=arena.g, t0_s=t0, t1_s=t1)
    return self._finish_evictions(key, evictions, label)

  def _arena_tick_failed(self, key, arena, exc) -> None:
    """Tick failure recovery: the slots stay resident under the transient
    retry budget (the next step retries the whole tick); once the budget is
    spent every resident fails together and the arena resets.  There is no
    bisection: per-slot state already isolates a poisoned request (a NaN
    slot fails alone at eviction), so a tick-level failure is arm-wide."""
    label = bucket_label(key)
    kind = classify_failure(exc, "execute")
    self.metrics.on_batch_failure(kind)
    if kind in ARM_FAILURE_KINDS:
      self._trace_transition(self.resilience.on_failure(key, _ARENA_ARM),
                             label, _ARENA_ARM, kind)
    with self._lock:
      self._arena_failures[key] = self._arena_failures.get(key, 0) + 1
      failures = self._arena_failures[key]
    if failures <= self.transient_retries:
      self.metrics.on_retry()
      backoff = self.retry_backoff_s * (2.0 ** min(failures - 1, 3))
      if backoff > 0.0:
        time.sleep(backoff)
      return
    with self._lock:
      self._arena_failures[key] = 0
    victims = arena.reset()
    if self.tracer.enabled:
      for r in victims:
        self.tracer.request_end(r.request_id, "failed", executing=True)
      self.tracer.instant("batch_fail", cat="batch",
                          args={"bucket": label, "batch": len(victims),
                                "error": type(exc).__name__})
    self._fail_requests(key, victims, exc)

  def _finish_evictions(self, key, evictions, label: str) -> int:
    """Turn evictions into results.  A NaN slot (or one the ``nonfinite``
    fault poisons) fails alone; its neighbours complete.  The estimator
    observes each request's measured iterations and its slot-seconds
    (admit → evict), the residency QoS predictions price, unless the slot
    lived through the arena's first (cold) tick."""
    completed = 0
    for ev in evictions:
      r, value = ev.request, ev.value
      poisoned = False
      if self.faults is not None:
        if self.faults.check("nonfinite", label=label, backend=_ARENA,
                             request_ids=[r.request_id]) is not None:
          poisoned = True
          if np.issubdtype(value.dtype, np.floating):
            value = np.full_like(value, np.nan)
      bad = (self.validate_results
             and np.issubdtype(value.dtype, np.floating)
             and bool(np.isnan(value).any()))
      if poisoned or bad:
        self.metrics.on_batch_failure("nonfinite")
        self._trace_transition(self.resilience.on_failure(key, _ARENA_ARM),
                               label, _ARENA_ARM, "nonfinite")
        self.tracer.request_end(r.request_id, "failed", executing=True,
                                args={"slot": ev.slot})
        self._fail_requests(key, [r], NonFiniteResultError(label, [ev.slot]))
        continue
      res = MMOResult(value=value, extras={"iterations": int(ev.iterations)})
      now = self._clock()
      self.estimator.observe_iterations(key, [int(ev.iterations)])
      with self._lock:
        cold = r.request_id in self._arena_cold
        self._arena_cold.discard(r.request_id)
      if not cold:
        self.estimator.observe_batch(key, _ARENA, _LOCAL, 1, now - ev.admit_s)
      self.tracer.request_end(r.request_id, "done", executing=True,
                              args={"slot": ev.slot,
                                    "iterations": int(ev.iterations)})
      with self._lock:
        self._inflight.discard(r.request_id)
        self._records.append(RequestRecord(
            request_id=r.request_id, kind=r.kind, op=r.op, bucket=tuple(key),
            batch_size=1, arrival_s=r.arrival_s, scheduled_s=ev.admit_s,
            completed_s=now))
        self.admission.on_done(r)
        self.metrics.on_complete(key, queue_s=ev.admit_s - r.arrival_s,
                                 service_s=now - ev.admit_s)
        fut = self._pending.pop(r.request_id, None)
        if fut is not None:
          fut._fulfill(res)
        if not self._pending:
          self._idle.notify_all()
      completed += 1
    return completed

  def arena_stats(self) -> dict:
    """Per-arena slot statistics, keyed by bucket label."""
    with self._lock:
      arenas = dict(self._arenas)
    return {bucket_label(k): a.stats() for k, a in arenas.items()}

  def run_until_idle(self) -> int:
    """Drain the queue (and, in arena mode, every resident slot)
    synchronously; returns total requests completed."""
    total = 0
    while True:
      done = self.step()
      with self._lock:
        drained = (len(self.scheduler) == 0
                   and not self._arena_live_locked())
      if done == 0 and drained:
        return total
      total += done

  def _check_dropped(self, fut: MMOFuture):
    """Raise if the scheduler lost this request: still pending, but neither
    queued nor inside an executing batch or an arena slot — an engine
    bug."""
    rid = fut.request.request_id
    with self._lock:
      dropped = (rid in self._pending and rid not in self._inflight
                 and len(self.scheduler) == 0
                 and not self._arena_live_locked())
    if dropped:
      raise RuntimeError(
          f"request {rid} ({fut.request.kind}/{fut.request.op}) was "
          f"dropped: the queue drained without completing it — engine bug")

  def _serving_thread(self) -> Optional[threading.Thread]:
    """The loop's thread, read once under the lock: stop() may clear it
    between two unlocked reads."""
    with self._lock:
      return self._thread

  def _drive(self, fut: MMOFuture, timeout: Optional[float]):
    """Future.result() plumbing: wait on the loop, or step synchronously."""
    deadline = None if timeout is None else time.perf_counter() + timeout
    while ((thread := self._serving_thread()) is not None
           and thread.is_alive() and not fut.done()):
      self._check_dropped(fut)
      if deadline is not None and time.perf_counter() > deadline:
        return
      wait = 0.05 if deadline is None else max(
          0.0, min(0.05, deadline - time.perf_counter()))
      if fut._event.wait(wait):
        return
    while not fut.done():
      if deadline is not None and time.perf_counter() > deadline:
        return
      if self.step() == 0 and not fut.done():
        self._check_dropped(fut)
        wait = 0.005 if deadline is None else max(
            0.0, min(0.005, deadline - time.perf_counter()))
        fut._event.wait(wait)

  def prewarm(self, sample_reqs) -> int:
    """Build every (bucket, pow2-batch) executable the sample's buckets can
    produce, without executing anything — in arena mode, a closure bucket's
    three arena programs instead.  Returns #executables built; after it,
    traffic confined to those buckets causes zero cache misses."""
    with self._lock:
      min_bucket = self.scheduler.min_bucket
      max_batch = self.scheduler.max_batch
    seen = {request_bucket(req, min_bucket) for req in sample_reqs}
    before = self.cache.misses
    for key in seen:
      if self.mode == "arena" and key.kind == "closure":
        with self._lock:
          arena = self._arena_for_locked(key)
        arena.prewarm()
        continue
      rb = 1
      while True:
        backend, block, schedule = self.resolve_placement(key, rb)
        self.cache.get_or_compile(
            self._exec_key(key, rb, backend, block, schedule),
            lambda: batching.make_batch_fn(key, backend=backend, block=block,
                                           device=self.device,
                                           mesh=self.mesh, schedule=schedule),
            batching.abstract_batch(key, rb))
        if rb >= max_batch:
          break
        rb = self._batch_bucket(min(2 * rb, max_batch))
    return self.cache.misses - before

  # -- live metrics ----------------------------------------------------------

  def metrics_snapshot(self) -> dict:
    """Point-in-time QoS view (rolling-window per-bucket p50/p99 queue and
    service latency, counters, queue depth, admission state, estimator
    cells).  Safe from any thread while the serving loop runs: the gauges
    are read under the engine lock for one moment, then aggregated outside
    the serving path."""
    with self._lock:
      depth = len(self.scheduler)
      executing = len(self._inflight)
      adm = self.admission.snapshot()
    return self.metrics.snapshot(queue_depth=depth, executing=executing,
                                 admission=adm,
                                 estimator=self.estimator.snapshot())

  def observability_state(self) -> dict:
    """Everything the Prometheus renderer (serve_mmo/exposition.py) emits,
    in one point-in-time document: metrics counters + histogram state,
    queue/executing gauges, admission, cache and scheduler counters, the
    estimator's cells with their drift against the static cost model
    (measured EWMA / static prediction), the breaker cells and the flight
    recorder's stats.  Gauges are read under the engine lock; the drift
    math runs outside it."""
    with self._lock:
      depth = len(self.scheduler)
      executing = len(self._inflight)
      adm = self.admission.snapshot()
      sched = {"picks": self.scheduler.picks,
               "pick_seconds": self.scheduler.pick_seconds}
    cells = []
    for key, backend, schedule, seconds, count in self.estimator.cells_raw():
      contraction_s, trips = self._static_point(key)
      static_s = contraction_s * trips
      cells.append({
          "bucket": bucket_label(key), "backend": backend,
          "schedule": schedule, "seconds": seconds, "observations": count,
          "drift": (seconds / static_s) if static_s > 0.0 else None,
      })
    return {
        "metrics": self.metrics.exposition_state(),
        "queue_depth": depth,
        "executing": executing,
        "admission": adm,
        "cache": self.cache.stats(),
        "scheduler": sched,
        "estimator_cells": cells,
        "breakers": self.resilience.snapshot(),
        "trace": self.tracer.stats(),
    }

  def export_trace(self) -> dict:
    """The flight recorder's Chrome trace-event JSON (load in Perfetto or
    about://tracing): per-request lifecycle spans plus per-batch host and
    device phases.  See serve_mmo/observability.py."""
    return self.tracer.export()

  # -- background serving loop -----------------------------------------------

  def start(self):
    """Spawn the background serving thread (idempotent; re-arms submit
    after a stop())."""
    with self._lock:
      self._stopped = False
      if self._running:
        return
      self._running = True
      thread = self._thread = threading.Thread(
          target=self._loop, name="mmo-serve", daemon=True)
    thread.start()

  def stop(self, *, drain: bool = True):
    """Stop the loop; with ``drain`` finish everything queued first (without
    a running loop, drain synchronously).  Later ``submit`` calls raise
    until ``start()`` is called again."""
    with self._lock:
      self._stopped = True
      thread = self._thread
    if drain:
      if thread is not None and thread.is_alive():
        with self._idle:
          while self._pending and thread.is_alive():
            self._idle.wait(timeout=0.5)
      else:
        self.run_until_idle()
    with self._work:
      self._running = False
      self._work.notify_all()
    if thread is not None:
      thread.join()  # outside the lock: the loop takes it to exit
      with self._lock:
        if self._thread is thread:
          self._thread = None

  def _loop(self):
    if self.device.type == "cuda":
      torch.cuda.set_device(self.device)
    while True:
      with self._work:
        while (self._running and len(self.scheduler) == 0
               and not self._arena_live_locked()):
          self._work.wait()
        if not self._running:
          return
      self.step()

  # -- stats -----------------------------------------------------------------

  def stats(self) -> EngineStats:
    with self._lock:
      recs = list(self._records)
      batches = self._batches
      rejected, expired = self._rejected, self._expired
    lat = np.asarray([r.latency_s for r in recs], dtype=np.float64)
    return EngineStats(
        completed=len(recs),
        batches=batches,
        mean_batch=(len(recs) / batches) if batches else 0.0,
        latencies_s=lat,
        cache=self.cache.stats(),
        rejected=rejected,
        expired=expired,
    )

  def reset_stats(self):
    with self._lock:
      self._records.clear()
      self._batches = 0
      self._rejected = 0
      self._expired = 0
