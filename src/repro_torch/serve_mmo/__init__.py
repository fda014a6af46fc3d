"""MMO serving engine — shape-bucketed batching for semiring workloads.

Counterpart of ``repro.serve_mmo``, in batch and arena mode, with its QoS,
recovery and telemetry layers:

  api.py        — problem requests (apsp / knn / reachability / raw mmo)
                  with QoS fields (tenant, priority, deadline_s) and result
                  futures with rejected/expired terminal states,
  scheduler.py  — request queue bucketed by (kind, op, padded shape, dtype,
                  static params); bucket picking delegates to a policy,
  policy.py     — scheduling policies: FIFO (default), deadline-aware
                  (earliest feasible deadline, priority tiers, fail-fast),
                  fair share (weighted round-robin across tenants),
  admission.py  — admission control: bounded queue depth, per-tenant
                  in-flight quotas, predicted-backlog-seconds rejection,
  metrics.py    — lock-cheap rolling-window metrics (per-bucket p50/p99
                  queue and service latency), snapshotable mid-run,
  estimator.py  — per-(bucket, backend, schedule) EWMA over measured batch
                  latencies and measured closure convergence counts; it
                  corrects the cost-table predictions that drive deadline
                  feasibility, backlog admission and the batch cap
                  (``adaptive=True``),
  batching.py   — pad-and-stack micro-batcher: one batch function per bucket
                  executes a whole request batch on the device, or sharded
                  over a mesh by a distributed schedule (per-request
                  convergence masks for closures),
  arena.py      — device-resident slot buffer for closure buckets: admit
                  between fused K2 ticks, evict on convergence,
  cache.py      — executable cache keyed by (bucket, batch, backend,
                  block, schedule, mesh),
  engine.py     — submit()/futures, synchronous step() or a background
                  serving loop, per-request latency stats, and the recovery
                  driver (bounded retries, bisection, watchdog, NaN
                  validation); ``backend="auto"`` dispatches each bucket
                  from the cost table; ``mesh=`` routes big buckets to a
                  distributed schedule (``schedule``, ``shard_flops``);
                  ``mode="arena"`` serves closures from arenas,
  faults.py     — deterministic, seedable fault injection (compile /
                  execute / nonfinite / slow points; persistent, transient
                  and seeded-rate schedules) threaded through engine hooks,
  resilience.py — per-(bucket, backend, schedule) circuit breakers with
                  cost-ranked fallback arms and half-open probes,
  observability.py — a bounded ring-buffer flight recorder of per-request
                  and per-batch spans, exported as Chrome trace-event JSON,
  exposition.py — Prometheus text exposition of the engine's counters,
                  log-bucketed latency histograms, gauges, estimator drift
                  and breakers,
  httpd.py      — stdlib HTTP endpoint serving /metrics /healthz /snapshot
                  /trace beside a live engine (``--http-port`` in
                  launch/serve_mmo.py).

Quickstart::

    from repro_torch.serve_mmo import MMOEngine, apsp_request

    eng = MMOEngine(backend="pallas", max_batch=8,     # device="cuda"
                    policy="deadline", max_queue=256)
    futs = [eng.submit(apsp_request(w, deadline_s=0.2))
            for w in weight_matrices]
    eng.run_until_idle()
    dist = futs[0].result().value
    print(eng.metrics_snapshot())
"""
from repro_torch.serve_mmo.admission import AdmissionController
from repro_torch.serve_mmo.api import (DeadlineExceededError, MMOFuture,
                                       MMOResult, NonFiniteResultError,
                                       ProblemRequest, RejectedError,
                                       apsp_request, closure_request,
                                       knn_request, mmo_request,
                                       reachability_request)
from repro_torch.serve_mmo.arena import Eviction, RequestArena
from repro_torch.serve_mmo.cache import ExecutableCache
from repro_torch.serve_mmo.engine import EngineStats, MMOEngine
from repro_torch.serve_mmo.estimator import Estimate, ServiceEstimator
from repro_torch.serve_mmo.exposition import LogHistogram, render_prometheus
from repro_torch.serve_mmo.faults import (BatchTimeoutError, FaultInjector,
                                          FaultRule, InjectedFault,
                                          parse_fault_spec)
from repro_torch.serve_mmo.httpd import ObservabilityServer
from repro_torch.serve_mmo.metrics import (RollingWindow, ServeMetrics,
                                           bucket_label)
from repro_torch.serve_mmo.observability import FlightRecorder
from repro_torch.serve_mmo.policy import (DeadlinePolicy, FairSharePolicy,
                                          FifoPolicy, QueueEntry,
                                          SchedulingPolicy, make_policy)
from repro_torch.serve_mmo.resilience import (CircuitBreaker,
                                              ResilienceManager)
from repro_torch.serve_mmo.scheduler import (BucketKey, BucketScheduler,
                                             FifoBucketScheduler, bucket_dim,
                                             contract_shape, request_bucket)

# The reference's public names that are ported.  QueueEntry, bucket_dim,
# contract_shape and request_bucket stay importable from here but are not
# in the reference's __all__.
__all__ = [
    "ProblemRequest",
    "MMOFuture",
    "MMOResult",
    "MMOEngine",
    "EngineStats",
    "RequestArena",
    "Eviction",
    "ExecutableCache",
    "BucketKey",
    "BucketScheduler",
    "FifoBucketScheduler",
    "SchedulingPolicy",
    "FifoPolicy",
    "DeadlinePolicy",
    "FairSharePolicy",
    "make_policy",
    "AdmissionController",
    "ServiceEstimator",
    "Estimate",
    "ServeMetrics",
    "RollingWindow",
    "bucket_label",
    "FlightRecorder",
    "ObservabilityServer",
    "LogHistogram",
    "render_prometheus",
    "FaultInjector",
    "FaultRule",
    "parse_fault_spec",
    "InjectedFault",
    "NonFiniteResultError",
    "BatchTimeoutError",
    "ResilienceManager",
    "CircuitBreaker",
    "RejectedError",
    "DeadlineExceededError",
    "mmo_request",
    "closure_request",
    "apsp_request",
    "reachability_request",
    "knn_request",
]
