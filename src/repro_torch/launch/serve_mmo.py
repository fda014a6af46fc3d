"""Open-loop load generator for semiring workloads → MMO engine.

    PYTHONPATH=src python -m repro_torch.launch.serve_mmo --rate 40 \
        --duration 3 --backend pallas --max-batch 8

    # QoS serving: deadline policy + admission caps + live metrics every 1s
    PYTHONPATH=src python -m repro_torch.launch.serve_mmo --policy deadline \
        --deadline-s 0.25 --max-queue 256 --tenant-quota 64 \
        --metrics-every 1 --rate 80 --duration 5

    # auto dispatch tuned on the card, adaptive predictions, bulk batches
    # capped to ~20 ms of predicted work while deadline traffic is active
    PYTHONPATH=src python -m repro_torch.launch.serve_mmo --backend auto \
        --autotune --policy deadline --deadline-s 0.25 --adaptive \
        --max-batch-seconds 0.02 --rate 80

    # live observability: Prometheus /metrics + /healthz + /snapshot +
    # /trace on :9178 while serving; the Chrome trace written at the end
    PYTHONPATH=src python -m repro_torch.launch.serve_mmo --http-port 9178 \
        --rate 40 --duration 10 --trace-out serve_trace.json

    # chaos: 5% of execute checks fail; retries and bisection keep every
    # request completing (the resilience line reports the recovery)
    PYTHONPATH=src python -m repro_torch.launch.serve_mmo --rate 40 \
        --duration 3 --inject-faults "execute:rate:0.05" --transient-retries 2
    # break K1 persistently: its breakers open and traffic moves to 'xla'
    PYTHONPATH=src python -m repro_torch.launch.serve_mmo \
        --inject-faults "execute:persistent:backend=pallas" --watchdog-s 5
    # sharded serving over a 2 x 2 mesh of the cards present: buckets of
    # at least 1e8 flops per request go to SUMMA, the rest stay local
    PYTHONPATH=src python -m repro_torch.launch.serve_mmo --mesh 2,2 \
        --schedule summa --shard-flops 1e8

Counterpart of ``repro/launch/serve_mmo.py``.  Generates a Poisson arrival
stream of mixed SIMD² problems (APSP,
KNN, reachability, raw minplus mmo at several sizes), submits each request
at its arrival time against the engine's background serving loop, and
reports throughput (problems/s), latency percentiles and executable-cache
behaviour.  Open-loop means arrivals do not wait for completions.  Runs on
the card (``--device cuda``, the default) unless told otherwise.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np

from repro_torch.apps import graphs
from repro_torch.serve_mmo import (DeadlineExceededError, MMOEngine,
                                   ObservabilityServer, RejectedError,
                                   apsp_request, knn_request, mmo_request,
                                   parse_fault_spec, reachability_request)
from repro_torch.serve_mmo.engine import ENGINE_BACKENDS

TENANTS = ("alpha", "beta", "gamma")


def synthesize_request(rng: np.random.Generator, sizes, *,
                       deadline_s=None, deadline_frac: float = 0.0):
  """One random problem from the mixed APSP/KNN/reachability/mmo workload
  (the reference's draw order, so one seed gives both packages the same
  stream).  With ``deadline_s``, a ``deadline_frac`` share of requests is
  deadline-tagged at priority 1."""
  kind = rng.choice(("apsp", "knn", "reach", "mmo"))
  n = int(rng.choice(sizes))
  seed = int(rng.integers(0, 2 ** 31))
  qos = {"tenant": TENANTS[int(rng.integers(0, len(TENANTS)))]}
  if deadline_s is not None and rng.random() < deadline_frac:
    qos.update(deadline_s=float(deadline_s), priority=1)
  if kind == "apsp":
    return apsp_request(graphs.weighted_digraph(n, 0.3, seed=seed), **qos)
  if kind == "reach":
    return reachability_request(graphs.boolean_digraph(n, 0.1, seed=seed),
                                **qos)
  if kind == "knn":
    ref, qry = graphs.knn_points(4 * n, n, 16, seed=seed)
    return knn_request(qry, ref, k=min(8, 4 * n), **qos)
  a = rng.standard_normal((n, n)).astype(np.float32)
  b = rng.standard_normal((n, n)).astype(np.float32)
  return mmo_request(a, b, op="minplus", **qos)


def warmup(engine: MMOEngine, rng: np.random.Generator, sizes, n: int = 40):
  """Build the bucket executables so the measured run is steady-state.

  A sample of the synthetic workload discovers the buckets; ``prewarm``
  then builds every (bucket, batch) variant those buckets can produce.
  """
  engine.prewarm([synthesize_request(rng, sizes) for _ in range(n)])
  engine.reset_stats()


def main(argv=None):
  from repro_torch.analysis.sanitize import maybe_enable_sanitize
  maybe_enable_sanitize()  # REPRO_SANITIZE=1: NaN checks + analyzer preflight
  ap = argparse.ArgumentParser()
  ap.add_argument("--rate", type=float, default=40.0,
                  help="mean arrival rate (problems/s)")
  ap.add_argument("--duration", type=float, default=3.0,
                  help="traffic window (s)")
  ap.add_argument("--backend", default="pallas", choices=ENGINE_BACKENDS)
  ap.add_argument("--max-batch", type=int, default=8)
  ap.add_argument("--min-bucket", type=int, default=8)
  ap.add_argument("--sizes", default="12,24,48",
                  help="comma-separated problem sizes")
  ap.add_argument("--seed", type=int, default=0)
  ap.add_argument("--no-warmup", action="store_true")
  ap.add_argument("--device", default="cuda",
                  help="torch device to serve on (default cuda; fails "
                       "without a card)")
  ap.add_argument("--mesh", default=None, metavar="DP,MP",
                  help="device mesh axis sizes, e.g. '2,2' (data=2, "
                       "model=2), over the devices of --device's type that "
                       "exist; enables the sharded bucket path")
  ap.add_argument("--schedule", default="auto",
                  choices=("auto", "dp", "summa", "kspan", "ring", "local"),
                  help="distributed schedule for over-threshold buckets "
                       "(auto: cost-table mesh rows / sharded prior; dp: "
                       "requests sharded over all devices)")
  ap.add_argument("--shard-flops", type=float, default=1e8,
                  help="per-request contraction FLOP cutoff above which a "
                       "bucket routes to the mesh")
  ap.add_argument("--cost-table", default=None, metavar="PATH",
                  help="JSON cost table for --backend auto (see "
                       "repro_torch.tuning.autotune); defaults to "
                       "$REPRO_TORCH_COST_TABLE")
  ap.add_argument("--autotune", action="store_true",
                  help="with --backend auto: measure this workload's buckets "
                       "on the device before serving (and persist to "
                       "--cost-table if given)")
  ap.add_argument("--policy", default="fifo",
                  choices=("fifo", "deadline", "fair"),
                  help="scheduling policy: fifo (oldest head first), "
                       "deadline (earliest feasible deadline + priority "
                       "tiers), fair (weighted round-robin across tenants)")
  ap.add_argument("--max-queue", type=int, default=None,
                  help="admission: reject once this many requests are queued")
  ap.add_argument("--tenant-quota", type=int, default=None,
                  help="admission: per-tenant in-flight request cap")
  ap.add_argument("--max-backlog-s", type=float, default=None,
                  help="admission: reject once the queue's predicted drain "
                       "time (seconds) exceeds this")
  ap.add_argument("--adaptive", action="store_true",
                  help="deadline feasibility, backlog admission and the "
                       "batch cap read live EWMA service latency and "
                       "measured closure convergence counts instead of the "
                       "static cost table alone")
  ap.add_argument("--max-batch-seconds", type=float, default=None,
                  metavar="SECS",
                  help="service-time batch cap: while deadline traffic is "
                       "active, bound each bulk batch to ~SECS of predicted "
                       "work")
  ap.add_argument("--deadline-s", type=float, default=None,
                  help="tag a --deadline-frac share of traffic with this "
                       "latency budget (priority 1); late requests expire")
  ap.add_argument("--deadline-frac", type=float, default=0.25,
                  help="share of traffic carrying --deadline-s (default .25)")
  ap.add_argument("--metrics-every", type=float, default=None, metavar="SECS",
                  help="emit a live metrics snapshot every SECS while "
                       "serving, to stderr (or --metrics-file)")
  ap.add_argument("--metrics-file", default=None, metavar="PATH",
                  help="append --metrics-every snapshots to PATH as JSON "
                       "lines instead of stderr")
  ap.add_argument("--http-port", type=int, default=None, metavar="PORT",
                  help="serve the live observability endpoint on PORT: "
                       "/metrics (Prometheus text exposition), /healthz, "
                       "/snapshot (metrics JSON), /trace (Chrome trace-event "
                       "JSON).  0 picks an ephemeral port")
  ap.add_argument("--http-host", default="127.0.0.1",
                  help="bind address for --http-port (default loopback)")
  ap.add_argument("--http-linger", type=float, default=0.0, metavar="SECS",
                  help="keep the observability endpoint up SECS after the "
                       "run drains (lets a scraper collect final state)")
  ap.add_argument("--no-trace", action="store_true",
                  help="disable the request-lifecycle flight recorder "
                       "(tracing is on by default)")
  ap.add_argument("--trace-out", default=None, metavar="PATH",
                  help="write the flight recorder's Chrome trace JSON to "
                       "PATH at the end of the run")
  ap.add_argument("--inject-faults", default=None, metavar="SPEC",
                  help="chaos harness: ';'-separated fault rules, each "
                       "point:mode[:arg][:k=v...][@match] — e.g. "
                       "'execute:rate:0.02' (2%% of execute checks fail), "
                       "'execute:persistent:backend=pallas', "
                       "'slow:transient:1:delay=0.2' (see serve_mmo/faults.py)")
  ap.add_argument("--fault-seed", type=int, default=0,
                  help="seed for rate-mode fault rules (replayable chaos)")
  ap.add_argument("--transient-retries", type=int, default=1,
                  help="whole-sub-batch retries before bisection (default 1)")
  ap.add_argument("--retry-backoff-s", type=float, default=0.002,
                  help="base backoff before a retry, doubled per attempt")
  ap.add_argument("--no-bisect", action="store_true",
                  help="fail a whole batch once retries are spent instead of "
                       "bisecting to isolate the poisoned request")
  ap.add_argument("--breaker-threshold", type=int, default=5, metavar="N",
                  help="consecutive arm failures that open a circuit "
                       "breaker; 0 disables breakers (fail in place)")
  ap.add_argument("--breaker-probe-s", type=float, default=0.25,
                  help="cooldown before an open breaker half-opens for a "
                       "probe batch")
  ap.add_argument("--watchdog-s", type=float, default=None, metavar="SECS",
                  help="per-batch device watchdog: a batch whose device run "
                       "does not end within SECS fails with a timeout "
                       "instead of wedging the serving loop (default: off)")
  args = ap.parse_args(argv)

  try:
    sizes = tuple(int(s) for s in args.sizes.split(","))
    if not sizes or any(s <= 0 for s in sizes):
      raise ValueError
  except ValueError:
    ap.error(f"--sizes must be comma-separated positive ints, got "
             f"{args.sizes!r}")
  rng = np.random.default_rng(args.seed)

  mesh = None
  if args.mesh:
    from repro_torch.launch.mesh import available_devices, make_host_mesh
    try:
      dims = tuple(int(x) for x in args.mesh.split(","))
      if not 1 <= len(dims) <= 2 or any(d <= 0 for d in dims):
        raise ValueError
    except ValueError:
      ap.error(f"--mesh must be 'dp,mp' positive ints, got {args.mesh!r}")
    if len(dims) == 1:
      dims = (1, dims[0])
    need, have = dims[0] * dims[1], len(available_devices(args.device))
    if need > have:
      ap.error(f"--mesh {args.mesh} needs {need} devices, host has {have}")
    mesh = make_host_mesh(need, model=dims[1], device=args.device)
    print(f"[serve_mmo] mesh data={dims[0]} × model={dims[1]} "
          f"schedule={args.schedule} shard_flops={args.shard_flops:g}")
  elif args.schedule != "auto":
    ap.error(f"--schedule {args.schedule} requires --mesh")

  cost_table = None
  if args.backend == "auto":
    cost_table = _auto_table(ap, args, sizes)

  injector = None
  if args.inject_faults:
    try:
      injector = parse_fault_spec(args.inject_faults, seed=args.fault_seed)
    except ValueError as e:
      ap.error(f"--inject-faults: {e}")
    print(f"[serve_mmo] fault injection armed: {args.inject_faults!r} "
          f"(seed={args.fault_seed})")

  engine = MMOEngine(backend=args.backend, max_batch=args.max_batch,
                     min_bucket=args.min_bucket, device=args.device,
                     cost_table=cost_table, mesh=mesh,
                     schedule=args.schedule if mesh else "auto",
                     shard_flops=args.shard_flops, policy=args.policy,
                     max_queue=args.max_queue,
                     tenant_quota=args.tenant_quota,
                     max_backlog_s=args.max_backlog_s,
                     adaptive=args.adaptive,
                     max_batch_seconds=args.max_batch_seconds,
                     trace=not args.no_trace, faults=injector,
                     transient_retries=args.transient_retries,
                     retry_backoff_s=args.retry_backoff_s,
                     bisect=not args.no_bisect,
                     breaker_threshold=(args.breaker_threshold
                                        if args.breaker_threshold > 0
                                        else None),
                     breaker_probe_s=args.breaker_probe_s,
                     watchdog_s=args.watchdog_s)

  http_server = None
  if args.http_port is not None:
    http_server = ObservabilityServer(engine, host=args.http_host,
                                      port=args.http_port).start()
    print(f"[serve_mmo] observability endpoint at {http_server.url} "
          f"(/metrics /healthz /snapshot /trace)")

  if not args.no_warmup:
    t0 = time.perf_counter()
    warmup(engine, rng, sizes)
    print(f"[serve_mmo] warmup: {engine.cache.stats()} "
          f"({time.perf_counter() - t0:.2f}s)")

  # Poisson arrivals, materialized up front so generation cost is not on the
  # serving path.
  arrivals = np.cumsum(rng.exponential(1.0 / args.rate,
                                       int(args.rate * args.duration)))
  reqs = [synthesize_request(rng, sizes, deadline_s=args.deadline_s,
                             deadline_frac=args.deadline_frac)
          for _ in arrivals]
  misses_before = engine.cache.misses

  ticker_stop = threading.Event()
  ticker = None
  if args.metrics_every:
    ticker = threading.Thread(target=_metrics_ticker, name="mmo-metrics",
                              args=(engine, args, ticker_stop), daemon=True)
    ticker.start()

  engine.start()
  t0 = time.perf_counter()
  futures = []
  try:
    for t_arr, req in zip(arrivals, reqs):
      now = time.perf_counter() - t0
      if t_arr > now:
        time.sleep(t_arr - now)
      futures.append(engine.submit(req))
    outcomes = {"done": 0, "rejected": 0, "expired": 0, "failed": 0}
    for f in futures:
      try:
        f.result(timeout=600)
        outcomes["done"] += 1
      except RejectedError:
        outcomes["rejected"] += 1
      except DeadlineExceededError:
        outcomes["expired"] += 1
      except Exception:  # noqa: BLE001 — tally, keep draining
        outcomes["failed"] += 1
    wall = time.perf_counter() - t0
  finally:
    engine.stop()
    ticker_stop.set()
    if ticker is not None:
      ticker.join(timeout=10)
    if http_server is not None and args.http_linger <= 0:
      http_server.stop()
  if args.trace_out:
    with open(args.trace_out, "w", encoding="utf-8") as f:
      json.dump(engine.export_trace(), f)
    print(f"[serve_mmo] wrote Chrome trace ({engine.tracer.stats()}) to "
          f"{args.trace_out}")
  if http_server is not None and args.http_linger > 0:
    print(f"[serve_mmo] endpoint lingering {args.http_linger:g}s at "
          f"{http_server.url}")
    time.sleep(args.http_linger)
    http_server.stop()

  st = engine.stats()
  misses_during = engine.cache.misses - misses_before
  print(f"[serve_mmo] backend={args.backend} policy={args.policy} "
        f"device={engine.device} rate={args.rate}/s "
        f"duration={args.duration}s offered={len(futures)}")
  print(f"[serve_mmo] served {st.completed} problems in {wall:.2f}s "
        f"({st.completed / wall:.1f} problems/s) outcomes={outcomes}")
  if st.completed:
    print(f"[serve_mmo] latency p50={st.percentile(50) * 1e3:.1f}ms "
          f"p90={st.percentile(90) * 1e3:.1f}ms "
          f"p99={st.percentile(99) * 1e3:.1f}ms")
  print(f"[serve_mmo] batches={st.batches} mean_batch={st.mean_batch:.2f} "
        f"rejected={st.rejected} expired={st.expired} cache={st.cache}")
  if st.rejected:
    print(f"[serve_mmo] admission rejections: "
          f"{dict(engine.admission.rejections)}")
  msnap = engine.metrics_snapshot()
  retries = msnap["counters"]["retries"]
  failures_by_kind = msnap["batch_failures_by_kind"]
  breakers = engine.resilience.snapshot()
  if injector is not None or retries or failures_by_kind or breakers:
    opens = sum(c["opens"] for c in breakers)
    open_now = [f"{c['bucket']}/{c['backend']}/{c['schedule']}"
                for c in breakers if c["state"] != "closed"]
    print(f"[serve_mmo] resilience: retries={retries} "
          f"batch_failures={failures_by_kind} breaker_opens={opens} "
          f"open_now={open_now}")
    if injector is not None:
      print(f"[serve_mmo] injector: {injector.stats()}")
  if mesh is not None:
    placed: dict = {}
    for sched in engine._schedules.values():
      placed[sched] = placed.get(sched, 0) + 1
    print(f"[serve_mmo] mesh placement (buckets per schedule): {placed}")
  if args.backend == "auto":
    arms: dict = {}
    for backend, _ in engine._decisions.values():
      arms[backend] = arms.get(backend, 0) + 1
    print(f"[serve_mmo] auto dispatch (buckets per arm): {arms}")
  if args.adaptive:
    est = engine.estimator.snapshot()
    warm = {label: f"{c['seconds'] * 1e3:.2f}ms/{c['observations']}obs"
            for label, c in est["cells"].items()}
    print(f"[serve_mmo] adaptive estimator (per-request EWMA): {warm}")
    if est["iterations"]:
      print(f"[serve_mmo] measured closure iterations: {est['iterations']}")
  if not args.no_warmup and misses_during:
    print(f"[serve_mmo] WARNING: {misses_during} builds during the measured "
          f"window (cold buckets)")
  return 0 if outcomes["failed"] == 0 else 1


def _auto_table(ap, args, sizes):
  """The cost table for ``--backend auto``: loaded from ``--cost-table``,
  measured on the device for this workload with ``--autotune`` (and then
  saved to ``--cost-table``), or None for the process-global table."""
  import os
  from repro_torch.tuning import CostTable, tune_for_requests
  table = None
  if args.cost_table and os.path.exists(args.cost_table):
    table = CostTable.load(args.cost_table)
    print(f"[serve_mmo] loaded cost table {args.cost_table}: "
          f"{len(table)} entries ({table.counts()})")
  elif args.cost_table and not args.autotune:
    # only --autotune may create the file; a missing table would mean
    # serving silently untuned
    ap.error(f"--cost-table {args.cost_table!r} does not exist "
             f"(pass --autotune to create it)")
  if args.autotune:
    sample_rng = np.random.default_rng(args.seed)
    sample = [synthesize_request(sample_rng, sizes) for _ in range(40)]
    t0 = time.perf_counter()
    table = tune_for_requests(sample, table=table, device=args.device)
    print(f"[serve_mmo] autotune: {len(table)} entries in "
          f"{time.perf_counter() - t0:.2f}s")
    if args.cost_table:
      table.save(args.cost_table)
      print(f"[serve_mmo] persisted cost table to {args.cost_table}")
  return table


def _metrics_ticker(engine, args, stop: threading.Event) -> None:
  """Write a metrics snapshot every ``--metrics-every`` seconds to stderr
  or ``--metrics-file`` (never stdout, which carries the results)."""
  sink = (open(args.metrics_file, "a", encoding="utf-8")
          if args.metrics_file else sys.stderr)
  try:
    while not stop.wait(args.metrics_every):
      line = json.dumps(engine.metrics_snapshot(), default=float)
      print(f"[serve_mmo][metrics] {line}", file=sink, flush=True)
  finally:
    if args.metrics_file:
      sink.close()


if __name__ == "__main__":
  sys.exit(main())
