"""One run of one cell: set-up, the measured window, the check, the result.

Order of a run:
  1. set-up (counted in ``setup_s``): imports, the engine, every stream's
     inputs, ``prewarm`` and warm-up batches of every (bucket, batch size)
     the traffic can produce, twice each so the engine's estimator is warm;
  2. the window: every client and sender starts at once and sends for
     ``--seconds``; with ``--trace 1`` all of it is profiled (the
     profiler starts before it and stops after it: both stall the host);
  3. every request sent ends (at most ``load.GRACE_S`` past the close);
     the device's memory peak is read; the engine stops and is freed;
  4. the reference works every kept answer out again and the comparison
     decides ``correct``;
  5. the metrics: the cell's end-to-end ones (``--trace 0``) or its
     per-layer ones (``--trace 1``).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time

from bench.lib import check, inputs, load, spec, stats, work

# batch sizes warmed: every power of two up to max_batch, each twice (the
# engine keeps an executable's first run out of its estimator)
WARM_REPEATS = 2
# a p95 that lands on a failed request: a stand-in far above any served
# latency (JSON has no infinity)
INFINITE_MS = 1e9
DEVICE_PHASES = ("pad_and_stack", "resolve_compile", "device_compute",
                 "split_results")


@dataclasses.dataclass
class RunData:
  """Everything a metric reader may read, after the window."""
  workload: str
  config: dict
  traffic: dict
  seconds: float
  t0: float
  t1: float
  obs: list
  wrong: set
  squarings: dict
  counters: dict          # engine counters' change over the window
  hist: dict              # (bucket label, window) -> (sum s, count) change
  records: list           # the engine's per-request records
  max_batch: int
  device_slice: object = None   # profile.DeviceSlice, traced runs only
  phases: list = dataclasses.field(default_factory=list)

  def in_window(self, o) -> bool:
    return self.t0 <= o.done_s <= self.t1

  def correct_done(self, o) -> bool:
    return o.state == "done" and id(o) not in self.wrong

  def least_parts(self, o):
    """(ops seconds, bytes seconds) of the counted work of one answered
    request, or None where the reference did not count it."""
    p = o.payload
    if p.kind == "closure":
      sq = self.squarings.get(id(p))
      if sq is None:
        return None
      terms, nbytes = work.closure_work(p.size[0], p.op, p.dtype, sq[0])
    else:
      terms, nbytes = work.knn_work(*p.size, p.dtype)
    return (work.ops_seconds(p.op, p.dtype, terms),
            nbytes / work.PEAK_BYTES_S)

  def batches(self) -> list:
    """The engine's batches: (bucket, scheduled_s, completed_s, request
    ids), from its per-request records."""
    groups: dict = {}
    for r in self.records:
      key = (r.bucket, r.scheduled_s, r.completed_s)
      groups.setdefault(key, []).append(r.request_id)
    return [(b, s, c, ids) for (b, s, c), ids in sorted(
        groups.items(), key=lambda kv: kv[0][1])]


def process_start_s() -> float:
  """This process's start on the ``perf_counter`` clock (from
  ``/proc/self/stat``; the harness's own import time where that is
  unreadable)."""
  try:
    with open("/proc/self/stat") as f:
      fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
      uptime = float(f.read().split()[0])
    import os
    age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.perf_counter() - max(0.0, age)
  except (OSError, ValueError, IndexError):
    return _IMPORTED_AT


_IMPORTED_AT = time.perf_counter()


def device_info(torch, device) -> dict:
  """What the run used: the contract's keys, and the card's power limit
  and clocks (``nvidia-smi``), which every number needs beside it."""
  info = {"platform": "gpu" if device.type == "cuda" else device.type,
          "kind": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
          "count": 1}
  try:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, timeout=20, check=False)
    if out.returncode == 0 and out.stdout.strip():
      info["nvidia_smi"] = out.stdout.strip()
  except (OSError, subprocess.TimeoutExpired):
    pass
  return info


def warm_up(engine, api, streams, pools, schedules, max_batch: int) -> None:
  """Build and run every (bucket, batch size) the traffic can produce.

  Streams without deadlines go first, so their full batches are warmed
  before a deadline-tagged request arms the batch cap; the deadline
  streams' own warm-ups come last, and so arm it for the window's start,
  as a live deadline stream would have."""
  samples = []
  for st in streams:
    p = pools.get(st["name"]) or schedules[st["name"]].payloads
    samples.append((st, p))
  engine.prewarm([load.make_request(api, p[0], st) for st, p in samples])
  ordered = sorted(samples, key=lambda sp: sp[0].get("deadline_s") is not None)
  sizes = []
  b = 1
  while b < max_batch:
    sizes.append(b)
    b *= 2
  sizes.append(max_batch)
  for st, p in ordered:
    warm = dict(st)
    if warm.get("deadline_s") is not None:
      warm["deadline_s"] = 600.0  # warm-ups never expire
    for size in sorted(sizes, reverse=True):
      for _ in range(WARM_REPEATS):
        futs = [engine.submit(load.make_request(api, p[i % len(p)], warm))
                for i in range(size)]
        for f in futs:
          f.result()


def _window_state(engine) -> tuple:
  state = engine.observability_state()["metrics"]
  hist = {}
  for label, b in state["buckets"].items():
    for name, (_, s, n) in b["histograms"].items():
      hist[(label, name)] = (s, n)
  return dict(state["counters"]), hist


def _delta(before: tuple, after: tuple) -> tuple:
  c0, h0 = before
  c1, h1 = after
  counters = {k: c1[k] - c0.get(k, 0) for k in c1}
  hist = {}
  for key, (s, n) in h1.items():
    s0, n0 = h0.get(key, (0.0, 0))
    hist[key] = (s - s0, n - n0)
  return counters, hist


def _phases(engine) -> list:
  out = []
  for ev in engine.export_trace().get("traceEvents", []):
    if ev.get("ph") == "X" and ev.get("name") in DEVICE_PHASES:
      s = float(ev["ts"]) * 1e-6
      out.append((ev["name"], s, s + float(ev.get("dur", 0.0)) * 1e-6))
  return out


def end_to_end(run: RunData, metrics: list, setup_s: float) -> dict:
  out = {}
  closed = [o for o in run.obs if o.loop == "closed"]
  due = [o for o in run.obs if o.loop == "open" and o.deadline_s is not None
         and run.t0 <= o.due_s < run.t1]
  for m in metrics:
    if m.name == "setup_s":
      v = setup_s
    elif m.name == "solves_per_s":
      v = sum(stats.window_credit(o.sent_s, o.done_s, run.t0, run.t1)
              for o in closed if run.correct_done(o)) / run.seconds
    elif m.name == "urgent_p95_ms":
      lat = [(o.done_s - o.due_s) * 1e3 if run.correct_done(o) else math.inf
             for o in due]
      v = stats.nearest_rank(lat, 95) if lat else None
      if v is not None and not math.isfinite(v):
        print(f"urgent_p95_ms: the 95th percentile is a failed request; "
              f"reported as {INFINITE_MS}", file=sys.stderr)
        v = INFINITE_MS
    elif m.name == "deadline_met_pct":
      met = [o for o in due if run.correct_done(o)
             and o.done_s - o.due_s <= o.deadline_s]
      v = 100.0 * len(met) / len(due) if due else None
    else:
      raise KeyError(f"no definition for end-to-end metric {m.name!r}")
    if v is not None:
      out[m.name] = {"value": float(v), "unit": m.unit}
  return out


def breakdown(run: RunData) -> dict:
  sl = run.device_slice
  ops = sorted(sl.kernel_seconds().items(), key=lambda kv: -kv[1])[:10]
  by_phase: dict = {}
  for g0, g1 in sl.idle_gaps():
    covered = 0.0
    for name, s, e in run.phases:
      o = min(e, g1) - max(s, g0)
      if o > 0:
        by_phase[f"idle in {name}"] = by_phase.get(f"idle in {name}", 0.0) + o
        covered += o
    rest = (g1 - g0) - covered
    if rest > 0:
      by_phase["idle between batches"] = (
          by_phase.get("idle between batches", 0.0) + rest)
  gaps = sorted(by_phase.items(), key=lambda kv: -kv[1])[:10]
  return {"device_ops": [[n, s] for n, s in ops],
          "idle_gaps": [[n, s] for n, s in gaps]}


def run_cell(cell: spec.Cell, *, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             log=None) -> dict:
  """Run one cell and return its result line (a dict)."""
  log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
  t_start = process_start_s() if t_start is None else t_start
  import torch

  from repro_torch.serve_mmo import MMOEngine
  from repro_torch.serve_mmo import api

  dev = torch.device(device)
  if dev.type == "cuda":
    if dev.index is None:
      dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.set_device(dev)
  config, traffic = cell.config, cell.traffic
  streams = traffic["streams"]
  pools, schedules = {}, {}
  for index, st in enumerate(streams):
    if st["loop"] == "closed":
      pools[st["name"]] = inputs.closed_pool(config, st, index, seed, dev)
    else:
      schedules[st["name"]] = inputs.open_schedule(config, st, index, seed,
                                                   seconds, dev)
  engine_kw = dict(config["engine"])
  max_batch = int(engine_kw.get("max_batch", 8))
  engine = MMOEngine(device=dev, **engine_kw)
  warm_up(engine, api, streams, pools, schedules, max_batch)
  if dev.type == "cuda":
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
  ld = load.Load(engine, api, streams, pools, schedules, seed, seconds)
  prof = slice_ = None
  if trace:
    from bench.lib.profile import Profiler
    prof = Profiler(cuda=dev.type == "cuda")
    prof.start()
  before = _window_state(engine)
  engine.start()
  t0 = ld.start()
  setup_s = t0 - t_start
  time.sleep(max(0.0, ld.t1 - time.perf_counter()))
  ld.close()
  after = _window_state(engine)
  if prof is not None:
    prof.stop()
  ended = ld.join()
  engine.stop(drain=True)
  memory_peak = (int(torch.cuda.max_memory_allocated(dev))
                 if dev.type == "cuda" else 0)
  with engine._lock:
    records = list(engine._records)
  phases = _phases(engine) if trace else []
  if prof is not None:
    slice_ = prof.read(ld.t0, ld.t1)
  del engine, prof
  gc.collect()
  if dev.type == "cuda":
    torch.cuda.empty_cache()
  log(f"window: {len(ld.obs)} requests sent, all ended: {ended}, open-loop "
      f"sender at most {ld.max_late_s * 1e3:.3f} ms late")
  per5 = [0] * max(1, math.ceil(seconds / 5.0))
  for o in ld.obs:
    if o.loop == "closed" and o.state == "done" and ld.t0 <= o.done_s < ld.t1:
      per5[min(len(per5) - 1, int((o.done_s - ld.t0) // 5.0))] += 1
  log(f"closed-loop answers per 5 s of the window: {per5}")

  t_check = time.perf_counter()
  verdict = check.judge(ld.obs, config["checks"], (ld.t0, ld.t1), dev)
  log(f"check: {verdict.checked} answers compared in "
      f"{time.perf_counter() - t_check:.1f} s")
  counters, hist = _delta(before, after)
  run = RunData(workload=cell.workload, config=config, traffic=traffic,
                seconds=seconds, t0=ld.t0, t1=ld.t1, obs=ld.obs,
                wrong=verdict.wrong, squarings=verdict.squarings,
                counters=counters, hist=hist, records=records,
                max_batch=max_batch, device_slice=slice_, phases=phases)
  sent = [o for o in ld.obs if o.sent_s < ld.t1]
  failed = sum(1 for o in sent
               if o.state != "done" or id(o) in verdict.wrong)
  info = device_info(torch, dev)
  info["memory_peak_bytes"] = memory_peak
  if trace:
    metrics = {}
    for m in cell.per_layer:
      v = spec.metric_reader(m.name)(run)
      if v is not None:
        metrics[m.name] = {"value": float(v), "unit": m.unit}
    info["busy_s"] = slice_.busy_s()
    info["window_s"] = slice_.window_s
  else:
    metrics = end_to_end(run, cell.end_to_end, setup_s)
  result = {"correct": verdict.correct, "attempted": len(sent),
            "failed": failed, "metrics": metrics, "device": info}
  if trace:
    result["breakdown"] = breakdown(run)
  log(f"setup_s {setup_s!r}; states: " + json.dumps(
      {s: sum(1 for o in sent if o.state == s)
       for s in ("done", "failed", "expired", "rejected", "pending")}))
  result["checks"] = verdict.as_dict()
  return result
