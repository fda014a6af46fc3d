"""Autotuner: time op × shape bucket × dtype × backend × block config.

    PYTHONPATH=src python -m repro_torch.tuning.autotune --out cost_table.json
    PYTHONPATH=src python -m repro_torch.tuning.autotune --dry-prior \
        --out t.json

    # the distributed schedules on a 2 x 2 mesh of the cards present
    PYTHONPATH=src python -m repro_torch.tuning.autotune --mesh 2,2 \
        --schedules dp,summa --out t.json

Counterpart of ``repro/tuning/autotune.py``.  Every point is first seeded
with the analytic prior, then (unless
``--dry-prior``) measured on the device: on a card with ``torch.cuda.Event``
pairs around each call, after ``warmup`` calls that also pay CUDA's lazy
module load; on the CPU with ``time.perf_counter``.  The best of ``iters``
calls is recorded.  Measured beats prior in the table, so re-running the
tuner only sharpens it.  ``--dry-prior`` runs the whole sweep → record →
serialize path with no device at all.  ``tune_mesh`` (``--mesh``) does the
same for the distributed schedule arms on a device mesh: one mesh row per
(point, schedule), in seconds per request.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import semiring as sr_mod
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.tuning.cost_table import (CostTable, DEFAULT_CONFIGS,
                                           SCHEDULE_ARMS, bucket_shape,
                                           prior_seconds,
                                           sharded_prior_seconds)

DEFAULT_OPS = ("mma", "minplus", "maxmin", "maxmul", "orand", "addnorm")
DEFAULT_SHAPES = ((64, 64, 64), (128, 128, 128), (64, 256, 64))
DEFAULT_BACKENDS = ("xla", "vector", "pallas", "megakernel")


def _megakernel_point_ok(op: str, shape) -> bool:
  """The fused-fixpoint arm only exists for closure-shaped points: square
  contractions on rings with a ⊗-identity (closure is refused elsewhere)."""
  m, k, n = bucket_shape(shape)
  return m == k == n and sr_mod.get(op).otimes_identity is not None


def _device_label(device=DEFAULT_DEVICE) -> str:
  """The card's name, or 'cpu'."""
  dev = torch.device(device)
  if dev.type == "cuda":
    return torch.cuda.get_device_name(dev)
  return dev.type


def _operands(op: str, shape, dtype, seed: int = 0):
  """Random operands at the bucket shape (bool for boolean rings)."""
  m, k, n = bucket_shape(shape)
  rng = np.random.default_rng(seed)
  if sr_mod.get(op).boolean:
    return (rng.random((m, k)) > 0.5), (rng.random((k, n)) > 0.5)
  a = rng.standard_normal((m, k)).astype(dtype)
  b = rng.standard_normal((k, n)).astype(dtype)
  if op in ("minmul", "maxmul"):  # reliability rings want [0, 1] weights
    a, b = np.abs(np.tanh(a)).astype(dtype), np.abs(np.tanh(b)).astype(dtype)
  return a, b


def _best_of(run, dev: torch.device, iters: int, warmup: int) -> float:
  """Best-of seconds for ``run``: CUDA events on a card (one event sync per
  measured call), the host clock on the CPU."""
  for _ in range(warmup):
    run()
  best = float("inf")
  if dev.type == "cuda":
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(iters):
      start.record()
      run()
      end.record()
      end.synchronize()
      best = min(best, start.elapsed_time(end) / 1e3)
    return best
  for _ in range(iters):
    t0 = time.perf_counter()
    run()
    best = min(best, time.perf_counter() - t0)
  return best


def measure_point(op: str, shape, dtype, backend: str, cfg: tuple, *,
                  device=DEFAULT_DEVICE, iters: int = 3,
                  warmup: int = 1) -> float:
  """Best-of seconds for one table point on ``device``."""
  from repro_torch.core.mmo import mmo
  dev = resolve_device(device)
  a_h, b_h = _operands(op, shape, dtype)
  a = torch.from_numpy(a_h).to(dev)
  b = torch.from_numpy(b_h).to(dev)
  return _best_of(lambda: mmo(a, b, op=op, backend=backend, block=cfg),
                  dev, iters, warmup)


def measure_megakernel_point(op: str, shape, dtype, cfg: tuple, *,
                             device=DEFAULT_DEVICE, iters: int = 3,
                             warmup: int = 1) -> float:
  """Best-of seconds *per fused iteration* for one megakernel row.

  The table prices every backend per contraction, so the fused arm is timed
  as one G-iteration chunk and divided by G.  The operand is a directed line
  graph, the slowest-converging closure input, with ``max_iters=G``, so the
  kernel runs exactly its chunk: the steady-state iteration cost, not a
  lucky early convergence."""
  from repro_torch.core.closure import batched_bellman_ford_closure
  dev = resolve_device(device)
  m, k, n = bucket_shape(shape)
  if not m == k == n:
    raise ValueError(f"megakernel rows are square closure points, got "
                     f"{(m, k, n)}")
  g = int(cfg[0]) if cfg else 8
  sr = sr_mod.get(op)
  rng = np.random.default_rng(0)
  if sr.boolean:
    adj_h = np.zeros((n, n), dtype=bool)
    adj_h[np.arange(n - 1), np.arange(1, n)] = True
  else:
    adj_h = np.full((n, n), sr.oplus_identity, dtype=dtype)
    np.fill_diagonal(adj_h, sr.otimes_identity)
    adj_h[np.arange(n - 1), np.arange(1, n)] = np.abs(
        np.tanh(rng.standard_normal(n - 1))).astype(dtype)
  adj = torch.from_numpy(adj_h).to(dev)[None]

  def run():
    return batched_bellman_ford_closure(
        adj, op=op, fixpoint_backend="megakernel", megakernel_g=g,
        max_iters=g)

  return _best_of(run, dev, iters, warmup) / g


def default_backends(device=DEFAULT_DEVICE) -> tuple:
  """Backends worth measuring on ``device``: the kernel arms ('pallas' and
  the fused 'megakernel') only on a card.  On the CPU they run their plain
  versions, which no one serves with.  (``--dry-prior`` sweeps cover every
  backend: priors cost nothing.)"""
  extra = (("pallas", "megakernel")
           if torch.device(device).type == "cuda" else ())
  return ("xla", "vector") + extra


def tune(*,
         ops: Sequence[str] = DEFAULT_OPS,
         shapes: Sequence[tuple] = DEFAULT_SHAPES,
         dtypes: Sequence[str] = ("float32",),
         backends: Optional[Sequence[str]] = None,
         configs: Optional[dict] = None,
         table: Optional[CostTable] = None,
         device=DEFAULT_DEVICE,
         iters: int = 3,
         warmup: int = 1,
         dry_prior: bool = False,
         fill_prior: bool = True,
         verbose: bool = False) -> CostTable:
  """Sweep the grid, recording priors for every point and measurements on
  ``device`` for all of them unless ``dry_prior``.  Updates and returns
  ``table``."""
  if not dry_prior:
    device = resolve_device(device)
  if backends is None:
    backends = DEFAULT_BACKENDS if dry_prior else default_backends(device)
  configs = configs or DEFAULT_CONFIGS
  if table is None:
    table = CostTable(device="prior-only" if dry_prior
                      else _device_label(device))
  for op in ops:
    boolean = sr_mod.get(op).boolean
    op_dtypes = ("bool",) if boolean else dtypes
    for shape in shapes:
      for dtype in op_dtypes:
        for backend in backends:
          if backend == "megakernel" and not _megakernel_point_ok(op, shape):
            continue  # closure undefined here: no row, prior or measured
          for cfg in configs.get(backend, ((),)):
            if fill_prior:
              table.record(op, shape, dtype, backend, cfg,
                           prior_seconds(op, shape, dtype, backend, cfg),
                           source="prior")
            if dry_prior:
              continue
            if backend == "megakernel":
              seconds = measure_megakernel_point(
                  op, shape, dtype, cfg, device=device, iters=iters,
                  warmup=warmup)
            else:
              seconds = measure_point(op, shape, dtype, backend, cfg,
                                      device=device, iters=iters,
                                      warmup=warmup)
            table.record(op, shape, dtype, backend, cfg, seconds,
                         source="measured")
            if verbose:
              print(f"[autotune] {op} {shape} {dtype} {backend} {cfg}: "
                    f"{seconds * 1e6:.1f}us", file=sys.stderr)
  return table


def measure_sharded_point(op: str, shape, dtype, schedule: str, mesh, *,
                          requests: Optional[int] = None, iters: int = 3,
                          warmup: int = 1) -> float:
  """Best-of seconds *per request* for one distributed-schedule arm: one
  batched sharded contraction over ``requests`` (default: one per shard,
  the smallest batch every schedule can shard) with each shard's
  contraction on 'pallas' (K1 on a card), divided by the request count.  Timed with
  CUDA events on the mesh's first card (every shard's work is on the
  streams by then, since the call ends in a copy back to that card), the
  host clock on the CPU."""
  from repro_torch.core.distributed import mmo_sharded_batched
  r = requests if requests is not None else mesh.size
  dev = mesh.devices[0][0]
  ops = [_operands(op, shape, dtype, seed=i) for i in range(r)]
  a = torch.from_numpy(np.stack([o[0] for o in ops])).to(dev)
  b = torch.from_numpy(np.stack([o[1] for o in ops])).to(dev)

  def run():
    return mmo_sharded_batched(a, b, op=op, schedule=schedule, mesh=mesh,
                               backend="pallas")

  return _best_of(run, dev, iters, warmup) / r


def tune_mesh(*,
              dims: Sequence[int],
              mesh=None,
              ops: Sequence[str] = DEFAULT_OPS,
              shapes: Sequence[tuple] = DEFAULT_SHAPES,
              dtypes: Sequence[str] = ("float32",),
              schedules: Sequence[str] = SCHEDULE_ARMS,
              table: Optional[CostTable] = None,
              device=DEFAULT_DEVICE,
              iters: int = 3,
              warmup: int = 1,
              dry_prior: bool = False,
              verbose: bool = False) -> CostTable:
  """Sweep the distributed-schedule arms on a (rows, cols) mesh: the
  sharded prior for every point, and a measurement on ``mesh`` (by default
  one built over the devices of ``device``'s type that exist) unless
  ``dry_prior``, which needs no device.  Points a schedule cannot shard
  (``core.distributed.schedule_fits``) keep their prior only.  Updates and
  returns ``table``."""
  dims = tuple(int(d) for d in dims)
  if table is None:
    table = CostTable(device="prior-only" if dry_prior
                      else _device_label(device if mesh is None
                                         else mesh.devices[0][0]))
  if not dry_prior:
    from repro_torch.core.distributed import schedule_fits
    if mesh is None:
      from repro_torch.launch.mesh import make_host_mesh
      mesh = make_host_mesh(dims[0] * dims[-1], model=dims[-1],
                            device=device)
    if (mesh.shape[mesh.axis_names[0]], mesh.shape[mesh.axis_names[-1]]) \
        != (dims[0], dims[-1]):
      raise ValueError(f"mesh shape {mesh.shape} is not {dims}")
  for op in ops:
    op_dtypes = ("bool",) if sr_mod.get(op).boolean else dtypes
    for shape in shapes:
      m, k, n = bucket_shape(shape)
      for dtype in op_dtypes:
        for sched in schedules:
          if sched not in SCHEDULE_ARMS:
            raise ValueError(f"unknown schedule {sched!r}; one of "
                             f"{SCHEDULE_ARMS}")
          table.record(op, shape, dtype, sched, dims,
                       sharded_prior_seconds(op, (m, k, n), dtype, sched,
                                             dims, backend="pallas"),
                       source="prior")
          if dry_prior or not schedule_fits(sched, m, k, n, mesh):
            continue
          seconds = measure_sharded_point(op, shape, dtype, sched, mesh,
                                          iters=iters, warmup=warmup)
          table.record(op, shape, dtype, sched, dims, seconds,
                       source="measured")
          if verbose:
            print(f"[autotune] {op} {shape} {dtype} {sched}@{dims}: "
                  f"{seconds * 1e6:.1f}us", file=sys.stderr)
  return table


def tune_for_requests(reqs, **kw) -> CostTable:
  """Tune exactly the (op, contraction shape, dtype) points a sample of
  serving requests exercises: the engine-warmup entry point."""
  from repro_torch.serve_mmo.scheduler import contract_shape, request_bucket
  points = {}
  for req in reqs:
    key = request_bucket(req)
    points.setdefault((key.op, contract_shape(key), key.dtypes[0]), None)
  table = kw.pop("table", None)
  if table is None:  # not `or`: an empty CostTable is falsy but valid
    table = CostTable(device=("prior-only" if kw.get("dry_prior")
                              else _device_label(kw.get("device",
                                                        DEFAULT_DEVICE))))
  for (op, shape, dtype) in points:
    table = tune(ops=(op,), shapes=(shape,), dtypes=(dtype,), table=table,
                 **kw)
  return table


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--out", default="cost_table.json",
                  help="JSON path to write the table to")
  ap.add_argument("--update", action="store_true",
                  help="load --out first and update it in place")
  ap.add_argument("--dry-prior", action="store_true",
                  help="analytic prior only, no device timing")
  ap.add_argument("--ops", default=",".join(DEFAULT_OPS))
  ap.add_argument("--shapes",
                  default=",".join("x".join(map(str, s))
                                   for s in DEFAULT_SHAPES),
                  help="comma-separated MxKxN triples, e.g. 64x64x64,128x128x128")
  ap.add_argument("--dtypes", default="float32")
  ap.add_argument("--backends", default=None,
                  help="comma-separated; default: every backend for "
                       "--dry-prior, else what the device can serve with")
  ap.add_argument("--iters", type=int, default=3)
  ap.add_argument("--warmup", type=int, default=1)
  ap.add_argument("--device", default=DEFAULT_DEVICE,
                  help="torch device to measure on (default cuda; fails "
                       "without a card)")
  ap.add_argument("--mesh", default=None, metavar="ROWS,COLS",
                  help="also sweep the distributed-schedule arms "
                       f"({','.join(SCHEDULE_ARMS)}) on a mesh of this shape "
                       "over the devices present, recording the mesh rows "
                       "the sharded serving path dispatches from "
                       "(--dry-prior needs no devices)")
  ap.add_argument("--schedules", default=",".join(SCHEDULE_ARMS),
                  help="comma-separated schedule arms for --mesh")
  ap.add_argument("-v", "--verbose", action="store_true")
  args = ap.parse_args(argv)

  try:
    shapes = tuple(tuple(int(d) for d in s.split("x"))
                   for s in args.shapes.split(","))
    if any(len(s) != 3 for s in shapes):
      raise ValueError
  except ValueError:
    ap.error(f"--shapes must be comma-separated MxKxN triples, got "
             f"{args.shapes!r}")

  dims = None
  if args.mesh:
    try:
      dims = tuple(int(x) for x in args.mesh.split(","))
      if len(dims) != 2 or any(d <= 0 for d in dims):
        raise ValueError
    except ValueError:
      ap.error(f"--mesh must be 'rows,cols' positive ints, got {args.mesh!r}")
    if not args.dry_prior:
      from repro_torch.launch.mesh import available_devices
      need, have = dims[0] * dims[1], len(available_devices(args.device))
      if need > have:
        ap.error(f"--mesh {args.mesh} needs {need} devices, host has {have}")

  table = CostTable.load(args.out) if args.update else None
  backends = tuple(args.backends.split(",")) if args.backends else None
  table = tune(ops=tuple(args.ops.split(",")), shapes=shapes,
               dtypes=tuple(args.dtypes.split(",")),
               backends=backends, table=table, device=args.device,
               iters=args.iters, warmup=args.warmup,
               dry_prior=args.dry_prior, verbose=args.verbose)
  if dims is not None:
    table = tune_mesh(dims=dims, ops=tuple(args.ops.split(",")),
                      shapes=shapes, dtypes=tuple(args.dtypes.split(",")),
                      schedules=tuple(args.schedules.split(",")),
                      table=table, device=args.device, iters=args.iters,
                      warmup=args.warmup, dry_prior=args.dry_prior,
                      verbose=args.verbose)
  table.save(args.out)
  counts = table.counts()
  print(f"[autotune] wrote {args.out}: {len(table)} entries "
        f"({counts['measured']} measured, {counts['prior']} prior) "
        f"device={table.device}")
  return 0


if __name__ == "__main__":
  sys.exit(main())
