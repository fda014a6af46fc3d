"""Training driver: config → mesh → sharded train loop with checkpointing,
fault tolerance and deterministic resume.

    python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --steps 200 --batch 8 --seq 256 --smoke --ckpt-dir run1
    python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke \
        --steps 30 --batch 8 --seq 32 --device cpu --shards 8
    python -m repro_torch.launch.train --arch mixtral-8x7b --smoke \
        --steps 30 --batch 4 --seq 32 --device cpu

Counterpart of ``repro/launch/train.py``, with its flags plus ``--device``
(default ``cuda``; ``cpu`` for the CPU), ``--shards`` and
``--deterministic``.  As the reference does, it builds a host mesh over
the devices of ``--device``'s type that exist (``model`` 2 when there are
more than one); ``--shards N`` builds a virtual mesh of N shards of
``--device`` instead (the counterpart of the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count``).  The step gets
none of the mesh knobs.

A mesh of one position (one card, ``--device cpu``, ``--shards 1``) runs
what the reference's GSPMD compiles on a 1 × 1 mesh: the one-device step
(``make_train_step(cfg, oc, accum=...)``) on the state ``(model,
init_opt_state(param_tree(model)))``.  On more positions the driver takes
``Parallelism(data_axes=("data",), tp_size=<model>)``, places the f32
master and both AdamW moments by ``specs_like`` (``train/sharded.py``)
and runs the tensor-parallel step: each mesh position runs its data
line's rows forward and backward on its heads, widths and vocab piece,
and its gradients land in the master's pieces (``train/steps.py``).  The
``[train] mesh`` line names the step.  Every ``--ckpt-every`` steps the
full train state is gathered and committed atomically in the reference's
layout; on restart the driver resumes from LATEST, on whatever mesh it
runs, and the stateless data pipeline replays the exact stream.
``--fail-at`` kills the process (exit code 42) at that step so tests can
exercise the restart path.  ``--deterministic`` makes every kernel pick a
deterministic algorithm (on the card the embedding's backward accumulates
with atomics otherwise), so a resumed run repeats the uninterrupted one.
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("--arch", required=True)
  ap.add_argument("--smoke", action="store_true")
  ap.add_argument("--steps", type=int, default=100)
  ap.add_argument("--batch", type=int, default=8)
  ap.add_argument("--seq", type=int, default=256)
  ap.add_argument("--lr", type=float, default=3e-3)
  ap.add_argument("--accum", type=int, default=1)
  ap.add_argument("--ckpt-dir", default=None)
  ap.add_argument("--ckpt-every", type=int, default=50)
  ap.add_argument("--fail-at", type=int, default=None,
                  help="simulate a node failure at this step (tests)")
  ap.add_argument("--corpus", default=None)
  ap.add_argument("--async-ckpt", action="store_true",
                  help="commit checkpoints on a background thread")
  ap.add_argument("--prefetch", type=int, default=2)
  ap.add_argument("--log-every", type=int, default=10)
  ap.add_argument("--seed", type=int, default=0)
  ap.add_argument("--device", default="cuda",
                  help="torch device to train on (default: cuda)")
  ap.add_argument("--shards", type=int, default=0,
                  help="a virtual mesh of this many shards of --device "
                       "(default: one shard per device present)")
  ap.add_argument("--deterministic", action="store_true",
                  help="deterministic kernels only, so a resumed run "
                       "repeats the uninterrupted one")
  args = ap.parse_args(argv)

  if args.deterministic:
    # cuBLAS reads this when its first handle is made: before any CUDA work
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
  import torch
  from repro_torch import configs
  from repro_torch.analysis.sanitize import maybe_enable_sanitize
  from repro_torch.data import DataConfig, make_source
  from repro_torch.device import resolve_device
  from repro_torch.launch import mesh as mesh_mod
  from repro_torch.models import common as cm
  from repro_torch.models import zoo
  from repro_torch.train import (AdamWConfig, checkpoint as ckpt,
                                 init_opt_state, make_train_step)
  from repro_torch.train.sharded import shard_state
  if args.deterministic:
    torch.use_deterministic_algorithms(True)
  maybe_enable_sanitize()  # REPRO_SANITIZE=1: NaN checks, anomaly mode

  device = resolve_device(args.device)
  cfg = configs.get_config(args.arch, smoke=args.smoke)
  oc = AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 20),
                   total_steps=args.steps)
  data = make_source(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                global_batch=args.batch, seed=args.seed,
                                corpus_path=args.corpus),
                     prefetch=args.prefetch)

  if args.shards:
    mesh = mesh_mod.make_host_mesh(model=2 if args.shards > 1 else 1,
                                   devices=[device] * args.shards)
  else:
    n_dev = len(mesh_mod.available_devices(args.device))
    mesh = mesh_mod.make_host_mesh(model=2 if n_dev > 1 else 1,
                                   device=args.device)
  par = cm.Parallelism(data_axes=("data",), tp_size=mesh.shape["model"])

  start = 0
  home = mesh.devices[0][0]
  one_position = mesh.size == 1
  model = zoo.init(cfg, torch.Generator(device=home).manual_seed(args.seed),
                   home)
  params = zoo.param_tree(model)
  if one_position:
    state = (model, init_opt_state(params))
  else:
    state = shard_state(params, cm.specs_like(params, cfg, par), mesh)
  del model, params
  if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
    if one_position:
      restored, start = ckpt.restore(
          args.ckpt_dir,
          template={"params": zoo.param_tree(state[0]), "opt": state[1]})
      state = (zoo.from_params(cfg, restored["params"]), restored["opt"])
    else:
      state, start = ckpt.restore(args.ckpt_dir, template=state)
    print(f"[train] resumed from step {start}")
  print(f"[train] mesh data={mesh.shape['data']} x "
        f"model={mesh.shape['model']} on {mesh.device_type}, "
        + ("one-device step" if one_position
           else "tensor-parallel step over model"), flush=True)

  step_fn = make_train_step(cfg, oc, accum=args.accum,
                            mesh=None if one_position else mesh)
  checkpointer = (ckpt.AsyncCheckpointer(args.ckpt_dir)
                  if args.ckpt_dir and args.async_ckpt else None)
  t0 = time.time()
  for step in range(start, args.steps):
    if args.fail_at is not None and step == args.fail_at:
      print(f"[train] simulating node failure at step {step}", flush=True)
      os._exit(42)
    batch = data.batch_at(step)
    state, metrics = step_fn(state, batch)
    if (step + 1) % args.log_every == 0 or step == start:
      loss = float(metrics["loss"])
      dt = time.time() - t0
      tok_s = args.batch * args.seq * (step + 1 - start) / max(dt, 1e-9)
      print(f"[train] step={step + 1} loss={loss:.6f} "
            f"aux={float(metrics['aux_loss']):.4f} "
            f"lr={float(metrics['lr']):.2e} "
            f"gnorm={float(metrics['grad_norm']):.2f} tok/s={tok_s:,.0f}",
            flush=True)
    if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
      # the reference's tree: {'params', 'opt'} whatever the state
      payload = ({"params": zoo.param_tree(state[0]), "opt": state[1]}
                 if one_position else state)
      if checkpointer is not None:
        checkpointer.save(step + 1, payload)
      else:
        ckpt.save(args.ckpt_dir, step + 1, payload)
  if checkpointer is not None:
    checkpointer.wait()
  print("[train] done")
  return 0


if __name__ == "__main__":
  sys.exit(main())
