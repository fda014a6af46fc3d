"""Dry run: does each (architecture × input shape × mesh) cell fit, and
what bounds it?  Counted on one host, without the machines.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell against 512 placeholder host devices and walks XLA's HLO.  The port
has no compiler to ask.  It runs its own step (``train/steps.py``:
``make_train_step``, ``make_prefill_step`` or ``make_decode_step``) on the
``xla`` arm, on meta tensors at the cell's global shapes, under
``roofline/flops.CostCounter``: nothing is computed or allocated and the
card is not touched.  K3 and K4 cannot run on meta tensors; the
reference's cells lower the same default arm.

Each row keeps ``analysis.Roofline.row()``'s keys, plus ``status``,
``trace_s`` (the reference's ``lower_s``/``compile_s``), ``arg_bytes``,
``out_bytes``, ``temp_bytes`` and ``accum``.  The reference's
``code_bytes``, ``xla_flops_raw`` and ``xla_bytes_raw`` read a compiled
executable and have no counterpart.  The values:

  * ``hlo_flops``, ``hlo_bytes`` — the global program's dot FLOPs and
    bytes.  Work that the reference's per-device programs repeat (the k/v
    projections replicated when the KV heads do not divide by the model
    axis, the router) is counted once.
  * ``arg_bytes``, ``out_bytes`` — exact: each leaf of the step's inputs
    (parameters; AdamW's moments in a train cell; the cache in a decode
    cell; the batch) and of its new outputs (a prefill's logits and cache,
    a decode's tokens, the metrics) divided, dimension by dimension, over
    the mesh axes its spec names.  The train step updates its state and
    the decode step its cache in place, as the reference donates them.
  * ``temp_bytes`` — an estimate: the counter's peak of live op outputs
    (``CostCounter.peak``; a train cell with accum > 1 adds the running
    f32 gradient sum) divided by the chips, as if every temporary were
    sharded over the whole mesh.
  * ``peak_mem_per_dev`` = arg + out + temp.
  * ``coll_bytes_per_dev``, ``coll_breakdown`` — a closed-form ring model
    (``collectives.ring_traffic_bytes``), per device, by axis group; D is
    the data axes' size, T the model axis's, a leaf's local bytes are its
    bytes divided over the axes its spec names other than the data axes,
    and tokens are a microbatch's tokens on one data shard:
      fsdp_all_gather       Σ_leaves sharded over data
                              ring(all-gather, local bytes, D) × n_g, the
                              master's f32 per microbatch (n_g = accum, ×2
                              in a train cell under remat "full": the
                              recompute gathers again), or with ``zero2``
                              the bf16 compute copy once per step (n_g = 1)
      grad_reduce_scatter   train: Σ_leaves sharded over data
                              ring(reduce-scatter, local grad bytes, D) ×
                              accum; f32, bf16 with ``grad_comm_bf16``
      grad_all_reduce       train: the same over the leaves replicated over
                              data, ring(all-reduce, ...)
      tp_all_reduce         ring(all-reduce, tokens · d_model · 2, T) per
                              row-parallel projection (attention's wo, the
                              MLP's or experts' w2, the SSM's out_proj: 2 per
                              transformer block, 1 per SSM layer, 3 per
                              decoder layer of the enc-dec), × accum; a
                              train cell adds as many for the backward and,
                              under remat "full", for the recompute
      decode_attn_all_reduce  decode with the cache's sequence on the model
                              axis: ring(all-reduce, B · H · (hd + 2) · 4, T)
                              per attention layer (partial outputs, max and
                              sum in f32)
    The data terms run over the data axes' group, the others over the
    model axis; ``analysis.axis_group_rate`` gives each group's link rate.

A train cell with accum > 1 runs one microbatch (``global_batch / accum``
rows) through ``make_train_step(accum=1)`` and counts accum × (that step
less AdamW) + AdamW + the accumulation's sums, which is what the step with
``accum`` microbatches dispatches.  ``make_train_step`` refuses
``grad_specs``, ``zero2`` and ``grad_comm_bf16`` (one device): the dry run
passes none of them and applies ``--zero2`` and ``--grad-comm-bf16`` in
its collective model only.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from typing import Optional

import torch

from repro_torch import configs
from repro_torch.configs import Shape
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs as sp
from repro_torch.models import attention as attn_mod
from repro_torch.models import common as cm
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import zoo
from repro_torch.roofline import analysis
from repro_torch.roofline.collectives import ring_traffic_bytes
from repro_torch.roofline.flops import CostCounter
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import steps as steps_mod


def active_params(cfg) -> float:
  """Non-embedding active params (MoE: topk/E of expert weights)."""
  total = 0.0
  for path, leaf in cm.tree_paths(sp.param_shapes(cfg)).items():
    n = math.prod(leaf.shape)
    if "embed" in path or "lm_head" in path:
      continue
    if "experts" in path and cfg.n_experts:
      n = n * cfg.topk / cfg.n_experts
    total += n
  return total


# Gradient microbatching per train cell: fixed global batch, sequential
# accumulation — the standard memory lever when activations exceed device
# memory at accum=1 (the reference's table).
ACCUM_OVERRIDES = {
    ("mixtral-8x7b", "train_4k"): 4,
    ("phi3.5-moe-42b-a6.6b", "train_4k"): 4,
    ("chameleon-34b", "train_4k"): 8,
    ("zamba2-7b", "train_4k"): 4,
    ("seamless-m4t-large-v2", "train_4k"): 4,
}


@dataclasses.dataclass
class Cell:
  """One cell, ready to count: the step and its meta inputs."""
  cfg: cm.ModelConfig
  shape: Shape
  mesh: mesh_mod.AbstractMesh
  par: cm.Parallelism
  act_spec: Optional[tuple]
  accum: int
  remat: str
  zero2: bool
  grad_comm_bf16: bool
  model: torch.nn.Module
  param_specs: dict
  args: tuple       # the step's meta inputs
  arg_specs: tuple  # their specs, leaf for leaf


def _parallelism(mesh, *, fsdp, seq_shard_decode, remat) -> cm.Parallelism:
  """The batch over every axis but the last, the model axis."""
  names = mesh.axis_names
  return cm.Parallelism(
      data_axes=tuple(names[:-1]), model_axis=names[-1],
      tp_size=mesh.shape[names[-1]],
      dp_size=math.prod(mesh.shape[a] for a in names[:-1]), fsdp=fsdp,
      seq_shard_decode=seq_shard_decode, remat=remat)


def build_cell(arch: str, shape, mesh, *, remat: str = "full",
               accum: int = 0, seq_shard_decode: bool = True,
               fsdp: bool = True, act_seq_shard: bool = True,
               cfg_overrides: dict = None, zero2: bool = False,
               grad_comm_bf16: bool = False) -> Cell:
  """``shape`` is a name of ``configs.SHAPES`` or a ``Shape``; ``mesh``
  "single", "multi" or an ``AbstractMesh`` (its last axis the model
  axis)."""
  shape = configs.SHAPES[shape] if isinstance(shape, str) else shape
  if accum == 0:  # auto: per-cell override table, default 1
    accum = ACCUM_OVERRIDES.get((arch, shape.name), 1)
  if shape.kind != "train":
    accum = 1
  if shape.global_batch % accum:
    raise ValueError(f"a batch of {shape.global_batch} does not split into "
                     f"{accum} microbatches")
  cfg = configs.get_config(arch)
  if cfg_overrides:
    cfg = cfg.replace(**cfg_overrides)
  mesh, _ = mesh_mod.as_abstract_mesh(mesh)
  par = _parallelism(mesh, fsdp=fsdp, seq_shard_decode=seq_shard_decode,
                     remat=remat)
  act_spec = (par.dp, par.tp, None) if act_seq_shard else None
  model = sp.init_meta(cfg)
  params = zoo.param_tree(model)
  p_specs = cm.specs_like(params, cfg, par)
  # a train cell's batch is one microbatch; its specs are the global batch's
  run_shape = dataclasses.replace(shape,
                                  global_batch=shape.global_batch // accum)
  batch = sp.batch_shapes(cfg, run_shape)
  b_specs = sp.batch_specs(cfg, shape, par)
  if shape.kind == "train":
    opt = opt_mod.init_opt_state(params)
    args = ((model, opt), batch)
    arg_specs = ((p_specs, {"m": p_specs, "v": p_specs, "step": ()}),
                 b_specs)
  elif shape.kind == "prefill":
    args, arg_specs = (model, batch), (p_specs, b_specs)
  else:
    cache = sp.cache_shapes(cfg, shape)
    args = (model, cache, batch)
    arg_specs = (p_specs, sp.cache_specs(cfg, par, shape), b_specs)
  return Cell(cfg, shape, mesh, par, act_spec, accum, remat, zero2,
              grad_comm_bf16, model, p_specs, args, arg_specs)


# ---------------------------------------------------------------------------
# bytes per device
# ---------------------------------------------------------------------------


def _factor(entry, mesh_shape: dict) -> int:
  if entry is None:
    return 1
  names = entry if isinstance(entry, tuple) else (entry,)
  return math.prod(mesh_shape[a] for a in names)


def local_bytes(t: torch.Tensor, spec, mesh_shape: dict,
                skip: tuple = ()) -> int:
  """Bytes of ``t``'s share on one device under ``spec``, the axes in
  ``skip`` taken as unsharded."""
  if len(spec) != t.ndim:
    raise ValueError(f"spec {spec} for a {t.ndim}-dimensional tensor")
  n = 1
  for dim, entry in zip(t.shape, spec):
    names = () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))
    kept = tuple(a for a in names if a not in skip)
    n *= -(-dim // _factor(kept or None, mesh_shape))
  return n * t.element_size()


def _leaves_with_specs(tree, specs):
  """(tensor, spec) pairs of a tree and its spec tree, walked together."""
  if isinstance(tree, torch.nn.Module):
    tree = zoo.param_tree(tree)
  if isinstance(tree, dict):
    for k, v in tree.items():
      yield from _leaves_with_specs(v, specs[k])
  elif isinstance(tree, (list, tuple)):
    for v, s in zip(tree, specs, strict=True):
      yield from _leaves_with_specs(v, s)
  else:
    yield tree, specs


def tree_bytes(tree, specs, mesh_shape: dict) -> int:
  return sum(local_bytes(t, s, mesh_shape)
             for t, s in _leaves_with_specs(tree, specs))


def new_outputs(cell: Cell, outs) -> tuple:
  """(the step's outputs that are not its inputs updated in place, their
  specs): a train step's metrics, a prefill's logits and cache, a
  decode's tokens."""
  par, shape = cell.par, cell.shape
  dp = par.dp_for(shape.global_batch)
  if shape.kind == "train":
    return outs[1], {k: () for k in outs[1]}
  if shape.kind == "prefill":
    return outs, ((dp, par.tp), sp.cache_specs(cell.cfg, par, shape))
  return outs[0], (dp, None)


# ---------------------------------------------------------------------------
# the collective model (formulas in the module docstring)
# ---------------------------------------------------------------------------


def _row_parallel_per_forward(cfg) -> tuple:
  """(row-parallel projections per token of the step's tokens, per token of
  the enc-dec's source)."""
  if cfg.family == "ssm":
    return cfg.n_layers, 0
  if cfg.family == "hybrid":
    return cfg.n_layers + 2 * hybrid_mod.layout(cfg)[1], 0
  if cfg.family == "encdec":
    return 3 * cfg.dec_layers, 2 * cfg.enc_layers
  return 2 * cfg.n_layers, 0


def _attention_layers(cfg) -> int:
  return {"ssm": 0, "hybrid": hybrid_mod.layout(cfg)[1],
          "encdec": cfg.dec_layers}.get(cfg.family, cfg.n_layers)


def collective_model(cell: Cell) -> tuple:
  """({term: per-device bytes}, {axis group: per-device bytes},
  {axis group: link rate})."""
  cfg, par, shape, mesh = cell.cfg, cell.par, cell.shape, cell.mesh
  ms = mesh.shape
  data, model = tuple(par.data_axes), par.model_axis
  d_size, t_size = par.dp_size, par.tp_size
  train = shape.kind == "train"
  terms = dict.fromkeys(("fsdp_all_gather", "grad_reduce_scatter",
                         "grad_all_reduce", "tp_all_reduce",
                         "decode_attn_all_reduce"), 0.0)
  comp = torch.empty((), dtype=cfg.dtype).element_size()
  if train and not cell.zero2:
    gathers = cell.accum * (2 if cell.remat == "full" else 1)
  else:
    gathers = 1
  grad_size = 2 if cell.grad_comm_bf16 else 4
  for t, spec in _leaves_with_specs(cell.model, cell.param_specs):
    over_data = any(a in data for e in spec if e is not None
                    for a in (e if isinstance(e, tuple) else (e,)))
    elems = local_bytes(t, spec, ms, skip=data) // t.element_size()
    if over_data:
      size = comp if cell.zero2 else t.element_size()
      terms["fsdp_all_gather"] += gathers * ring_traffic_bytes(
          "all-gather", elems * size, d_size)
    if train:
      kind = "reduce-scatter" if over_data else "all-reduce"
      key = "grad_reduce_scatter" if over_data else "grad_all_reduce"
      terms[key] += cell.accum * ring_traffic_bytes(kind, elems * grad_size,
                                                    d_size)
  b = shape.global_batch // cell.accum
  b_local = b // d_size if par.dp_for(shape.global_batch) else b
  step_tokens = b_local * (1 if shape.kind == "decode" else shape.seq_len)
  per_tok, per_src = _row_parallel_per_forward(cfg)
  passes = (1 + (1 if train else 0)
            + (1 if train and cell.remat == "full" else 0))
  if shape.kind == "decode":
    per_src = 0  # the encoder's output comes in the batch
  act = (per_tok * step_tokens + per_src * b_local * cfg.src_len) \
      * cfg.d_model * comp
  terms["tp_all_reduce"] = cell.accum * passes * ring_traffic_bytes(
      "all-reduce", act, t_size)
  if shape.kind == "decode" and par.seq_shard_decode:
    partial = b_local * cfg.n_heads * (cfg.hd + 2) * 4
    terms["decode_attn_all_reduce"] = _attention_layers(cfg) * \
        ring_traffic_bytes("all-reduce", partial, t_size)
  data_key, model_key = "+".join(data), model
  axis_bytes = {
      data_key: (terms["fsdp_all_gather"] + terms["grad_reduce_scatter"]
                 + terms["grad_all_reduce"]),
      model_key: terms["tp_all_reduce"] + terms["decode_attn_all_reduce"]}
  rates = {data_key: analysis.axis_group_rate(mesh, data),
           model_key: analysis.axis_group_rate(mesh, model)}
  return terms, axis_bytes, rates


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------


def _counted(fn) -> tuple:
  with CostCounter() as c:
    out = fn()
  return out, c


def count_cell(cell: Cell) -> tuple:
  """(flops, bytes, peak live bytes, the step's outputs) of the cell's
  step, at its global shapes."""
  kind, cfg = cell.shape.kind, cell.cfg
  if kind == "prefill":
    step = steps_mod.make_prefill_step(cfg, impl="xla")
    with torch.no_grad():
      outs, c = _counted(lambda: step(*cell.args))
    return c.flops, c.bytes, c.peak, outs
  if kind == "decode":
    step = steps_mod.make_decode_step(cfg)
    with torch.no_grad():
      outs, c = _counted(lambda: step(*cell.args))
    return c.flops, c.bytes, c.peak, outs
  oc = opt_mod.AdamWConfig()
  step = steps_mod.make_train_step(cfg, oc, accum=1, impl="xla",
                                   remat=cell.remat)
  outs, c = _counted(lambda: step(*cell.args))
  if cell.accum == 1:
    return c.flops, c.bytes, c.peak, outs
  params = zoo.param_tree(cell.model)
  grads = opt_mod.tree_map(
      lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta"),
      params)
  _, c_opt = _counted(lambda: opt_mod.adamw_update(oc, params, grads,
                                                   cell.args[0][1]))
  _, c_acc = _counted(lambda: _accumulate(opt_mod._leaves(grads),
                                          cell.accum))
  a = cell.accum
  flops = a * (c.flops - c_opt.flops) + c_opt.flops + c_acc.flops
  nbytes = a * (c.bytes - c_opt.bytes) + c_opt.bytes + c_acc.bytes
  grad_bytes = sum(g.numel() * 4 for g in opt_mod._leaves(grads))
  return flops, nbytes, c.peak + grad_bytes, outs


def _accumulate(grads: list, accum: int) -> None:
  """The sums and means ``make_train_step`` adds for ``accum`` microbatches
  (gradients, loss and aux)."""
  loss = aux = torch.empty((), device="meta")
  acc = grads
  for _ in range(accum - 1):
    acc = [x + y for x, y in zip(acc, grads)]
    loss, aux = loss + loss, aux + aux
  _ = [g / accum for g in acc]
  _ = (loss / accum, aux / accum)


def run_cell(arch: str, shape, mesh, **kw) -> dict:
  """One row; ``shape`` and ``mesh`` as ``build_cell`` takes them."""
  shape_name = shape if isinstance(shape, str) else shape.name
  _, mesh_label = mesh_mod.as_abstract_mesh(mesh)
  skip = configs.skip_reason(arch, shape_name)
  if skip:
    return {"arch": arch, "shape": shape_name, "mesh": mesh_label,
            "status": "skipped", "reason": skip}
  t0 = time.perf_counter()
  cell = build_cell(arch, shape, mesh, **kw)
  with cm.activation_sharding(cell.act_spec):
    flops, nbytes, peak, outs = count_cell(cell)
  t_trace = time.perf_counter() - t0
  ms = cell.mesh.shape
  chips = cell.mesh.size
  arg_b = tree_bytes(cell.args, cell.arg_specs, ms)
  out_b = tree_bytes(*new_outputs(cell, outs), ms)
  tmp_b = math.ceil(peak / chips)
  terms, axis_bytes, rates = collective_model(cell)
  shp = cell.shape
  tokens = shp.global_batch * (shp.seq_len if shp.kind != "decode" else 1)
  mf = analysis.model_flops_estimate(active_params(cell.cfg), shp.kind,
                                     tokens)
  roof = analysis.Roofline(
      arch=arch, shape=shape_name, mesh=mesh_label, chips=chips,
      hlo_flops=float(flops), hlo_bytes=float(nbytes),
      coll_bytes=sum(axis_bytes.values()), coll_breakdown=terms,
      model_flops=mf, peak_memory_per_dev=arg_b + out_b + tmp_b,
      coll_axis_bytes=axis_bytes, axis_rates=rates)
  row = roof.row()
  row.update({"status": "ok", "trace_s": round(t_trace, 1),
              "arg_bytes": arg_b, "out_bytes": out_b, "temp_bytes": tmp_b,
              "accum": cell.accum})
  return row


def main(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("--arch", default=None)
  ap.add_argument("--shape", default=None)
  ap.add_argument("--mesh", default="single", choices=("single", "multi"))
  ap.add_argument("--all", action="store_true")
  ap.add_argument("--out", default=None, help="directory for per-cell JSON")
  ap.add_argument("--remat", default="full")
  ap.add_argument("--accum", type=int, default=0)
  ap.add_argument("--no-fsdp", action="store_true")
  ap.add_argument("--no-seq-shard-decode", action="store_true")
  ap.add_argument("--no-act-seq-shard", action="store_true")
  ap.add_argument("--zero2", action="store_true",
                  help="ZeRO-2: gather compute params once per step")
  ap.add_argument("--grad-comm-bf16", action="store_true",
                  help="bf16 gradient reduction (DDP-style compression)")
  ap.add_argument("--flash-chunk", type=int, default=0)
  ap.add_argument("--set", action="append", default=[],
                  help="config override k=v (e.g. --set ssm_chunk=128)")
  args = ap.parse_args(argv)

  cells = []
  if args.all:
    for a, s, _ in configs.cells():
      cells.append((a, s, args.mesh))
  else:
    if not args.arch or not args.shape:
      ap.error("give --arch and --shape, or --all")
    cells.append((args.arch, args.shape, args.mesh))

  ok = True
  for arch, shp, mk in cells:
    try:
      if args.flash_chunk:
        attn_mod.FLASH_CHUNK = args.flash_chunk
      overrides = {}
      for kv in args.set:
        k, v = kv.split("=")
        overrides[k] = int(v) if v.lstrip("-").isdigit() else v
      row = run_cell(arch, shp, mk, remat=args.remat, accum=args.accum,
                     fsdp=not args.no_fsdp,
                     seq_shard_decode=not args.no_seq_shard_decode,
                     act_seq_shard=not args.no_act_seq_shard,
                     cfg_overrides=overrides or None, zero2=args.zero2,
                     grad_comm_bf16=args.grad_comm_bf16)
    except Exception as e:  # noqa: BLE001 — a failed cell is a bug; report it
      row = {"arch": arch, "shape": shp, "mesh": mk, "status": "FAILED",
             "error": f"{type(e).__name__}: {e}"}
      ok = False
    print(json.dumps(row, default=float))
    sys.stdout.flush()
    if args.out:
      os.makedirs(args.out, exist_ok=True)
      fn = f"{arch}__{shp}__{mk}.json".replace("/", "_")
      with open(os.path.join(args.out, fn), "w") as f:
        json.dump(row, f, indent=1, default=float)
  return 0 if ok else 1


if __name__ == "__main__":
  sys.exit(main())
