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
  * ``coll_bytes_per_dev``, ``coll_breakdown`` — a closed-form model of the
    collectives the port's own step holds on its single-controller mesh
    (``step_collectives``: the first position's, by the ring model of
    ``collectives.ring_traffic_bytes``), per device, by axis group.  D is
    the data axes' size, T the model axis's; b a microbatch's rows on one
    data line (all of them where the batch does not split over the lines),
    s its tokens per row (1 in a decode); a part is a leaf's piece on the
    first position with the data axes left uncut (its heads' slice of a
    leaf replicated over the model axis, ``zoo.head_slice``):
      fsdp_all_gather       Σ_leaves cut over data ring(all-gather, part,
                              D) per gather: in a train cell two per
                              microbatch under every remat (the forward's,
                              then the backward's regather, ``zoo.
                              _Regather``, or the recompute's gather) in
                              ``cfg.dtype`` (the router in f32), or with
                              ``zero2`` one ``cfg.dtype`` copy per step;
                              in serving one per forward in the stored
                              dtype; a shared block's parts once per
                              application, the encoder's not in a decode,
                              the decoder's cross-attention parts once more
                              per forward (``encdec.cross_kv``; its wk and
                              wv, unused by the layer, are not regathered
                              but are gathered again in a recompute)
      grad_reduce_scatter   train, per microbatch: Σ_leaves cut over data
                              and over the model axis ring(reduce-scatter,
                              part's gradient, D) per use of a gathered part
                              (once per leaf under zero2); f32, bf16 with
                              ``grad_comm_bf16``; a leaf replicated over
                              the model axis and cut over data (the router)
                              ring(reduce-scatter, the whole leaf's, D)
      grad_all_reduce       train, per microbatch: the same over the leaves
                              not cut over data, ring(all-reduce, ..., D);
                              besides, every leaf replicated over the model
                              axis is summed over the line first:
                              ring(all-reduce, the whole leaf in f32, T)
      tp_all_reduce         the residual stream's meetings on the model
                              axis: per row-parallel projection (attention's
                              wo, the MLP's w2, the SSM's out_proj)
                              ring(all-reduce, b·s·d_model·4, T) of f32
                              partials; with the stream's sequence cut over
                              the model axis (``act_seq_shard``, s
                              divisible by T) a ring(reduce-scatter, same)
                              and a ring(all-gather, b·s·d_model in
                              ``cfg.dtype``, T) ahead of each column-parallel
                              input and at the stack's end; the MoE's
                              expert sum ring(all-reduce, E·b·C·d_model·4,
                              T); the enc-dec's encoder (never cut) 2 per
                              layer over its b·src_len tokens
      tp_embed_all_reduce   the vocab-parallel embedding's sum,
                              ring(all-reduce, b·s·d_model·4, T) per forward
      tp_stats_all_reduce   (B, S) statistics in f32: each SSM layer's gated
                              norm ring(all-reduce, b·s·4, T); the loss's
                              log-sum-exp (max and Σ exp, 2·b·(s−1)·4), its
                              gradient's carrier and the gold logit
                              (b·(s−1)·4 each); a decode's greedy token
                              (value and int64 index, b·(dtype + 8))
      decode_attn_all_reduce  decode, per attention layer: the new row's
                              q, k and v heads all-gathered
                              (ring(all-gather, T·b·(H/T + 2·KV_p)·hd·dtype,
                              T), KV_p the kv heads one position computes)
                              and, with ``seq_shard_decode``, the partial
                              outputs, max and sum ring(all-reduce,
                              b·H·(hd + 2)·4, T) (H the heads a line
                              attends)
      decode_heads_all_gather decode of a batch that does not split over the
                              data axes, whose kv heads they divide (the
                              2-D cache cut: each data line attends H/D
                              heads): ring(all-gather, b·H·hd·4, D) per
                              attention layer (the heads assembled over the
                              column; in ``cfg.dtype`` without
                              ``seq_shard_decode``)
    A train cell holds each meeting per microbatch and, in the backward,
    its transposed collective over the same bytes (the gradient goes back
    to every posted tensor; the loss's max and Σ exp carry none); a
    recompute replays its meetings' results (``common.remat_contexts``)
    and holds none.  The data terms run over the data axes' group, the
    model axis terms and the line sums of the gradients over the model
    axis; ``analysis.axis_group_rate`` gives each group's link rate.  On
    a real mesh ``roofline/collectives.CollectiveCounter`` counts the same
    from the step (``tests/test_torch_dryrun_collectives.py`` holds the two
    equal, term by term, for every family, remat and knob).

A train cell's step gets the reference cell's knobs: ``grad_specs`` (the
parameters' specs), ``zero2`` and ``grad_comm_bf16``, so the bf16 compute
copy of ``--zero2`` and the gradients' bf16 rounding casts of
``--grad-comm-bf16`` are counted, and the collective model above applies
both.  A train cell with accum > 1 runs one microbatch (``global_batch /
accum`` rows) through ``make_train_step(accum=1)`` and counts accum × (that
step less AdamW and the compute copy) + AdamW + the compute copy + the
accumulation's sums, which is what the step with ``accum`` microbatches
dispatches.
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
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models import zoo
from repro_torch.roofline import analysis
from repro_torch.roofline.collectives import (TRANSPOSE, Collective,
                                              ring_totals)
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


def _itemsize(dtype: torch.dtype) -> int:
  return torch.empty((), dtype=dtype).element_size()


def _meetings(cell: Cell, b: int) -> list:
  """(Collective, differentiable) for each meeting the first position
  holds in one forward over ``b`` rows of its data line."""
  cfg, par, shape = cell.cfg, cell.par, cell.shape
  t_size, d_size = par.tp_size, par.dp_size
  model, data = par.model_axis, "+".join(par.data_axes)
  comp, d, hd = _itemsize(cfg.dtype), cfg.d_model, cfg.hd
  decode = shape.kind == "decode"
  s = 1 if decode else shape.seq_len
  act = cell.act_spec
  split = (act is not None and len(act) > 1 and act[1] == model
           and t_size > 1 and s % t_size == 0)
  grouped = (decode and par.dp_for(shape.global_batch) is None
             and cfg.n_kv_heads % d_size == 0)
  out = []

  def meet(term, kind, nbytes, diff=True, axis=model, group=t_size):
    out.append((Collective(term, axis, kind, nbytes, group), diff))

  def row(tokens, stream=True):
    """A row-parallel projection over ``tokens`` of the stream, and the
    column-parallel input ahead of it."""
    if stream and split:
      meet("tp_all_reduce", "all-gather", tokens * d * comp)
      meet("tp_all_reduce", "reduce-scatter", tokens * d * 4)
    else:
      meet("tp_all_reduce", "all-reduce", tokens * d * 4)

  def attention():
    if not decode:
      row(b * s)
      return
    (q0, q1), (k0, k1) = cm.head_range(cfg.n_heads, cfg.n_kv_heads, 0,
                                       t_size)
    meet("decode_attn_all_reduce", "all-gather",
         t_size * b * (q1 - q0 + 2 * (k1 - k0)) * hd * comp, False)
    heads = cfg.n_heads // d_size if grouped else cfg.n_heads
    if par.seq_shard_decode:
      meet("decode_attn_all_reduce", "all-reduce",
           b * heads * (hd + 2) * 4, False)
    if grouped:
      meet("decode_heads_all_gather", "all-gather",
           b * cfg.n_heads * hd * (4 if par.seq_shard_decode else comp),
           False, data, d_size)
    row(b * s)

  def block(moe: bool):
    attention()
    if not moe:
      row(b * s)
      return
    if split:
      meet("tp_all_reduce", "all-gather", b * s * d * comp)
    slots = cfg.n_experts * b * moe_mod.capacity(cfg, s)
    meet("tp_all_reduce", "all-reduce", slots * d * 4)

  def ssm_layer():
    if split:
      meet("tp_all_reduce", "all-gather", b * s * d * comp)
    meet("tp_stats_all_reduce", "all-reduce", b * s * 4)   # the gated norm
    meet("tp_all_reduce", "reduce-scatter" if split else "all-reduce",
         b * s * d * 4)

  meet("tp_embed_all_reduce", "all-reduce", b * s * d * 4)
  if cfg.family == "ssm":
    for _ in range(cfg.n_layers):
      ssm_layer()
  elif cfg.family == "hybrid":
    for _ in range(cfg.n_layers):
      ssm_layer()
    for _ in range(hybrid_mod.layout(cfg)[1]):
      block(False)
  elif cfg.family == "encdec":
    if not decode:      # a decode's batch carries the encoder's output
      for _ in range(2 * cfg.enc_layers):
        row(b * cfg.src_len, stream=False)
    for _ in range(cfg.dec_layers):
      attention()       # self-attention
      row(b * s)        # cross-attention
      row(b * s)        # the MLP
  else:
    for _ in range(cfg.n_layers):
      block(bool(cfg.n_experts))
  if split:
    meet("tp_all_reduce", "all-gather", b * s * d * comp)  # end_stream
  if shape.kind == "train":
    stat = b * (s - 1) * 4
    meet("tp_stats_all_reduce", "all-reduce", 2 * stat, False)  # max, Σexp
    meet("tp_stats_all_reduce", "all-reduce", stat)   # log-sum-exp's grad
    meet("tp_stats_all_reduce", "all-reduce", stat)   # the gold logit
  elif decode:
    meet("tp_stats_all_reduce", "all-reduce", b * (comp + 8), False)
  return out


def _part_numel(cell: Cell, path: str, t: torch.Tensor, spec) -> int:
  """Elements of the first position's part of a leaf: its ceil-sized
  piece along every axis but the data axes, or its heads' slice of a leaf
  replicated over the model axis (``zoo.head_slice``)."""
  numel = local_bytes(t, spec, cell.mesh.shape,
                      skip=tuple(cell.par.data_axes)) // t.element_size()
  cut = zoo.head_slice(path, t.ndim, cell.cfg, 0, cell.par.tp_size)
  if cut is not None:
    dim, lo, hi = cut
    numel = numel // t.shape[dim] * (hi - lo)
  return numel


def _leaf_collectives(cell: Cell) -> list:
  """The first position's gathers along ``data`` and gradient sums over
  one step, leaf by leaf."""
  cfg, par, kind = cell.cfg, cell.par, cell.shape.kind
  data, model = tuple(par.data_axes), par.model_axis
  data_key, d_size, t_size = "+".join(data), par.dp_size, par.tp_size
  comp = _itemsize(cfg.dtype)
  train, accum = kind == "train", cell.accum
  grad_size = 2 if cell.grad_comm_bf16 else 4
  apps_shared = hybrid_mod.layout(cfg)[1] if cfg.family == "hybrid" else 0
  # a layer's recompute gathers its parts again; without one the
  # backward regathers each part it saved
  layer_remat = cell.remat == "full" or (
      cell.remat == "dots" and cfg.family in tf_mod.FAMILIES)
  specs = cm.tree_paths(cell.param_specs)
  out = []
  for path, t in cm.tree_paths(zoo.param_tree(cell.model)).items():
    spec = specs[path]
    axes = {a for e in spec if e is not None
            for a in (e if isinstance(e, tuple) else (e,))}
    over_data, over_model = bool(axes & set(data)), model in axes
    top = path.split("/")[0]
    apps = {"shared": apps_shared,
            "enc": 0 if kind == "decode" else 1}.get(top, 1)
    # every forward's cross K/V gathers the decoder's cross-attention
    # weights again (``encdec.cross_kv``); its layer uses only wq and wo
    cross = top == "dec" and "/cross/" in path
    unused = cross and path.endswith(("/wk", "/wv"))
    part = _part_numel(cell, path, t, spec)
    if over_data:
      if not train:
        n, size = apps + cross, t.element_size()
      elif cell.zero2:
        n, size = 1, comp
      else:
        back = apps if layer_remat or not unused else 0
        n = accum * (apps + cross + back)
        size = 4 if path.endswith(zoo.F32_LEAVES) else comp
      out.append(Collective("fsdp_all_gather", data_key, "all-gather",
                            part * size, d_size, times=n))
    if not train:
      continue
    key, ring = (("grad_reduce_scatter", "reduce-scatter") if over_data
                 else ("grad_all_reduce", "all-reduce"))
    if over_model:
      uses = apps if over_data and not cell.zero2 else 1
      out.append(Collective(key, data_key, ring, part * grad_size, d_size,
                            times=accum * uses))
    else:  # summed over the line in f32, then into every replica
      out.append(Collective("grad_all_reduce", model, "all-reduce",
                            t.numel() * 4, t_size, times=accum))
      out.append(Collective(key, data_key, ring, t.numel() * grad_size,
                            d_size, times=accum))
  return out


def step_collectives(cell: Cell) -> list:
  """The collectives the first mesh position takes part in over one of
  the cell's steps (``roofline.collectives.Collective``, with ``times``):
  what a ``CollectiveCounter`` records of it in the port's step."""
  b = cell.shape.global_batch // cell.accum
  if cell.par.dp_for(b) is not None:
    b //= cell.par.dp_size
  out = _leaf_collectives(cell)
  for c, diff in _meetings(cell, b):
    out.append(dataclasses.replace(c, times=cell.accum))
    if diff and cell.shape.kind == "train":
      out.append(dataclasses.replace(c, kind=TRANSPOSE[c.kind],
                                     times=cell.accum))
  return out


def collective_model(cell: Cell) -> tuple:
  """({term: per-device bytes}, {axis group: per-device bytes},
  {axis group: link rate})."""
  par, mesh = cell.par, cell.mesh
  data_key, model_key = "+".join(par.data_axes), par.model_axis
  terms, by_axis = ring_totals(step_collectives(cell))
  axis_bytes = {data_key: by_axis.get(data_key, 0.0),
                model_key: by_axis.get(model_key, 0.0)}
  rates = {data_key: analysis.axis_group_rate(mesh, par.data_axes),
           model_key: analysis.axis_group_rate(mesh, model_key)}
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
                                   remat=cell.remat,
                                   grad_specs=cell.param_specs,
                                   zero2=cell.zero2,
                                   grad_comm_bf16=cell.grad_comm_bf16)
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
  # zero2's compute copy is made once per step, not per microbatch
  once = [c_opt]
  if cell.zero2:
    once.append(_counted(lambda: steps_mod.compute_copy(params,
                                                        cfg.dtype))[1])
  a = cell.accum
  flops = (a * (c.flops - sum(o.flops for o in once))
           + sum(o.flops for o in once) + c_acc.flops)
  nbytes = (a * (c.bytes - sum(o.bytes for o in once))
            + sum(o.bytes for o in once) + c_acc.bytes)
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
