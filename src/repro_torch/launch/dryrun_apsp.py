"""Pod-scale dry run of the paper's own flagship workload: one Leyzorek
squaring C ← C ⊕ (C ⊗ C) of all-pairs shortest paths as a distributed
min-plus SUMMA (``core.distributed.summa_mmo``) at the paper's Table-4
sizes, counted on one host.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_apsp \\
        [--v 16384] [--mesh single]

Counterpart of ``repro/launch/dryrun_apsp.py``, with its row keys.  C is
block-sharded (row axis, column axis) over the mesh: the first axis (or,
with three, the first two) holds rows, the last columns.  Per squaring:

  * collectives — each device all-gathers A's row panel (V/R × V f32) over
    the column axis and B's column panel (V × V/C) over the row axis:
    ring(all-gather, panel bytes, C) and ring(all-gather, panel bytes, R);
  * ``model_flops`` = 2·V³, the useful ⊕⊗ work;
  * ``t_step_xla_vector`` — the roofline bound of the port's ``xla``
    min-plus arm (``core.mmo``: blocked broadcast and reduce, every ⊗ block
    through memory) on one device's shard, run on meta tensors under
    ``roofline/flops.CostCounter`` and scaled to the chips;
  * ``t_step_pallas_vpu`` — K1 (``kernels/csrc/semiring_mmo.cu``) on the
    CUDA cores: ``hw.ops_seconds("minplus", "float32", V³ / chips)``,
    against its tiled traffic (A and B panels re-read once per 128-wide
    tile, 2 · V³/128 · 4 bytes over the chips) at ``hw.PEAK_BYTES_S``;
  * ``t_step_simd2_unit`` — the same work at ``PEAK_OPS["bfloat16"]`` (the
    tensor cores' rate, as the reference takes the MXU's peak), the paper's
    proposed unit;
  * ``solve_bound_s`` — ⌈lg V⌉ squarings on the xla arm, and the two
    speedups.

``run(v, mesh)`` takes "single", "multi" or an ``AbstractMesh`` of any
shape, e.g. (data 2, model 2) for the four shards of one card.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch

from repro_torch.core.mmo import mmo
from repro_torch.launch import mesh as mesh_mod
from repro_torch.roofline import analysis, hw
from repro_torch.roofline.collectives import ring_traffic_bytes
from repro_torch.roofline.flops import CostCounter

K1_TILE = 128  # K1's tile edge for min-plus at these sizes


def shard_cost(v: int, rows: int, cols: int, op: str = "minplus"):
  """CostCounter of one device's ``xla`` contraction: its (V/R × V) row
  panel ⊗ (V × V/C) column panel, ⊕ its C block, on meta tensors."""
  m, n = v // rows, v // cols
  a = torch.empty((m, v), device="meta")
  b = torch.empty((v, n), device="meta")
  c = torch.empty((m, n), device="meta")
  with CostCounter() as counter:
    mmo(a, b, c, op=op, backend="xla")
  return counter


def run(v: int, mesh="single", op: str = "minplus") -> dict:
  mesh, label = mesh_mod.as_abstract_mesh(mesh)
  names = mesh.axis_names
  row_axes, col_axis = names[:-1], names[-1]
  rows = math.prod(mesh.shape[a] for a in row_axes)
  cols = mesh.shape[col_axis]
  if v % rows or v % cols:
    raise ValueError(f"|V| = {v} does not split over a {rows} x {cols} grid")
  chips = mesh.size
  shard = shard_cost(v, rows, cols, op)
  panel_a = (v // rows) * v * 4
  panel_b = v * (v // cols) * 4
  row_key = "+".join(row_axes)
  axis_bytes = {col_axis: ring_traffic_bytes("all-gather", panel_a, cols),
                row_key: ring_traffic_bytes("all-gather", panel_b, rows)}
  rates = {col_axis: analysis.axis_group_rate(mesh, col_axis),
           row_key: analysis.axis_group_rate(mesh, row_axes)}
  block = (v // rows) * (v // cols) * 4
  lg = math.ceil(math.log2(v))
  roof = analysis.Roofline(
      arch=f"apsp-|V|={v}", shape=f"closure_step({op})", mesh=label,
      chips=chips, hlo_flops=float(shard.flops * chips),
      hlo_bytes=float(shard.bytes * chips),
      coll_bytes=sum(axis_bytes.values()),
      coll_breakdown={"all-gather": sum(axis_bytes.values())},
      model_flops=2.0 * v ** 3,   # useful ⊕⊗ work of one squaring
      # the C block in and out, both panels, the shard's temporaries
      peak_memory_per_dev=2 * block + panel_a + panel_b + shard.peak,
      coll_axis_bytes=axis_bytes, axis_rates=rates)
  row = roof.row()
  terms = float(v) ** 3 / chips
  tiled_bytes = 2.0 * (float(v) ** 3 / K1_TILE) * 4.0 / chips
  t_mem_tiled = tiled_bytes / hw.PEAK_BYTES_S
  t_k1 = max(hw.ops_seconds(op, "float32", terms), t_mem_tiled)
  t_unit = max(2.0 * terms / hw.PEAK_OPS["bfloat16"], t_mem_tiled)
  row.update({
      "status": "ok", "lg_v_steps": lg,
      "solve_bound_s": roof.t_bound * lg,
      "t_step_xla_vector": roof.t_bound,
      "t_step_pallas_vpu": t_k1,
      "t_step_simd2_unit": t_unit,
      "speedup_pallas_vs_xla": roof.t_bound / t_k1,
      "speedup_simd2_vs_pallas": t_k1 / t_unit,
  })
  return row


def main(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("--v", type=int, default=16384)
  ap.add_argument("--mesh", default="single", choices=("single", "multi"))
  ap.add_argument("--op", default="minplus")
  ap.add_argument("--out", default=None)
  args = ap.parse_args(argv)
  row = run(args.v, args.mesh, args.op)
  print(json.dumps(row, default=float))
  if args.out:
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out,
                           f"apsp_{args.v}_{args.mesh}.json"), "w") as f:
      json.dump(row, f, indent=1, default=float)
  return 0


if __name__ == "__main__":
  sys.exit(main())
