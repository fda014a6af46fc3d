"""The port's dry run (``repro_torch.launch.dryrun``, ``dryrun_apsp``):
rows on this host with no device memory, the reference's active
parameter counts, the accum identity, the collective formulas by hand and
the APSP squaring's closed forms."""
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.configs import Shape  # noqa: E402
from repro_torch.launch import dryrun, dryrun_apsp  # noqa: E402
from repro_torch.launch import specs as sp  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.roofline import hw  # noqa: E402
from repro_torch.roofline.collectives import ring_traffic_bytes  # noqa: E402
from repro_torch.roofline.flops import CostCounter  # noqa: E402
from repro_torch.train import optimizer as opt_mod  # noqa: E402
from repro_torch.train import steps as steps_mod  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def test_dryrun_cell_counts_on_the_host():
  """tests/test_dryrun.py::test_dryrun_cell_compiles' assertions, in
  process, with the card's memory."""
  row = dryrun.run_cell("tinyllama-1.1b", "decode_32k", "single")
  assert row["status"] == "ok", row
  assert row["chips"] == 256
  assert row["peak_mem_per_dev"] < hw.HBM_BYTES
  for k in ("t_compute_s", "t_memory_s", "t_collective_s"):
    assert row[k] >= 0.0
  assert row["bottleneck"] in ("compute", "memory", "collective")
  assert row["hlo_flops"] > 0
  assert row["peak_mem_per_dev"] == (row["arg_bytes"] + row["out_bytes"]
                                     + row["temp_bytes"])
  for gone in ("code_bytes", "xla_flops_raw", "xla_bytes_raw", "lower_s"):
    assert gone not in row
  # the decode step's own work: 2·N per token at least
  assert row["hlo_flops"] >= row["model_flops"]


def test_dryrun_skip_reason_and_cli():
  """The CLI in a subprocess: granite-8b × long_500k is skipped."""
  env = dict(os.environ, PYTHONPATH=SRC)
  r = subprocess.run(
      [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
       "granite-8b", "--shape", "long_500k", "--mesh", "single"],
      capture_output=True, text=True, env=env, timeout=300)
  assert r.returncode == 0, r.stderr[-2000:]
  row = json.loads(r.stdout.strip().splitlines()[-1])
  assert row["status"] == "skipped"
  assert "full-attention" in row["reason"]


_REFERENCE_ACTIVE = textwrap.dedent("""
    import json
    from repro import configs
    from repro.launch import dryrun
    print(json.dumps({a: dryrun.active_params(configs.get_config(a))
                      for a in configs.list_archs()}))
""")


def test_active_params_equal_the_reference():
  """The reference's dry run sets XLA_FLAGS at import, so its value comes
  from one subprocess."""
  pytest.importorskip("jax")
  env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
  r = subprocess.run([sys.executable, "-c", _REFERENCE_ACTIVE],
                     capture_output=True, text=True, env=env, timeout=600)
  assert r.returncode == 0, r.stderr[-2000:]
  ref = json.loads(r.stdout.strip().splitlines()[-1])
  assert set(ref) == set(configs.list_archs())
  for arch, want in ref.items():
    got = dryrun.active_params(configs.get_config(arch))
    assert abs(got - want) <= 1e-9 * want, (arch, got, want)


def _smoke_cell(arch, kind, accum=1, mesh=None, seq=16, batch=4, **kw):
  cfg = configs.get_config(arch, smoke=True)
  shape = Shape(f"{kind}_smoke", seq, batch, kind)
  mesh = mesh or AbstractMesh((2, 2), ("data", "model"))
  orig = configs.get_config
  configs.get_config = lambda a, smoke=False: cfg  # the smoke config
  try:
    return dryrun.build_cell(arch, shape, mesh, accum=accum, **kw)
  finally:
    configs.get_config = orig


@pytest.mark.parametrize("arch", ("tinyllama-1.1b", "mixtral-8x7b"))
def test_one_microbatch_times_accum_is_the_whole_step(arch):
  """Counting one microbatch through make_train_step(accum=1) and
  scaling gives exactly what make_train_step(accum=2) dispatches on the
  whole batch: FLOPs and bytes.  A first count warms the per-process RoPE
  frequency cache (one host copy per width, not per step)."""
  cell = _smoke_cell(arch, "train", accum=2, remat="full")
  dryrun.count_cell(cell)
  flops, nbytes, _, _ = dryrun.count_cell(cell)
  cfg = cell.cfg
  model = sp.init_meta(cfg)
  state = (model, opt_mod.init_opt_state(zoo.param_tree(model)))
  batch = sp.batch_shapes(cfg, cell.shape)
  step = steps_mod.make_train_step(cfg, opt_mod.AdamWConfig(), accum=2,
                                   remat="full")
  with CostCounter() as c:
    step(state, batch)
  assert flops == c.flops
  assert nbytes == c.bytes


def test_collective_formulas_by_hand():
  """Each term of the ring model on tinyllama's smoke config (2 layers,
  d 64, 4 heads over 2 kv heads, bf16) on a (2, 2) mesh, counted by hand
  from what the port's step holds: two gathers of each part per
  microbatch in the compute dtype, the residual stream's meetings (its
  sequence cut over the model axis: an f32 reduce-scatter per
  row-parallel projection, a bf16 all-gather ahead of each column-parallel
  one and at the end) and in the backward their transposes, the
  embedding's sum, the loss's (B, S) statistics, and the norms' gradients
  summed over the model axis."""
  cfg = configs.get_config("tinyllama-1.1b", smoke=True)
  assert (cfg.n_layers, cfg.d_model, cfg.dtype) == (2, 64, torch.bfloat16)
  mesh = AbstractMesh((2, 2), ("data", "model"))
  d, t = 2, 2
  # -- train, accum 2, remat full -------------------------------------------
  cell = _smoke_cell("tinyllama-1.1b", "train", accum=2, mesh=mesh,
                     remat="full")
  terms, axis_bytes, rates = dryrun.collective_model(cell)
  params = zoo.param_tree(cell.model)
  # leaves over data (fsdp): every projection (wq, wk, wv, wo, w1, w2, w3);
  # not the embedding/head (vocab over model) or the norms (replicated)
  gathered = replicated = norms = 0
  for path, leaf in cm.tree_paths(params).items():
    n = leaf.numel()
    if any(s in path for s in ("wq", "wo", "w1", "w2", "w3")):
      gathered += n // t          # sharded over model too
    elif any(s in path for s in ("wk", "wv")):
      # 2 kv heads over a model axis of 2: divisible, sharded
      gathered += n // t
    elif "embed" in path or "lm_head" in path:
      replicated += n // t
    else:
      replicated += n
      norms += n
  # the forward's gather and the recompute's, per microbatch, in bf16
  assert terms["fsdp_all_gather"] == 2 * 2 * ring_traffic_bytes(
      "all-gather", 2 * gathered, d)
  assert terms["grad_reduce_scatter"] == 2 * ring_traffic_bytes(
      "reduce-scatter", 4 * gathered, d)
  model_sums = 2 * ring_traffic_bytes("all-reduce", 4 * norms, t)
  assert terms["grad_all_reduce"] == 2 * ring_traffic_bytes(
      "all-reduce", 4 * replicated, d) + model_sums
  rows = (4 // 2) // d                  # a microbatch's rows on one line
  stream = rows * 16 * cfg.d_model
  forward = (2 * cfg.n_layers * (ring_traffic_bytes("all-gather", stream * 2,
                                                    t)
                                 + ring_traffic_bytes("reduce-scatter",
                                                      stream * 4, t))
             + ring_traffic_bytes("all-gather", stream * 2, t))
  # forward and backward, per microbatch: the recompute replays its
  # meetings' results
  assert terms["tp_all_reduce"] == 2 * 2 * forward
  assert terms["tp_embed_all_reduce"] == 2 * 2 * ring_traffic_bytes(
      "all-reduce", stream * 4, t)
  stat = rows * (16 - 1)                # the loss's positions
  assert terms["tp_stats_all_reduce"] == 2 * (
      ring_traffic_bytes("all-reduce", 2 * stat * 4, t)
      + 2 * 2 * ring_traffic_bytes("all-reduce", stat * 4, t))
  assert terms["decode_attn_all_reduce"] == 0
  assert axis_bytes["data"] == (terms["fsdp_all_gather"]
                                + terms["grad_reduce_scatter"]
                                + terms["grad_all_reduce"] - model_sums)
  assert axis_bytes["model"] == (terms["tp_all_reduce"]
                                 + terms["tp_embed_all_reduce"]
                                 + terms["tp_stats_all_reduce"] + model_sums)
  assert rates == {"data": hw.NVLINK_BYTES_S, "model": hw.NVLINK_BYTES_S}
  # -- zero2 and bf16 gradients -----------------------------------------------
  cell = _smoke_cell("tinyllama-1.1b", "train", accum=2, mesh=mesh,
                     remat="full", zero2=True, grad_comm_bf16=True)
  terms2, _, _ = dryrun.collective_model(cell)
  assert terms2["fsdp_all_gather"] == ring_traffic_bytes(
      "all-gather", 2 * gathered, d)
  assert terms2["grad_reduce_scatter"] == terms["grad_reduce_scatter"] / 2
  # -- decode with the cache's sequence on the model axis --------------------
  cell = _smoke_cell("tinyllama-1.1b", "decode", mesh=mesh, batch=4)
  terms3, _, _ = dryrun.collective_model(cell)
  # serving gathers the stored f32 parts, once per layer per step
  assert terms3["fsdp_all_gather"] == ring_traffic_bytes(
      "all-gather", 4 * gathered, d)
  assert terms3["grad_reduce_scatter"] == terms3["grad_all_reduce"] == 0
  b_local = 4 // d
  assert terms3["tp_all_reduce"] == 2 * cfg.n_layers * ring_traffic_bytes(
      "all-reduce", b_local * cfg.d_model * 4, t)
  # the new row's heads (2 query and 1 kv head per position, q, k and v)
  # all-gathered, then the partial outputs all-reduced
  heads = ring_traffic_bytes("all-gather", t * b_local * (2 + 2 * 1)
                             * cfg.hd * 2, t)
  assert terms3["decode_attn_all_reduce"] == cfg.n_layers * (
      heads + ring_traffic_bytes(
          "all-reduce", b_local * cfg.n_heads * (cfg.hd + 2) * 4, t))
  assert terms3["tp_stats_all_reduce"] == ring_traffic_bytes(
      "all-reduce", b_local * (2 + 8), t)   # the greedy token's argmax


def test_smoke_rows_fit_and_split_their_bytes():
  """A smoke prefill row on a (2, 2) mesh: arg bytes are the parameters'
  shares plus the batch's, exactly."""
  cell = _smoke_cell("tinyllama-1.1b", "prefill")
  ms = cell.mesh.shape
  params = zoo.param_tree(cell.model)
  p_specs = cell.arg_specs[0]
  want = dryrun.tree_bytes(params, p_specs, ms)
  want += 4 // 2 * 16 * 4            # tokens (B 4 over data 2, S 16, int32)
  assert dryrun.tree_bytes(cell.args, cell.arg_specs, ms) == want
  flat = sum(t.numel() * 4 for t in cm.tree_paths(params).values())
  assert want < flat


def test_apsp_squaring_closed_forms():
  """dryrun_apsp.run on a (2, 2) mesh against its closed forms."""
  v = 512
  mesh = AbstractMesh((2, 2), ("data", "model"))
  row = dryrun_apsp.run(v, mesh)
  assert row["status"] == "ok" and row["chips"] == 4 and row["mesh"] == "2x2"
  assert row["model_flops"] == 2.0 * v ** 3
  assert row["hlo_flops"] == 0.0          # min-plus has no dot
  panel = (v // 2) * v * 4
  ag = ring_traffic_bytes("all-gather", panel, 2)
  assert row["coll_bytes_per_dev"] == 2 * ag
  assert row["t_collective_s"] == pytest.approx(2 * ag / hw.NVLINK_BYTES_S)
  terms = v ** 3 / 4
  tiled = 2.0 * v ** 3 / 128 * 4 / 4 / hw.PEAK_BYTES_S
  assert row["t_step_pallas_vpu"] == pytest.approx(
      max(hw.ops_seconds("minplus", "float32", terms), tiled), rel=1e-12)
  assert row["t_step_simd2_unit"] == pytest.approx(
      max(2 * terms / hw.PEAK_OPS["bfloat16"], tiled), rel=1e-12)
  assert row["lg_v_steps"] == 9
  assert row["solve_bound_s"] == pytest.approx(9 * row["t_step_xla_vector"])
  # the xla arm on one shard: 512-deep blocks of the (256, 512) ⊗ (512,
  # 256) panels — one ⊗ block, one ⊕ over it, then ⊕ with C
  m = n = v // 2
  k = v
  shard = (m * k + k * n + m * k * n) + (m * k * n + m * n) + 3 * m * n
  assert row["hlo_bytes"] == 4 * 4 * shard
  assert row["t_step_xla_vector"] == pytest.approx(
      max(row["t_memory_s"], row["t_collective_s"]))
  assert row["speedup_pallas_vs_xla"] == pytest.approx(
      row["t_step_xla_vector"] / row["t_step_pallas_vpu"])
  single = dryrun_apsp.run(v, "single")
  assert single["chips"] == 256 and math.isfinite(single["solve_bound_s"])


@pytest.mark.parametrize("arch", ("tinyllama-1.1b", "mamba2-780m"))
def test_grad_comm_bf16_counts_the_rounding_casts(arch):
  """A train cell's counted bytes grow by the rounding casts under
  --grad-comm-bf16 — each f32 gradient rounded to bf16 (4 bytes read, 2
  written) and back (2 read, 4 written), once per microbatch — and its
  FLOPs do not."""
  plain = _smoke_cell(arch, "train", accum=1, remat="full")
  dryrun.count_cell(plain)  # warms the RoPE frequency cache
  f0, b0, _, _ = dryrun.count_cell(plain)
  comm = _smoke_cell(arch, "train", accum=1, remat="full",
                     grad_comm_bf16=True)
  f1, b1, _, _ = dryrun.count_cell(comm)
  n = sum(t.numel() for t in cm.tree_paths(
      zoo.param_tree(plain.model)).values())
  assert f1 == f0
  assert b1 - b0 == 12 * n
  accum2 = _smoke_cell(arch, "train", accum=2, remat="full",
                       grad_comm_bf16=True)
  plain2 = _smoke_cell(arch, "train", accum=2, remat="full")
  assert (dryrun.count_cell(accum2)[1] - dryrun.count_cell(plain2)[1]
          == 2 * 12 * n)


def test_knobs_scale_one_microbatch_to_the_whole_step():
  """With grad_specs, zero2 and grad_comm_bf16, one microbatch scaled to
  accum 2 (the compute copy counted once) is what make_train_step(accum=2)
  with the same knobs dispatches on the whole batch."""
  cell = _smoke_cell("tinyllama-1.1b", "train", accum=2, remat="full",
                     zero2=True, grad_comm_bf16=True)
  dryrun.count_cell(cell)
  flops, nbytes, _, _ = dryrun.count_cell(cell)
  cfg = cell.cfg
  model = sp.init_meta(cfg)
  state = (model, opt_mod.init_opt_state(zoo.param_tree(model)))
  batch = sp.batch_shapes(cfg, cell.shape)
  step = steps_mod.make_train_step(cfg, opt_mod.AdamWConfig(), accum=2,
                                   remat="full",
                                   grad_specs=cell.param_specs, zero2=True,
                                   grad_comm_bf16=True)
  with CostCounter() as c:
    step(state, batch)
  assert flops == c.flops
  assert nbytes == c.bytes
  # the compute copy: every f32 leaf read once and written in bf16, once
  plain = _smoke_cell("tinyllama-1.1b", "train", accum=2, remat="full",
                      grad_comm_bf16=True)
  assert nbytes != dryrun.count_cell(plain)[1]
