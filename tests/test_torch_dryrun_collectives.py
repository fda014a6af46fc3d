"""The dry run's collective model held to the port's own steps.

``launch/dryrun.collective_model`` is a closed form: the pod-scale cells
(256 and 512 positions) are out of reach of any run.  Here every family's
smoke config runs its train, prefill and decode steps on a 2 × 2 mesh of
CPU shards (``make_host_mesh(4, model=2, devices=["cpu"] * 4)``) under a
``roofline.collectives.CollectiveCounter``, which records every meeting,
its transposed collective in the backward, every gather of a part along
``data`` and every gradient sum into another position's piece; the first
position's ring-model bytes must equal the model's for a cell of the same
shapes on ``AbstractMesh((2, 2), ("data", "model"))``, term by term and
axis group by axis group, exactly (at a group size of 2 every ring share is
a multiple of one half, so the sums are exact in either order).  The
cells take the smoke config's fields as ``cfg_overrides``.
"""
import dataclasses
import gc

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.configs import Shape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as sp  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, make_host_mesh  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.roofline.collectives import (TERMS,  # noqa: E402
                                              CollectiveCounter)
from repro_torch.train import optimizer as opt_mod  # noqa: E402
from repro_torch.train import sharded  # noqa: E402
from repro_torch.train import steps  # noqa: E402

MESH = AbstractMesh((2, 2), ("data", "model"))
SEQ, ROWS = 16, 4
FAMILIES = {"dense": "tinyllama-1.1b", "moe": "mixtral-8x7b",
            "ssm": "mamba2-780m", "hybrid": "zamba2-7b",
            "encdec": "seamless-m4t-large-v2", "vlm": "chameleon-34b"}
# name → (family, kind, rows, build_cell keywords, config overrides)
CASES = {
    **{f"{fam}-train-{remat}": (fam, "train", ROWS, {"remat": remat}, {})
       for fam in FAMILIES for remat in ("none", "full")},
    **{f"{fam}-train-dots": (fam, "train", ROWS, {"remat": "dots"}, {})
       for fam in FAMILIES},
    "dense-train-accum2": ("dense", "train", 2 * ROWS,
                           {"remat": "full", "accum": 2}, {}),
    "dense-train-zero2": ("dense", "train", ROWS,
                          {"remat": "none", "zero2": True}, {}),
    "moe-train-zero2": ("moe", "train", ROWS,
                        {"remat": "none", "zero2": True}, {}),
    "dense-train-grad_comm_bf16": ("dense", "train", ROWS,
                                   {"remat": "none", "grad_comm_bf16": True},
                                   {}),
    "dense-train-all-knobs": ("dense", "train", 2 * ROWS,
                              {"remat": "full", "accum": 2, "zero2": True,
                               "grad_comm_bf16": True}, {}),
    "dense-train-no-act-seq-shard": ("dense", "train", ROWS,
                                     {"remat": "none",
                                      "act_seq_shard": False}, {}),
    "ssm-train-f32": ("ssm", "train", ROWS, {"remat": "none"},
                      {"dtype": torch.float32}),
    "moe-train-f32": ("moe", "train", ROWS, {"remat": "none"},
                      {"dtype": torch.float32}),
    **{f"{fam}-prefill": (fam, "prefill", ROWS, {}, {}) for fam in FAMILIES},
    **{f"{fam}-decode": (fam, "decode", ROWS, {}, {}) for fam in FAMILIES},
    "dense-decode-no-seq-shard": ("dense", "decode", ROWS,
                                  {"seq_shard_decode": False}, {}),
    # B = 1 does not split over the 2 data lines, which divide the kv heads:
    # the 2-D cache cut, the heads assembled over the column
    "dense-decode-b1": ("dense", "decode", 1, {}, {}),
    "hybrid-decode-b1": ("hybrid", "decode", 1, {}, {}),
    "dense-decode-b1-no-seq-shard": ("dense", "decode", 1,
                                     {"seq_shard_decode": False}, {}),
    "dense-prefill-b1": ("dense", "prefill", 1, {}, {}),
    # one kv head over a model axis of 2: the kv projections (and qwen's
    # biases) replicated over it, each position on its heads' slice
    "dense-train-1kv-bias": ("dense", "train", ROWS, {"remat": "none"},
                             {"n_kv_heads": 1, "qkv_bias": True}),
    "dense-decode-1kv-bias": ("dense", "decode", ROWS, {},
                              {"n_kv_heads": 1, "qkv_bias": True}),
    "dense-decode-b1-1kv": ("dense", "decode", 1, {}, {"n_kv_heads": 1}),
}


def _cell(name):
  fam, kind, rows, kw, extra = CASES[name]
  arch = FAMILIES[fam]
  smoke = configs.get_config(arch, smoke=True)
  fields = {f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke)
            if f.name != "name"}
  return dryrun.build_cell(arch, Shape(f"{kind}_smoke", SEQ, rows, kind),
                           MESH, cfg_overrides={**fields, **extra}, **kw)


def _batch(cfg, shape):
  g = torch.Generator().manual_seed(1)
  s = 1 if shape.kind == "decode" else shape.seq_len
  tokens = torch.randint(0, cfg.vocab, (shape.global_batch, s), generator=g,
                         dtype=torch.int32)
  batch = {"tokens": tokens}
  if shape.kind == "train":
    batch["labels"] = tokens
  if cfg.family == "encdec":
    key = "enc_out" if shape.kind == "decode" else "src_embeds"
    batch[key] = torch.randn(shape.global_batch, cfg.src_len, cfg.d_model,
                             generator=g).to(cfg.dtype)
  return batch


def count_step(cell) -> CollectiveCounter:
  """The cell's step run once on a 2 × 2 CPU mesh, under the cell's
  activation layout, with a counter on."""
  cfg, shape = cell.cfg, cell.shape
  mesh = make_host_mesh(4, model=2, devices=["cpu"] * 4)
  model = zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
  batch = _batch(cfg, shape)
  if shape.kind == "train":
    state = sharded.shard_state(zoo.param_tree(model), cell.param_specs,
                                mesh)
    step = steps.make_train_step(
        cfg, opt_mod.AdamWConfig(), accum=cell.accum, remat=cell.remat,
        mesh=mesh, grad_specs=cell.param_specs, zero2=cell.zero2,
        grad_comm_bf16=cell.grad_comm_bf16)
    with cm.activation_sharding(cell.act_spec), CollectiveCounter() as c:
      step(state, batch)
    return c
  lm = zoo.shard(cfg, model, mesh, cell.par)
  with torch.no_grad(), cm.activation_sharding(cell.act_spec):
    if shape.kind == "prefill":
      with CollectiveCounter() as c:
        steps.make_prefill_step(cfg)(lm, batch)
      return c
    cache = zoo.init_cache(cfg, shape.global_batch,
                           sp.cache_max_len(cfg, shape), mesh=mesh,
                           specs=sp.cache_specs(cfg, cell.par, shape))
    with CollectiveCounter() as c:
      steps.make_decode_step(cfg)(lm, cache, batch)
  return c


@pytest.mark.parametrize("name", list(CASES))
def test_the_model_charges_what_the_step_holds(name):
  """The counted step's terms and axis-group bytes per device equal
  ``collective_model``'s for the cell, exactly."""
  cell = _cell(name)
  counted = count_step(cell)
  terms, axes = counted.ring_bytes()
  want_terms, want_axes, _ = dryrun.collective_model(cell)
  assert set(terms) == set(TERMS) == set(want_terms)
  assert terms == want_terms
  assert {k: axes.get(k, 0.0) for k in want_axes} == want_axes
  assert set(axes) <= set(want_axes)
  assert sum(terms.values()) > 0


def _live_tensors() -> int:
  gc.collect()
  return sum(1 for o in gc.get_objects() if type(o) is torch.Tensor)


@pytest.mark.parametrize("name", ["hybrid-train-none", "dense-train-full"])
def test_the_counter_keeps_no_tensor_alive(name):
  """A counted step leaves no tensor behind once its state is dropped: the
  backward hooks that report the meetings' transposes hold no reference
  to a ``LineGroup``, whose slots hold tensors of the graph (a cycle
  through autograd's nodes is never collected)."""
  cell = _cell(name)
  before = _live_tensors()
  counted = count_step(cell)
  assert counted.count() > 0
  assert _live_tensors() == before
