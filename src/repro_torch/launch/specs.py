"""Meta-tensor stand-ins and specs for every dry-run cell.

Counterpart of ``repro/launch/specs.py``.  Shapes are meta tensors (the
reference's ``ShapeDtypeStruct``): the model from ``zoo.init(cfg, None,
device="meta")``, the caches from ``zoo.init_cache(..., device="meta")``,
nothing drawn or allocated.  Specs are ``models.common``'s plain tuples;
parameter trees are ``zoo.param_tree``'s, with ``blocks``/``enc``/``dec``
lists of layers where the reference stacks them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import Shape
from repro_torch.models import common as cm
from repro_torch.models import zoo
from repro_torch.train import optimizer as opt_mod

META = torch.device("meta")


# ---------------------------------------------------------------------------
# model / optimizer state
# ---------------------------------------------------------------------------


def init_meta(cfg: cm.ModelConfig):
  """The model of ``cfg`` with empty meta parameters."""
  return zoo.init(cfg, None, device=META)


def param_shapes(cfg: cm.ModelConfig):
  return zoo.param_tree(init_meta(cfg))


def param_specs(cfg: cm.ModelConfig, par: cm.Parallelism):
  return cm.specs_like(param_shapes(cfg), cfg, par)


def train_state_shapes(cfg: cm.ModelConfig):
  p = param_shapes(cfg)
  return (p, opt_mod.init_opt_state(p))


def train_state_specs(cfg: cm.ModelConfig, par: cm.Parallelism):
  ps = param_specs(cfg, par)
  return (ps, {"m": ps, "v": ps, "step": ()})


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------


def batch_shapes(cfg: cm.ModelConfig, shape: Shape):
  b = shape.global_batch
  s = 1 if shape.kind == "decode" else shape.seq_len

  def empty(shp, dtype):
    return torch.empty(shp, dtype=dtype, device=META)

  out = {"tokens": empty((b, s), torch.int32)}
  if shape.kind == "train":
    out["labels"] = empty((b, s), torch.int32)
  if cfg.family == "encdec":
    if shape.kind == "decode":
      out["enc_out"] = empty((b, cfg.src_len, cfg.d_model), cfg.dtype)
    else:
      out["src_embeds"] = empty((b, cfg.src_len, cfg.d_model), cfg.dtype)
  return out


def batch_specs(cfg: cm.ModelConfig, shape: Shape, par: cm.Parallelism):
  dp = par.dp_for(shape.global_batch)
  out = {"tokens": (dp, None)}
  if shape.kind == "train":
    out["labels"] = (dp, None)
  if cfg.family == "encdec":
    if shape.kind == "decode":
      out["enc_out"] = (dp, None, None)
    else:
      out["src_embeds"] = (dp, None, None)
  return out


# ---------------------------------------------------------------------------
# KV / state caches
# ---------------------------------------------------------------------------


def cache_max_len(cfg: cm.ModelConfig, shape: Shape) -> int:
  """SWA archs decode long contexts with a window-sized ring buffer."""
  if cfg.window is not None:
    return min(shape.seq_len, cfg.window)
  return shape.seq_len


def cache_shapes(cfg: cm.ModelConfig, shape: Shape):
  return zoo.init_cache(cfg, shape.global_batch, cache_max_len(cfg, shape),
                        device=META)


def cache_specs(cfg: cm.ModelConfig, par: cm.Parallelism, shape: Shape, *,
                seq_sharded: Optional[bool] = None):
  """Specs matching the init_cache tree.  ``seq_sharded`` (decode default)
  puts the cache sequence axis on the model axis — sequence-parallel decode;
  SSM/conv states put their head/channel axis there instead."""
  dp, tp = par.dp_for(shape.global_batch), par.tp
  seq_sharded = par.seq_shard_decode if seq_sharded is None else seq_sharded
  kv_seq = tp if seq_sharded else None

  def walk(prefix, tree):
    out = {}
    for k, v in tree.items():
      if isinstance(v, dict):
        out[k] = walk(f"{prefix}/{k}", v)
        continue
      if k in ("k", "v"):
        # (L|n_apps, B, S, KV, hd).  When the batch can't shard (B=1
        # long-context cells) put the idle data axes on the KV-head dim
        # instead (divisibility permitting) — 2-D cache sharding.
        kv_heads_dp = None
        if dp is None and cfg.n_kv_heads % par.dp_size == 0:
          kv_heads_dp = par.dp
        out[k] = (None, dp, kv_seq, kv_heads_dp, None)
      elif k == "ssm":
        # (L, B, H, N, Pdim) — heads on the model axis
        out[k] = (None, dp, tp, None, None)
      elif k in ("conv", "bc_conv"):
        # (L, B, K-1, C) — channels on the model axis (conv is depthwise);
        # bc channels are small → replicated
        out[k] = (None, dp, None, tp if k == "conv" else None)
      elif k == "len":
        out[k] = ()
      else:
        raise KeyError(f"unknown cache leaf {prefix}/{k}")
    return out

  return walk("", zoo.init_cache(cfg, 8, 128, device=META))


def logits_spec(cfg: cm.ModelConfig, par: cm.Parallelism):
  del cfg
  return (par.dp, None, par.tp)
