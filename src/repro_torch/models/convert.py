"""Weights of the reference's ``zoo.init`` pytree as a port model.

``from_reference`` takes the reference's parameter tree as numpy arrays
(``jax.tree.map(np.asarray, params)``, so this module needs no JAX), splits
the stacked layer axis of ``blocks`` into one dict per layer and builds a
``TransformerLM`` (dense and MoE families; an MoE layer's experts stay
stacked on their own axis, (E, D, F)), a ``zoo.SSMLM`` (SSM family: blocks
of ``ln_norm_scale`` and the ``ssm`` subtree) or a ``hybrid.HybridLM``
(hybrid family: SSM blocks, and the ``shared`` block carried over as it
is, with no layer axis) on ``device``.  The tests use it so that both
packages compute with the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import common as cm
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models import zoo


def _tensor(a, cfg: cm.ModelConfig, device) -> torch.Tensor:
  return torch.from_numpy(np.array(a, dtype=np.float32)).to(
      device, cfg.param_dtype)


def _layer(tree: dict, i, cfg: cm.ModelConfig, device) -> dict:
  """Layer i of a stacked subtree (the whole subtree when i is None)."""
  return {name: (_layer(sub, i, cfg, device) if isinstance(sub, dict)
                 else _tensor(np.asarray(sub) if i is None
                              else np.asarray(sub)[i], cfg, device))
          for name, sub in tree.items()}


def from_reference(tree: dict, cfg: cm.ModelConfig, device=DEFAULT_DEVICE):
  dev = resolve_device(device)
  blocks = tree["blocks"]
  ssm_blocks = cfg.family in ("ssm", "hybrid")
  n = np.asarray(blocks["ln_norm_scale" if ssm_blocks
                        else "ln1_norm_scale"]).shape[0]
  if n != cfg.n_layers:
    raise ValueError(f"the tree has {n} layers, the config {cfg.n_layers}")
  params = {name: _tensor(tree[name], cfg, dev)
            for name in ("embed", "final_norm_scale", "lm_head")
            if name in tree}
  params["blocks"] = [_layer(blocks, i, cfg, dev) for i in range(n)]
  if cfg.family == "hybrid":
    params["shared"] = _layer(tree["shared"], None, cfg, dev)
    return hybrid_mod.HybridLM(cfg, params)
  if cfg.family == "ssm":
    return zoo.SSMLM(cfg, params)
  return tf_mod.TransformerLM(cfg, params)
