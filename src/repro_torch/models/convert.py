"""Weights of the reference's ``zoo.init`` pytree as a port model.

``from_reference`` takes the reference's parameter tree as numpy arrays
(``jax.tree.map(np.asarray, params)``, so this module needs no JAX), splits
the stacked layer axis of ``blocks`` into one dict per layer and builds a
``TransformerLM`` (dense and MoE families; an MoE layer's experts stay
stacked on their own axis, (E, D, F); a VLM's attention with its q/k norm
scales), a ``zoo.SSMLM`` (SSM family: blocks of ``ln_norm_scale`` and the
``ssm`` subtree), a ``hybrid.HybridLM`` (hybrid family: SSM blocks, and
the ``shared`` block carried over as it is, with no layer axis) or an
``encdec.EncDecLM`` (enc-dec family: ``enc`` and ``dec`` stacked in the
reference, split the same way) on ``device``.  The tests use it so that
both packages compute with the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import common as cm
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


def _layers(stacked: dict, n: int, cfg: cm.ModelConfig, device,
            norm: str = "ln1_norm_scale") -> list:
  """A stacked subtree of ``n`` layers (the config's count; ``norm`` is a
  leaf every layer has) as one dict per layer."""
  got = np.asarray(stacked[norm]).shape[0]
  if got != n:
    raise ValueError(f"the tree has {got} layers, the config {n}")
  return [_layer(stacked, i, cfg, device) for i in range(n)]


def from_reference(tree: dict, cfg: cm.ModelConfig, device=DEFAULT_DEVICE):
  dev = resolve_device(device)
  params = {name: _tensor(tree[name], cfg, dev)
            for name in ("embed", "final_norm_scale", "lm_head",
                         "enc_norm_scale") if name in tree}
  if cfg.family == "encdec":
    params["enc"] = _layers(tree["enc"], cfg.enc_layers, cfg, dev)
    params["dec"] = _layers(tree["dec"], cfg.dec_layers, cfg, dev)
    return zoo.from_params(cfg, params)
  params["blocks"] = _layers(
      tree["blocks"], cfg.n_layers, cfg, dev,
      "ln_norm_scale" if cfg.family in ("ssm", "hybrid") else "ln1_norm_scale")
  if cfg.family == "hybrid":
    params["shared"] = _layer(tree["shared"], None, cfg, dev)
  return zoo.from_params(cfg, params)
