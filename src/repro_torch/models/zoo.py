"""Unified model API for the port's LM families (dense so far):

    model = zoo.init(cfg, generator, device)
    logits, cache, aux = zoo.forward(model, cfg, batch, mode=..., ...)

Counterpart of ``repro/models/zoo.py``.  ``batch`` is a dict
{'tokens': (B, S) int}.  The cache keeps the reference's layout:
{'k', 'v': (L, B, max_len, KV, hd), 'len': int32 scalar}.  The SSM, MoE,
hybrid, enc-dec and VLM families are ROADMAP item 13's later slices and
raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf_mod


def init(cfg: cm.ModelConfig, generator: torch.Generator,
         device=DEFAULT_DEVICE) -> tf_mod.TransformerLM:
  """Random weights from ``generator`` (drawn on its device), on ``device``."""
  dev = resolve_device(device)
  params = tf_mod.init_lm_params(generator, cfg)
  return tf_mod.TransformerLM(cfg, params).to(dev)


def forward(model: tf_mod.TransformerLM, cfg: cm.ModelConfig, batch: dict, *,
            mode: str = "train", cache: Optional[dict] = None,
            impl: str = "xla"):
  """Returns (logits, new_cache_or_None, aux_loss)."""
  return tf_mod.forward_lm(model, cfg, batch["tokens"], mode=mode,
                           cache=cache, impl=impl)


def init_cache(cfg: cm.ModelConfig, batch: int, max_len: int,
               device=DEFAULT_DEVICE) -> dict:
  tf_mod.check_dense(cfg)
  return attn_mod.init_cache(cfg, cfg.n_layers, batch, max_len,
                             device=resolve_device(device))


def param_count(model: torch.nn.Module) -> int:
  return sum(p.numel() for p in model.parameters())
