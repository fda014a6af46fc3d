"""Serve step factories: prefill and greedy decode.

Counterpart of ``repro/train/steps.py``'s ``make_prefill_step`` and
``make_decode_step``.  The optimizer, ``make_train_step`` and checkpointing
come with the training slice (ROADMAP item 13).
"""
from __future__ import annotations

import torch

from repro_torch.models import common as cm
from repro_torch.models import zoo


def make_prefill_step(cfg: cm.ModelConfig, *, impl: str = "xla"):
  """prefill_step(model, batch) → (last-position logits (B, V), cache)."""
  def prefill_step(model, batch):
    logits, cache, _ = zoo.forward(model, cfg, batch, mode="prefill",
                                   impl=impl)
    return logits[:, -1, :], cache
  return prefill_step


def make_decode_step(cfg: cm.ModelConfig):
  """decode_step(model, cache, batch) → (greedy next token (B, 1) int32,
  cache).  ``batch`` is {'tokens': (B, 1)}; the cache is updated in place."""
  def decode_step(model, cache, batch):
    logits, cache, _ = zoo.forward(model, cfg, batch, mode="decode",
                                   cache=cache)
    nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
    return nxt[:, None], cache
  return decode_step
