"""Feed-forward blocks: SwiGLU (llama family) and GELU.

Counterpart of ``repro/models/mlp.py``.  ``mlp_params`` draws one layer's
SwiGLU weights (or, ungated, the enc-dec family's GELU weights) in the
reference's layout; ``mlp`` is the block as a function of such a dict
(GELU when the dict has no ``w3``, as the reference's ungated weights have
none); ``MLP`` holds one layer's weights as a module.  On a mesh position
(tensor parallelism, serving or training) w1 and w3 are column-parallel
and w2 row-parallel (``common.row_parallel``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import common as cm

Tensor = torch.Tensor


def mlp_params(generator: torch.Generator, cfg: cm.ModelConfig,
               gated: bool = True) -> dict:
  """One layer's SwiGLU weights (``gated``) or GELU weights (no ``w3``) in
  the reference's layout."""
  d, f = cfg.d_model, cfg.d_ff
  p = {
      "w1": cm.dense_init(generator, (d, f), dtype=cfg.param_dtype),
      "w2": cm.dense_init(generator, (f, d), dtype=cfg.param_dtype),
  }
  if gated:
    p["w3"] = cm.dense_init(generator, (d, f), dtype=cfg.param_dtype)
  return p


def mlp(p: dict, cfg: cm.ModelConfig, x: Tensor) -> Tensor:
  """x: (B, S, D) in ``cfg.dtype``; weights cast to it at use."""
  dt = cfg.dtype
  x = cm.col_input(x)
  h = torch.matmul(x, p["w1"].to(dt))
  if "w3" in p:
    h = nn.functional.silu(h) * torch.matmul(x, p["w3"].to(dt))
  else:
    # jax.nn.gelu defaults to the tanh approximation
    h = nn.functional.gelu(h, approximate="tanh")
  return cm.row_parallel(h, p["w2"].to(dt))


class MLP(nn.Module):
  """One layer's feed-forward weights (``w1``, ``w2``, optional ``w3``)."""

  def __init__(self, cfg: cm.ModelConfig, params: dict):
    super().__init__()
    self.cfg = cfg
    for name, t in params.items():
      self.register_parameter(name, nn.Parameter(t, requires_grad=False))

  def forward(self, x: Tensor) -> Tensor:
    return mlp(dict(self.named_parameters(recurse=False)), self.cfg, x)
