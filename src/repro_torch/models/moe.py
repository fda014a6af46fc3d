"""Top-k routed mixture-of-experts with capacity-bounded scatter dispatch.

Counterpart of ``repro/models/moe.py``, with its semantics kept exactly,
since each of them decides which tokens an expert sees:

  * capacity per batch row C = max(8, ⌈topk · S · capacity_factor / E⌉
    rounded up to 8) (``capacity``);
  * the router's logits in f32, softmax, then the top k **with ties to the
    lower expert index**, as ``jax.lax.top_k`` breaks them (``torch.topk``
    does not: on the CPU it gives [2, 3] for four equal probabilities);
    gates normalised by their sum clamped at 1e-9 and rounded to x's dtype;
  * the Switch aux loss E · Σ_e (mean of one_hot(top-1)) · (mean prob);
  * dispatch: within each batch row the (token, choice) pairs, token-major,
    are queued per expert in arrival order; pairs past C are dropped (and
    add a zero to their expert's slot 0, as the reference's scatter-add
    does);
  * the experts' SwiGLU over every slot of the (E, C) buffer, empty ones
    included, in ``cfg.dtype`` with ``models/mlp.py``'s rounding points;
  * combine: each (token, choice) slot gathered back, weighted by
    gate · keep in ``cfg.dtype`` and summed over the k choices.

On a mesh position (tensor parallelism, serving or training) the router
is replicated, so every position routes, drops and slots alike; each runs
the experts on its slice of the expert width F, and the f32 partial sums
of w2 are added over the line (``common.tp_sum``) before the combine.

The reference vmaps a one-row dispatch over the batch; here the batch is a
leading axis, and the capacity buffer is laid out (E, B, C, D) so that the
experts' three products are batched matmuls over E without a copy.  They
are plain products outside any kernel, as the reference leaves them to
XLA.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models import common as cm

Tensor = torch.Tensor


def moe_params(generator: torch.Generator, cfg: cm.ModelConfig) -> dict:
  """One layer's router and expert weights in the reference's layout."""
  d, f, e, pd = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.param_dtype
  return {
      "router": cm.dense_init(generator, (d, e), dtype=pd),
      "experts": {
          "w1": cm.dense_init(generator, (e, d, f), dtype=pd),
          "w3": cm.dense_init(generator, (e, d, f), dtype=pd),
          "w2": cm.dense_init(generator, (e, f, d), in_axis=-2, dtype=pd),
      },
  }


def capacity(cfg: cm.ModelConfig, seq: int) -> int:
  c = math.ceil(cfg.topk * seq * cfg.capacity_factor / cfg.n_experts)
  return max(8, -(-c // 8) * 8)  # the reference's round-up to 8


def _route(router_w: Tensor, cfg: cm.ModelConfig, x: Tensor):
  """x (B, S, D) → gates (B, S, k) in x's dtype, expert ids (B, S, k),
  aux loss (f32 scalar)."""
  logits = torch.matmul(x.float(), router_w.float())
  probs = torch.softmax(logits, dim=-1)
  # a stable descending sort keeps equal probabilities in index order
  top = torch.sort(probs, dim=-1, descending=True, stable=True)
  gate, idx = top.values[..., :cfg.topk], top.indices[..., :cfg.topk]
  gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
  e = cfg.n_experts
  frac = nn.functional.one_hot(idx[..., 0], e).float().mean(dim=(0, 1))
  aux = e * torch.sum(frac * probs.mean(dim=(0, 1)))
  return gate.to(x.dtype), idx, aux


def _dispatch(x: Tensor, idx: Tensor, e: int, cap: int):
  """Scatter each row's (token, choice) pairs into its expert's slots.

  x (B, S, D), idx (B, S, k).  Returns (buf (E, B, C, D), slot_e, slot_p,
  keep (B, S, k)): a kept pair sits at buf[slot_e, b, slot_p]; a dropped
  one has slot_p 0 and keep False."""
  b, s, d = x.shape
  k = idx.shape[-1]
  flat_e = idx.reshape(b, s * k)                             # token-major
  onehot = nn.functional.one_hot(flat_e, e)                  # (B, S·k, E)
  pos = torch.cumsum(onehot, dim=1) - 1                      # arrival order
  flat_p = torch.gather(pos, 2, flat_e[..., None])[..., 0]
  keep = flat_p < cap
  safe_p = torch.where(keep, flat_p, 0)
  tokens = x.repeat_interleave(k, dim=1) * keep[..., None].to(x.dtype)
  rows = torch.arange(b, device=x.device)[:, None]
  slot = (flat_e * b + rows) * cap + safe_p                  # into (E, B, C)
  buf = torch.zeros((e * b * cap, d), dtype=x.dtype, device=x.device)
  buf = buf.index_add(0, slot.reshape(-1), tokens.reshape(-1, d))
  return (buf.view(e, b, cap, d), flat_e.reshape(b, s, k),
          safe_p.reshape(b, s, k), keep.reshape(b, s, k))


def _experts(w: dict, cfg: cm.ModelConfig, buf: Tensor) -> Tensor:
  """SwiGLU of every slot: buf (E, B, C, D) → (E, B, C, D) in
  ``cfg.dtype``."""
  dt = cfg.dtype
  e, b, c, d = buf.shape
  xs = buf.reshape(e, b * c, d)
  h = torch.matmul(xs, w["w1"].to(dt))
  h = nn.functional.silu(h) * torch.matmul(xs, w["w3"].to(dt))
  dp, tp = cm.act_axes()
  h = cm.constrain(h, (None, dp, tp))            # rows b-major: B over dp
  if cm.position() is None:
    return torch.matmul(h, w["w2"].to(dt)).view(e, b, c, d)
  return cm.tp_sum(cm.f32_product(h, w["w2"].to(dt)), dt).view(e, b, c, d)


def moe_block(p: dict, cfg: cm.ModelConfig, x: Tensor):
  """x (B, S, D) in ``cfg.dtype`` → (y (B, S, D), aux loss)."""
  x = cm.col_input(x)
  b, s, d = x.shape
  e, cap, dt = cfg.n_experts, capacity(cfg, s), cfg.dtype
  gate, idx, aux = _route(p["router"], cfg, x)
  buf, slot_e, slot_p, keep = _dispatch(x, idx, e, cap)
  # the reference pins its (B, E, C, ·) buffers to the batch and model
  # axes; here the batch is the second axis
  dp, _ = cm.act_axes()
  buf = cm.constrain(buf, (None, dp, None, None))
  out = cm.constrain(_experts(p["experts"], cfg, buf), (None, dp, None, None))
  out = out.reshape(e * b * cap, d)
  rows = torch.arange(b, device=x.device)[:, None, None]
  tok = out[(slot_e * b + rows) * cap + slot_p]             # (B, S, k, D)
  w = gate.to(dt) * keep.to(dt)
  return cm.seq_local(torch.sum(tok * w[..., None], dim=2)), aux


class Experts(nn.Module):
  """One layer's expert weights ``w1``, ``w3`` (E, D, F) and ``w2``
  (E, F, D)."""

  def __init__(self, params: dict):
    super().__init__()
    for name, t in params.items():
      self.register_parameter(name, nn.Parameter(t, requires_grad=False))


class MoE(nn.Module):
  """One layer's router (D, E) and experts, as ``moe_block``."""

  def __init__(self, cfg: cm.ModelConfig, params: dict):
    super().__init__()
    self.cfg = cfg
    self.router = nn.Parameter(params["router"], requires_grad=False)
    self.experts = Experts(params["experts"])

  def forward(self, x: Tensor):
    w = dict(self.experts.named_parameters())
    return moe_block({"router": self.router, "experts": w}, self.cfg, x)
