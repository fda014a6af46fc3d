"""Decoder-only LM, dense, MoE and VLM: tinyllama, qwen2.5, granite,
h2o-danube (sliding window), mixtral (MoE, sliding window), phi3.5-moe,
chameleon (the qk-norm early-fusion VLM backbone).

Counterpart of ``repro/models/transformer.py``.  The reference stacks its
layers and scans over them; here each layer is a ``Block`` module and the
model loops over them.  A block takes the ``moe`` subtree where
``cfg.n_experts`` is set and the ``mlp`` subtree otherwise; the model's aux
loss is the mean of its blocks' (0 for a dense block).  The model takes
token ids or precomputed (B, S, D) embeddings (a modality frontend's).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt_mod

from repro_torch.models import attention as attn_mod
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod

Tensor = torch.Tensor


def padded_vocab(cfg: cm.ModelConfig, mult: int = 256) -> int:
  return -(-cfg.vocab // mult) * mult


REMATS = ("none", "full", "dots")
# matmuls without batch dims: the reference's dots_with_no_batch_dims_saveable
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
  return (ckpt_mod.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
          else ckpt_mod.CheckpointPolicy.PREFER_RECOMPUTE)


def run_layer(layer, remat: str, *args, **kwargs):
  """One layer's forward under the ``remat`` policy: 'none' keeps every
  activation for the backward; 'full' keeps only the layer's input and
  recomputes the rest (``jax.checkpoint``); 'dots' keeps the outputs of the
  matmuls without batch dims and recomputes the rest (the reference's
  ``dots_with_no_batch_dims_saveable``)."""
  if remat not in REMATS:
    raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")
  if remat == "none" or not torch.is_grad_enabled():
    return layer(*args, **kwargs)
  if remat == "full":
    return ckpt_mod.checkpoint(layer, *args, use_reentrant=False, **kwargs)
  return ckpt_mod.checkpoint(
      layer, *args, use_reentrant=False,
      context_fn=lambda: ckpt_mod.create_selective_checkpoint_contexts(
          _save_dots), **kwargs)


FAMILIES = ("dense", "moe", "vlm")


def check_family(cfg: cm.ModelConfig) -> None:
  if cfg.family not in FAMILIES:
    raise ValueError(f"{cfg.name}: the transformer runs the {FAMILIES} "
                     f"families, not {cfg.family}")


def init_lm_params(generator: torch.Generator, cfg: cm.ModelConfig) -> dict:
  """Random weights in the reference's layout, one dict per layer under
  ``blocks``, drawn from ``generator`` on its device."""
  vp, d = padded_vocab(cfg), cfg.d_model
  dev = cm.init_device(generator)

  def normal(shape, std):
    return (cm.randn(generator, shape) * std).to(cfg.param_dtype)

  p = {
      "embed": normal((vp, d), 0.02),
      "final_norm_scale": torch.ones(d, dtype=cfg.param_dtype, device=dev),
      "blocks": [{
          "ln1_norm_scale": torch.ones(d, dtype=cfg.param_dtype, device=dev),
          "ln2_norm_scale": torch.ones(d, dtype=cfg.param_dtype, device=dev),
          "attn": attn_mod.attn_params(generator, cfg),
          **({"moe": moe_mod.moe_params(generator, cfg)} if cfg.n_experts
             else {"mlp": mlp_mod.mlp_params(generator, cfg)}),
      } for _ in range(cfg.n_layers)],
  }
  if not cfg.tie_embeddings:
    p["lm_head"] = normal((vp, d), 0.02)
  return p


class Block(nn.Module):
  """Pre-norm residual block: x + attn(norm(x)), then + mlp(norm(x)) or
  + moe(norm(x)); returns (x, kv, aux)."""

  def __init__(self, cfg: cm.ModelConfig, params: dict):
    super().__init__()
    self.cfg = cfg
    self.ln1_norm_scale = nn.Parameter(params["ln1_norm_scale"],
                                       requires_grad=False)
    self.ln2_norm_scale = nn.Parameter(params["ln2_norm_scale"],
                                       requires_grad=False)
    self.attn = attn_mod.Attention(cfg, params["attn"])
    if cfg.n_experts:
      self.moe = moe_mod.MoE(cfg, params["moe"])
    else:
      self.mlp = mlp_mod.MLP(cfg, params["mlp"])

  def forward(self, x: Tensor, positions: Tensor, *, mode: str,
              cache: Optional[dict], cache_len: Optional[Tensor], impl: str):
    x = cm.constrain_acts(x)
    h = cm.rms_norm(x, self.ln1_norm_scale, self.cfg.norm_eps)
    a, kv = self.attn(h, positions, mode=mode, layer_cache=cache,
                      cache_len=cache_len, impl=impl)
    x = x + a
    h = cm.rms_norm(x, self.ln2_norm_scale, self.cfg.norm_eps)
    if self.cfg.n_experts:
      m, aux = self.moe(h)
    else:
      m, aux = self.mlp(h), torch.zeros((), device=x.device)
    return x + m, kv, aux


class TransformerLM(nn.Module):
  """Embedding, ``n_layers`` blocks, final norm and LM head.

  ``params`` is ``init_lm_params``'s layout: tensors in ``param_dtype``,
  ``blocks`` a list of per-layer dicts.
  """

  def __init__(self, cfg: cm.ModelConfig, params: dict):
    super().__init__()
    check_family(cfg)
    if len(params["blocks"]) != cfg.n_layers:
      raise ValueError(f"{len(params['blocks'])} blocks for a "
                       f"{cfg.n_layers}-layer config")
    self.cfg = cfg
    self.embed = nn.Parameter(params["embed"], requires_grad=False)
    self.final_norm_scale = nn.Parameter(params["final_norm_scale"],
                                         requires_grad=False)
    if not cfg.tie_embeddings:
      self.lm_head = nn.Parameter(params["lm_head"], requires_grad=False)
    self.blocks = nn.ModuleList(Block(cfg, lp) for lp in params["blocks"])

  def forward(self, tokens: Tensor, positions: Optional[Tensor] = None, *,
              mode: str = "train", cache: Optional[dict] = None,
              impl: str = "xla", remat: str = "none"):
    """Returns (logits, new cache or None, aux loss).

    tokens: (B, S) int token ids, or (B, S, D) precomputed embeddings (the
    reference's ``forward_lm(tokens_or_embeds)``).  ``remat`` is each layer's ``run_layer`` policy
    (it acts only when gradients are recorded).  'train' gives logits for
    every position;
    'prefill' only for the last one (the serving path needs no more) and the
    stacked cache {'k', 'v' (L, B, S, KV, hd), 'len'}; 'decode' takes S == 1
    and an ``init_cache``-layout cache, which it updates in place and
    returns with ``len`` advanced.
    """
    cfg = self.cfg
    x = (self.embed[tokens] if tokens.ndim == 2 else tokens).to(cfg.dtype)
    b, s = x.shape[:2]
    cache_len = cache["len"] if cache is not None else None
    if positions is None:
      base = cache_len if mode == "decode" else 0
      positions = (base + torch.arange(s, device=x.device)[None, :]
                   + torch.zeros((b, 1), dtype=torch.int32, device=x.device))
    kvs, auxs = [], []
    for i, block in enumerate(self.blocks):
      layer_cache = (None if cache is None else
                     {"k": cache["k"][i], "v": cache["v"][i]})
      x, kv, aux = run_layer(block, remat, x, positions, mode=mode,
                             cache=layer_cache, cache_len=cache_len,
                             impl=impl)
      kvs.append(kv)
      auxs.append(aux)
    if mode == "prefill":
      x = x[:, -1:]
    x = cm.rms_norm(x, self.final_norm_scale, cfg.norm_eps)
    logits = logits_from(self, cfg, x)
    new_cache = None
    if mode == "prefill":
      new_cache = {"k": torch.stack([kv["k"] for kv in kvs]),
                   "v": torch.stack([kv["v"] for kv in kvs]),
                   "len": torch.full((), s, dtype=torch.int32,
                                     device=x.device)}
    elif mode == "decode":
      # each layer wrote its row into its view of the stacked cache
      new_cache = {"k": cache["k"], "v": cache["v"], "len": cache_len + 1}
    return logits, new_cache, torch.stack(auxs).mean()


def logits_from(model: TransformerLM, cfg: cm.ModelConfig,
                x: Tensor) -> Tensor:
  """x (B, S, D) → logits (B, S, padded vocab) over the LM head (or the
  embedding when tied), in ``cfg.dtype``."""
  head = model.embed if cfg.tie_embeddings else model.lm_head
  return torch.matmul(x, head.to(cfg.dtype).T)


def forward_lm(model: TransformerLM, cfg: cm.ModelConfig, tokens: Tensor,
               positions: Optional[Tensor] = None, *, mode: str = "train",
               cache: Optional[dict] = None, impl: str = "xla",
               remat: str = "none"):
  """Returns (logits, new_cache_or_None, aux_loss); see
  ``TransformerLM.forward``."""
  return model(tokens, positions, mode=mode, cache=cache, impl=impl,
               remat=remat)
