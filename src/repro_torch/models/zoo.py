"""Unified model API for the port's LM families (dense, MoE, VLM, SSM,
hybrid, enc-dec):

    model = zoo.init(cfg, generator, device)
    logits, cache, aux = zoo.forward(model, cfg, batch, mode=..., ...)

Counterpart of ``repro/models/zoo.py``.  ``batch`` is a dict
{'tokens': (B, S) int}, plus {'src_embeds': (B, S_src, D)} for the
enc-dec family (and, for the transformer families, precomputed embeddings
in place of the tokens), and for an enc-dec decode the encoder output
{'enc_out'} (or ``enc_out=``).  Caches keep the reference's layouts: dense
{'k', 'v': (L, B, max_len, KV, hd), 'len'} (enc-dec: the decoder's
self-attention, L = dec_layers); SSM {'ssm': {'ssm' (L, B, H, N, P) f32,
'conv' (L, B, K−1, d_inner), 'bc_conv' (L, B, K−1, 2GN)}, 'len'}; hybrid
{'ssm': the SSM state, 'attn': {'k', 'v': (n_apps, B, max_len, KV, hd)},
'len'}; each with an int32 scalar 'len'.  The MoE and VLM families run in
the dense family's ``TransformerLM``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import common as cm
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf_mod

Tensor = torch.Tensor


def init_ssm_lm_params(generator: torch.Generator,
                       cfg: cm.ModelConfig) -> dict:
  """Random SSM-LM weights in the reference's layout, one dict per layer
  under ``blocks``, drawn from ``generator`` on its device."""
  vp, d = tf_mod.padded_vocab(cfg), cfg.d_model
  dev = cm.init_device(generator)

  def normal(shape, std):
    return (cm.randn(generator, shape) * std).to(cfg.param_dtype)

  def ones(shape):
    return torch.ones(shape, dtype=cfg.param_dtype, device=dev)

  return {
      "embed": normal((vp, d), 0.02),
      "final_norm_scale": ones(d),
      "blocks": [{"ln_norm_scale": ones(d),
                  "ssm": ssm_mod.ssm_params(generator, cfg)}
                 for _ in range(cfg.n_layers)],
      "lm_head": normal((vp, d), 0.02),
  }


class SSMLM(nn.Module):
  """Embedding, ``n_layers`` SSM layers, final norm and LM head (the
  reference's ``_init_ssm_lm`` / ``_forward_ssm_lm``)."""

  def __init__(self, cfg: cm.ModelConfig, params: dict):
    super().__init__()
    if cfg.family != "ssm":
      raise ValueError(f"{cfg.name} is a {cfg.family} config, not ssm")
    if len(params["blocks"]) != cfg.n_layers:
      raise ValueError(f"{len(params['blocks'])} blocks for a "
                       f"{cfg.n_layers}-layer config")
    self.cfg = cfg
    self.embed = nn.Parameter(params["embed"], requires_grad=False)
    self.final_norm_scale = nn.Parameter(params["final_norm_scale"],
                                         requires_grad=False)
    if not cfg.tie_embeddings:
      self.lm_head = nn.Parameter(params["lm_head"], requires_grad=False)
    self.blocks = nn.ModuleList(ssm_mod.SSMLayer(cfg, lp)
                                for lp in params["blocks"])

  def forward(self, tokens: Tensor, *, mode: str = "train",
              cache: Optional[dict] = None, impl: str = "xla",
              remat: str = "none"):
    """Returns (logits, new cache or None, aux loss).

    ``remat`` 'full' recomputes each layer in the backward; 'dots', like
    the reference's SSM stack, keeps every activation ('none').

    'train' gives logits for every position; 'prefill' only for the last
    one and the stacked state after the prompt as the cache; 'decode'
    takes S == 1 and an ``init_cache``-layout cache, whose per-layer states
    it updates in place and returns with ``len`` advanced.
    """
    cfg = self.cfg
    if remat not in tf_mod.REMATS:
      raise ValueError(f"remat must be one of {tf_mod.REMATS}, got {remat!r}")
    x = self.embed[tokens].to(cfg.dtype)
    stacked = cache["ssm"] if cache is not None else None
    states = []
    for i, layer in enumerate(self.blocks):
      st = (None if stacked is None else
            {name: t[i] for name, t in stacked.items()})
      x = cm.constrain_acts(x)
      x, new_st = tf_mod.run_layer(layer, "full" if remat == "full" else
                                   "none", x, mode=mode, state=st, impl=impl)
      if mode == "decode":
        for name, t in new_st.items():
          st[name].copy_(t)
      states.append(new_st)
    if mode == "prefill":
      x = x[:, -1:]
    x = cm.rms_norm(x, self.final_norm_scale, cfg.norm_eps)
    logits = tf_mod.logits_from(self, cfg, x)
    new_cache = None
    if mode == "prefill":
      new_cache = {"ssm": {name: torch.stack([st[name] for st in states])
                           for name in states[0]},
                   "len": torch.full((), tokens.shape[1], dtype=torch.int32,
                                     device=x.device)}
    elif mode == "decode":
      new_cache = {"ssm": stacked, "len": cache["len"] + 1}
    return logits, new_cache, torch.zeros((), device=x.device)


def init(cfg: cm.ModelConfig, generator: Optional[torch.Generator],
         device=DEFAULT_DEVICE) -> nn.Module:
  """Random weights from ``generator`` (drawn on its device), on ``device``.

  ``generator=None`` with ``device="meta"`` builds the module with every
  parameter an empty meta tensor of its shape: nothing is drawn or
  allocated, at any size (the dry run's models)."""
  dev = resolve_device(device)
  if generator is None and dev.type != "meta":
    raise ValueError("with no generator the weights are not drawn: only "
                     "device='meta' builds such a model")
  if cfg.family == "ssm":
    params = init_ssm_lm_params(generator, cfg)
  elif cfg.family == "hybrid":
    params = hybrid_mod.init_hybrid_params(generator, cfg)
  elif cfg.family == "encdec":
    params = encdec_mod.init_encdec_params(generator, cfg)
  else:
    tf_mod.check_family(cfg)
    params = tf_mod.init_lm_params(generator, cfg)
  return from_params(cfg, params).to(dev)


def from_params(cfg: cm.ModelConfig, params: dict) -> nn.Module:
  """The module of ``cfg``'s family over ``params`` (``param_tree``'s
  layout): its parameters are those tensors themselves, not copies, on
  whatever device they lie."""
  if cfg.family == "ssm":
    return SSMLM(cfg, params)
  if cfg.family == "hybrid":
    return hybrid_mod.HybridLM(cfg, params)
  if cfg.family == "encdec":
    return encdec_mod.EncDecLM(cfg, params)
  tf_mod.check_family(cfg)
  return tf_mod.TransformerLM(cfg, params)


def forward(model: nn.Module, cfg: cm.ModelConfig, batch: dict, *,
            mode: str = "train", cache: Optional[dict] = None,
            enc_out: Optional[Tensor] = None, impl: str = "xla",
            remat: str = "none"):
  """Returns (logits, new_cache_or_None, aux_loss); ``model`` is
  ``init``'s module for ``cfg``'s family.  An enc-dec model reads
  ``batch['enc_out']`` ahead of ``enc_out`` and encodes
  ``batch['src_embeds']`` when neither is given."""
  if cfg.family == "encdec":
    return encdec_mod.forward_encdec(
        model, cfg, batch.get("src_embeds"), batch["tokens"], mode=mode,
        cache=cache, enc_out=batch.get("enc_out", enc_out), impl=impl,
        remat=remat)
  inputs = (batch.get("src_embeds", batch.get("tokens"))
            if cfg.family in tf_mod.FAMILIES else batch["tokens"])
  return model(inputs, mode=mode, cache=cache, impl=impl, remat=remat)


def param_tree(model: nn.Module) -> dict:
  """The model's parameters (the tensors themselves, not copies) in the
  reference's tree: ``embed``, ``final_norm_scale``, ``lm_head`` and
  ``blocks`` — here a list of per-layer dicts where the reference stacks
  each leaf along a leading layer axis — and a hybrid's ``shared``; an
  enc-dec model's ``enc`` and ``dec`` (lists of layers, as ``blocks``) and
  ``enc_norm_scale`` in place of ``blocks``."""
  tree: dict = {}
  for name, p in model.named_parameters():  # layers come in index order
    *path, leaf = name.split(".")
    node = tree
    for part, nxt in zip(path, path[1:] + [leaf]):
      if isinstance(node, list):
        if int(part) == len(node):
          node.append({})
        node = node[int(part)]
      else:
        node = node.setdefault(part, [] if nxt.isdigit() else {})
    node[leaf] = p
  return tree


def init_cache(cfg: cm.ModelConfig, batch: int, max_len: int,
               device=DEFAULT_DEVICE) -> dict:
  """A zeroed cache; ``max_len`` sizes the KV cache (dense, MoE, VLM, the
  enc-dec decoder's self-attention, and the hybrid's per application) and
  is not read by the SSM state, which has no length."""
  dev = resolve_device(device)
  if cfg.family == "ssm":
    return {"ssm": ssm_mod.init_ssm_state(cfg, cfg.n_layers, batch,
                                          device=dev),
            "len": torch.zeros((), dtype=torch.int32, device=dev)}
  if cfg.family == "hybrid":
    return hybrid_mod.init_hybrid_cache(cfg, batch, max_len, device=dev)
  if cfg.family == "encdec":
    return attn_mod.init_cache(cfg, cfg.dec_layers, batch, max_len,
                               device=dev)
  tf_mod.check_family(cfg)
  return attn_mod.init_cache(cfg, cfg.n_layers, batch, max_len, device=dev)


def param_count(model: nn.Module) -> int:
  return sum(p.numel() for p in model.parameters())
