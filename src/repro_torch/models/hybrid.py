"""Zamba2-style hybrid: a stack of Mamba2 (SSD) layers with one *shared*
attention + MLP block applied after every ``hybrid_attn_every`` SSM layers
(arXiv:2411.15242: the shared block amortises attention parameters over
depth).

Counterpart of ``repro/models/hybrid.py``.  With every = ``hybrid_attn_every``
(or L + 1 when it is 0), the L SSM layers form n_apps = L // every groups,
each followed by an application of the shared block, then a tail of
L mod every SSM layers (zamba2-7b: 13 applications over 78 layers, then 3).
The reference scans over the groups; here the model loops over them.  The
shared block has one parameter set; each application has its own KV cache
slice, {'k', 'v': (n_apps, B, max_len, KV, hd)}.  Decode writes each
application's new row into its slice in place and copies the SSM states in
place, as ``zoo.SSMLM`` does.  ``remat="full"`` recomputes each group (its
SSM layers and the shared block) and each tail layer in the backward;
"dots", like the reference's, keeps every activation.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf_mod

Tensor = torch.Tensor


def layout(cfg: cm.ModelConfig) -> tuple:
  """(every, n_apps): SSM layers per group and applications of the shared
  block; the n_layers − every · n_apps layers after them are the tail."""
  every = cfg.hybrid_attn_every or cfg.n_layers + 1
  return every, cfg.n_layers // every


def init_hybrid_params(generator: torch.Generator,
                       cfg: cm.ModelConfig) -> dict:
  """Random weights in the reference's layout (``blocks`` one dict per SSM
  layer, ``shared`` one attention + MLP block), drawn from ``generator``
  on its device."""
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
      "shared": {"ln1_norm_scale": ones(d), "ln2_norm_scale": ones(d),
                 "attn": attn_mod.attn_params(generator, cfg),
                 "mlp": mlp_mod.mlp_params(generator, cfg)},
      "lm_head": normal((vp, d), 0.02),
  }


class SharedBlock(tf_mod.Block):
  """The shared pre-norm attention + MLP block (the dense ``Block`` with
  one parameter set), applied once per group."""


class HybridLM(nn.Module):
  """Embedding, the SSM layers with the shared block after each group, final
  norm and LM head."""

  def __init__(self, cfg: cm.ModelConfig, params: dict):
    super().__init__()
    if cfg.family != "hybrid":
      raise ValueError(f"{cfg.name} is a {cfg.family} config, not hybrid")
    if len(params["blocks"]) != cfg.n_layers:
      raise ValueError(f"{len(params['blocks'])} blocks for a "
                       f"{cfg.n_layers}-layer config")
    self.cfg = cfg
    self.embed = nn.Parameter(params["embed"], requires_grad=False)
    self.final_norm_scale = nn.Parameter(params["final_norm_scale"],
                                         requires_grad=False)
    self.lm_head = nn.Parameter(params["lm_head"], requires_grad=False)
    self.blocks = nn.ModuleList(ssm_mod.SSMLayer(cfg, lp)
                                for lp in params["blocks"])
    self.shared = SharedBlock(cfg, params["shared"])

  def _ssm(self, i: int, x: Tensor, *, mode: str, stacked: Optional[dict],
           impl: str):
    """SSM layer i; in decode its state in ``stacked`` is updated in
    place."""
    st = (None if stacked is None else
          {name: t[i] for name, t in stacked.items()})
    x = cm.constrain_acts(x)
    x, new_st = self.blocks[i](x, mode=mode, state=st, impl=impl)
    if mode == "decode":
      for name, t in new_st.items():
        st[name].copy_(t)
    return x, new_st

  def _group(self, x: Tensor, app: int, positions: Tensor, *, mode: str,
             stacked: Optional[dict], attn_cache: Optional[dict],
             cache_len: Optional[Tensor], impl: str):
    """Group ``app``: its SSM layers, then the shared block on the
    application's KV slice.  Returns (x, the layers' states, kv)."""
    every = layout(self.cfg)[0]
    states = []
    for i in range(app * every, (app + 1) * every):
      x, st = self._ssm(i, x, mode=mode, stacked=stacked, impl=impl)
      states.append(st)
    lc = (None if attn_cache is None else
          {"k": attn_cache["k"][app], "v": attn_cache["v"][app]})
    x, kv, _ = self.shared(x, positions, mode=mode, cache=lc,
                           cache_len=cache_len, impl=impl)
    return x, states, kv

  def forward(self, tokens: Tensor, positions: Optional[Tensor] = None, *,
              mode: str = "train", cache: Optional[dict] = None,
              impl: str = "xla", remat: str = "none"):
    """Returns (logits, new cache or None, aux loss = 0).

    'train' gives logits for every position; 'prefill' only for the last
    one and the cache {'ssm': stacked states (L, ...), 'attn': {'k', 'v'
    (n_apps, B, S, KV, hd)}, 'len'}; 'decode' takes S == 1 and an
    ``init_hybrid_cache``-layout cache, updates it in place and returns it
    with ``len`` advanced.
    """
    cfg = self.cfg
    if remat not in tf_mod.REMATS:
      raise ValueError(f"remat must be one of {tf_mod.REMATS}, got {remat!r}")
    per_layer = "full" if remat == "full" else "none"
    x = self.embed[tokens].to(cfg.dtype)
    b, s = tokens.shape
    cache_len = cache["len"] if cache is not None else None
    if positions is None:
      base = cache_len if mode == "decode" else 0
      positions = (base + torch.arange(s, device=x.device)[None, :]
                   + torch.zeros((b, 1), dtype=torch.int32, device=x.device))
    stacked = cache["ssm"] if cache is not None else None
    attn_cache = cache["attn"] if cache is not None else None
    every, n_apps = layout(cfg)
    states, kvs = [], []
    for app in range(n_apps):
      x, sts, kv = tf_mod.run_layer(
          self._group, per_layer, x, app, positions, mode=mode,
          stacked=stacked, attn_cache=attn_cache, cache_len=cache_len,
          impl=impl)
      states += sts
      kvs.append(kv)
    for i in range(n_apps * every, cfg.n_layers):
      x, st = tf_mod.run_layer(self._ssm, per_layer, i, x, mode=mode,
                               stacked=stacked, impl=impl)
      states.append(st)
    if mode == "prefill":
      x = x[:, -1:]
    x = cm.rms_norm(x, self.final_norm_scale, cfg.norm_eps)
    logits = tf_mod.logits_from(self, cfg, x)
    new_cache = None
    if mode == "prefill":
      def stack(name):
        if kvs:
          return torch.stack([kv[name] for kv in kvs])
        return torch.empty((0, b, s, cfg.n_kv_heads, cfg.hd),
                           dtype=cfg.dtype, device=x.device)
      new_cache = {"ssm": {name: torch.stack([st[name] for st in states])
                           for name in states[0]},
                   "attn": {"k": stack("k"), "v": stack("v")},
                   "len": torch.full((), s, dtype=torch.int32,
                                     device=x.device)}
    elif mode == "decode":
      new_cache = {"ssm": stacked, "attn": attn_cache, "len": cache_len + 1}
    return logits, new_cache, torch.zeros((), device=x.device)


def init_hybrid_cache(cfg: cm.ModelConfig, batch: int, max_len: int,
                      device=DEFAULT_DEVICE) -> dict:
  """A zeroed cache: the layer-stacked SSM state and one KV slice of
  ``max_len`` rows per application of the shared block."""
  dev = resolve_device(device)
  kv = attn_mod.init_cache(cfg, layout(cfg)[1], batch, max_len, device=dev)
  return {"ssm": ssm_mod.init_ssm_state(cfg, cfg.n_layers, batch,
                                        device=dev),
          "attn": {"k": kv["k"], "v": kv["v"]}, "len": kv["len"]}
