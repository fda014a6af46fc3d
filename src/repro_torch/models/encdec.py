"""Encoder-decoder backbone (seamless-m4t text/audio).

Counterpart of ``repro/models/encdec.py``.  The audio frontend is a stub,
as in the reference: ``src_embeds`` are precomputed frame embeddings (B,
S_src, D).  The encoder is non-causal self-attention and an ungated GELU
MLP; each decoder layer adds causal self-attention, cross-attention over
the encoder output, then the MLP.  The reference scans over stacked
layers; here ``EncDecLM`` holds one module per layer (``enc``, ``dec``) and
loops over them, and ``remat="full"`` recomputes each layer in the
backward ("dots", like the reference's enc-dec, keeps every activation).

Cross-attention K/V for all decoder layers are projected once per call
from the encoder output, as one product, and each layer reads its slice as
a view (the reference's ``decode_stack``).  On ``impl="pallas"`` each
decoder layer launches K3 twice in the prefill (causal self-attention,
then non-causal cross-attention with Sq = the prompt and Skv = the
source); the encoder launches it once per layer when ``encode`` is given
``impl="pallas"`` (the serving engine does; the reference's ``encode``
always takes the chunked arm).  Decode steps launch no kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.models import attention as attn_mod
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import transformer as tf_mod

Tensor = torch.Tensor


def init_encdec_params(generator: torch.Generator,
                       cfg: cm.ModelConfig) -> dict:
  """Random weights in the reference's layout, one dict per layer under
  ``enc`` and ``dec``, drawn from ``generator`` on its device."""
  vp, d = tf_mod.padded_vocab(cfg), cfg.d_model
  dev = cm.init_device(generator)

  def normal(shape, std):
    return (cm.randn(generator, shape) * std).to(cfg.param_dtype)

  def ones():
    return torch.ones(d, dtype=cfg.param_dtype, device=dev)

  return {
      "embed": normal((vp, d), 0.02),
      "enc": [{"ln1_norm_scale": ones(), "ln2_norm_scale": ones(),
               "attn": attn_mod.attn_params(generator, cfg),
               "mlp": mlp_mod.mlp_params(generator, cfg, gated=False)}
              for _ in range(cfg.enc_layers)],
      "enc_norm_scale": ones(),
      "dec": [{"ln1_norm_scale": ones(), "ln2_norm_scale": ones(),
               "ln3_norm_scale": ones(),
               "attn": attn_mod.attn_params(generator, cfg),
               "cross": attn_mod.attn_params(generator, cfg),
               "mlp": mlp_mod.mlp_params(generator, cfg, gated=False)}
              for _ in range(cfg.dec_layers)],
      "final_norm_scale": ones(),
      "lm_head": normal((vp, d), 0.02),
  }


def _frozen(t: Tensor) -> nn.Parameter:
  return nn.Parameter(t, requires_grad=False)


class EncoderLayer(nn.Module):
  """x + attn(norm(x)) with every key visible, then + mlp(norm(x))."""

  def __init__(self, cfg: cm.ModelConfig, params: dict):
    super().__init__()
    self.cfg = cfg
    self.ln1_norm_scale = _frozen(params["ln1_norm_scale"])
    self.ln2_norm_scale = _frozen(params["ln2_norm_scale"])
    self.attn = attn_mod.Attention(cfg, params["attn"])
    self.mlp = mlp_mod.MLP(cfg, params["mlp"])

  def forward(self, x: Tensor, positions: Tensor, *, impl: str) -> Tensor:
    h = cm.rms_norm(x, self.ln1_norm_scale, self.cfg.norm_eps)
    a, _ = self.attn(h, positions, mode="train", causal=False, impl=impl)
    x = x + a
    h = cm.rms_norm(x, self.ln2_norm_scale, self.cfg.norm_eps)
    return x + self.mlp(h)


class DecoderLayer(nn.Module):
  """x + self-attn(norm(x)), + cross-attn(norm(x)) over the layer's
  encoder K/V, then + mlp(norm(x)); returns (x, kv)."""

  def __init__(self, cfg: cm.ModelConfig, params: dict):
    super().__init__()
    self.cfg = cfg
    for name in ("ln1_norm_scale", "ln2_norm_scale", "ln3_norm_scale"):
      setattr(self, name, _frozen(params[name]))
    self.attn = attn_mod.Attention(cfg, params["attn"])
    self.cross = attn_mod.Attention(cfg, params["cross"])
    self.mlp = mlp_mod.MLP(cfg, params["mlp"])

  def forward(self, x: Tensor, positions: Tensor, ck: Tensor, cv: Tensor, *,
              mode: str, cache: Optional[dict], cache_len: Optional[Tensor],
              impl: str):
    eps = self.cfg.norm_eps
    x = cm.constrain_acts(x)
    h = cm.rms_norm(x, self.ln1_norm_scale, eps)
    a, kv = self.attn(h, positions, mode=mode, layer_cache=cache,
                      cache_len=cache_len, impl=impl)
    x = x + a
    h = cm.rms_norm(x, self.ln2_norm_scale, eps)
    ca, _ = self.cross(h, positions, mode=mode, layer_cache=cache,
                       cache_len=cache_len, impl=impl, kv_override=(ck, cv))
    x = x + ca
    h = cm.rms_norm(x, self.ln3_norm_scale, eps)
    return x + self.mlp(h), kv


class EncDecLM(nn.Module):
  """Embedding, ``enc_layers`` encoder layers and their final norm,
  ``dec_layers`` decoder layers, final norm and LM head."""

  def __init__(self, cfg: cm.ModelConfig, params: dict):
    super().__init__()
    if cfg.family != "encdec":
      raise ValueError(f"{cfg.name} is a {cfg.family} config, not encdec")
    if (len(params["enc"]), len(params["dec"])) != (cfg.enc_layers,
                                                    cfg.dec_layers):
      raise ValueError(f"{len(params['enc'])} + {len(params['dec'])} layers "
                       f"for a {cfg.enc_layers} + {cfg.dec_layers}-layer "
                       f"config")
    self.cfg = cfg
    self.embed = _frozen(params["embed"])
    self.enc = nn.ModuleList(EncoderLayer(cfg, lp) for lp in params["enc"])
    self.enc_norm_scale = _frozen(params["enc_norm_scale"])
    self.dec = nn.ModuleList(DecoderLayer(cfg, lp) for lp in params["dec"])
    self.final_norm_scale = _frozen(params["final_norm_scale"])
    self.lm_head = _frozen(params["lm_head"])

  def forward(self, src_embeds: Optional[Tensor], tokens: Tensor, *,
              mode: str = "train", cache: Optional[dict] = None,
              enc_out: Optional[Tensor] = None, impl: str = "xla",
              remat: str = "none"):
    """Returns (logits, new cache or None, aux loss 0).  Encodes
    ``src_embeds`` (on the chunked arm, as the reference does) unless
    ``enc_out`` is given; see ``decode_stack``."""
    if enc_out is None:
      enc_out = encode(self, self.cfg, src_embeds, remat=remat)
    logits, new_cache = decode_stack(self, self.cfg, tokens, enc_out,
                                     mode=mode, cache=cache, impl=impl,
                                     remat=remat)
    return logits, new_cache, torch.zeros((), device=logits.device)


def _layer_remat(remat: str) -> str:
  if remat not in tf_mod.REMATS:
    raise ValueError(f"remat must be one of {tf_mod.REMATS}, got {remat!r}")
  return "full" if remat == "full" else "none"


def encode(model: EncDecLM, cfg: cm.ModelConfig, src_embeds: Tensor,
           remat: str = "none", impl: str = "xla") -> Tensor:
  """src_embeds (B, S_src, D) → the normalised encoder output (B, S_src,
  D) in ``cfg.dtype``.  ``impl`` is the encoder's attention arm: 'xla' is
  the reference's (its ``encode`` has no such argument); the serving engine
  passes its own, so that on 'pallas' each layer launches K3."""
  remat = _layer_remat(remat)
  x = src_embeds.to(cfg.dtype)
  b, s = x.shape[:2]
  positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
  for layer in model.enc:
    x = tf_mod.run_layer(layer, remat, x, positions, impl=impl)
  return cm.rms_norm(x, model.enc_norm_scale, cfg.norm_eps)


def cross_kv(model: EncDecLM, cfg: cm.ModelConfig, enc_out: Tensor):
  """Every decoder layer's cross-attention K and V (no RoPE), (L, B, Skv,
  KV, hd) each: views of one product of ``enc_out`` with all layers' wk
  and wv, so each layer's slice is a strided view that K3 reads as it is
  (unit stride on hd, rows 16-byte aligned)."""
  n, kvh, hd = len(model.dec), model.dec[0].cross.wk.shape[1], cfg.hd
  with cm.whole_weights(*(layer.cross for layer in model.dec)):
    w = torch.stack([torch.stack((layer.cross.wk, layer.cross.wv))
                     for layer in model.dec])          # (L, 2, D, KV, hd)
  w = w.to(cfg.dtype).permute(2, 0, 1, 3, 4).reshape(cfg.d_model, -1)
  kv = torch.matmul(enc_out, w).unflatten(-1, (n, 2, kvh, hd))
  kv = kv.permute(2, 3, 0, 1, 4, 5)                    # (L, 2, B, Skv, KV, hd)
  return kv[:, 0], kv[:, 1]


def decode_stack(model: EncDecLM, cfg: cm.ModelConfig, tokens: Tensor,
                 enc_out: Tensor, *, mode: str = "train",
                 cache: Optional[dict] = None, impl: str = "xla",
                 remat: str = "none"):
  """The decoder over ``tokens`` (B, S) attending ``enc_out``.  Returns
  (logits, new cache or None).

  'train' gives logits for every position; 'prefill' only for the last one
  and the self-attention cache {'k', 'v' (L, B, S, KV, hd), 'len' S};
  'decode' takes S == 1 and an ``init_cache``-layout cache of
  ``dec_layers`` layers, writes each layer's row in place and returns it
  with ``len`` advanced.
  """
  remat = _layer_remat(remat)
  x = cm.embed(model.embed, tokens, tf_mod.padded_vocab(cfg), cfg.dtype)
  b, s = tokens.shape
  cache_len = cache["len"] if cache is not None else None
  base = cache_len if mode == "decode" else 0
  positions = (base + torch.arange(s, device=x.device)[None, :]
               + torch.zeros((b, 1), dtype=torch.int32, device=x.device))
  ck, cv = cross_kv(model, cfg, enc_out)
  kvs = []
  for i, layer in enumerate(model.dec):
    layer_cache = (None if cache is None else
                   {"k": cache["k"][i], "v": cache["v"][i]})
    x, kv = tf_mod.run_layer(layer, remat, x, positions, ck[i], cv[i],
                             mode=mode, cache=layer_cache,
                             cache_len=cache_len, impl=impl)
    kvs.append(kv)
  x = cm.end_stream(x)
  if mode == "prefill":
    x = x[:, -1:]
  x = cm.rms_norm(x, model.final_norm_scale, cfg.norm_eps)
  logits = tf_mod.logits_from(model, cfg, x)
  new_cache = None
  if mode == "prefill":
    new_cache = {"k": torch.stack([kv["k"] for kv in kvs]),
                 "v": torch.stack([kv["v"] for kv in kvs]),
                 "len": torch.full((), s, dtype=torch.int32,
                                   device=x.device)}
  elif mode == "decode":
    new_cache = {"k": cache["k"], "v": cache["v"], "len": cache_len + 1}
  return logits, new_cache


def forward_encdec(model: EncDecLM, cfg: cm.ModelConfig,
                   src_embeds: Optional[Tensor], tokens: Tensor, *,
                   mode: str = "train", cache: Optional[dict] = None,
                   enc_out: Optional[Tensor] = None, impl: str = "xla",
                   remat: str = "none"):
  """Returns (logits, new_cache, aux).  For decode, pass precomputed
  ``enc_out`` (the serving loop encodes once)."""
  return model(src_embeds, tokens, mode=mode, cache=cache, enc_out=enc_out,
               impl=impl, remat=remat)
