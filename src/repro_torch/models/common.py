"""Model substrate shared by the LM families: the configuration record and
the primitives every block uses.

Counterpart of ``repro/models/common.py``.  Parameters are plain tensors in
``param_dtype`` (f32) and are cast to ``cfg.dtype`` (bf16) at each use, as
the reference casts them inside its jitted step.  The mesh and sharding
helpers (``Parallelism``, ``spec_for``, ``constrain_acts``) come with the
LM sharding, ROADMAP Queue 1 item 13, and are not here.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ModelConfig:
  name: str
  family: str                      # dense | moe | ssm | hybrid | encdec | vlm
  n_layers: int
  d_model: int
  n_heads: int
  n_kv_heads: int
  d_ff: int
  vocab: int
  head_dim: Optional[int] = None
  # attention
  window: Optional[int] = None     # sliding-window size (SWA) or None
  qkv_bias: bool = False
  qk_norm: bool = False
  rope_theta: float = 10000.0
  norm_eps: float = 1e-5
  tie_embeddings: bool = False
  # MoE
  n_experts: int = 0
  topk: int = 0
  capacity_factor: float = 1.25
  # SSM (mamba2 / SSD)
  ssm_state: int = 0
  ssm_expand: int = 2
  ssm_headdim: int = 64
  ssm_ngroups: int = 1
  ssm_chunk: int = 256
  conv_kernel: int = 4
  # hybrid (zamba2-style): one shared attention block every k SSM blocks
  hybrid_attn_every: int = 0
  # encoder-decoder
  enc_layers: int = 0
  dec_layers: int = 0
  cross_attention: bool = False
  src_len: int = 0
  modality_stub: Optional[str] = None
  # dtypes
  dtype: torch.dtype = torch.bfloat16        # activation / compute dtype
  param_dtype: torch.dtype = torch.float32   # master weights

  @property
  def hd(self) -> int:
    return self.head_dim if self.head_dim else self.d_model // self.n_heads

  @property
  def d_inner(self) -> int:        # SSD inner width
    return self.ssm_expand * self.d_model

  @property
  def ssm_heads(self) -> int:
    return self.d_inner // self.ssm_headdim

  def replace(self, **kw) -> "ModelConfig":
    return dataclasses.replace(self, **kw)


def rms_norm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
  """RMS normalisation in f32, cast back to x's dtype."""
  dt = x.dtype
  x = x.float()
  x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
  return (x * scale.float()).to(dt)


def layer_norm(x: Tensor, scale: Tensor, bias: Tensor, eps: float) -> Tensor:
  """Layer normalisation: mean and variance in f32, cast back to x's
  dtype."""
  dt = x.dtype
  x = x.float()
  mu = torch.mean(x, dim=-1, keepdim=True)
  var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
  x = (x - mu) * torch.rsqrt(var + eps)
  return (x * scale.float() + bias.float()).to(dt)


def rope_freqs(d2: int, theta: float) -> np.ndarray:
  """The rotation frequencies, built in numpy f32 exactly as the reference
  builds them, so both packages start from the same bits."""
  return 1.0 / (theta ** (np.arange(0, d2, dtype=np.float32) / d2))


@functools.lru_cache(maxsize=32)
def _rope_freqs_on(d2: int, theta: float, device: torch.device) -> Tensor:
  # one host-to-device copy per (width, theta, device), not one per call:
  # a copy from pageable memory waits for the card's queue to drain
  return torch.from_numpy(rope_freqs(d2, theta)).to(device)


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
  """Half-split rotary embedding.  x: (B, S, H, D) with D even; positions:
  (B, S) or (S,)."""
  d2 = x.shape[-1] // 2
  freqs = _rope_freqs_on(d2, float(theta), x.device)
  if positions.ndim == 1:
    positions = positions[None, :]
  ang = positions[..., None].float() * freqs  # (B, S, d2)
  cos = torch.cos(ang)[:, :, None, :]
  sin = torch.sin(ang)[:, :, None, :]
  x1, x2 = x[..., :d2].float(), x[..., d2:].float()
  out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
  return out.to(x.dtype)


def dense_init(generator: torch.Generator, shape: Sequence[int],
               in_axis: int = -2, dtype=torch.float32) -> Tensor:
  """N(0, 1/fan_in) weights drawn from ``generator`` on its device."""
  fan_in = shape[in_axis]
  w = torch.randn(tuple(shape), generator=generator, device=generator.device)
  return (w / math.sqrt(fan_in)).to(dtype)
