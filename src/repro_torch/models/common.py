"""Model substrate shared by the LM families: the configuration record and
the primitives every block uses.

Counterpart of ``repro/models/common.py``.  Parameters are plain tensors in
``param_dtype`` (f32) and are cast to ``cfg.dtype`` (bf16) at each use, as
the reference casts them inside its jitted step.  With no generator, the
draw helpers (``randn``, ``dense_init``) give empty meta tensors: a model
built so (``zoo.init(cfg, None, device="meta")``) has every shape and
draws and allocates nothing.

The sharding rules: ``Parallelism`` assigns mesh axes, and
``spec_for``/``specs_like`` give each parameter a spec — a plain tuple with
one entry per dimension, each an axis name, a tuple of names or ``None``,
as ``models/pipeline.py`` takes them.  The dry run (``launch/dryrun.py``)
reads them to size each device's share, and training on a mesh
(``train/sharded.py``) cuts the f32 master, both AdamW moments and the
gradient sums by them over the data and model axes.  The model axis
shards storage only: a data line runs its forward and backward whole on
one device, so no activation is sharded, and ``constrain_acts`` and
``constrain`` return their input unchanged.
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


@dataclasses.dataclass(frozen=True)
class Parallelism:
  """Mesh-axis assignment for shardings (see launch/mesh.py)."""
  data_axes: tuple = ("data",)     # batch axis(es); ("pod","data") multi-pod
  model_axis: str = "model"
  tp_size: int = 16                # size of the model axis (divisibility)
  dp_size: int = 16                # total size of the data axes
  fsdp: bool = True                # ZeRO-3: layer weights sharded over data
  seq_shard_decode: bool = True    # decode KV cache sharded over model axis
  remat: str = "none"              # none | full | dots

  @property
  def dp(self):                    # spec entry for the batch dimension
    return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]

  def dp_for(self, batch_size: int):
    """dp spec entry, or None when the batch can't shard evenly (e.g. the
    global_batch=1 long-context cells — batch stays replicated, the model
    axis still shards the long dimension)."""
    return self.dp if batch_size % self.dp_size == 0 else None

  @property
  def fsdp_axis(self):
    return self.dp if self.fsdp else None

  @property
  def tp(self):
    return self.model_axis


# ---------------------------------------------------------------------------
# activation-sharding constraint (Megatron-style sequence parallelism): the
# dry run installs a spec for the residual stream; every block body calls
# constrain_acts where the reference does.  The port shards no activation
# (a data line computes whole on one device), so both constraints return
# their input unchanged, installed spec or not; ``act_axes`` reads the
# installed spec back.
# ---------------------------------------------------------------------------

_ACT_SPEC: list = [None]


class activation_sharding:
  """Context manager: with activation_sharding(('data', 'model', None)):"""

  def __init__(self, spec):
    self.spec = spec

  def __enter__(self):
    self._prev = _ACT_SPEC[0]
    _ACT_SPEC[0] = self.spec
    return self

  def __exit__(self, *a):
    _ACT_SPEC[0] = self._prev
    return False


def constrain_acts(x: Tensor) -> Tensor:
  """The residual stream x (B, S, D), unchanged."""
  return x


def act_axes():
  """(dp, tp) axis names of the installed activation spec (None when
  unset)."""
  spec = _ACT_SPEC[0]
  if spec is None:
    return None, None
  dp = spec[0] if len(spec) > 0 else None
  tp = spec[1] if len(spec) > 1 else None
  return dp, tp


def constrain(x: Tensor, spec) -> Tensor:
  """x, unchanged: ``spec`` is its layout's metadata only."""
  del spec
  return x


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


def init_device(generator: Optional[torch.Generator]) -> torch.device:
  """The device weights are made on: the generator's, or with no generator
  the meta device."""
  return torch.device("meta") if generator is None else generator.device


def randn(generator: Optional[torch.Generator],
          shape: Sequence[int]) -> Tensor:
  """Standard normal f32 draws from ``generator`` on its device; with no
  generator an empty meta tensor of ``shape`` (nothing drawn or
  allocated)."""
  if generator is None:
    return torch.empty(tuple(shape), device="meta")
  return torch.randn(tuple(shape), generator=generator,
                     device=generator.device)


def dense_init(generator: Optional[torch.Generator], shape: Sequence[int],
               in_axis: int = -2, dtype=torch.float32) -> Tensor:
  """N(0, 1/fan_in) weights drawn from ``generator`` on its device (meta
  and undrawn with no generator)."""
  fan_in = shape[in_axis]
  w = randn(generator, shape)
  return (w / math.sqrt(fan_in)).to(dtype)


# ---------------------------------------------------------------------------
# sharding-spec construction
# ---------------------------------------------------------------------------

def spec_for(path: str, shape: Sequence[int], cfg: ModelConfig,
             par: Parallelism) -> tuple:
  """The spec of one parameter, keyed by its tree path (the reference's
  rules, entry for entry).

  Conventions (leading dim is the stacked layer dim for layer leaves):
    embeddings (V, D)            → (tp, None)            vocab-sharded
    *_norm  (..., D)             → replicated
    attn q/o projections         → TP on the head dim, fsdp on d_model
    attn k/v                     → TP on the kv-head dim iff divisible
    mlp w1/w3 (L, D, F)          → (None, fsdp, tp)
    mlp w2 (L, F, D)             → (None, tp, fsdp)
    moe experts (L, E, D, F)     → TP on F (expert width), fsdp on D
    ssd in/out projections       → TP on the inner dim
  """
  tp, fs = par.tp, par.fsdp_axis
  nd = len(shape)

  if "embed" in path or path.endswith("lm_head"):
    return (tp, None) if nd == 2 else (None,)
  if "norm" in path or path.endswith(("scale", "bias", "dt_bias", "A_log",
                                      "D")):
    return (None,) * nd
  if any(s in path for s in ("wq", "wo")):
    # stacked (L, D, H, hd) / (L, H, hd, D); shared (D, H, hd) / (H, hd, D)
    if nd == 4:
      return (None, fs, tp, None) if "wq" in path else (None, tp, None, fs)
    if nd == 3:
      return (fs, tp, None) if "wq" in path else (tp, None, fs)
    return (fs, tp) if "wq" in path else (tp, fs)
  if any(s in path for s in ("wk", "wv")):
    # Megatron GQA rule: TP-shard kv heads only when divisible, else
    # replicate the (small) kv projections across the model axis.
    kv_tp = tp if cfg.n_kv_heads % max(par.tp_size, 1) == 0 else None
    if nd == 4:
      return (None, fs, kv_tp, None)
    if nd == 3:
      return (fs, kv_tp, None)
    return (fs, kv_tp)
  if "experts" in path:
    # (L, E, D, F) or (L, E, F, D)
    if path.endswith("w2"):
      return (None, None, tp, fs)
    return (None, None, fs, tp)
  if "router" in path:
    return (None, fs, None)
  if any(s in path for s in ("w1", "w3", "in_proj", "up")):
    return (None,) * (nd - 2) + (fs, tp)
  if any(s in path for s in ("w2", "out_proj", "down")):
    return (None,) * (nd - 2) + (tp, fs)
  if "conv" in path:
    return (None,) * (nd - 1) + (tp,)
  return (None,) * nd


def tree_paths(tree, prefix=""):
  """{path: leaf} over a tree of dicts and lists; a list entry's path
  carries its index (``blocks/3/attn/wq``)."""
  out = {}
  items = tree.items() if isinstance(tree, dict) else enumerate(tree)
  for k, v in items:
    p = f"{prefix}/{k}" if prefix else str(k)
    if isinstance(v, (dict, list)):
      out.update(tree_paths(v, p))
    else:
      out[p] = v
  return out


def specs_like(params, cfg: ModelConfig, par: Parallelism):
  """Tree of specs matching ``params`` (``zoo.param_tree``'s layout).

  A leaf of a per-layer list (``blocks``, ``enc``, ``dec``) takes the spec
  of the reference's stacked leaf, ``spec_for(path, (L,) + shape)``,
  without its first (layer) entry; its path has no layer index, as the
  reference's has none.
  """
  def walk(tree, prefix, layers):
    out = {}
    for k, v in tree.items():
      p = f"{prefix}/{k}" if prefix else k
      if isinstance(v, dict):
        out[k] = walk(v, p, layers)
      elif isinstance(v, list):
        out[k] = [walk(layer, p, len(v)) for layer in v]
      elif layers:
        out[k] = spec_for(p, (layers,) + tuple(v.shape), cfg, par)[1:]
      else:
        out[k] = spec_for(p, tuple(v.shape), cfg, par)
    return out
  return walk(params, "", 0)
