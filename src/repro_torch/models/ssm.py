"""Mamba2 / SSD (state-space duality) blocks — arXiv:2405.21060.

Counterpart of ``repro/models/ssm.py``.  The SSD chunked scan's
intra-chunk term is a masked (+, ×) contraction Y = (L ∘ C Bᵀ) X with a
decay mask L = exp(segsum(dt·A)); ``ssd_chunked`` computes it with the
reference's einsums on ``impl="xla"`` and with the kernel K4
(``kernels.ops.ssd_intra_chunk``) on ``impl="pallas"``.  The chunk states,
the inter-chunk recurrence (a loop over the chunks) and the inter-chunk
output stay plain PyTorch on both arms.

Layout: x (B, S, D) → z, xin (d_inner), B, C (G·N), dt (H) → depthwise
causal conv on xin and on (B|C) → SSD over chunks → gated RMSNorm →
out_proj.  Decode (S == 1) is the single-step recurrence on the state
{'ssm': (B, H, N, P) f32, 'conv': (B, K−1, d_inner), 'bc_conv':
(B, K−1, 2GN)}.  Parameters are one layer's dict in the reference's
layout, cast to ``cfg.dtype`` at use.

On a mesh position (tensor parallelism, serving or training)
``in_proj_z``, ``in_proj_x`` and ``conv_w`` hold the position's slice of
the inner width (its H/tp heads), ``dt_proj``, ``A_log``, ``dt_bias``,
``ssd_skip_D`` and the norm scale are sliced to those heads, ``bc_proj``
stays whole (each position takes the groups its heads read), K4 runs on
the H/tp heads, the gated norm's mean square is the line's sum over the
whole inner width (``common.rms_norm_wide``, whose backward flows through
its meeting) and ``out_proj`` is row-parallel.  The block reads its head
count from ``in_proj_x``'s width.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import common as cm

Tensor = torch.Tensor
IMPLS = ("pallas", "xla")


def ssm_params(generator: torch.Generator, cfg: cm.ModelConfig) -> dict:
  """One layer's SSM weights in the reference's layout."""
  d, din = cfg.d_model, cfg.d_inner
  g, n, h = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_heads
  k, pd, dev = cfg.conv_kernel, cfg.param_dtype, cm.init_device(generator)

  def normal(shape, std):
    return (cm.randn(generator, shape) * std).to(pd)

  return {
      "in_proj_z": cm.dense_init(generator, (d, din), dtype=pd),
      "in_proj_x": cm.dense_init(generator, (d, din), dtype=pd),
      "bc_proj": cm.dense_init(generator, (d, 2 * g * n), dtype=pd),
      "dt_proj": cm.dense_init(generator, (d, h), dtype=pd),
      "conv_w": normal((k, din), 0.1),
      "bc_filter_w": normal((k, 2 * g * n), 0.1),
      "A_log": torch.zeros(h, dtype=pd, device=dev),       # A = −exp(A_log)
      "ssd_skip_D": torch.ones(h, dtype=pd, device=dev),
      "dt_bias": torch.full((h,), -4.6, dtype=pd, device=dev),  # softplus ≈ 0.01
      "ssd_norm_scale": torch.ones(din, dtype=pd, device=dev),
      "out_proj": cm.dense_init(generator, (din, d), dtype=pd),
  }


def _silu(x: Tensor) -> Tensor:
  """x · logistic(x) with the reference's roundings: jax.nn.silu on the CPU
  evaluates the logistic as 1 / (1 + exp(−x)) with each step rounded to
  x's dtype, then the product (a fused f32 sigmoid differs in a third of
  the bf16 results)."""
  return x * torch.reciprocal(1 + torch.exp(-x))


def _causal_conv(x: Tensor, w: Tensor, state: Optional[Tensor] = None):
  """Depthwise causal conv.  x: (B, S, C); w: (K, C).  Returns (y,
  new_state), the state holding the last K−1 inputs for decode.

  The K products are formed and summed in x's dtype, left to right, as the
  reference sums them (a conv1d would accumulate in f32 and round once).
  """
  k, s = w.shape[0], x.shape[1]
  if state is None:
    pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                      device=x.device)
  else:
    pad = state.to(x.dtype)
  xp = torch.cat([pad, x], dim=1)
  wd = w.to(x.dtype)
  y = xp[:, :s] * wd[0]
  for i in range(1, k):
    y = y + xp[:, i:i + s] * wd[i]
  new_state = xp[:, -(k - 1):].clone() if k > 1 else None
  return y, new_state


def _segsum(x: Tensor) -> Tensor:
  """Within-chunk segment sum: out[..., i, j] = Σ_{t ∈ (j, i]} x[..., t],
  −inf above the diagonal, so that exp(segsum) is the decay mask L."""
  q = x.shape[-1]
  cs = torch.cumsum(x, dim=-1)
  diff = cs[..., :, None] - cs[..., None, :]
  mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
  return torch.where(mask, diff, -torch.inf)


def _y_diag(cc: Tensor, bc: Tensor, xc: Tensor, dtc: Tensor, dac: Tensor,
            cum: Tensor, impl: str) -> Tensor:
  """The intra-chunk output (B, nc, Q, H, P) f32 of the chunked operands
  cc, bc (B, nc, Q, G, N), xc (B, nc, Q, H, P), dtc, dac, cum (B, nc, Q, H).

  'xla': the reference's einsums over the expanded (B, nc, H, Q, Q) decay
  mask.  'pallas': one K4 launch reading every operand in place (strided
  (z, head, q) views) and writing the (B, nc, Q, H, P) result directly; K4
  has no backward, so it refuses operands that need gradients.
  """
  bsz, nc, q, h, p = xc.shape
  g, n = bc.shape[3], bc.shape[4]
  if impl == "pallas":
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (cc, bc, xc, dtc, cum)):
      raise RuntimeError(
          "impl='pallas' has no backward: K4 (the SSD intra-chunk term) is "
          "a forward kernel, as the reference's Pallas arm is; train on "
          "impl='xla'")
    bz = bsz * nc
    y = torch.empty((bsz, nc, q, h, p), dtype=torch.float32, device=xc.device)
    ops.ssd_intra_chunk(
        cc.reshape(bz, q, g, n).transpose(1, 2),
        bc.reshape(bz, q, g, n).transpose(1, 2),
        xc.reshape(bz, q, h, p).transpose(1, 2),
        dtc.reshape(bz, q, h).transpose(1, 2),
        cum.reshape(bz, q, h).transpose(1, 2),
        out=y.view(bz, q, h, p).transpose(1, 2))
    return y
  seg = _segsum(dac.permute(0, 1, 3, 2))               # (B, nc, H, Q, Q)
  L = torch.exp(seg)
  scores = torch.einsum("bzqgn,bzkgn->bzgqk", cc, bc)  # (B, nc, G, Q, Q)
  scores = scores.repeat_interleave(h // g, dim=2) * L
  return torch.einsum("bzhqk,bzkh,bzkhp->bzqhp", scores, dtc, xc)


def ssd_chunked(xh: Tensor, dt: Tensor, a: Tensor, b: Tensor, c: Tensor,
                chunk: int, init_state: Optional[Tensor] = None, *,
                impl: str = "xla"):
  """SSD scan.  xh: (B, S, H, P); dt: (B, S, H); a: (H,) negative; b, c:
  (B, S, G, N).  Returns (y (B, S, H, P), final_state (B, H, N, P)), f32.

  ``impl`` picks the intra-chunk term's arm (``_y_diag``); everything else
  is the same plain PyTorch on both.
  """
  if impl not in IMPLS:
    raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
  bsz, s, h, p = xh.shape
  g, n = b.shape[2], b.shape[3]
  hg = h // g
  q = min(chunk, s)
  s_real = s
  if s % q:
    # pad the tail: dt = 0 ⇒ decay exp(0) = 1 and contribution dt·B·x = 0,
    # so the final state and all real rows are unaffected (tail rows are
    # cropped)
    pad = q * (-(-s // q)) - s
    xh = nn.functional.pad(xh, (0, 0, 0, 0, 0, pad))
    dt = nn.functional.pad(dt, (0, 0, 0, pad))
    b = nn.functional.pad(b, (0, 0, 0, 0, 0, pad))
    c = nn.functional.pad(c, (0, 0, 0, 0, 0, pad))
    s = s + pad
  nc = s // q

  f32 = torch.float32
  xh = xh.to(f32)
  dt = dt.to(f32)
  dA = dt * a.to(f32)[None, None, :]                   # (B, S, H) ≤ 0
  xc = xh.reshape(bsz, nc, q, h, p)
  dtc = dt.reshape(bsz, nc, q, h)
  dac = dA.reshape(bsz, nc, q, h)
  bc = b.to(f32).reshape(bsz, nc, q, g, n)
  cc = c.to(f32).reshape(bsz, nc, q, g, n)

  cum = torch.cumsum(dac, dim=2)                        # (B, nc, Q, H)
  total = cum[:, :, -1]                                 # (B, nc, H)
  y_diag = _y_diag(cc, bc, xc, dtc, dac, cum, impl)

  # chunk states: S_z = Σ_j exp(total − cum_j) dt_j B_j ⊗ x_j, per group
  decay_state = torch.exp(total[:, :, None, :] - cum)  # (B, nc, Q, H)
  xw = (xc * (decay_state * dtc)[..., None]).reshape(bsz, nc, q, g, hg, p)
  states = torch.einsum("bzqgn,bzqgjp->bzgjnp", bc, xw).reshape(
      bsz, nc, h, n, p)

  # inter-chunk recurrence: state_{z+1} = exp(total_z)·state_z + S_z
  chunk_decay = torch.exp(total)                        # (B, nc, H)
  st = (torch.zeros((bsz, h, n, p), dtype=f32, device=xh.device)
        if init_state is None else init_state.to(f32))
  prevs = []
  for zi in range(nc):
    prevs.append(st)
    st = st * chunk_decay[:, zi, :, None, None] + states[:, zi]
  prev_states = torch.stack(prevs, dim=1)               # (B, nc, H, N, P)

  # inter-chunk output: Y_off[i] = (C_i · state_prev) exp(cum_i)
  y_off = torch.einsum("bzqgn,bzgjnp->bzqgjp", cc,
                       prev_states.reshape(bsz, nc, g, hg, n, p))
  y_off = y_off.reshape(bsz, nc, q, h, p) * torch.exp(cum)[..., None]
  y = (y_diag + y_off).reshape(bsz, s, h, p)[:, :s_real]
  return y, st


def ssm_block(p: dict, cfg: cm.ModelConfig, x: Tensor, *, mode: str = "train",
              state: Optional[dict] = None, impl: str = "xla"):
  """One mamba2 block.  x: (B, S, D) in ``cfg.dtype``.  Returns (y,
  new_state or None); 'prefill' returns the state after the prompt,
  'decode' (S == 1) takes ``state`` and returns the next one."""
  dt_ = cfg.dtype
  x = cm.col_input(x)
  bsz, s, _ = x.shape
  g, n, pdim = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_headdim
  h = p["in_proj_x"].shape[-1] // pdim

  z = torch.matmul(x, p["in_proj_z"].to(dt_))
  xin = torch.matmul(x, p["in_proj_x"].to(dt_))
  bcat = torch.matmul(x, p["bc_proj"].to(dt_))
  dt = torch.matmul(x, p["dt_proj"].to(dt_))

  conv_state = state["conv"] if state is not None else None
  bc_state = state["bc_conv"] if state is not None else None
  xin, new_conv = _causal_conv(xin, p["conv_w"], conv_state)
  bcat, new_bc = _causal_conv(bcat, p["bc_filter_w"], bc_state)
  xin = _silu(xin)
  bcat = _silu(bcat)

  b_ssm = bcat[..., :g * n].reshape(bsz, s, g, n)
  c_ssm = bcat[..., g * n:].reshape(bsz, s, g, n)
  pos = cm.position()
  if pos is not None:  # the groups this position's heads read
    _, (g0, g1) = cm.head_range(cfg.ssm_heads, g, pos.rank, pos.size)
    b_ssm, c_ssm, g = b_ssm[:, :, g0:g1], c_ssm[:, :, g0:g1], g1 - g0
  dt = nn.functional.softplus(dt.float() + p["dt_bias"].float())
  a = -torch.exp(p["A_log"].float())
  xh = xin.reshape(bsz, s, h, pdim)

  if mode == "decode":
    # single-step recurrence (s == 1)
    st = state["ssm"].float()
    da = torch.exp(dt[:, 0] * a[None, :])               # (B, H)
    b1 = b_ssm[:, 0].float().repeat_interleave(h // g, dim=1)  # (B, H, N)
    c1 = c_ssm[:, 0].float().repeat_interleave(h // g, dim=1)
    upd = torch.einsum("bh,bhn,bhp->bhnp", dt[:, 0], b1, xh[:, 0].float())
    st = st * da[..., None, None] + upd
    y = torch.einsum("bhn,bhnp->bhp", c1, st)[:, None]  # (B, 1, H, P)
    new_state = {"ssm": st, "conv": new_conv, "bc_conv": new_bc}
  elif mode in ("train", "prefill"):
    y, final = ssd_chunked(xh, dt, a, b_ssm, c_ssm, cfg.ssm_chunk, impl=impl)
    new_state = ({"ssm": final, "conv": new_conv, "bc_conv": new_bc}
                 if mode == "prefill" else None)
  else:
    raise ValueError(f"mode must be 'train', 'prefill' or 'decode', got "
                     f"{mode!r}")

  y = y + p["ssd_skip_D"].float()[None, None, :, None] * xh.float()
  y = y.reshape(bsz, s, h * pdim).to(dt_)
  y = cm.rms_norm_wide(y * _silu(z), p["ssd_norm_scale"], cfg.norm_eps)
  return cm.row_parallel(y, p["out_proj"].to(dt_)), new_state


class SSMBlock(nn.Module):
  """One layer's SSM weights (``ssm_params``' layout) as a module."""

  def __init__(self, cfg: cm.ModelConfig, params: dict):
    super().__init__()
    self.cfg = cfg
    for name, t in params.items():
      self.register_parameter(name, nn.Parameter(t, requires_grad=False))

  def forward(self, x: Tensor, **kw):
    return ssm_block(dict(self.named_parameters(recurse=False)), self.cfg, x,
                     **kw)


class SSMLayer(nn.Module):
  """Pre-norm residual SSM layer: x + ssm_block(rms_norm(x))."""

  def __init__(self, cfg: cm.ModelConfig, params: dict):
    super().__init__()
    self.cfg = cfg
    self.ln_norm_scale = nn.Parameter(params["ln_norm_scale"],
                                      requires_grad=False)
    self.ssm = SSMBlock(cfg, params["ssm"])

  def forward(self, x: Tensor, **kw):
    h = cm.rms_norm(x, self.ln_norm_scale, self.cfg.norm_eps)
    y, state = self.ssm(h, **kw)
    return x + y, state


def init_ssm_state(cfg: cm.ModelConfig, n_layers: int, batch: int,
                   device=DEFAULT_DEVICE) -> dict:
  """Zeroed layer-stacked decode state: 'ssm' (L, B, H, N, P) f32, 'conv'
  (L, B, K−1, d_inner) and 'bc_conv' (L, B, K−1, 2GN) in ``cfg.dtype``."""
  dev = resolve_device(device)
  h, n, pdim = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim
  k = cfg.conv_kernel
  return {
      "ssm": torch.zeros((n_layers, batch, h, n, pdim), dtype=torch.float32,
                         device=dev),
      "conv": torch.zeros((n_layers, batch, k - 1, cfg.d_inner),
                          dtype=cfg.dtype, device=dev),
      "bc_conv": torch.zeros(
          (n_layers, batch, k - 1, 2 * cfg.ssm_ngroups * cfg.ssm_state),
          dtype=cfg.dtype, device=dev),
  }
