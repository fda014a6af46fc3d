"""GQA attention: the flash kernel K3 (``impl="pallas"``), the chunked
online-softmax path in plain PyTorch with a flash backward (``impl="xla"``)
or with autograd through the chunks (``impl="xla_autodiff"``), and the
KV-cache decode step with sliding-window masking; non-causal
self-attention and cross-attention over given keys and values for the
enc-dec family.

Counterpart of ``repro/models/attention.py``.  K3 has no backward, as the
reference's Pallas arm has none: a step that needs gradients through it
raises.  Layouts are the reference's: activations (B, S, D),
q (B, S, H, hd), k and v (B, S, KV, hd), a layer cache (B, Smax, KV, hd).
GQA runs in grouped (KV, G) form; expanded k and v are never materialised.
Decode attention and every projection are plain tensor code, as the
reference leaves them to XLA outside any kernel.

On a mesh position (``common.position()``, tensor parallelism in serving
or training) the weights are the position's: its H/tp query heads and the
kv heads they group over, K3 runs on those heads, and ``wo`` is
row-parallel
(``common.row_parallel``).  A decode step follows the cache's layout:
with ``seq_shard_decode`` each position holds Smax/tp cache rows of every
kv head, the new row goes to the position that owns ``cache_len % Smax``,
and each position's partial softmax (max, sum, weighted values) over its
rows for all query heads is merged by log-sum-exp in position order
(``_decode_rows``); without it the cache is whole on every position and
each attends its own heads.  Where the batch does not split over the data
lines (B = 1, the long-context cells), every line holds the whole batch
and, when the data lines divide the kv heads, only its group of them
(``cache_specs``' 2-D cut, ``kv_group``): the line attends that group's
query heads (merged over its positions' rows as above), and one meeting
of the column over the lines (``common.column_cat``) assembles all H
heads in line order before each position takes its own for ``wo``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import kernel_takes
from repro_torch.models import common as cm

Tensor = torch.Tensor
_NEG = -1e30
IMPLS = ("pallas", "xla", "xla_autodiff")

# kv chunk of the online-softmax prefill path (the reference's FLASH_CHUNK)
FLASH_CHUNK = 2048


def attn_params(generator: torch.Generator, cfg: cm.ModelConfig) -> dict:
  """One layer's attention weights in the reference's layout."""
  hd, h, kv, d = cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
  dev = cm.init_device(generator)
  p = {
      "wq": cm.dense_init(generator, (d, h, hd), in_axis=-3,
                          dtype=cfg.param_dtype),
      "wk": cm.dense_init(generator, (d, kv, hd), in_axis=-3,
                          dtype=cfg.param_dtype),
      "wv": cm.dense_init(generator, (d, kv, hd), in_axis=-3,
                          dtype=cfg.param_dtype),
      "wo": cm.dense_init(generator, (h, hd, d), in_axis=-2,
                          dtype=cfg.param_dtype),
  }
  if cfg.qkv_bias:
    p["bq"] = torch.zeros((h, hd), dtype=cfg.param_dtype, device=dev)
    p["bk"] = torch.zeros((kv, hd), dtype=cfg.param_dtype, device=dev)
    p["bv"] = torch.zeros((kv, hd), dtype=cfg.param_dtype, device=dev)
  if cfg.qk_norm:
    p["q_norm_scale"] = torch.ones((hd), dtype=cfg.param_dtype,
                                   device=dev)
    p["k_norm_scale"] = torch.ones((hd), dtype=cfg.param_dtype,
                                   device=dev)
  return p


def _proj(x: Tensor, w: Tensor) -> Tensor:
  """einsum("bsd,dhk->bshk") as one matmul."""
  d, h, k = w.shape
  return torch.matmul(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


def _project_q(p: dict, cfg: cm.ModelConfig, x: Tensor,
               positions: Tensor) -> Tensor:
  """x: (B, S, D) → q (B, S, H, hd), RoPE applied."""
  dt = cfg.dtype
  q = _proj(x, p["wq"].to(dt))
  if cfg.qkv_bias:
    q = q + p["bq"].to(dt)
  if cfg.qk_norm:
    q = cm.rms_norm(q, p["q_norm_scale"], cfg.norm_eps)
  return cm.rope(q, positions, cfg.rope_theta)


def _project_qkv(p: dict, cfg: cm.ModelConfig, x: Tensor, positions: Tensor):
  """x: (B, S, D) → q (B, S, H, hd), k and v (B, S, KV, hd), RoPE applied."""
  dt = cfg.dtype
  k = _proj(x, p["wk"].to(dt))
  v = _proj(x, p["wv"].to(dt))
  if cfg.qkv_bias:
    k = k + p["bk"].to(dt)
    v = v + p["bv"].to(dt)
  if cfg.qk_norm:
    k = cm.rms_norm(k, p["k_norm_scale"], cfg.norm_eps)
  k = cm.rope(k, positions, cfg.rope_theta)
  return _project_q(p, cfg, x, positions), k, v


def _chunk_mask(c_idx: int, ck: int, skv: int, qpos: Tensor, causal: bool,
                window: Optional[int]) -> Tensor:
  kpos = (c_idx * ck + torch.arange(ck, device=qpos.device))[None, :]
  mask = kpos < skv
  if causal:
    mask = mask & (kpos <= qpos)
  if window is not None:
    mask = mask & (kpos > qpos - window)
  return mask


def _kv_chunks(k: Tensor, v: Tensor, chunk: int):
  """k, v (B, Skv, KV, hd) → zero-padded (nck, B, KV, ck, hd) chunks."""
  b, skv, kvh, hd = k.shape
  ck = min(chunk, skv)
  nck = -(-skv // ck)
  pad = nck * ck - skv
  kp = nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
  vp = nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
  ks = kp.reshape(b, nck, ck, kvh, hd).permute(1, 0, 3, 2, 4)
  vs = vp.reshape(b, nck, ck, kvh, hd).permute(1, 0, 3, 2, 4)
  return ks, vs, ck, nck


def _flash_fwd_impl(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                    window: Optional[int], scale: float, q_offset: int,
                    chunk: int):
  """Online-softmax forward over kv chunks, q pre-scaled in f32.  Returns
  (out (B, S, H, hd) in q's dtype, lse (B, KV, G, Sq))."""
  b, sq, h, hd = q.shape
  skv, kvh = k.shape[1], k.shape[2]
  g = h // kvh
  qg = q.reshape(b, sq, kvh, g, hd).permute(0, 2, 3, 1, 4).float() * scale
  ks, vs, ck, nck = _kv_chunks(k, v, chunk)
  qpos = (q_offset + torch.arange(sq, device=q.device))[:, None]
  m = torch.full((b, kvh, g, sq), _NEG, device=q.device)
  l = torch.zeros((b, kvh, g, sq), device=q.device)
  acc = torch.zeros((b, kvh, g, sq, hd), device=q.device)
  for c_idx in range(nck):
    s = torch.einsum("bkgqd,bkcd->bkgqc", qg, ks[c_idx].float())
    mask = _chunk_mask(c_idx, ck, skv, qpos, causal, window)
    s = torch.where(mask, s, _NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    pexp = torch.exp(s - m_new[..., None])
    l = l * alpha + pexp.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum(
        "bkgqc,bkcd->bkgqd", pexp, vs[c_idx].float())
    m = m_new
  lsafe = torch.where(l == 0.0, 1.0, l)
  out = acc / lsafe[..., None]
  out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)
  return out, m + torch.log(lsafe)


class _FlashXla(torch.autograd.Function):
  """The reference's ``_flash_xla`` custom VJP: the forward keeps only (q, k,
  v, out, lse), and the backward recomputes each kv chunk's probabilities
  from them in f32 (``_flash_xla_bwd``) instead of keeping every chunk's
  probabilities alive from the forward."""

  @staticmethod
  def forward(ctx, q, k, v, causal, window, scale, q_offset, chunk):
    out, lse = _flash_fwd_impl(q, k, v, causal, window, scale, q_offset,
                               chunk)
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.cfg = (causal, window, scale, q_offset, chunk)
    return out

  @staticmethod
  def backward(ctx, dout):
    q, k, v, out, lse = ctx.saved_tensors
    causal, window, scale, q_offset, chunk = ctx.cfg
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh

    def grouped(t):  # (B, S, H, hd) → (B, KV, G, S, hd) f32
      return t.reshape(b, sq, kvh, g, hd).permute(0, 2, 3, 1, 4).float()

    qg, og, dg = grouped(q), grouped(out), grouped(dout)
    delta = torch.sum(og * dg, dim=-1)                   # (B, KV, G, Sq)
    ks, vs, ck, nck = _kv_chunks(k, v, chunk)
    qpos = (q_offset + torch.arange(sq, device=q.device))[:, None]
    dq = torch.zeros((b, kvh, g, sq, hd), device=q.device)
    dks, dvs = [], []
    for c_idx in range(nck):
      kc, vc = ks[c_idx].float(), vs[c_idx].float()
      s = torch.einsum("bkgqd,bkcd->bkgqc", qg * scale, kc)
      mask = _chunk_mask(c_idx, ck, skv, qpos, causal, window)
      p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
      dvs.append(torch.einsum("bkgqc,bkgqd->bkcd", p, dg))
      dp = torch.einsum("bkgqd,bkcd->bkgqc", dg, vc)
      ds = p * (dp - delta[..., None]) * scale          # dL/ds · scale chain
      dq = dq + torch.einsum("bkgqc,bkcd->bkgqd", ds, kc)
      dks.append(torch.einsum("bkgqc,bkgqd->bkcd", ds, qg))
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)
    # (nck, B, KV, ck, hd) → (B, Skv padded, KV, hd) → crop
    dk = torch.stack(dks).permute(1, 0, 3, 2, 4).reshape(b, nck * ck, kvh, hd)
    dv = torch.stack(dvs).permute(1, 0, 3, 2, 4).reshape(b, nck * ck, kvh, hd)
    return (dq, dk[:, :skv].to(k.dtype), dv[:, :skv].to(v.dtype),
            None, None, None, None, None)


def _needs_grad(*tensors) -> bool:
  return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_xla(q: Tensor, k: Tensor, v: Tensor, causal: bool,
              window: Optional[int], scale: float, q_offset: int = 0,
              chunk: int = FLASH_CHUNK) -> Tensor:
  """The chunked online-softmax attention with the flash backward; without
  gradients it is the forward alone."""
  if not _needs_grad(q, k, v):
    return _flash_fwd_impl(q, k, v, causal, window, scale, q_offset,
                           chunk)[0]
  return _FlashXla.apply(q, k, v, causal, window, scale, q_offset, chunk)


def _full_decode(q: Tensor, k: Tensor, v: Tensor, *, scale: float,
                 kv_len: Tensor, window: Optional[int]) -> Tensor:
  """One-step attention against a (possibly partly filled) cache.

  q: (B, 1, H, hd); k, v: (B, Smax, KV, hd); kv_len: valid prefix length,
  (B,) or ().  As the reference: q is scaled in f32 and rounded to the
  cache's dtype; both products take cache-dtype operands with f32
  accumulation (an f32 matmul of the upcast operands, not a bf16 product
  rounded to bf16); the probabilities are rounded to the cache's dtype
  before the PV product.
  """
  b, _, h, hd = q.shape
  s, _ = _decode_scores(q, k, scale=scale, row0=0, kv_len=kv_len,
                        window=window)
  p = torch.softmax(s, dim=-1)
  out = torch.einsum("bkgs,bskd->bkgd", p.to(k.dtype).float(), v.float())
  return out.reshape(b, 1, h, hd).to(q.dtype)


def _decode_scores(q: Tensor, k: Tensor, *, scale: float, row0: int,
                   kv_len: Tensor, window: Optional[int]):
  """(scores (B, KV, G, rows) f32 with masked rows at ``_NEG``, mask (B,
  rows)) of one decode step's q (B, 1, H, hd) against cache rows [row0,
  row0 + rows) of k (B, rows, KV, hd): q scaled in f32 and rounded to the
  cache's dtype, the product in f32, rows at or past ``kv_len`` (B,) or
  () masked, and with ``window`` rows older than it too."""
  b, _, h, hd = q.shape
  rows, kvh = k.shape[1], k.shape[2]
  qb = (q.reshape(b, kvh, h // kvh, hd).float() * scale).to(k.dtype)
  kv_len = torch.as_tensor(kv_len, device=q.device)
  if kv_len.ndim == 0:
    kv_len = kv_len.expand(b)
  s = torch.einsum("bkgd,bskd->bkgs", qb.float(), k.float())
  kpos = row0 + torch.arange(rows, device=q.device)[None, :]
  mask = kpos < kv_len[:, None]
  if window is not None:
    mask = mask & (kpos > kv_len[:, None] - 1 - window)
  return torch.where(mask[:, None, None], s, _NEG), mask


def init_cache(cfg: cm.ModelConfig, n_layers: int, batch: int, max_len: int,
               device=DEFAULT_DEVICE) -> dict:
  """Zeroed layer-stacked cache in ``cfg.dtype``: k, v (L, B, max_len, KV,
  hd), len 0."""
  device = resolve_device(device)
  dtype = cfg.dtype
  kv, hd = cfg.n_kv_heads, cfg.hd
  shape = (n_layers, batch, max_len, kv, hd)
  return {
      "k": torch.zeros(shape, dtype=dtype, device=device),
      "v": torch.zeros(shape, dtype=dtype, device=device),
      "len": torch.zeros((), dtype=torch.int32, device=device),
  }


def _check_override(k: Tensor, v: Tensor) -> None:
  """K3 reads cross-attention K/V, slices of the stacked (L, B, Skv, KV,
  hd) projections, as they are: a layout the kernel does not take is an
  error, not a silent copy."""
  for name, t in (("k", k), ("v", v)):
    if t.device.type == "cuda" and not kernel_takes(t.transpose(1, 2)):
      raise ValueError(
          f"kv_override {name} (strides {t.stride()}) is not a layout K3 "
          f"reads: a unit stride on hd and, in bf16, 16-byte aligned rows")


def attention(p: dict, cfg: cm.ModelConfig, x: Tensor, positions: Tensor, *,
              mode: str = "train", layer_cache: Optional[dict] = None,
              cache_len: Optional[Tensor] = None, impl: str = "xla",
              causal: bool = True, kv_override: Optional[tuple] = None):
  """One attention block with RoPE; returns (out (B, S, D), cache entry or
  None).

  mode:
    'train'   — full sequence, no cache; returns (out, None)
    'prefill' — full sequence; returns (out, {'k', 'v'}) to seed the cache
    'decode'  — x is (B, 1, D); ``layer_cache`` holds {'k', 'v'}
                (B, Smax, KV, hd) and ``cache_len`` the filled length.  The
                new row is written in place at ``cache_len % Smax`` (a ring
                buffer once the cache is full; the reference selects into a
                donated buffer instead), and the updated cache is returned.
  impl ('train' and 'prefill'): 'pallas' runs K3 through
  ``kernels.ops.flash_attention`` and refuses a step that needs gradients
  (K3 has no backward); 'xla' the chunked plain-PyTorch path with the flash
  backward; 'xla_autodiff' the same forward with autograd through its
  chunks (the reference's baseline arm).

  ``causal=False`` lets every query see every key (the encoder).
  ``kv_override=(k, v)``, each (B, Skv, KV, hd), is cross-attention: the
  keys and values are the given ones (the encoder's, with no RoPE), the
  attention is non-causal, and q keeps its RoPE at ``positions``.  In
  'decode' it attends all Skv rows and returns ``layer_cache`` untouched.
  The reference projects k and v from x before overriding them; that work
  changes no value and is skipped here.
  """
  scale = cfg.hd ** -0.5
  window = cfg.window
  wo = p["wo"].to(cfg.dtype)
  x = cm.col_input(x)

  if mode in ("train", "prefill"):
    if impl not in IMPLS:
      raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if kv_override is None:
      q, k, v = _project_qkv(p, cfg, x, positions)
    else:
      q = _project_q(p, cfg, x, positions)
      k, v = kv_override
      causal = False
    if impl == "pallas":
      if _needs_grad(q, k, v):
        raise RuntimeError(
            "impl='pallas' has no backward: K3 (flash attention) is a "
            "forward kernel, as the reference's Pallas arm is; train on "
            "impl='xla'")
      if kv_override is not None:
        _check_override(k, v)
      # K3 reads the (B, S, H, hd) projections through transposed views and
      # writes into a (B, S, H, hd) buffer: no copies on either side
      out = torch.empty_like(q)
      ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, window=window,
                          scale=scale, out=out.transpose(1, 2))
    elif impl == "xla_autodiff":
      out, _ = _flash_fwd_impl(q, k, v, causal, window, scale, 0,
                               FLASH_CHUNK)
    else:
      out = flash_xla(q, k, v, causal, window, scale, 0, FLASH_CHUNK)
    y = cm.row_parallel(out.flatten(-2), wo.flatten(0, 1))
    return y, ({"k": k, "v": v} if mode == "prefill" else None)

  if mode == "decode" and kv_override is not None:
    ko, vo = kv_override
    out = _full_decode(_project_q(p, cfg, x, positions), ko, vo, scale=scale,
                       kv_len=ko.shape[1], window=None)
    return cm.row_parallel(out.flatten(-2), wo.flatten(0, 1)), layer_cache

  if mode == "decode" and cm.position() is not None:
    out = _decode_on_position(p, cfg, x, positions, layer_cache, cache_len)
    y = cm.row_parallel(out.flatten(-2), wo.flatten(0, 1))
    return y, layer_cache

  if mode == "decode":
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    k_cache, v_cache = layer_cache["k"], layer_cache["v"]
    smax = k_cache.shape[1]
    write_idx = (cache_len % smax).reshape(1).long()
    k_cache.index_copy_(1, write_idx, k_new.to(k_cache.dtype))
    v_cache.index_copy_(1, write_idx, v_new.to(v_cache.dtype))
    kv_len = torch.clamp(cache_len + 1, max=smax)
    # extra window masking only when the cache is larger than the window
    eff_window = window if (window is not None and window < smax) else None
    out = _full_decode(q, k_cache, v_cache, scale=scale, kv_len=kv_len,
                       window=eff_window)
    y = cm.row_parallel(out.flatten(-2), wo.flatten(0, 1))
    return y, {"k": k_cache, "v": v_cache}

  raise ValueError(f"mode must be 'train', 'prefill' or 'decode', got "
                   f"{mode!r}")


def _decode_rows(q: Tensor, k: Tensor, v: Tensor, *, scale: float,
                 row0: int, kv_len: Tensor, window: Optional[int]):
  """The softmax over cache rows [row0, row0 + rows) of a longer cache,
  unnormalised: (max m, sum l (B, KV, G), weighted values acc (B, KV, G,
  hd)), all f32, for ``_merge_rows``.  The scores are ``_full_decode``'s
  (``_decode_scores``); the weights rounded to the cache's dtype before
  the PV product are the local exp(s − m), since the normalisation waits
  for the merge (``_full_decode`` rounds the normalised ones: in bf16 the
  two differ by that rounding)."""
  s, mask = _decode_scores(q, k, scale=scale, row0=row0, kv_len=kv_len,
                           window=window)
  m = s.amax(dim=-1)
  e = torch.where(mask[:, None, None], torch.exp(s - m[..., None]), 0.0)
  acc = torch.einsum("bkgs,bskd->bkgd", e.to(k.dtype).float(), v.float())
  return m, e.sum(dim=-1), acc


def _merge_rows(parts, device) -> Tensor:
  """The positions' ``_decode_rows`` partials merged by log-sum-exp in
  position order: (B, KV, G, hd) f32."""
  parts = [[t.to(device) for t in part] for part in parts]
  m = parts[0][0]
  for part in parts[1:]:
    m = torch.maximum(m, part[0])
  l = acc = None
  for pm, pl, pacc in parts:
    w = torch.exp(pm - m)
    l = pl * w if l is None else l + pl * w
    acc = pacc * w[..., None] if acc is None else acc + pacc * w[..., None]
  return acc / l[..., None]


def kv_group(cfg: cm.ModelConfig, held: int):
  """(k0, k1): the kv heads a mesh position's cache holds when it holds
  ``held`` of them: all, or under the 2-D cut (a batch that does not
  split over the data lines, ``launch/specs.cache_specs``) its data
  line's group."""
  pos = cm.position()
  if held == cfg.n_kv_heads:
    return 0, held
  return pos.line * held, (pos.line + 1) * held


def _decode_on_position(p: dict, cfg: cm.ModelConfig, x: Tensor,
                        positions: Tensor, layer_cache: dict,
                        cache_len: Tensor) -> Tensor:
  """A decode step's attention output (B, 1, H/tp, hd) for this mesh
  position's query heads; the new k/v row (the kv heads the cache holds,
  gathered from the positions) is written into ``layer_cache`` in place.
  Where the cache holds only the data line's group of kv heads, the line
  attends that group's query heads and the column of positions over the
  lines assembles all H heads in line order (one meeting) before each
  position takes its own."""
  pos = cm.position()
  h, kvh = cfg.n_heads, cfg.n_kv_heads
  (q0, q1), (k0, k1) = cm.head_range(h, kvh, pos.rank, pos.size)
  q, k_new, v_new = _project_qkv(p, cfg, x, positions)
  q_all, k_new, v_new = cm.gather_heads((q, k_new, v_new), h, kvh, 2,
                                        kv=(False, True, True))
  k_cache, v_cache = layer_cache["k"], layer_cache["v"]
  rows = k_cache.shape[1]
  c0, c1 = kv_group(cfg, k_cache.shape[2])
  grouped = c1 - c0 < kvh
  if grouped:
    grp = h // kvh
    q_all = q_all[:, :, c0 * grp:c1 * grp]
    k_new, v_new = k_new[:, :, c0:c1], v_new[:, :, c0:c1]
  scale = cfg.hd ** -0.5
  b, hd = q.shape[0], q.shape[-1]
  if not pos.seq_shard_decode:
    write_idx = (cache_len % rows).reshape(1).long()
    k_cache.index_copy_(1, write_idx, k_new.to(k_cache.dtype))
    v_cache.index_copy_(1, write_idx, v_new.to(v_cache.dtype))
    kv_len = torch.clamp(cache_len + 1, max=rows)
    window = (cfg.window if cfg.window is not None and cfg.window < rows
              else None)
    if not grouped:
      return _full_decode(q, k_cache[:, :, k0:k1], v_cache[:, :, k0:k1],
                          scale=scale, kv_len=kv_len, window=window)
    out = cm.column_cat(_full_decode(q_all, k_cache, v_cache, scale=scale,
                                     kv_len=kv_len, window=window), 2)
    return out[:, :, q0:q1]
  smax, row0 = rows * pos.size, rows * pos.rank
  local = (cache_len % smax - row0).reshape(1).long()
  mine = (local >= 0) & (local < rows)
  at = local.clamp(0, rows - 1)
  for cache, new in ((k_cache, k_new), (v_cache, v_new)):
    old = cache.index_select(1, at)
    cache.index_copy_(1, at, torch.where(mine, new.to(cache.dtype), old))
  kv_len = torch.clamp(cache_len + 1, max=smax).expand(b)
  window = cfg.window if cfg.window is not None and cfg.window < smax else None
  part = _decode_rows(q_all, k_cache, v_cache, scale=scale, row0=row0,
                      kv_len=kv_len, window=window)
  out = pos.group.meet(pos.rank, part,
                       lambda parts: _merge_rows(parts, q.device),
                       term="decode_attn_all_reduce", kind="all-reduce")
  if grouped:
    out = cm.column_cat(out, 1)
  out = out.reshape(b, 1, h, hd)[:, :, q0:q1]
  return out.to(q.dtype)


class Attention(nn.Module):
  """One layer's attention weights (``wq``, ``wk``, ``wv``, ``wo`` and the
  optional biases and q/k norm scales, in the reference's layout)."""

  def __init__(self, cfg: cm.ModelConfig, params: dict):
    super().__init__()
    self.cfg = cfg
    for name, t in params.items():
      self.register_parameter(name, nn.Parameter(t, requires_grad=False))

  def forward(self, x: Tensor, positions: Tensor, **kw):
    return attention(dict(self.named_parameters(recurse=False)), self.cfg, x,
                     positions, **kw)
