"""K3, flash attention (forward): online-softmax attention for the LM prefill.

``flash_attention`` is the wrapper of the hand-written CUDA kernel in
``csrc/flash_attention.cu``, which replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` (the source note there
says what bounds it and how its design answers that).  q is (B, H, Sq, D),
k and v are (B, Hkv, Skv, D) with H a multiple of Hkv; query head h reads KV
head h // (H / Hkv).  Query rows sit at the end of the kv axis; causal and
sliding-window masks apply; masked scores take the finite sentinel -1e30.

The kernel has two instances: bf16 runs both products on the tensor cores
(wgmma, f32 accumulation, P rounded to bf16 for P V), f32 runs f32 FMA on
the CUDA cores.

Beside it, ``flash_attention_plain`` computes the same function in plain
PyTorch, walking the kv blocks with the same block skip, the same sentinel
and the same tile sizes as the kernel, so the two agree even on the rows
that see no key (see the source note); P stays f32 there, so the bf16
instance differs from it by P's rounding (within the bf16 tolerance).

q, k and v may be any (B, H, S, D) views with a unit stride on D (the model
passes transposed views of its (B, S, H, D) buffers), and ``out=`` takes
such a view to write into.

The wrapper takes the plain version only for tensors on the CPU.  For a CUDA
tensor it launches the kernel or raises: there is no fallback.  The library
is built with ``nvcc`` at first use (``kernels/nvcc.py``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import nan_check, nvcc

Tensor = torch.Tensor

# Query and kv tile compiled into the kernel.  The TPU kernel's default is
# 128 x 128; the tile matters only to rows that see no key in a block that is
# not skipped (they get the mean of V over that block), which prefill, with
# Sq == Skv, never has.
TILE = (64, 64)
HEAD_DIMS = (16, 32, 64, 80, 112, 128)
_NEG = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID = 2 ** 31 - 1

LIBRARY = nvcc.KernelLibrary(
    "flash_attention", "simd2_flash_attention",
    [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
library_path = LIBRARY.path
build_log = LIBRARY.build_log
load = LIBRARY.load


def _check(q: Tensor, k: Tensor, v: Tensor) -> None:
  if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
    raise ValueError(f"flash_attention takes (B, H, Sq, D) and (B, Hkv, Skv, "
                     f"D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                     f"{tuple(v.shape)}")
  b, h, _, d = q.shape
  if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
    raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                     f"{tuple(k.shape)}, v {tuple(v.shape)}")
  hkv = k.shape[1]
  if hkv == 0 or h % hkv:
    raise ValueError(f"{h} query heads do not group over {hkv} kv heads")
  if k.shape[2] == 0:
    raise ValueError("flash_attention needs at least one key")
  if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
    raise TypeError(f"flash_attention takes f32 or bf16 q, k, v of one dtype, "
                    f"got {q.dtype}, {k.dtype}, {v.dtype}")
  if k.device != q.device or v.device != q.device:
    raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")


def kernel_takes(t: Tensor) -> bool:
  """Whether the kernel reads (or writes) ``t`` as it is: a unit stride on
  D, and for bf16 (whose tiles move by TMA) 16-byte aligned rows with
  positive strides."""
  if t.stride(-1) != 1 and t.shape[-1] > 1:
    return False
  if t.dtype != torch.bfloat16:
    return True
  return t.data_ptr() % 16 == 0 and all(
      (s % 8 == 0 and s > 0) or n == 1
      for s, n in zip(t.stride()[:3], t.shape[:3]))


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None,
                    out: Optional[Tensor] = None) -> Tensor:
  """K3: softmax(scale · q kᵀ, masked) v, per query head, out in q's dtype.

  ``out``, when given, is a (B, H, Sq, D) tensor of q's dtype with a unit
  stride on D (a transposed view of a (B, Sq, H, D) buffer, say) that
  receives the result and is returned.  CPU tensors run
  ``flash_attention_plain``; CUDA tensors launch the kernel once on the
  current stream and add one to ``flash_attention.launches``.
  """
  _check(q, k, v)
  if out is not None and (out.shape != q.shape or out.dtype != q.dtype
                          or out.device != q.device):
    raise ValueError(f"out must be {q.dtype} {tuple(q.shape)} on {q.device}, "
                     f"got {out.dtype} {tuple(out.shape)} on {out.device}")
  scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
  if q.device.type == "cpu":
    y = flash_attention_plain(q, k, v, causal=causal, window=window,
                              scale=scale)
    return nan_check.checked("flash_attention", (q, k, v),
                             y if out is None else out.copy_(y))
  if q.device.type != "cuda":
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
  b, h, sq, d = q.shape
  hkv, skv = k.shape[1], k.shape[2]
  if d not in HEAD_DIMS:
    raise ValueError(f"flash_attention's kernel takes head dims {HEAD_DIMS}, "
                     f"got {d}")
  nq = -(-sq // TILE[0])
  if b * h * nq > _MAX_GRID or max(sq, skv) >= 2 ** 30:
    raise ValueError(f"too large for the kernel: B·H={b * h}, Sq={sq}, "
                     f"Skv={skv}")
  if out is None:
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
  for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
    if not kernel_takes(t):
      raise ValueError(f"flash_attention's kernel takes {name} with a unit "
                       f"stride on its last axis (bf16: 16-byte aligned "
                       f"rows), got strides {t.stride()}")
  if out.numel() == 0:
    return out
  # a window past every distance is no window; clamping keeps int32 exact
  win = 0 if window is None else min(int(window), sq + skv + 1)
  strides = (ctypes.c_longlong * 12)(*[
      s for t in (q, k, v, out) for s in t.stride()[:3]])
  launch = load()
  with torch.cuda.device(q.device):
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = launch(_DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), b, h, hkv, sq, skv, int(causal),
                int(window is not None), win, scale,
                ctypes.addressof(strides), stream)
  if rc != 0:
    raise RuntimeError(f"flash_attention kernel launch failed for {q.dtype} "
                       f"B={b} H={h} Hkv={hkv} Sq={sq} Skv={skv} D={d}: error "
                       f"code {rc}")
  flash_attention.launches += 1
  return nan_check.checked("flash_attention", (q, k, v), out)


flash_attention.launches = 0


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, *,
                          causal: bool = True, window: Optional[int] = None,
                          scale: Optional[float] = None) -> Tensor:
  """The kernel's function in plain PyTorch, block by block.

  Mirrors the kernel step for step: query blocks of min(64, Sq) rows and
  kv blocks of min(64, Skv) keys (``TILE``) over zero-padded k and v; a kv
  block updates a query block's rows only if the pair is reachable; masked
  scores are -1e30; q and k widen to f32, the scale multiplies the dot, P stays f32,
  and l == 0 divides as 1.  GQA groups query heads over their kv head
  instead of expanding k and v.
  """
  _check(q, k, v)
  b, h, sq, d = q.shape
  hkv, skv = k.shape[1], k.shape[2]
  grp = h // hkv
  scale = d ** -0.5 if scale is None else float(scale)
  bq_, bkv_ = min(TILE[0], sq), min(TILE[1], skv)
  if sq == 0:
    return torch.empty_like(q)
  sq_p = -(-sq // bq_) * bq_
  skv_p = -(-skv // bkv_) * bkv_
  dev = q.device
  qf = torch.nn.functional.pad(q.float(), (0, 0, 0, sq_p - sq))
  qf = qf.reshape(b, hkv, grp, sq_p, d)
  kf = torch.nn.functional.pad(k.float(), (0, 0, 0, skv_p - skv))
  vf = torch.nn.functional.pad(v.float(), (0, 0, 0, skv_p - skv))
  qpos = torch.arange(sq_p, device=dev) + (skv - sq)
  q_start = torch.arange(sq_p, device=dev) // bq_ * bq_ + (skv - sq)
  m = torch.full((b, hkv, grp, sq_p), _NEG, device=dev)
  l = torch.zeros((b, hkv, grp, sq_p), device=dev)
  acc = torch.zeros((b, hkv, grp, sq_p, d), device=dev)
  for j in range(skv_p // bkv_):
    k_start = j * bkv_
    run = torch.ones(sq_p, dtype=torch.bool, device=dev)
    if causal:
      run &= k_start <= q_start + bq_ - 1
    if window is not None:
      run &= k_start + bkv_ - 1 > q_start - window
    if not bool(run.any()):
      continue
    kc = kf[:, :, k_start:k_start + bkv_]
    vc = vf[:, :, k_start:k_start + bkv_]
    s = torch.einsum("bkgqd,bkcd->bkgqc", qf, kc) * scale
    kpos = k_start + torch.arange(bkv_, device=dev)[None, :]
    mask = (kpos < skv).expand(sq_p, bkv_)
    if causal:
      mask = mask & (kpos <= qpos[:, None])
    if window is not None:
      mask = mask & (kpos > qpos[:, None] - window)
    s = torch.where(mask, s, _NEG)
    m_cur = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_cur)
    p = torch.exp(s - m_cur[..., None])
    l_cur = alpha * l + p.sum(dim=-1)
    acc_cur = acc * alpha[..., None] + torch.einsum("bkgqc,bkcd->bkgqd", p, vc)
    m = torch.where(run, m_cur, m)
    l = torch.where(run, l_cur, l)
    acc = torch.where(run[:, None], acc_cur, acc)
  l = torch.where(l == 0.0, 1.0, l)
  out = (acc / l[..., None]).to(q.dtype)
  return out.reshape(b, h, sq_p, d)[:, :, :sq].contiguous()
