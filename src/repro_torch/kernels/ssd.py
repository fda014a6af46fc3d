"""K4, the Mamba2 SSD intra-chunk term: Y = ((C Bᵀ) ∘ L ∘ dtᵀ) X per chunk.

``ssd_intra_chunk`` is the wrapper of the hand-written CUDA kernel in
``csrc/ssd.cu``, which replaces the Pallas TPU kernel
``repro/kernels/ssd.py::ssd_intra_chunk`` (the source note there says what
bounds it and how its design answers that: C Bᵀ formed once per (z,
group, query tile) and shared by a block of the group's heads, both
products on the tensor cores as 3×TF32).  For every (batch·chunk z, head
h) and row q of a chunk of Q rows:

    Y[q] = Σ_{k ≤ q} (C_q · B_k) · exp(cum_q − cum_k) · dt_k · X[k]

c and b are (BZ, G, Q, N), x is (BZ, H, Q, P), dt and cum are (BZ, H, Q);
head h reads group h // (H / G), so G == H is the TPU kernel's call with
per-head C and B, and G < H never expands them.  The result is f32 whatever
the inputs' dtype.  The kernel takes any strides over (z, head, q) with a
unit stride on the last axis, so the model hands it views of its
(B, nc, Q, H, ·) layout, and ``out`` lets it write into one.

Beside it, ``ssd_intra_chunk_plain`` computes the same function in plain
PyTorch: the reference oracle's einsums, with ``torch.where`` for the mask.

The wrapper takes the plain version only for tensors on the CPU.  For a
CUDA tensor it launches the kernel or raises: there is no fallback.  The
library is built with ``nvcc`` at first use (``kernels/nvcc.py``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import nan_check, nvcc

Tensor = torch.Tensor

HEAD_DIMS = (8, 16, 32, 64, 128)
MAX_STATE = 256          # C^T and B^T tiles of N rows share a CTA's memory
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BQ = 64                 # query rows per CTA (csrc/ssd.cu)
_MAX_GRID = 2 ** 31 - 1

LIBRARY = nvcc.KernelLibrary(
    "ssd", "simd2_ssd_intra_chunk",
    [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_void_p, ctypes.c_void_p])
library_path = LIBRARY.path
build_log = LIBRARY.build_log
load = LIBRARY.load


def head_block(dtype: torch.dtype, p: int, bz: int, h: int, g: int,
               q: int) -> int:
  """How many heads of a group one CTA of the kernel takes for this call
  shape on the current card (the kernel sizes its grid by the card's
  resident CTAs)."""
  fn = LIBRARY.function("simd2_ssd_head_block", [ctypes.c_int] * 6)
  hb = fn(_DTYPE_CODES[dtype], p, bz, h, g, q)
  if hb <= 0:
    raise RuntimeError(f"no head block for {dtype} P={p} BZ={bz} H={h} G={g} "
                       f"Q={q}")
  return hb


def _check(c: Tensor, b: Tensor, x: Tensor, dt: Tensor, cum: Tensor) -> None:
  if c.ndim != 4 or b.ndim != 4 or x.ndim != 4 or dt.ndim != 3 or (
      cum.ndim != 3):
    raise ValueError(
        f"ssd_intra_chunk takes c, b (BZ, G, Q, N), x (BZ, H, Q, P) and dt, "
        f"cum (BZ, H, Q), got {tuple(c.shape)}, {tuple(b.shape)}, "
        f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(cum.shape)}")
  bz, h, q, _ = x.shape
  g = c.shape[1]
  if (c.shape != b.shape or c.shape[0] != bz or c.shape[2] != q
      or tuple(dt.shape) != (bz, h, q) or tuple(cum.shape) != (bz, h, q)):
    raise ValueError(
        f"shape mismatch: c {tuple(c.shape)}, b {tuple(b.shape)}, x "
        f"{tuple(x.shape)}, dt {tuple(dt.shape)}, cum {tuple(cum.shape)}")
  if g == 0 or h % g:
    raise ValueError(f"{h} heads do not group over {g} groups")
  dtypes = {t.dtype for t in (c, b, x, dt, cum)}
  if len(dtypes) != 1 or c.dtype not in _DTYPE_CODES:
    raise TypeError(f"ssd_intra_chunk takes f32 or bf16 inputs of one dtype, "
                    f"got {sorted(map(str, dtypes))}")
  if len({t.device for t in (c, b, x, dt, cum)}) != 1:
    raise ValueError("ssd_intra_chunk's inputs lie on different devices")


def ssd_intra_chunk(c: Tensor, b: Tensor, x: Tensor, dt: Tensor, cum: Tensor,
                    *, out: Optional[Tensor] = None) -> Tensor:
  """K4: the intra-chunk SSD output (BZ, H, Q, P) in f32.

  ``out``, when given, is an f32 (BZ, H, Q, P) tensor with a unit stride on
  P (a permuted view of a (BZ, Q, H, P) buffer, say) that receives the
  result and is returned.  CPU tensors run ``ssd_intra_chunk_plain``; CUDA
  tensors launch the kernel once on the current stream and add one to
  ``ssd_intra_chunk.launches``.
  """
  _check(c, b, x, dt, cum)
  bz, h, q, p = x.shape
  g, n = c.shape[1], c.shape[3]
  if out is not None and (tuple(out.shape) != (bz, h, q, p)
                          or out.dtype != torch.float32
                          or out.device != x.device):
    raise ValueError(f"out must be f32 {(bz, h, q, p)} on {x.device}, got "
                     f"{out.dtype} {tuple(out.shape)} on {out.device}")
  if x.device.type == "cpu":
    y = ssd_intra_chunk_plain(c, b, x, dt, cum)
    return nan_check.checked("ssd_intra_chunk", (c, b, x, dt, cum),
                             y if out is None else out.copy_(y))
  if x.device.type != "cuda":
    raise ValueError(f"ssd_intra_chunk runs on cuda or cpu, not {x.device}")
  if p not in HEAD_DIMS:
    raise ValueError(f"ssd_intra_chunk's kernel takes head dims {HEAD_DIMS}, "
                     f"got {p}")
  if not 0 < n <= MAX_STATE:
    raise ValueError(f"ssd_intra_chunk's kernel takes a state of 1 to "
                     f"{MAX_STATE}, got {n}")
  if out is None:
    out = torch.empty((bz, h, q, p), dtype=torch.float32, device=x.device)
  for name, t in (("c", c), ("b", b), ("x", x), ("out", out)):
    if t.stride(3) != 1 and t.shape[3] > 1:
      raise ValueError(f"ssd_intra_chunk's kernel takes {name} with a unit "
                       f"stride on its last axis, got strides {t.stride()}")
  nq = -(-q // _BQ)
  if bz * h * nq > _MAX_GRID:
    raise ValueError(f"too large for the kernel: BZ·H={bz * h}, Q={q}")
  if out.numel() == 0:
    return out
  strides = (ctypes.c_longlong * 18)(*[
      s for t in (c, b, x, dt, cum, out) for s in t.stride()[:3]])
  launch = load()
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = launch(_DTYPE_CODES[x.dtype], p, c.data_ptr(), b.data_ptr(),
                x.data_ptr(), dt.data_ptr(), cum.data_ptr(), out.data_ptr(),
                bz, h, g, q, n, ctypes.addressof(strides), stream)
  if rc != 0:
    raise RuntimeError(f"ssd_intra_chunk kernel launch failed for {x.dtype} "
                       f"BZ={bz} H={h} G={g} Q={q} N={n} P={p}: error code "
                       f"{rc}")
  ssd_intra_chunk.launches += 1
  return nan_check.checked("ssd_intra_chunk", (c, b, x, dt, cum), out)


ssd_intra_chunk.launches = 0


def ssd_intra_chunk_plain(c: Tensor, b: Tensor, x: Tensor, dt: Tensor,
                          cum: Tensor) -> Tensor:
  """The kernel's function in plain PyTorch, in f32.

  The reference oracle's steps (``ssd_intra_chunk_ref``): scores C Bᵀ per
  group, the decay exp(cum_q − cum_k) selected to 0 above the diagonal,
  the weights (scores · decay) · dt_k, then their product with X.  Heads
  are grouped as (G, H/G) over their group's scores instead of expanding C
  and B.
  """
  _check(c, b, x, dt, cum)
  bz, h, q, p = x.shape
  g = c.shape[1]
  f32 = torch.float32
  scores = torch.einsum("zgqn,zgkn->zgqk", c.to(f32), b.to(f32))
  cumf = cum.to(f32).reshape(bz, g, h // g, q)
  seg = cumf[..., :, None] - cumf[..., None, :]           # (z, g, j, q, k)
  mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
  decay = torch.where(mask, torch.exp(seg), 0.0)
  w = (scores[:, :, None] * decay
       * dt.to(f32).reshape(bz, g, h // g, 1, q))
  y = torch.einsum("zgjqk,zgjkp->zgjqp", w, x.to(f32).reshape(bz, g, h // g,
                                                               q, p))
  return y.reshape(bz, h, q, p)
