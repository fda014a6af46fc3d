"""K1, the SIMD² unit: D = C ⊕ (A ⊗ B) over a stack of requests.

``semiring_mmo`` is the wrapper of the hand-written CUDA kernel in
``csrc/semiring_mmo.cu`` (which replaces the Pallas TPU kernel
``repro/kernels/semiring_mmo.py::semiring_mmo``; the source note there says
what bounds it and how its design answers that).  Beside it,
``semiring_mmo_plain`` computes the same function in plain PyTorch: blocked
broadcast-⊗ plus ⊕-reduce, like ``core.mmo._contract_vector``.

The wrapper takes the plain version only for tensors on the CPU.  For a CUDA
tensor it launches the kernel or raises: there is no fallback.  The library
is built with ``nvcc`` at first use into ``build/kernels/`` under the
checkout (one shared library with a plain C interface, loaded with ctypes)
and cached there by the sources' content hash (``kernels/nvcc.py``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.core import semiring as sr_mod
from repro_torch.kernels import nvcc

Tensor = torch.Tensor

# The smallest output tile (BM, BN) and the K slab (BK) of the CUDA-core
# instances; mma's tensor-core instance takes 128×128 tiles and 32-deep slabs.
# tile_shape() says which tile a launch takes.
TILE = (64, 64, 16)
_MAX_GRID_YZ = 65535
# Elements of the plain version's (R, M, bk, N) intermediate per K block.
_PLAIN_BLOCK_ELEMS = 1 << 26

OP_CODES = {op: i for i, op in enumerate(sr_mod.ALL_OPS)}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}

LIBRARY = nvcc.KernelLibrary(
    "semiring_mmo", "simd2_semiring_mmo",
    [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
    + [ctypes.c_void_p])
SOURCE = LIBRARY.source
library_path = LIBRARY.path
build_library = LIBRARY.build
build_log = LIBRARY.build_log
load = LIBRARY.load


def _workspace(r: int, m: int, k: int, n: int,
               device: torch.device) -> Tensor:
  """mma's workspace (A's and B's split TF32 parts, B transposed), sized by
  the library."""
  nbytes = LIBRARY.function("simd2_semiring_mmo_workspace",
                            [ctypes.c_int] * 5, ctypes.c_longlong)(
                                OP_CODES["mma"], r, m, k, n)
  return torch.empty(nbytes, dtype=torch.uint8, device=device)


def tile_shape(op: str, dtype: torch.dtype, r: int, m: int, n: int) -> tuple:
  """(rows, columns) of the output tile a launch at R × M × N takes on the
  current card: 128×128 on the tensor cores for mma; 128×128 for the other
  rings where those tiles cover at least two waves of the card's resident
  CTAs, else 64×64."""
  sr = sr_mod.get(op)
  code = _DTYPE_CODES[torch.uint8 if dtype == torch.bool else dtype]
  tile = (ctypes.c_int * 2)()
  fn = LIBRARY.function("simd2_semiring_mmo_tile",
                        [ctypes.c_int] * 5 + [ctypes.c_void_p])
  rc = fn(OP_CODES[sr.name], code, r, m, n, ctypes.addressof(tile))
  if rc != 0:
    raise RuntimeError(f"semiring_mmo tile query failed for {sr.name} "
                       f"{dtype}: error code {rc}")
  return tile[0], tile[1]


def _check(a: Tensor, b: Tensor, c: Optional[Tensor],
           k_valid: Optional[Tensor], sr: sr_mod.Semiring) -> None:
  if a.ndim != 3 or b.ndim != 3:
    raise ValueError(f"semiring_mmo takes (R, M, K) and (R, K, N), got "
                     f"{tuple(a.shape)} and {tuple(b.shape)}")
  r, m, k = a.shape
  if b.shape[0] != r or b.shape[1] != k:
    raise ValueError(f"shape mismatch: a {tuple(a.shape)}, b {tuple(b.shape)}")
  n = b.shape[2]
  if b.device != a.device:
    raise ValueError(f"a on {a.device}, b on {b.device}")
  if b.dtype != a.dtype:
    raise TypeError(f"a is {a.dtype}, b is {b.dtype}")
  allowed = (torch.bool,) if sr.boolean else (torch.float32, torch.bfloat16)
  if a.dtype not in allowed:
    raise TypeError(f"{sr.name} takes {allowed}, got {a.dtype}")
  if c is not None:
    if tuple(c.shape) != (r, m, n):
      raise ValueError(f"c must be {(r, m, n)}, got {tuple(c.shape)}")
    if c.dtype != sr.acc_dtype(a.dtype) or c.device != a.device:
      raise TypeError(f"c must be {sr.acc_dtype(a.dtype)} on {a.device}, got "
                      f"{c.dtype} on {c.device}")
  if k_valid is not None:
    if (tuple(k_valid.shape) != (r,) or k_valid.dtype != torch.int32
        or k_valid.device != a.device):
      raise TypeError(f"k_valid must be int32 of shape {(r,)} on {a.device}, "
                      f"got {k_valid.dtype} {tuple(k_valid.shape)} on "
                      f"{k_valid.device}")


def semiring_mmo(a: Tensor, b: Tensor, c: Optional[Tensor] = None, *,
                 op: str = "mma", k_valid: Optional[Tensor] = None) -> Tensor:
  """K1: D[r] = C[r] ⊕ (A[r] ⊗ B[r]) for a (R, M, K) × (R, K, N) stack.

  ``c`` is in the ring's output dtype (``acc_dtype`` of the input);
  ``k_valid`` (int32, one per request) bounds the live K lanes — lanes at or
  past it contribute the ⊕-identity and whole K steps past it are skipped.
  CPU tensors run ``semiring_mmo_plain``; CUDA tensors launch the kernel on
  the current stream and add one to ``semiring_mmo.launches``.
  """
  sr = sr_mod.get(op)
  _check(a, b, c, k_valid, sr)
  if a.device.type == "cpu":
    return semiring_mmo_plain(a, b, c, op=sr.name, k_valid=k_valid)
  if a.device.type != "cuda":
    raise ValueError(f"semiring_mmo runs on cuda or cpu, not {a.device}")
  tensors = (a, b) + tuple(t for t in (c, k_valid) if t is not None)
  if not all(t.is_contiguous() for t in tensors):
    raise ValueError("semiring_mmo's kernel takes contiguous tensors")
  r, m, k = a.shape
  n = b.shape[2]
  if r > _MAX_GRID_YZ or math.ceil(m / TILE[0]) > _MAX_GRID_YZ:
    raise ValueError(f"grid too large: R={r}, M={m}")
  if max(m, k, n) >= 2 ** 31:
    raise ValueError(f"dimension too large for the kernel: M={m} K={k} N={n}")
  out = torch.empty((r, m, n), dtype=sr.acc_dtype(a.dtype), device=a.device)
  if out.numel() == 0:
    return out
  if sr.boolean:  # the kernel reads and writes {0,1} bytes
    a, b = a.view(torch.uint8), b.view(torch.uint8)
    c = None if c is None else c.view(torch.uint8)
    d = out.view(torch.uint8)
  else:
    d = out
  launch = load()
  workspace = (_workspace(r, m, k, n, a.device) if sr.name == "mma"
               else None)
  with torch.cuda.device(a.device):
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = launch(
        OP_CODES[sr.name], _DTYPE_CODES[a.dtype], a.data_ptr(), b.data_ptr(),
        None if c is None else c.data_ptr(),
        None if k_valid is None else k_valid.data_ptr(), d.data_ptr(),
        None if workspace is None else workspace.data_ptr(), r, m, k, n,
        stream)
  if rc != 0:
    raise RuntimeError(f"semiring_mmo kernel launch failed for {sr.name} "
                       f"{a.dtype} R={r} M={m} K={k} N={n}: error code {rc}")
  semiring_mmo.launches += 1
  return out


semiring_mmo.launches = 0


def semiring_mmo_plain(a: Tensor, b: Tensor, c: Optional[Tensor] = None, *,
                       op: str = "mma",
                       k_valid: Optional[Tensor] = None) -> Tensor:
  """The kernel's function in plain PyTorch: blocked broadcast-⊗ + ⊕-reduce.

  Operands widen to f32 (bool for orand), lanes at or past ``k_valid`` take
  the contraction pads, the result rounds once to the output dtype.  mma
  widens further, to float64, so its sum is the exact product rounded once
  to f32: the reference the kernel's 3×TF32 tensor-core sum is held to
  (a blocked f32 sum of 4096 terms is itself off by up to ~3e-4 from it,
  three times the check's atol).  K blocks are sized so one block's
  (R, M, bk, N) intermediate stays near ``_PLAIN_BLOCK_ELEMS`` elements.
  """
  sr = sr_mod.get(op)
  r, m, k = a.shape
  n = b.shape[-1]
  work = (torch.bool if sr.boolean else
          torch.float64 if sr.name == "mma" else torch.float32)
  af, bf = a.to(work), b.to(work)
  kmax = k
  if k_valid is not None:
    pa, pb = (False, False) if sr.boolean else sr_mod.contraction_pads(sr)
    kv = k_valid.to(a.device).clamp(0, k)
    live = torch.arange(k, device=a.device)[None, :] < kv[:, None]  # (R, K)
    af = torch.where(live[:, None, :], af, pa)
    bf = torch.where(live[:, :, None], bf, pb)
    kmax = int(kv.max()) if r else 0
  acc = sr.identity_like((r, m, n), work, device=a.device)
  bk = max(1, min(kmax, _PLAIN_BLOCK_ELEMS // max(1, r * m * n)))
  for k0 in range(0, kmax, bk):
    prod = sr.otimes(af[:, :, k0:k0 + bk, None], bf[:, None, k0:k0 + bk, :])
    acc = sr.oplus(acc, sr_mod.oplus_reduce(sr, prod, dim=2))
  if c is not None:
    acc = sr.oplus(acc, c.to(work))
  return acc.to(sr.acc_dtype(a.dtype))
