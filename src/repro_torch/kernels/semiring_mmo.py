"""K1, the SIMD² unit: D = C ⊕ (A ⊗ B) over a stack of requests.

``semiring_mmo`` is the wrapper of the hand-written CUDA kernel in
``csrc/semiring_mmo.cu`` (which replaces the Pallas TPU kernel
``repro/kernels/semiring_mmo.py::semiring_mmo``; the source note there says
what bounds it and how its design answers that).  Beside it,
``semiring_mmo_plain`` computes the same function in plain PyTorch: blocked
broadcast-⊗ plus ⊕-reduce, like ``core.mmo._contract_vector``.

Types follow the reference's Pallas arm (``repro/kernels/semiring_mmo.py``):
mma and addnorm return f32 whatever the input; the min/max rings return the
input's dtype; orand returns bool.  The kernel has f32, bf16 and {0,1}-byte
instances, and int32 instances of the min/max rings.  float16 is widened to
f32 here and the result rounded once to float16 (bit-exact for + and ×, as
f32's 24 bits are at least 2·11 + 2, and rounding is monotone under min and
max); int32 mma and addnorm are widened to f32 too, as the reference
computes them in f32.

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
from repro_torch.kernels import nan_check, nvcc

Tensor = torch.Tensor

# The smallest output tile (BM, BN) and the K slab (BK) of the CUDA-core
# instances; mma's tensor-core instance takes 128×128 tiles and 32-deep slabs.
# tile_shape() says which tile a launch takes.
TILE = (64, 64, 16)
_MAX_GRID_YZ = 65535
# Elements of the plain version's (R, M, bk, N) intermediate per K block.
_PLAIN_BLOCK_ELEMS = 1 << 26

OP_CODES = {op: i for i, op in enumerate(sr_mod.ALL_OPS)}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2,
                torch.int32: 3}

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


def out_dtype(op: str, dtype: torch.dtype) -> torch.dtype:
  """The dtype K1 returns for operands of ``dtype``: bool for orand, f32 for
  mma and addnorm, the operands' own for the min/max rings."""
  sr = sr_mod.get(op)
  if sr.boolean:
    return torch.bool
  return torch.float32 if sr.name in ("mma", "addnorm") else dtype


def kernel_dtype(op: str, dtype: torch.dtype) -> torch.dtype:
  """The dtype of the kernel instance that serves ``dtype``: float16, and
  int32 under mma and addnorm, run on the f32 instance."""
  if dtype == torch.float16 or (dtype == torch.int32 and sr_mod.get(
      op).name in ("mma", "addnorm")):
    return torch.float32
  return dtype


def tile_shape(op: str, dtype: torch.dtype, r: int, m: int, n: int) -> tuple:
  """(rows, columns) of the output tile a launch at R × M × N takes on the
  current card: 128×128 on the tensor cores for mma; 128×128 for the other
  rings where those tiles cover at least two waves of the card's resident
  CTAs, else 64×64."""
  sr = sr_mod.get(op)
  dtype = kernel_dtype(sr.name, dtype)
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
  allowed = ((torch.bool,) if sr.boolean else
             (torch.float32, torch.bfloat16, torch.float16, torch.int32))
  if a.dtype not in allowed:
    raise TypeError(f"{sr.name} takes {allowed}, got {a.dtype}")
  if c is not None:
    if tuple(c.shape) != (r, m, n):
      raise ValueError(f"c must be {(r, m, n)}, got {tuple(c.shape)}")
    want = out_dtype(sr.name, a.dtype)
    if c.dtype != want or c.device != a.device:
      raise TypeError(f"c must be {want} on {a.device}, got {c.dtype} on "
                      f"{c.device}")
  if k_valid is not None:
    if (tuple(k_valid.shape) != (r,) or k_valid.dtype != torch.int32
        or k_valid.device != a.device):
      raise TypeError(f"k_valid must be int32 of shape {(r,)} on {a.device}, "
                      f"got {k_valid.dtype} {tuple(k_valid.shape)} on "
                      f"{k_valid.device}")


def semiring_mmo(a: Tensor, b: Tensor, c: Optional[Tensor] = None, *,
                 op: str = "mma", k_valid: Optional[Tensor] = None) -> Tensor:
  """K1: D[r] = C[r] ⊕ (A[r] ⊗ B[r]) for a (R, M, K) × (R, K, N) stack.

  ``c`` is in the ring's output dtype (``out_dtype`` of the input);
  ``k_valid`` (int32, one per request) bounds the live K lanes — lanes at or
  past it contribute the ⊕-identity and whole K steps past it are skipped.
  CPU tensors run ``semiring_mmo_plain``; CUDA tensors launch the kernel on
  the current stream and add one to ``semiring_mmo.launches``.
  """
  sr = sr_mod.get(op)
  _check(a, b, c, k_valid, sr)
  if a.device.type == "cpu":
    out = semiring_mmo_plain(a, b, c, op=sr.name, k_valid=k_valid)
    return nan_check.checked("semiring_mmo", (a, b, c), out)
  if a.device.type != "cuda":
    raise ValueError(f"semiring_mmo runs on cuda or cpu, not {a.device}")
  tensors = (a, b) + tuple(t for t in (c, k_valid) if t is not None)
  if not all(t.is_contiguous() for t in tensors):
    raise ValueError("semiring_mmo's kernel takes contiguous tensors")
  run = kernel_dtype(sr.name, a.dtype)
  if run == a.dtype:
    out = _launch(a, b, c, k_valid, sr)
  else:
    # the f32 instance on the widened operands, rounded once to the output
    out = _launch(a.to(run), b.to(run), None if c is None else c.to(run),
                  k_valid, sr).to(out_dtype(sr.name, a.dtype))
  return nan_check.checked("semiring_mmo", (a, b, c), out)


def _launch(a: Tensor, b: Tensor, c: Optional[Tensor],
            k_valid: Optional[Tensor], sr: sr_mod.Semiring) -> Tensor:
  """One launch of the instance of ``a``'s dtype on contiguous CUDA
  tensors."""
  r, m, k = a.shape
  n = b.shape[2]
  if r > _MAX_GRID_YZ or math.ceil(m / TILE[0]) > _MAX_GRID_YZ:
    raise ValueError(f"grid too large: R={r}, M={m}")
  if max(m, k, n) >= 2 ** 31:
    raise ValueError(f"dimension too large for the kernel: M={m} K={k} N={n}")
  out = torch.empty((r, m, n), dtype=out_dtype(sr.name, a.dtype),
                    device=a.device)
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

  Operands widen to f32 (bool for orand; int32 stays int32 on the min/max
  rings, ⊗ wrapping in two's complement), lanes at or past ``k_valid`` take
  the contraction pads, the result rounds once to the output dtype
  (``out_dtype``).  mma widens further, to float64, so its sum is the exact
  product rounded once to f32: the reference the kernel's 3×TF32
  tensor-core sum is held to (a blocked f32 sum of 4096 terms is itself off
  by up to ~3e-4 from it, three times the check's atol).  K blocks are sized
  so one block's (R, M, bk, N) intermediate stays near
  ``_PLAIN_BLOCK_ELEMS`` elements.
  """
  sr = sr_mod.get(op)
  r, m, k = a.shape
  n = b.shape[-1]
  if sr.boolean or sr.name == "mma":
    work = torch.bool if sr.boolean else torch.float64
  else:  # int32 on the min/max rings' own instances, else f32
    work = (torch.int32 if kernel_dtype(sr.name, a.dtype) == torch.int32
            else torch.float32)
  af, bf = a.to(work), b.to(work)
  kmax = k
  if k_valid is not None:
    pa, pb = ((False, False) if sr.boolean else
              sr_mod.contraction_pads(sr, work))
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
  return acc.to(out_dtype(sr.name, a.dtype))

