"""K2, the fused closure fixpoint: G iterations per launch, no host sync
between them.

``fixpoint_chunk`` is the wrapper of the hand-written CUDA kernel in
``csrc/closure_megakernel.cu``, which replaces the Pallas TPU kernel
``repro/kernels/closure_megakernel.py::_chunk_call`` (the source note there
says what bounds it and how its cooperative, persistent design answers
that).  One launch advances every live request of an (R, n̄, n̄) stack by up
to ``g_steps`` iterations of C ← C ⊕ (C ⊗ C) (Leyzorek) or D ← D ⊕ (D ⊗ A)
(Bellman-Ford, ``adj`` given), freezing each request whose iterate stops
changing, and returns (iterate, iteration counters, active flags).

Beside it, ``fixpoint_chunk_plain`` runs the same chunk in plain PyTorch,
one ``semiring_mmo_plain`` step at a time with the dispatch path's k_valid
masking, so on the CPU the fused path computes the per-iteration path's
bits.  The wrapper takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.

``chunk_geometry`` is the one layout resolver shared by the batched driver
``megakernel_fixpoint`` and the request arena (``serve_mmo/arena.py``), so a
request lands in the same layout on both paths.  The kernel masks its own
ragged tiles, so unlike the TPU layout no row-slab alignment pads n̄.

The iterate keeps the reference's dtype: f32 for mma, bool for orand, and
the input's own (f32, bf16, float16 or int32) for the min/max rings.  A
float16 iterate is computed in f32 and rounded to float16 at each step's
store, as the reference stores it between steps; int32 ⊗ wraps in two's
complement.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core import closure as cl_mod
from repro_torch.core import semiring as sr_mod
from repro_torch.core import stamps
from repro_torch.kernels import nan_check, nvcc
from repro_torch.kernels.semiring_mmo import (OP_CODES, TILE,
                                              semiring_mmo_plain)

Tensor = torch.Tensor

DEFAULT_G = 8  # chunk length: fixpoint iterations fused per kernel launch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.bool: 2,
                torch.int32: 3, torch.float16: 4}

LIBRARY = nvcc.KernelLibrary(
    "closure_megakernel", "simd2_closure_fixpoint",
    [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
    + [ctypes.c_void_p])
SOURCE = LIBRARY.source
library_path = LIBRARY.path
build_library = LIBRARY.build
build_log = LIBRARY.build_log
load = LIBRARY.load


def tile_shape(op: str, dtype: torch.dtype, r: int, n: int) -> tuple:
  """(rows, columns) of the output tile of a step of an (R, n, n) stack with
  every request live, on the current card: 128×128 on the tensor cores for
  mma; for the other rings K1's rule applied to the live tiles."""
  sr = sr_mod.get(op)
  tile = (ctypes.c_int * 2)()
  fn = LIBRARY.function("simd2_closure_fixpoint_tile",
                        [ctypes.c_int] * 4 + [ctypes.c_void_p])
  rc = fn(OP_CODES[sr.name], _DTYPE_CODES[dtype], r, n,
          ctypes.addressof(tile))
  if rc != 0:
    raise RuntimeError(f"closure_megakernel tile query failed for {sr.name} "
                       f"{dtype}: error code {rc}")
  return tile[0], tile[1]


class ChunkGeometry(NamedTuple):
  """Resolved kernel layout for one (ring, n, dtype) combination."""
  missing: float      # no-edge fill for padded cells
  self_value: float   # ⊗-identity on the padded diagonal (isolated vertices)
  acc_dtype: torch.dtype  # the iterate's dtype (bool for orand)
  np_: int            # padded matrix dim


def _torch_dtype(dtype) -> torch.dtype:
  if isinstance(dtype, torch.dtype):
    return dtype
  return getattr(torch, str(dtype).removeprefix("torch."))


def chunk_geometry(op: str, n: int, dtype=torch.float32) -> ChunkGeometry:
  """Resolve the megakernel layout for ring ``op`` at true size ``n``.

  Raises for rings without a ⊗-identity (addnorm): no isolated-vertex
  embedding exists, as the per-iteration path refuses closure.
  """
  sr = sr_mod.get(op)
  missing, self_value = cl_mod.closure_pad_values(op)
  acc_dtype = torch.bool if sr.boolean else (
      torch.float32 if sr.name == "mma" else sr.acc_dtype(
          _torch_dtype(dtype)))
  return ChunkGeometry(missing=float(missing), self_value=float(self_value),
                       acc_dtype=acc_dtype, np_=int(n))


def fixpoint_iters(algorithm: str, n: int) -> int:
  """Default trip-count cap, the same bound both fixpoint paths use:
  Bellman-Ford needs n relaxation rounds, repeated squaring ⌈log2 n⌉."""
  if algorithm == "bellman_ford":
    return max(1, int(n))
  if algorithm == "leyzorek":
    return max(1, math.ceil(math.log2(max(n, 2))))
  raise ValueError(f"unknown algorithm {algorithm!r}")


def _check(c: Tensor, adj: Optional[Tensor], vecs, sr: sr_mod.Semiring,
           g_steps: int) -> None:
  if c.ndim != 3 or c.shape[1] != c.shape[2]:
    raise ValueError(f"fixpoint_chunk takes an (R, n, n) stack, got "
                     f"{tuple(c.shape)}")
  if sr.otimes_identity is None:
    raise ValueError(f"op {sr.name!r} has no ⊗-identity: no closure")
  allowed = ((torch.bool,) if sr.boolean else (torch.float32,)
             if sr.name == "mma" else (torch.float32, torch.bfloat16,
                                       torch.float16, torch.int32))
  if c.dtype not in allowed:
    raise TypeError(f"{sr.name} iterates in {allowed}, got {c.dtype}")
  if adj is not None and (adj.shape != c.shape or adj.dtype != c.dtype
                          or adj.device != c.device):
    raise ValueError(f"adj must match c: {adj.dtype}{tuple(adj.shape)} on "
                     f"{adj.device} vs {c.dtype}{tuple(c.shape)} on "
                     f"{c.device}")
  r = c.shape[0]
  for name, v in vecs.items():
    if (tuple(v.shape) != (r,) or v.dtype != torch.int32
        or v.device != c.device):
      raise TypeError(f"{name} must be int32 of shape {(r,)} on {c.device}, "
                      f"got {v.dtype} {tuple(v.shape)} on {v.device}")
  if g_steps < 0:
    raise ValueError(f"g_steps must be >= 0, got {g_steps}")


def fixpoint_chunk(c: Tensor, adj: Optional[Tensor], kv: Tensor,
                   act: Tensor, it: Tensor, glim: Tensor, *, op: str,
                   g_steps: int):
  """K2: up to ``g_steps`` fixpoint iterations of an (R, n̄, n̄) stack.

  Request ``r`` runs while ``act[r] != 0`` and fewer than ``glim[r]`` steps
  of this chunk have run; ``kv[r]`` bounds its live K lanes.  Operands are in
  ``chunk_geometry`` layout; ``kv``/``act``/``it``/``glim`` are int32 (R,).
  Returns new (iterate, iteration counters, active flags); the inputs are
  not modified.  CPU tensors run ``fixpoint_chunk_plain``; CUDA tensors
  launch the kernel once on the current stream and add one to
  ``fixpoint_chunk.launches``.
  """
  sr = sr_mod.get(op)
  _check(c, adj, {"kv": kv, "act": act, "it": it, "glim": glim}, sr, g_steps)
  if c.device.type == "cpu":
    return nan_check.checked(
        "fixpoint_chunk", (c, adj),
        fixpoint_chunk_plain(c, adj, kv, act, it, glim, op=sr.name,
                             g_steps=g_steps))
  if c.device.type != "cuda":
    raise ValueError(f"fixpoint_chunk runs on cuda or cpu, not {c.device}")
  operands = (c, kv, glim) + (() if adj is None else (adj,))
  if not all(t.is_contiguous() for t in operands):
    raise ValueError("fixpoint_chunk's kernel takes contiguous tensors")
  r, n = c.shape[0], c.shape[-1]
  if r * math.ceil(n / TILE[0]) ** 2 >= 2 ** 62 or n >= 2 ** 31:
    raise ValueError(f"stack too large for the kernel: R={r} n={n}")
  out = torch.empty_like(c)
  it_out, act_out = it.clone(), act.clone()
  if c.numel() == 0:
    return out, it_out, act_out
  scratch = torch.empty_like(c)
  work = torch.empty(2 * r + 2, dtype=torch.int32, device=c.device)
  tc_ws = None
  if sr.name == "mma":  # the split TF32 operands of each step
    nbytes = LIBRARY.function("simd2_closure_fixpoint_workspace",
                              [ctypes.c_int] * 3, ctypes.c_longlong)(
                                  OP_CODES[sr.name], r, n)
    tc_ws = torch.empty(nbytes, dtype=torch.uint8, device=c.device)

  launch = load()
  with torch.cuda.device(c.device):
    stream = torch.cuda.current_stream(c.device).cuda_stream
    rc = launch(OP_CODES[sr.name], _DTYPE_CODES[c.dtype], c.data_ptr(),
                None if adj is None else adj.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), kv.data_ptr(),
                act_out.data_ptr(), it_out.data_ptr(), glim.data_ptr(),
                work.data_ptr(), None if tc_ws is None else tc_ws.data_ptr(),
                r, n, int(g_steps), stream)
  if rc != 0:
    raise RuntimeError(f"closure_megakernel launch failed for {sr.name} "
                       f"{c.dtype} R={r} n={n} g={g_steps}: error code {rc}")
  fixpoint_chunk.launches += 1
  return nan_check.checked("fixpoint_chunk", (c, adj),
                           (out, it_out, act_out))


fixpoint_chunk.launches = 0


def fixpoint_chunk_plain(c: Tensor, adj: Optional[Tensor], kv: Tensor,
                         act: Tensor, it: Tensor, glim: Tensor, *, op: str,
                         g_steps: int):
  """The kernel's function in plain PyTorch, one step at a time.

  Each step is the per-iteration path's step: ``semiring_mmo_plain`` with
  k_valid = kv for live requests and 0 for the rest, then the freeze and
  the inf/NaN-aware compare.  Reads whether any request is live once per
  step (a host sync: this is the reference, not the fast path).
  """
  sr = sr_mod.get(op)
  act, it = act.clone(), it.clone()
  for s in range(g_steps):
    live = (act != 0) & (s < glim)
    if not bool(live.any()):
      break
    k_valid = torch.where(live, kv, torch.zeros_like(kv))
    new = semiring_mmo_plain(c, c if adj is None else adj, c, op=sr.name,
                             k_valid=k_valid)
    new = torch.where(live[:, None, None], new, c)
    changed = cl_mod._batched_changed(new, c)
    it = it + live.to(torch.int32)
    act = torch.where(live, changed.to(torch.int32), act)
    c = new
  return c, it, act


def _pad_closure(x: Tensor, np_: int, missing, self_value) -> Tensor:
  """Embed (R, n, n) into (R, np_, np_) as isolated vertices — the padding
  the serving bucketer uses, so the convergence compare over the padded
  region never flips a flag."""
  r, n = x.shape[0], x.shape[-1]
  if np_ == n:
    return x
  out = torch.full((r, np_, np_), sr_mod.saturate(missing, x.dtype),
                   dtype=x.dtype, device=x.device)
  out[:, :n, :n] = x
  diag = torch.arange(n, np_, device=x.device)
  out[:, diag, diag] = torch.tensor(sr_mod.saturate(self_value, x.dtype),
                                    dtype=x.dtype, device=x.device)
  return out


def megakernel_fixpoint(adj: Tensor, *, op: str, algorithm: str = "leyzorek",
                        max_iters: Optional[int] = None, valid_n=None,
                        g: int = DEFAULT_G):
  """Whole-fixpoint driver over G-iteration ``fixpoint_chunk`` launches.

  Drop-in for ``core.closure._batched_fixpoint``: the same (closure,
  per-request iteration counts) contract and the same bits.  Each chunk
  gets the budget ``min(g, max_iters − i)``, which keeps the cap exact when
  G does not divide it.  The host reads the active flags once per chunk.
  """
  if adj.ndim != 3:
    raise ValueError(f"megakernel fixpoint needs (R, n, n) input, got "
                     f"{tuple(adj.shape)}")
  if algorithm not in ("leyzorek", "bellman_ford"):
    raise ValueError(f"unknown algorithm {algorithm!r}")
  if g < 1:
    raise ValueError(f"chunk length g must be >= 1, got {g}")
  r, n = adj.shape[0], adj.shape[-1]
  dev = adj.device
  iters = fixpoint_iters(algorithm, n) if max_iters is None else max_iters
  geom = chunk_geometry(op, n, adj.dtype)
  c = _pad_closure(adj.to(geom.acc_dtype), geom.np_, geom.missing,
                   geom.self_value).contiguous()
  adj_operand = c if algorithm == "bellman_ford" else None
  if valid_n is None:
    kv = torch.full((r,), n, dtype=torch.int32, device=dev)
  else:
    kv = torch.as_tensor(valid_n, dtype=torch.int32).to(dev).contiguous()
  g_steps = min(g, iters)
  act = torch.ones((r,), dtype=torch.int32, device=dev)
  it = torch.zeros((r,), dtype=torch.int32, device=dev)
  i = 0
  while i < iters:
    glim = min(g_steps, iters - i)
    c, it, act = fixpoint_chunk(
        c, adj_operand, kv, act, it,
        torch.full((r,), glim, dtype=torch.int32, device=dev), op=op,
        g_steps=g_steps)
    i += glim
    if not stamps.sync(act.any()):  # the one host sync per chunk
      break
  return c[:, :n, :n], it
