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
reads them to size each device's share, ``models/placement.py`` cuts a
tree by them, and training on a mesh (``train/sharded.py``) cuts the f32
master, both AdamW moments and the gradient sums by them over the data and
model axes.

Tensor parallelism (``zoo.ShardedLM``, for serving and for training)
computes on the model axis: every mesh position runs the block code below
on its own device, in a thread of its own, over its slice of the heads,
the MLP and expert width, the SSM inner width and the vocab (``Position``,
``run_positions``).  The positions of one data line meet at the points the
reference's GSPMD program communicates: ``row_parallel`` and ``tp_sum``
(partial sums added in f32, in position order, rounded once), ``col_input``
and ``seq_local`` (the sequence-sharded residual stream under
``activation_sharding``), ``gather_heads``, ``embed``, ``vocab_argmax``
and the vocab-parallel loss terms ``vocab_logsumexp`` and ``vocab_gold``.
A meeting's result on a position is an ordinary differentiable function of
every position's posted tensor (copies and f32 adds), so the positions'
forwards record one autograd graph per data line, and its backward is the
transposed collective with no meeting of its own.  A checkpointed layer's
recompute replays its forward's meeting results instead of meeting again
(``remat_contexts``).  Where a batch does not split over the data lines,
the positions of one model index over the lines meet too
(``column_cat``: a decode step's heads under the 2-D cache cut).  With no
position installed each of them is the one-device operation, unchanged.
Each meeting names the dry-run term it is charged to
(``roofline/collectives.TERMS``) and its ring kind, and reports itself to
a ``roofline.collectives.CollectiveCounter`` that is on.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.roofline import collectives

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
# dry run and the tensor-parallel steps install a spec for the residual
# stream; every block body calls constrain_acts where the reference does.
# With a mesh position installed and the model axis on the stream's
# sequence dim, constrain_acts keeps the position's rows of the stream
# (``Position.split``): row-parallel outputs are then reduce-scattered
# along the sequence and ``col_input`` all-gathers before the next
# column-parallel projection.  Otherwise both constraints return their
# input unchanged (the reference's no-op when unset).  ``act_axes`` reads
# the installed spec back.
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


def act_axes():
  """(dp, tp) axis names of the installed activation spec (None when
  unset)."""
  spec = _ACT_SPEC[0]
  if spec is None:
    return None, None
  dp = spec[0] if len(spec) > 0 else None
  tp = spec[1] if len(spec) > 1 else None
  return dp, tp


def constrain_acts(x: Tensor) -> Tensor:
  """The residual stream x (B, S, D) in the installed layout: on a mesh
  position whose model axis the spec puts on the sequence (S divisible by
  its size), the position's S/tp rows; else x unchanged."""
  pos = position()
  if pos is None or pos.split or x.ndim != 3 or pos.size == 1:
    return x
  if act_axes()[1] != pos.model_axis or x.shape[1] % pos.size:
    return x
  pos.split = True
  return seq_local(x)


def constrain(x: Tensor, spec) -> Tensor:
  """x, unchanged: ``spec`` is its layout's metadata only (on a mesh
  position x already holds the position's slice)."""
  del spec
  return x


# ---------------------------------------------------------------------------
# tensor parallelism: the positions of a data line and where they meet
# ---------------------------------------------------------------------------


class Baton:
  """Runs the threads of a tensor-parallel run one at a time, in a fixed
  order: a thread holds the baton until it waits at a meeting (or ends),
  then hands it to the next.  Only the holder runs Python, so the threads
  do not contend for the interpreter lock at every operator (contending,
  they slowed a mesh decode on the card severalfold), and the order of
  all launches is fixed."""

  def __init__(self, keys):
    self._lock = threading.Lock()
    self._order = list(keys)
    self._wake = {k: threading.Condition(self._lock) for k in keys}
    self._holder = self._order[0] if self._order else None
    self._broken = False
    self._progress = 0

  def _pass_locked(self, key) -> None:
    i = self._order.index(key)
    self._holder = self._order[(i + 1) % len(self._order)]
    self._wake[self._holder].notify()

  def _await_locked(self, key) -> None:
    while self._holder != key and not self._broken:
      self._wake[key].wait()
    if self._broken:
      raise threading.BrokenBarrierError

  def start(self, key) -> None:
    """Wait for the baton's first turn."""
    with self._lock:
      self._await_locked(key)

  def wait_for(self, key, ready: Callable[[], bool]) -> None:
    """Hand the baton on until it comes back with ``ready()`` true (read
    under the baton's lock).  A whole round with no thread ready is a
    mismatch of meetings, and breaks the run."""
    with self._lock:
      seen = None
      while not ready():
        if seen == self._progress:
          self._broken = True
          for cv in self._wake.values():
            cv.notify_all()
          raise RuntimeError("the positions' meetings do not match")
        seen = self._progress
        self._pass_locked(key)
        self._await_locked(key)
      self._progress += 1

  def finish(self, key) -> None:
    """Leave the rotation (the thread's job ended), handing the baton on."""
    with self._lock:
      self._progress += 1
      if len(self._order) > 1 and self._holder == key:
        self._pass_locked(key)
      self._order.remove(key)

  def abort(self) -> None:
    with self._lock:
      self._broken = True
      for cv in self._wake.values():
        cv.notify_all()


class LineGroup:
  """The model-axis positions of one data line: ``meet`` is their
  rendezvous, under the run's ``Baton`` (a group of its own when none is
  given).  ``axis`` names the mesh axis group its positions span (a
  column over the data lines spans the data axes)."""

  def __init__(self, size: int, baton: Optional[Baton] = None,
               keys: Optional[Sequence] = None, axis: str = "model"):
    self.size = size
    self.axis = axis
    self.keys = list(range(size)) if keys is None else list(keys)
    self.baton = Baton(self.keys) if baton is None else baton
    # two sets of slots, used by turns: a position cannot post to a set
    # again before every position has passed the meeting that reads it
    self._slots = ([None] * size, [None] * size)
    self._count = [0] * size

  @property
  def held(self) -> int:
    """The meetings every position of the group has passed."""
    return min(self._count)

  def meet(self, rank: int, value, fn: Callable, *, term: str,
           kind: str):
    """Every position posts ``value``; each then gets ``fn`` of all the
    posted values in position order.  A posted value stays referenced in
    its slot until the meeting after next, so its memory is not handed to
    later work on its stream while another position's copy of it may
    still be queued.  Inside a region that ``remat_contexts`` records,
    the result is also kept for the region's recompute.  ``term`` and
    ``kind`` (a ring kind) are what a ``CollectiveCounter`` is told."""
    if self.size == 1:
      return _record(fn([value]))
    slots = self._slots[self._count[rank] % 2]
    slots[rank] = value
    self._count[rank] += 1
    mine = self._count[rank]
    self.baton.wait_for(self.keys[rank], lambda: min(self._count) >= mine)
    try:
      result = fn(list(slots))
    except BaseException:
      self.baton.abort()
      raise
    if collectives.counting():
      self._report(rank, value, result, term, kind)
    return _record(result)

  def _report(self, rank: int, value, result, term: str, kind: str) -> None:
    """The meeting as a collective of ``kind`` over the posted bytes (an
    all-gather's output: the size times one posted value), and, when its
    gradient arrives in the backward, the transposed collective over the
    same bytes: the gradient goes back to every posted tensor."""
    nbytes = collectives.tensor_bytes(value)
    if kind == "all-gather":
      nbytes *= self.size
    said = (term, self.axis, kind, nbytes, self.size, self.keys[rank])
    collectives.record(*said)
    if isinstance(result, Tensor) and result.requires_grad:
      # the hook holds no reference to the group, whose slots hold
      # tensors of the graph: a cycle through autograd's nodes would
      # never be collected
      back = said[:2] + (collectives.TRANSPOSE[kind],) + said[3:]
      result.register_hook(functools.partial(_report_backward, back))


def _report_backward(said: tuple, grad: Tensor) -> None:
  """A meeting's gradient has arrived: its transposed collective runs."""
  del grad
  collectives.record(*said)


class _Replay:
  """A recompute's stand-in for a position's groups: ``meet`` hands back
  the results its forward recorded, in order, and neither posts nor
  waits (the recompute runs inside the backward, where the other
  positions do not meet)."""

  def __init__(self, size: int, results):
    self.size = size
    self._results = results

  def meet(self, rank: int, value, fn: Callable, **collective):
    del rank, value, fn, collective
    try:
      return next(self._results)
    except StopIteration:
      raise RuntimeError("a recompute holds more meetings than its "
                         "forward recorded") from None


@dataclasses.dataclass
class Position:
  """The mesh position the current thread computes for: its rank on the
  model axis of its line's group, the axis' name, and the serving knob
  ``seq_shard_decode``.  ``split`` is set while the residual stream holds
  only this position's rows (``constrain_acts``).  ``column`` is the
  positions of its model index over the data lines (its rank there is
  ``line``): where a batch does not split over the lines, each line holds
  one group of the KV cache's heads and a decode step assembles the heads
  over the column.  ``tape`` collects the meetings' results while a
  checkpointed region runs (``remat_contexts``)."""

  group: LineGroup
  rank: int
  model_axis: str = "model"
  seq_shard_decode: bool = True
  split: bool = False
  column: Optional[LineGroup] = None
  line: int = 0
  tape: Optional[list] = None

  @property
  def size(self) -> int:
    return self.group.size


_POSITION = threading.local()


def position() -> Optional[Position]:
  """The position installed on this thread (None on one device)."""
  return getattr(_POSITION, "value", None)


def _record(result):
  pos = position()
  if pos is not None and pos.tape is not None:
    pos.tape.append(result)
  return result


def remat_contexts():
  """(forward context, recompute context) for one checkpointed region
  (``torch.utils.checkpoint``'s ``context_fn``) on this thread's mesh
  position; two no-ops on one device.

  The forward records the result of every meeting the region holds, in
  order.  The recompute runs inside the backward, on autograd's thread,
  where no position is installed and the other positions do not meet: it
  installs a copy of the position as it was when the region began, whose
  groups hand back the recorded results from the first on (``_Replay``),
  so the recomputed tensors are the forward's bit for bit.  Each result
  is an ordinary function of every position's posted tensor, so the
  graph the backward runs is the forward's; the records live as long as
  the region's saved tensors."""
  pos = position()
  if pos is None:
    return contextlib.nullcontext(), contextlib.nullcontext()
  tape, split = [], pos.split

  @contextlib.contextmanager
  def record():
    if pos.tape is not None:
      raise RuntimeError("checkpointed regions nest on a mesh position")
    pos.tape = tape
    try:
      yield
    finally:
      pos.tape = None

  @contextlib.contextmanager
  def replay():
    results = iter(tape)
    again = dataclasses.replace(
        pos, group=_Replay(pos.size, results), split=split, tape=None,
        column=None if pos.column is None else _Replay(pos.column.size,
                                                       results))
    prev = position()
    _POSITION.value = again
    try:
      yield
    finally:
      _POSITION.value = prev
  return record(), replay()


def run_positions(jobs: dict, devices: dict) -> dict:
  """Run ``jobs[key]()`` for every key, one thread each, with
  ``jobs[key].position`` installed (a ``Position``; every job of a
  ``LineGroup`` must be here, and the groups share one ``Baton`` over the
  keys, in order) and, on a card, ``devices[key]`` current.  The caller's
  grad and inference modes hold in every thread.  Returns {key: result};
  a job's exception breaks the others' meetings and is raised here."""
  grad, inference = torch.is_grad_enabled(), torch.is_inference_mode_enabled()
  out, errors = {}, []
  baton = next(iter(jobs.values())).position.group.baton

  def work(key, job):
    _POSITION.value = job.position
    try:
      baton.start(key)
      dev = torch.device(devices[key])
      if dev.type == "cuda":
        torch.cuda.set_device(dev)
      with torch.inference_mode(inference), torch.set_grad_enabled(grad):
        out[key] = job()
      baton.finish(key)
    except threading.BrokenBarrierError:
      pass                       # another position failed first
    except BaseException as e:  # noqa: BLE001 - raised below
      errors.append(e)
      baton.abort()
    finally:
      _POSITION.value = None

  threads = [threading.Thread(target=work, args=(k, j), daemon=True)
             for k, j in jobs.items()]
  for t in threads:
    t.start()
  for t in threads:
    t.join()
  if errors:
    raise errors[0]
  if len(out) != len(jobs):
    raise RuntimeError("a mesh position's meeting was broken")
  return out


@contextlib.contextmanager
def whole_weights(*modules):
  """With ``fsdp``, a mesh position's layer weights are cut along
  ``data``: a module holding such weights carries ``_gather``, {name:
  (gather, placeholder)}.  Within this context the weights of
  ``modules`` and their submodules are gathered for use (in training a
  gather whose backward hands the part's gradient on), and freed after
  (the placeholders put back).  A module with none is untouched."""
  owners = [m for mod in modules for m in mod.modules()
            if getattr(m, "_gather", None)]
  for m in owners:
    for name, (gather, _) in m._gather.items():
      m._parameters[name] = gather()
  try:
    yield
  finally:
    for m in owners:
      for name, (_, placeholder) in m._gather.items():
        m._parameters[name] = placeholder


def head_range(n_heads: int, n_kv: int, rank: int, size: int):
  """((q0, q1), (k0, k1)): the query heads position ``rank`` of ``size``
  computes and the kv heads (or SSM groups) they group over."""
  if n_heads % size:
    raise ValueError(f"{n_heads} heads do not split over {size} positions")
  hq, grp = n_heads // size, n_heads // n_kv
  q0, q1 = rank * hq, (rank + 1) * hq
  k0, k1 = q0 // grp, (q1 - 1) // grp + 1
  if hq % grp and grp % hq:
    raise ValueError(f"{hq} heads per position do not group over kv heads "
                     f"of {grp} query heads each")
  return (q0, q1), (k0, k1)


def _f32_product(x: Tensor, w: Tensor) -> Tensor:
  if x.device.type == "cuda":
    if x.ndim == 3 and w.ndim == 3:
      return torch.bmm(x, w, out_dtype=torch.float32)
    lead = x.shape[:-1]
    return torch.mm(x.reshape(-1, x.shape[-1]), w,
                    out_dtype=torch.float32).reshape(*lead, w.shape[-1])
  return torch.matmul(x.float(), w.float())


class _F32Product(torch.autograd.Function):
  """``_f32_product`` with the one-device product's backward: the f32
  output gradient (an upcast bf16 value: the sum it feeds is rounded to
  x's dtype) is rounded back, and dx = g wᵀ and dw = xᵀ g are products in
  x's dtype, as a bf16 ``matmul``'s backward runs them (a card's
  ``out_dtype`` product has no backward of its own)."""

  @staticmethod
  def forward(ctx, x, w):
    ctx.save_for_backward(x, w)
    return _f32_product(x, w)

  @staticmethod
  def backward(ctx, g):
    x, w = ctx.saved_tensors
    g = g.to(x.dtype)
    dx = dw = None
    if ctx.needs_input_grad[0]:
      dx = torch.matmul(g, w.transpose(-1, -2))
    if ctx.needs_input_grad[1]:
      if w.ndim == 2:
        dw = torch.matmul(x.reshape(-1, x.shape[-1]).T,
                          g.reshape(-1, g.shape[-1]))
      else:
        dw = torch.matmul(x.transpose(-1, -2), g)
    return dx, dw


def f32_product(x: Tensor, w: Tensor) -> Tensor:
  """x @ w with an f32 result and no rounding on the way: a card's bf16
  product accumulates in f32 and writes f32 (``out_dtype``); elsewhere the
  operands are widened (exact) and multiplied in f32.  Differentiable
  (``_F32Product``)."""
  if x.dtype == torch.float32:
    return torch.matmul(x, w)
  if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
    return _F32Product.apply(x, w)
  return _f32_product(x, w)


def _ordered_sum(parts, device, rows: Optional[slice] = None) -> Tensor:
  acc = None
  for t in parts:
    t = t if rows is None else t[:, rows]
    t = t.to(device, torch.float32)
    acc = t if acc is None else acc + t
  return acc


def _rows(pos: Position, n: int) -> slice:
  per = n // pos.size
  return slice(pos.rank * per, (pos.rank + 1) * per)


def tp_sum(partial: Tensor, dtype: torch.dtype,
           term: str = "tp_all_reduce") -> Tensor:
  """The sum over the line's positions of their f32 ``partial``s, added in
  position order and rounded once to ``dtype`` (the all-reduce, charged to
  the dry run's ``term``)."""
  pos = position()
  if pos is None:
    return partial.to(dtype)
  dev = partial.device
  return pos.group.meet(pos.rank, partial,
                        lambda parts: _ordered_sum(parts, dev).to(dtype),
                        term=term, kind="all-reduce")


def row_parallel(x: Tensor, w: Tensor) -> Tensor:
  """x @ w for a row-parallel weight (its input dim cut over the model
  axis): on a position, the f32 partial products summed over the line
  (``tp_sum``), or under a split stream only this position's rows of the
  sum (the reduce-scatter); on one device the plain product."""
  pos = position()
  if pos is None:
    return torch.matmul(x, w)
  partial = f32_product(x, w)
  if not pos.split:
    return tp_sum(partial, x.dtype)
  dev, rows = partial.device, _rows(pos, partial.shape[1])
  return pos.group.meet(pos.rank, partial, lambda parts: _ordered_sum(
      parts, dev, rows).to(x.dtype), term="tp_all_reduce",
      kind="reduce-scatter")


def _gather(t: Tensor, dim: int, term: str = "tp_all_reduce") -> Tensor:
  pos = position()
  dev = t.device
  return pos.group.meet(pos.rank, t, lambda parts: torch.cat(
      [p.to(dev) for p in parts], dim=dim), term=term, kind="all-gather")


def column_cat(t: Tensor, dim: int) -> Tensor:
  """The column's tensors (one per data line, this position's model
  index) concatenated along ``dim`` in line order: the all-gather over the
  data axis."""
  pos = position()
  dev = t.device
  return pos.column.meet(pos.line, t, lambda parts: torch.cat(
      [p.to(dev) for p in parts], dim=dim), term="decode_heads_all_gather",
      kind="all-gather")


def col_input(x: Tensor) -> Tensor:
  """The whole stream (B, S, D) ahead of a column-parallel projection:
  under a split stream the positions' rows all-gathered, else x."""
  pos = position()
  if pos is None or not pos.split:
    return x
  return _gather(x, 1)


def seq_local(x: Tensor) -> Tensor:
  """This position's rows of a whole (B, S, ...) stream when the stream is
  split, else x."""
  pos = position()
  if pos is None or not pos.split:
    return x
  return x[:, _rows(pos, x.shape[1])]


def end_stream(x: Tensor) -> Tensor:
  """The whole stream after the last block (the stream is replicated over
  the line again)."""
  pos = position()
  if pos is None or not pos.split:
    return x
  pos.split = False
  return _gather(x, 1)


def gather_heads(tensors: tuple, n_heads: int, n_kv: int, dim: int,
                 kv: tuple, term: str = "decode_attn_all_reduce") -> tuple:
  """All heads of each tensor of ``tensors`` whose ``dim`` holds this
  position's query heads (its ``kv`` entry False) or kv heads (True) of
  ``head_range``, in one meeting (an all-gather charged to ``term``):
  each head from the first position that holds it (replicated kv heads
  are held by several)."""
  pos = position()
  if pos is None:
    return tensors
  size, dev = pos.size, tensors[0].device

  def assemble(parts):
    out = []
    for i, is_kv in enumerate(kv):
      pieces, done = [], 0
      for r, p in enumerate(parts):
        lo, hi = head_range(n_heads, n_kv, r, size)[1 if is_kv else 0]
        if hi > done:
          pieces.append(p[i].narrow(dim, done - lo, hi - done).to(dev))
          done = hi
      out.append(torch.cat(pieces, dim=dim))
    return tuple(out)
  return pos.group.meet(pos.rank, tuple(tensors), assemble, term=term,
                        kind="all-gather")


def vocab_start(vocab: int) -> int:
  """The first (padded) vocab row of this position's piece of a (tp, None)
  embedding or head: the ceil-sized pieces ``placement.piece_box``
  cuts."""
  pos = position()
  if pos is None:
    return 0
  return min(vocab, pos.rank * -(-vocab // pos.size))


def embed(table: Tensor, tokens: Tensor, vocab: int,
          dtype: torch.dtype) -> Tensor:
  """table[tokens] in ``dtype``.  On a position ``table`` is its vocab
  piece: each position gives its rows and zeros elsewhere, and the f32 sum
  over the line (one nonzero term per token) is exact."""
  pos = position()
  if pos is None:
    return table[tokens].to(dtype)
  local = tokens - vocab_start(vocab)
  inside = (local >= 0) & (local < table.shape[0])
  rows = table[local.clamp(0, max(table.shape[0] - 1, 0))].float()
  return tp_sum(torch.where(inside[..., None], rows, 0.0), dtype,
                "tp_embed_all_reduce")


def gather_vocab(logits: Tensor) -> Tensor:
  """Logits (..., V) over the whole padded vocab, all-gathered from the
  positions' pieces."""
  return (logits if position() is None else
          _gather(logits, -1, "tp_logits_all_gather"))


def vocab_argmax(logits: Tensor, vocab: int) -> Tensor:
  """argmax over the last dim of the whole padded vocab, as int64.  On a
  position each piece's (max, argmax) is merged over the line in position
  order with ties to the earlier piece, i.e. the lowest global index: the
  one-device ``argmax`` bit for bit."""
  pos = position()
  idx = torch.argmax(logits, dim=-1)
  if pos is None:
    return idx
  val = torch.gather(logits, -1, idx[..., None])[..., 0]
  dev = logits.device

  def merge(parts):
    best_v, best_i = None, None
    for v, i in parts:
      v, i = v.to(dev), i.to(dev)
      if best_v is None:
        best_v, best_i = v, i
      else:
        take = v > best_v
        best_v, best_i = torch.where(take, v, best_v), torch.where(
            take, i, best_i)
    return best_i
  return pos.group.meet(pos.rank, (val, idx + vocab_start(vocab)), merge,
                        term="tp_stats_all_reduce", kind="all-reduce")


class _LogsumexpGrad(torch.autograd.Function):
  """A zero whose backward is ``torch.logsumexp``'s for one vocab piece:
  g · exp(l − logz), given the merged ``logz``.  Added to the merged value
  through ``tp_sum`` (whose backward hands g to every position's term
  unchanged), it makes the line's log-sum-exp differentiable with the
  one-device rounding."""

  @staticmethod
  def forward(ctx, logits, logz):
    ctx.save_for_backward(logits, logz)
    return torch.zeros_like(logz)

  @staticmethod
  def backward(ctx, g):
    logits, logz = ctx.saved_tensors
    return g[..., None] * torch.exp(logits - logz[..., None]), None


def vocab_logsumexp(logits: Tensor) -> Tensor:
  """log Σ exp over the last dim of the whole padded vocab, in f32.  On a
  position ``logits`` is its vocab piece: each piece's max and Σ exp(l −
  max) meet as (...) statistics and merge in position order; the gradient
  comes back to each piece as g · exp(l − logz) (``_LogsumexpGrad``)."""
  logits = logits.float()
  pos = position()
  if pos is None:
    return torch.logsumexp(logits, dim=-1)
  dev = logits.device
  with torch.no_grad():
    m = logits.amax(dim=-1)
    s = torch.exp(logits - m[..., None]).sum(dim=-1)

    def merge(parts):
      parts = [(pm.to(dev), ps.to(dev)) for pm, ps in parts]
      top = parts[0][0]
      for pm, _ in parts[1:]:
        top = torch.maximum(top, pm)
      total = None
      for pm, ps in parts:
        term = ps * torch.exp(pm - top)
        total = term if total is None else total + term
      return top + torch.log(total)
    logz = pos.group.meet(pos.rank, (m, s), merge,
                          term="tp_stats_all_reduce", kind="all-reduce")
  if not (torch.is_grad_enabled() and logits.requires_grad):
    return logz
  return logz + tp_sum(_LogsumexpGrad.apply(logits, logz), torch.float32,
                       "tp_stats_all_reduce")


def vocab_gold(logits: Tensor, idx: Tensor, vocab: int) -> Tensor:
  """logits[..., idx] in f32 for indices into the whole padded vocab of
  ``vocab`` rows.  On a position the piece that holds an index gives it and
  the others zero; their f32 sum over the line is exact."""
  pos = position()
  if pos is None:
    return torch.gather(logits.float(), -1, idx[..., None])[..., 0]
  local = idx - vocab_start(vocab)
  inside = (local >= 0) & (local < logits.shape[-1])
  at = local.clamp(0, max(logits.shape[-1] - 1, 0))
  picked = torch.gather(logits.float(), -1, at[..., None])[..., 0]
  return tp_sum(torch.where(inside, picked, 0.0), torch.float32,
                "tp_stats_all_reduce")


def rms_norm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
  """RMS normalisation in f32, cast back to x's dtype."""
  dt = x.dtype
  x = x.float()
  x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
  return (x * scale.float()).to(dt)


def rms_norm_wide(x: Tensor, scale: Tensor, eps: float) -> Tensor:
  """``rms_norm`` over a last dim cut over the model axis: on a position
  the mean square is the line's f32 sum of squares (an all-reduce of a
  (..., 1) statistic) over the whole width, and ``scale`` is the
  position's slice."""
  pos = position()
  if pos is None:
    return rms_norm(x, scale, eps)
  dt = x.dtype
  x = x.float()
  ss = tp_sum(torch.sum(x * x, dim=-1, keepdim=True), torch.float32,
              "tp_stats_all_reduce")
  x = x * torch.rsqrt(ss / (x.shape[-1] * pos.size) + eps)
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
