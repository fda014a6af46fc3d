"""FLOPs, bytes and live memory of a call, counted at dispatch.

Takes the place of the reference's ``hlo_walk.py``, which walks XLA's
optimized HLO to count a scanned program loop-correctly.  Torch emits no
HLO; eager torch dispatches every op of every loop iteration, so a count
at dispatch is loop-correct by construction: a Python loop of 16 M × M
matmuls counts 16 · 2M³.  Run the call on meta tensors and nothing is
computed or allocated.  ``CostCounter`` is a ``TorchDispatchMode`` that
counts, over the ops it sees:

  * ``flops`` — dot FLOPs (matmul, bmm, baddbmm, einsum through bmm,
    convolution, SDPA) by ``torch.utils.flop_counter``'s formulas, as
    ``hlo_walk`` counts dots only;
  * ``bytes`` — each op's input plus output bytes.  In eager execution each
    op goes through HBM, so this stands in for the reference's post-fusion
    traffic.  A view moves nothing; a gather (an indexed read, e.g. the
    embedding lookup) reads what it writes plus its indices; an indexed or
    copying write into an existing tensor (``copy_``, ``index_copy_``,
    ``index_put_``) reads and writes its source's bytes; an allocation
    (``empty``) moves nothing; an input that is a broadcast view reads at
    most its storage;
  * ``peak`` — the most bytes held at once by the outputs of the ops it saw
    (new tensors, not views or in-place results), each freed when its
    tensor is (``weakref.finalize``).  Inputs that existed before the call
    are not in it: it estimates the call's temporaries.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_aten = torch.ops.aten
# an indexed read: its input bytes are what it gathers
_GATHERS = {_aten.index.Tensor, _aten.embedding.default,
            _aten.gather.default, _aten.index_select.default,
            _aten.take_along_dim.default}
# an indexed or copying write into an existing tensor: the bytes moved are
# its source's (read once, written once)
_WRITES = {_aten.copy_.default, _aten.index_copy_.default,
           _aten.index_put_.default, _aten.scatter_.src}
# allocations: they hold memory but move no bytes
_ALLOCS = {_aten.empty.memory_format, _aten.empty_like.default,
           _aten.empty_strided.default, _aten.new_empty.default,
           _aten.new_empty_strided.default}


def tensor_bytes(t: torch.Tensor) -> int:
  return t.numel() * t.element_size()


def read_bytes(t: torch.Tensor) -> int:
  """Bytes an op reads from ``t``: its elements, or its storage when it is
  a broadcast view of fewer."""
  return min(tensor_bytes(t), t.untyped_storage().nbytes())


def _storage(t: torch.Tensor) -> int:
  """An id of ``t``'s storage (meta tensors have no data pointer)."""
  return t.untyped_storage()._cdata


def _tensors(tree) -> list:
  return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class CostCounter(TorchDispatchMode):
  """``with CostCounter() as c: fn(*meta_args)`` → c.flops, c.bytes,
  c.peak."""

  def __init__(self):
    super().__init__()
    self.flops = 0
    self.bytes = 0
    self.live = 0
    self.peak = 0

  def _free(self, nbytes: int) -> None:
    self.live -= nbytes

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    kwargs = kwargs or {}
    out = func(*args, **kwargs)
    packet = func._overloadpacket
    if packet in flop_registry:
      self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
    ins, outs = _tensors((args, kwargs)), _tensors(out)
    held = {_storage(t) for t in ins}
    fresh = [t for t in outs if _storage(t) not in held]
    if not fresh and not func._schema.is_mutable:
      return out  # a view or alias of an input moves nothing
    if func in _ALLOCS:
      pass
    elif func in _GATHERS:
      self.bytes += 2 * sum(map(tensor_bytes, fresh)) + sum(
          read_bytes(t) for t in ins[1:])
    elif func in _WRITES:
      dst, src = ins[0], ins[-1]
      written = tensor_bytes(dst if func is _aten.copy_.default else src)
      self.bytes += sum(read_bytes(t) for t in ins[1:]) + written
    else:
      self.bytes += sum(map(read_bytes, ins)) + sum(map(tensor_bytes, outs))
    for t in fresh:
      nbytes = tensor_bytes(t)
      self.live += nbytes
      weakref.finalize(t, self._free, nbytes)
    self.peak = max(self.peak, self.live)
    return out
