"""AdamW with global-norm clipping and decoupled weight decay.

Counterpart of ``repro/train/optimizer.py``.  Parameters, gradients and
both moments are trees of tensors in the reference's layout
(``models.zoo.param_tree``: nested dicts, with ``blocks`` a list of
per-layer dicts where the reference stacks a layer axis); a leaf's path
is the reference's (``/blocks/attn/wq``), so the weight-decay mask and the
checkpoint see the same names.  The math is the reference's, in f32, with
the step count and the learning rate kept on the device: an update reads
nothing back to the host.  Unlike the reference's pure function,
``adamw_update`` writes the new parameters and moments in place, as a
torch optimizer does.

On a mesh the state is a ``train.sharded.ShardedState`` and the update
runs piece by piece on each position's device: the global norm sums each
element's square once (replicas counted once) on the mesh's first device,
the clip scalar goes back to every piece, and the elementwise update, the
decay mask by path and the schedule are the one-device step's.
"""
from __future__ import annotations

import dataclasses
import math

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
  lr: float = 3e-4
  b1: float = 0.9
  b2: float = 0.95
  eps: float = 1e-8
  weight_decay: float = 0.1
  grad_clip: float = 1.0
  warmup_steps: int = 100
  total_steps: int = 10000
  min_lr_ratio: float = 0.1


def lr_schedule(c: AdamWConfig, step: Tensor) -> Tensor:
  """Linear warmup → cosine decay to min_lr_ratio·lr (f32)."""
  step = step.float()
  warm = step / max(1.0, c.warmup_steps)
  prog = (step - c.warmup_steps) / max(1.0, c.total_steps - c.warmup_steps)
  prog = torch.clamp(prog, 0.0, 1.0)
  cos = c.min_lr_ratio + (1 - c.min_lr_ratio) * 0.5 * (
      1 + torch.cos(math.pi * prog))
  return c.lr * torch.where(step < c.warmup_steps, warm, cos)


def _leaves(tree) -> list:
  """The leaves in the reference's order (sorted keys, then layers)."""
  if isinstance(tree, dict):
    return [x for k in sorted(tree) for x in _leaves(tree[k])]
  if isinstance(tree, (list, tuple)):
    return [x for sub in tree for x in _leaves(sub)]
  return [tree]


def tree_map(fn, tree):
  """``fn`` over the leaves of a tree of dicts and lists."""
  if isinstance(tree, dict):
    return {k: tree_map(fn, v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return [tree_map(fn, v) for v in tree]
  return fn(tree)


def init_opt_state(params) -> dict:
  """Zeroed f32 moments shaped like ``params`` and an int32 step count, on
  the parameters' device."""
  leaves = _leaves(params)
  device = leaves[0].device if leaves else None

  def zeros(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

  return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
          "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> Tensor:
  """√(Σ x²) over every leaf, in f32."""
  return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                        for x in _leaves(tree)))


def _decay_mask(path: str) -> bool:
  """No weight decay on norms/biases/1-D scales (standard practice)."""
  needle = path.lower()
  return not any(s in needle for s in ("norm", "bias", "scale", "a_log",
                                       "dt_", "skip_d"))


def _paths(tree, prefix: str = ""):
  """The tree with each leaf replaced by its path; a list's layers share
  the list's path, as the reference's stacked leaf has one."""
  if isinstance(tree, dict):
    return {k: _paths(v, f"{prefix}/{k}") for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return [_paths(v, prefix) for v in tree]
  return prefix


def _scalars(c: AdamWConfig, gnorm: Tensor, step: Tensor) -> tuple:
  """(clip, lr, bc1, bc2) of the step after ``step``."""
  clip = torch.clamp(c.grad_clip / (gnorm + 1e-9), max=1.0)
  step = step + 1
  return (clip, lr_schedule(c, step), 1 - c.b1 ** step.float(),
          1 - c.b2 ** step.float())


def _update(c: AdamWConfig, decay: bool, p, g, m, v, clip, lr, bc1, bc2):
  """One leaf (or one piece of it) in place."""
  b1, b2 = c.b1, c.b2
  g = g.float() * clip
  p32 = p.float()
  m.copy_(b1 * m + (1 - b1) * g)
  v.copy_(b2 * v + (1 - b2) * g * g)
  delta = (m / bc1) / (torch.sqrt(v / bc2) + c.eps)
  if decay:
    delta = delta + c.weight_decay * p32
  p.copy_(p32 - lr * delta)


@torch.no_grad()
def adamw_update(c: AdamWConfig, params, grads, opt_state=None):
  """One AdamW step; returns (params, new_opt_state, metrics).

  ``params`` and the moments ``opt_state['m']``/``['v']`` are updated in
  place (and returned); ``opt_state['step']`` is replaced by step + 1.
  ``grads`` matches ``params``; metrics hold ``grad_norm`` (before the clip)
  and ``lr``, as tensors.

  ``params`` may be a ``ShardedState`` (no ``opt_state``: it holds the
  moments and the step), with ``grads`` a tree of ``Sharded`` f32 pieces
  cut as its master; the state is updated in place and returned twice.
  """
  from repro_torch.train.sharded import ShardedState
  if isinstance(params, ShardedState):
    return _adamw_sharded(c, params, grads)
  gnorm = global_norm(grads)
  clip, lr, bc1, bc2 = _scalars(c, gnorm, opt_state["step"])
  flat = zip(_leaves(_paths(params)), _leaves(params), _leaves(grads),
             _leaves(opt_state["m"]), _leaves(opt_state["v"]))
  for path, p, g, m, v in flat:
    _update(c, _decay_mask(path), p, g, m, v, clip, lr, bc1, bc2)
  new_opt = {"m": opt_state["m"], "v": opt_state["v"],
             "step": opt_state["step"] + 1}
  return params, new_opt, {"grad_norm": gnorm, "lr": lr}


def sharded_global_norm(grads, device) -> Tensor:
  """√(Σ x²) over a tree of ``Sharded`` pieces, each element once (one
  piece per distinct box), the pieces' sums added on ``device``."""
  return torch.sqrt(sum(
      torch.sum(torch.square(x.pieces[pos].float())).to(device)
      for x in _leaves(grads) for pos in x.distinct()))


def _adamw_sharded(c: AdamWConfig, state, grads):
  dev0 = state.mesh.devices[0][0]
  gnorm = sharded_global_norm(grads, dev0)
  scalars = _scalars(c, gnorm, state.step)
  on = {}
  flat = zip(_leaves(_paths(state.master)), _leaves(state.master),
             _leaves(grads), _leaves(state.m), _leaves(state.v))
  for path, p, g, m, v in flat:
    decay = _decay_mask(path)
    for pos, piece in p.pieces.items():
      dev = piece.device
      if dev not in on:  # the clip and the schedule, once per device
        on[dev] = [t.to(dev) for t in scalars]
      _update(c, decay, piece, g.pieces[pos], m.pieces[pos], v.pieces[pos],
              *on[dev])
  state.step = state.step + 1
  return state, state, {"grad_norm": gnorm, "lr": scalars[1]}
