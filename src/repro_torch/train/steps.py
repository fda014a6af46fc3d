"""Train and serve step factories.

Counterpart of ``repro/train/steps.py``.  ``make_train_step`` builds a
(state, batch) → (state, metrics) function with:
  * next-token cross-entropy (+ the MoE load-balance aux, weight 0.01:
    the model's mean over its MoE layers, averaged over the microbatches
    like the loss; 0 for the dense, SSM and hybrid families),
  * gradient microbatching (sequential accumulation over ``accum`` slices
    — the compute/memory knob at fixed global batch),
  * AdamW with global-norm clip (``train.optimizer``).

The state is (model, opt_state) on one device: the model's parameters are
the f32 master, the forward computes in ``cfg.dtype`` by casting them at
each use, and the gradients come back through those casts in f32.  The
reference's mesh knobs keep its semantics there: ``grad_specs`` changes
nothing (a sharding constraint on one device), ``zero2`` (only with
``grad_specs``) differentiates with respect to ``cfg.dtype`` casts of the
master made once per step, and ``grad_comm_bf16`` rounds each
microbatch's gradients to bf16 and back before they are added up.

On a mesh (``mesh=``) the state is a ``train.sharded.ShardedState``: the
f32 master, both moments and the gradient sums are cut by the parameters'
specs over both axes, and the step is tensor-parallel.  Each microbatch's
rows split over the ``data`` axis; position (i, j) runs line i's rows
forward on its H/tp heads, its slice of the MLP, expert and SSM inner
widths and its vocab piece (a ``zoo.ShardedLM`` over the master, one
thread per position), computing with its own master pieces, with the
parts cut along ``data`` gathered layer by layer (ZeRO-3), or under
``zero2`` with a ``cfg.dtype`` copy of its part gathered once per step.
The positions of a line meet where the reference's GSPMD program
communicates, and the cross-entropy is vocab-parallel (each piece's
log-sum-exp statistics and the gold logit meet as (B, S) terms).  The
threads record one autograd graph per line; the step then runs one
backward per line, in line order, from its position 0's loss (every
position's copy of a meeting carries gradient into every partial, so one
copy is the whole gradient), with no meeting in it.  Each position's
gradients go straight into the master's pieces
(``train.sharded.PositionGrads``: summed in f32, rounded to bf16 for the
copy under ``grad_comm_bf16``); AdamW runs piece by piece.  The loss is
the global masked mean; the MoE aux is the mean of the lines' (the
reference takes its fractions over the whole batch).  Each microbatch must
split over the data lines.  ``remat`` ("full", "dots") checkpoints each
position's layers as on one device; the recompute runs inside the
backward, on autograd's thread, where no meeting can be held, so it
replays the results its forward's meetings recorded
(``common.remat_contexts``): the step's values and meetings are the
"none" step's, and "full" keeps those results besides each layer's input.
``make_prefill_step`` / ``make_decode_step`` are the two serving steps,
for every family's cache (dense, MoE, VLM and the enc-dec decoder's KV,
SSM state, hybrid both), on one device or tensor-parallel on a
``zoo.ShardedLM``, which serves a batch that does not split over its data
lines whole on every line (the reference's ``dp_for`` None).  A batch
carries ``src_embeds`` for the enc-dec family (its source frames) and, in
an enc-dec decode, the encoder output ``enc_out``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import common as cm
from repro_torch.models import placement
from repro_torch.models import transformer as tf_mod
from repro_torch.models import zoo
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import sharded

Tensor = torch.Tensor

# the reference's Pallas arms cannot be differentiated: jax.grad through
# its flash_attention kernel raises AssertionError, through ssd_intra_chunk
# "ValueError: Linearization failed"; K3 and K4 have no backward either
TRAIN_IMPLS = ("xla", "xla_autodiff")


def _mask(labels: Tensor, vocab: int) -> Tensor:
  return ((labels >= 0) & (labels < vocab)).float()


def xent_sum(logits: Tensor, labels: Tensor, vocab: int,
             padded: Optional[int] = None) -> Tensor:
  """Σ next-token cross-entropy · mask in f32; labels outside [0, vocab)
  (pad ids) are masked.  The log-sum-exp runs over the ``padded`` vocab
  (the logits' width on one device), as the reference's does.  On a mesh
  position ``logits`` is its vocab piece of the ``padded`` vocab and the
  terms meet over the line (``common.vocab_logsumexp``,
  ``common.vocab_gold``)."""
  if padded is None:
    if cm.position() is not None:
      raise ValueError("on a mesh position xent_sum needs the padded vocab")
    padded = logits.shape[-1]
  logits = logits.float()  # one f32 copy, saved for both terms' backward
  logz = cm.vocab_logsumexp(logits)
  idx = labels.long().clamp(0, padded - 1)
  gold = cm.vocab_gold(logits, idx, padded)
  return torch.sum((logz - gold) * _mask(labels, vocab))


def xent_loss(logits: Tensor, labels: Tensor, vocab: int) -> Tensor:
  """Mean next-token cross-entropy in f32 over the unmasked labels."""
  return xent_sum(logits, labels, vocab) / torch.clamp(
      _mask(labels, vocab).sum(), min=1.0)


def loss_fn(model, cfg: cm.ModelConfig, batch: dict, *, impl: str = "xla",
            remat: str = "none"):
  """(loss + 0.01·aux, (loss, aux)) of one batch {'tokens', 'labels'}
  (+ 'src_embeds' for enc-dec)."""
  logits, _, aux = zoo.forward(model, cfg, batch, mode="train", impl=impl,
                               remat=remat)
  loss = xent_loss(logits[:, :-1], batch["labels"][:, 1:], cfg.vocab)
  return loss + 0.01 * aux, (loss, aux)


def compute_copy(params, dtype: torch.dtype):
  """``dtype`` casts of the floating leaves of a parameter tree, detached
  (``zero2``'s compute copy)."""
  return opt_mod.tree_map(
      lambda p: p.detach().to(dtype) if p.is_floating_point() else p.detach(),
      params)


def make_train_step(cfg: cm.ModelConfig, oc: opt_mod.AdamWConfig, *,
                    accum: int = 1, impl: str = "xla", remat: str = "none",
                    grad_specs=None, zero2: bool = False,
                    grad_comm_bf16: bool = False, mesh=None):
  """Returns train_step(state, batch) → (state, metrics).

  With no ``mesh`` the state is (model, opt_state): the step turns
  gradients on for the model's parameters (the f32 master), moves the
  batch to the model's device, runs ``accum`` microbatches of
  ``batch_size / accum`` rows one after another, summing their f32
  gradients, then averages them and applies ``adamw_update`` in place.
  On a ``launch.mesh.Mesh`` the state is a ``ShardedState`` on that mesh
  (``train.sharded.shard_state``), updated in place by the
  tensor-parallel step (see the module's docstring); ``grad_specs``, when
  given, must be its specs, each microbatch must split over the data
  lines, and ``remat`` recomputes each position's layers in the backward
  from their recorded meetings.  Metrics are device tensors: ``loss``,
  ``aux_loss``, ``grad_norm``, ``lr``; on a mesh also ``meetings``, the
  number of meetings a data line's positions held in the step (an int).
  """
  if impl not in TRAIN_IMPLS:
    raise ValueError(
        f"make_train_step trains on impl in {TRAIN_IMPLS}, got {impl!r}: "
        f"K3 and K4 are forward kernels with no backward, as the "
        f"reference's Pallas arms cannot be differentiated")
  if accum < 1:
    raise ValueError(f"accum must be >= 1, got {accum}")
  # as in the reference, zero2 acts only with gradient specs to pin
  zero2 = zero2 and grad_specs is not None

  def grads_of(model, mb):
    """(f32 gradients of the model's leaves, loss, aux) of one batch."""
    leaves = opt_mod._leaves(zoo.param_tree(model))
    for p in leaves:
      p.requires_grad_(True)
    tot, (loss, aux) = loss_fn(model, cfg, mb, impl=impl, remat=remat)
    # a leaf the batch does not reach (the embedding, when the batch
    # carries embeddings) has a zero gradient, as under jax.grad
    grads = torch.autograd.grad(tot, leaves, allow_unused=True)
    return ([torch.zeros_like(p, dtype=torch.float32) if g is None
             else g.float() for p, g in zip(leaves, grads)],
            loss.detach(), aux.detach())

  def split(batch, b: int, parts: int, what: str) -> list:
    if b % parts:
      raise ValueError(f"batch of {b} rows does not split into {parts} "
                       f"{what}")
    n = b // parts
    return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            for i in range(parts)]

  def train_step(state, batch):
    model, opt_state = state
    params = zoo.param_tree(model)
    dev = opt_mod._leaves(params)[0].device
    batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
    # zero2: differentiate wrt the compute copy, made once per step
    fwd = zoo.from_params(cfg, compute_copy(params, cfg.dtype)) if zero2 \
        else model
    grads = loss = aux = None
    for mb in split(batch, batch["tokens"].shape[0], accum, "microbatches"):
      g, l_i, a_i = grads_of(fwd, mb)
      if grad_comm_bf16:
        g = [x.to(torch.bfloat16).float() for x in g]
      if grads is None:
        grads, loss, aux = g, l_i, a_i
      else:
        grads = [x + y for x, y in zip(grads, g)]
        loss, aux = loss + l_i, aux + a_i
    if accum > 1:
      grads = [g / accum for g in grads]
      loss, aux = loss / accum, aux / accum
    grad_tree = _unflatten_like(params, iter(grads))
    _, new_opt, om = opt_mod.adamw_update(oc, params, grad_tree, opt_state)
    return (model, new_opt), {"loss": loss, "aux_loss": aux, **om}

  vocab = tf_mod.padded_vocab(cfg)

  def position_loss(local, sub, count, aux_weight):
    """One position's part of a line's loss: (loss + 0.01·aux·aux_weight
    with its graph, loss, aux), the loss Σ nll·mask over ``count``."""
    logits, _, aux = zoo.forward(local, cfg, sub, mode="train", impl=impl,
                                 remat=remat)
    loss = xent_sum(logits[:, :-1], sub["labels"][:, 1:], cfg.vocab,
                    vocab) / count
    return (loss + 0.01 * aux * aux_weight, loss.detach(), aux.detach())

  def mesh_step(state, batch):
    if not isinstance(state, sharded.ShardedState) or state.mesh != mesh:
      raise TypeError("a train step on a mesh takes a ShardedState on that "
                      "mesh (train.sharded.shard_state)")
    if grad_specs is not None and grad_specs != state.specs:
      raise ValueError("grad_specs must equal the state's specs: the "
                       "gradients land in the master's layout")
    lines = len(mesh.devices)
    dev0 = mesh.devices[0][0]
    par = zoo.mesh_parallelism(mesh)
    sink = sharded.PositionGrads(state.master, par.tp, bf16=grad_comm_bf16)
    acc = sink.acc
    # the positions over the master (zero2: over their compute copies,
    # gathered here once per step)
    lm = zoo.ShardedLM(cfg, mesh, par, state.master, grads=sink,
                       copy_dtype=cfg.dtype if zero2 else None)
    loss = aux = 0.0
    for mb in split(batch, batch["tokens"].shape[0], accum, "microbatches"):
      if not lm.splits(mb["tokens"].shape[0]):
        raise ValueError(f"a microbatch of {mb['tokens'].shape[0]} rows "
                         f"does not split over {lines} data lines")
      # the global masked mean: every line divides by the microbatch's count
      count = torch.clamp(_mask(mb["labels"][:, 1:], cfg.vocab).sum(),
                          min=1.0)
      counts = zoo.PerPosition(  # copies that do not wait for the queue
          {(i, j): count.to(d, non_blocking=True)
           for i, row in enumerate(mesh.devices) for j, d in enumerate(row)})
      out = lm.run(position_loss, mb, counts,
                   zoo.PerPosition.of(lm, 1.0 / lines))
      for i in range(lines):
        tot, l_i, a_i = out[(i, 0)]
        torch.autograd.backward(tot)
        sink.flush()
        loss = loss + l_i.to(dev0)
        aux = aux + a_i.to(dev0) / lines
      del out
    sink.fill()
    if accum > 1:
      for x in opt_mod._leaves(acc):
        for piece in x.pieces.values():
          piece.div_(accum)
      loss, aux = loss / accum, aux / accum
    _, _, om = opt_mod.adamw_update(oc, state, acc)
    return state, {"loss": loss, "aux_loss": aux, **om,
                   "meetings": lm.meetings}

  return train_step if mesh is None else mesh_step


def _unflatten_like(tree, leaves):
  """``tree`` with its leaves replaced, in ``optimizer._leaves`` order."""
  if isinstance(tree, dict):
    return {k: _unflatten_like(tree[k], leaves) for k in sorted(tree)}
  if isinstance(tree, (list, tuple)):
    return [_unflatten_like(sub, leaves) for sub in tree]
  return next(leaves)


def make_prefill_step(cfg: cm.ModelConfig, *, impl: str = "xla"):
  """prefill_step(model, batch) → (last-position logits (B, V), cache).

  With a ``zoo.ShardedLM`` for ``model`` every position of its mesh runs
  the prefill on its heads and widths (K3 and K4 on ``impl="pallas"``);
  the logits stay where they were computed, as the reference's
  ``out_specs`` ``P(dp, tp)`` leave them: a ``placement.Sharded`` of the
  whole (B, padded V) whose piece at each position is its line's rows
  (every row where the batch does not split over the lines) of its vocab
  piece (``whole_logits`` gathers them); the cache comes back as a
  ``zoo.PerPosition`` of each position's (its kv heads, SSM heads and
  conv channels), for ``launch.serve.seat_cache``."""
  def body(local, sub):
    logits, cache, _ = zoo.forward(local, cfg, sub, mode="prefill",
                                   impl=impl)
    return logits[:, -1, :], cache

  def prefill_step(model, batch):
    if not isinstance(model, zoo.ShardedLM):
      return body(model, batch)
    out = model.run(body, batch)
    first = out[(0, 0)][0]
    rows = first.shape[0] * (1 if out.replicated else len(model.mesh.devices))
    spec = (None if out.replicated else model.par.dp, model.par.tp)
    logits = placement.Sharded(
        torch.Size((rows, tf_mod.padded_vocab(cfg))), first.dtype, spec,
        model.mesh, {pos: o[0] for pos, o in out.items()})
    return logits, out.item(1)
  return prefill_step


def whole_logits(logits, device=None) -> Tensor:
  """A prefill's last logits whole (B, padded V): a mesh prefill's vocab
  pieces gathered onto ``device`` (default the mesh's first device); a
  one-device prefill's tensor as it is."""
  if isinstance(logits, Tensor):
    return logits
  return sharded.gather_leaf(
      logits, logits.mesh.devices[0][0] if device is None else device)


def make_decode_step(cfg: cm.ModelConfig):
  """decode_step(model, cache, batch) → (greedy next token (B, 1) int32,
  cache).  ``batch`` is {'tokens': (B, 1)} (and, for enc-dec, 'enc_out');
  the cache is updated in place.

  With a ``zoo.ShardedLM`` for ``model`` the cache is ``seat_cache``'s
  ``zoo.PerPosition`` and an enc-dec batch's 'enc_out' one too; the greedy
  token is the positions' vocab-piece (max, argmax) merged with ties to
  the lowest index (``common.vocab_argmax``), the one-device argmax, and
  comes back on the mesh's first device."""
  vocab = tf_mod.padded_vocab(cfg)

  def body(local, c, sub):
    logits, c, _ = zoo.forward(local, cfg, sub, mode="decode", cache=c,
                               enc_out=sub.get("enc_out"))
    nxt = cm.vocab_argmax(logits[:, -1, :], vocab).to(torch.int32)
    return nxt[:, None], c

  def decode_step(model, cache, batch):
    if not isinstance(model, zoo.ShardedLM):
      return body(model, cache, batch)
    out = model.run(body, cache, batch)
    return model.lines(out, 0), zoo.PerPosition(
        {pos: o[1] for pos, o in out.items()})
  return decode_step
