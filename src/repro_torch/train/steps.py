"""Train and serve step factories.

Counterpart of ``repro/train/steps.py``.  ``make_train_step`` builds a
(state, batch) → (state, metrics) function with:
  * next-token cross-entropy (+ the MoE load-balance aux, weight 0.01:
    the model's mean over its MoE layers, averaged over the microbatches
    like the loss; 0 for the dense, SSM and hybrid families),
  * gradient microbatching (sequential accumulation over ``accum`` slices
    — the compute/memory knob at fixed global batch),
  * AdamW with global-norm clip (``train.optimizer``).

The state is (model, opt_state): the model's parameters are the f32
master, the forward computes in ``cfg.dtype`` by casting them at each use,
and the gradients come back through those casts in f32.  The step runs on
one device; the reference's mesh knobs (``grad_specs``, ``zero2``,
``grad_comm_bf16``) are ROADMAP item 13.6 and accepted only at their
no-mesh defaults.  ``make_prefill_step`` / ``make_decode_step`` are the
two serving steps, for every family's cache (dense, MoE, VLM and the
enc-dec decoder's KV, SSM state, hybrid both).  A batch carries
``src_embeds`` for the enc-dec family (its source frames) and, in an
enc-dec decode, the encoder output ``enc_out``.
"""
from __future__ import annotations

import torch

from repro_torch.models import common as cm
from repro_torch.models import zoo
from repro_torch.train import optimizer as opt_mod

Tensor = torch.Tensor

# the reference's Pallas arms cannot be differentiated: jax.grad through
# its flash_attention kernel raises AssertionError, through ssd_intra_chunk
# "ValueError: Linearization failed"; K3 and K4 have no backward either
TRAIN_IMPLS = ("xla", "xla_autodiff")


def xent_loss(logits: Tensor, labels: Tensor, vocab: int) -> Tensor:
  """Mean next-token cross-entropy in f32; labels outside [0, vocab) (pad
  ids) are masked."""
  logits = logits.float()
  logz = torch.logsumexp(logits, dim=-1)
  idx = labels.long().clamp(0, logits.shape[-1] - 1)
  gold = torch.gather(logits, -1, idx[..., None])[..., 0]
  mask = ((labels >= 0) & (labels < vocab)).float()
  return torch.sum((logz - gold) * mask) / torch.clamp(mask.sum(), min=1.0)


def loss_fn(model, cfg: cm.ModelConfig, batch: dict, *, impl: str = "xla",
            remat: str = "none"):
  """(loss + 0.01·aux, (loss, aux)) of one batch {'tokens', 'labels'}
  (+ 'src_embeds' for enc-dec)."""
  logits, _, aux = zoo.forward(model, cfg, batch, mode="train", impl=impl,
                               remat=remat)
  loss = xent_loss(logits[:, :-1], batch["labels"][:, 1:], cfg.vocab)
  return loss + 0.01 * aux, (loss, aux)


def make_train_step(cfg: cm.ModelConfig, oc: opt_mod.AdamWConfig, *,
                    accum: int = 1, impl: str = "xla", remat: str = "none",
                    grad_specs=None, zero2: bool = False,
                    grad_comm_bf16: bool = False):
  """Returns train_step((model, opt_state), batch) → (state, metrics).

  The step turns gradients on for the model's parameters (the f32 master),
  moves the batch to the model's device, runs ``accum`` microbatches of
  ``batch_size / accum`` rows one after another, summing their f32
  gradients, then averages them and applies ``adamw_update`` in place.
  Metrics are device tensors: ``loss``, ``aux_loss``, ``grad_norm``,
  ``lr``.
  """
  if impl not in TRAIN_IMPLS:
    raise ValueError(
        f"make_train_step trains on impl in {TRAIN_IMPLS}, got {impl!r}: "
        f"K3 and K4 are forward kernels with no backward, as the "
        f"reference's Pallas arms cannot be differentiated")
  if grad_specs is not None or zero2 or grad_comm_bf16:
    raise NotImplementedError(
        "grad_specs, zero2 and grad_comm_bf16 shard gradients over a mesh: "
        "the LM's sharding is ROADMAP item 13.6; the port's train step "
        "runs on one device")
  if accum < 1:
    raise ValueError(f"accum must be >= 1, got {accum}")

  def grads_of(model, leaves, mb):
    tot, (loss, aux) = loss_fn(model, cfg, mb, impl=impl, remat=remat)
    # a leaf the batch does not reach (the embedding, when the batch
    # carries embeddings) has a zero gradient, as under jax.grad
    grads = torch.autograd.grad(tot, leaves, allow_unused=True)
    return ([torch.zeros_like(p, dtype=torch.float32) if g is None
             else g.float() for p, g in zip(leaves, grads)],
            loss.detach(), aux.detach())

  def train_step(state, batch):
    model, opt_state = state
    params = zoo.param_tree(model)
    leaves = opt_mod._leaves(params)
    for p in leaves:
      p.requires_grad_(True)
    dev = leaves[0].device
    batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
    b = batch["tokens"].shape[0]
    if b % accum:
      raise ValueError(f"batch of {b} rows does not split into {accum} "
                       f"microbatches")
    if accum == 1:
      grads, loss, aux = grads_of(model, leaves, batch)
    else:
      grads = loss = aux = None
      for i in range(accum):
        rows = slice(i * (b // accum), (i + 1) * (b // accum))
        g, l_i, a_i = grads_of(model, leaves,
                               {k: v[rows] for k, v in batch.items()})
        if grads is None:
          grads, loss, aux = g, l_i, a_i
        else:
          grads = [x + y for x, y in zip(grads, g)]
          loss, aux = loss + l_i, aux + a_i
      grads = [g / accum for g in grads]
      loss, aux = loss / accum, aux / accum
    grad_tree = _unflatten_like(params, iter(grads))
    _, new_opt, om = opt_mod.adamw_update(oc, params, grad_tree, opt_state)
    return (model, new_opt), {"loss": loss, "aux_loss": aux, **om}

  return train_step


def _unflatten_like(tree, leaves):
  """``tree`` with its leaves replaced, in ``optimizer._leaves`` order."""
  if isinstance(tree, dict):
    return {k: _unflatten_like(tree[k], leaves) for k in sorted(tree)}
  if isinstance(tree, (list, tuple)):
    return [_unflatten_like(sub, leaves) for sub in tree]
  return next(leaves)


def make_prefill_step(cfg: cm.ModelConfig, *, impl: str = "xla"):
  """prefill_step(model, batch) → (last-position logits (B, V), cache)."""
  def prefill_step(model, batch):
    logits, cache, _ = zoo.forward(model, cfg, batch, mode="prefill",
                                   impl=impl)
    return logits[:, -1, :], cache
  return prefill_step


def make_decode_step(cfg: cm.ModelConfig):
  """decode_step(model, cache, batch) → (greedy next token (B, 1) int32,
  cache).  ``batch`` is {'tokens': (B, 1)} (and, for enc-dec, 'enc_out');
  the cache is updated in place."""
  def decode_step(model, cache, batch):
    logits, cache, _ = zoo.forward(model, cfg, batch, mode="decode",
                                   cache=cache, enc_out=batch.get("enc_out"))
    nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
    return nxt[:, None], cache
  return decode_step
