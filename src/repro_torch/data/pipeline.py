"""Deterministic, stateless data pipeline.

Counterpart of ``repro/data/pipeline.py``.  Every batch is a pure function
of (seed, step, host shard) — there is no iterator state to checkpoint,
which is what makes checkpoint/restart exact: restoring ``step`` restores
the stream.  Two sources:

  * ``SyntheticLM``  — seeded token streams with local structure (each token
    is a noisy affine step from its predecessor mod V, so loss decreases and
    smoke training is meaningful).  The reference draws them from
    ``jax.random``'s threefry stream, which cannot be reproduced without
    JAX; this one has the same structure drawn from a ``torch.Generator``
    seeded by ``SeedSequence([seed, step, host])`` — the same rule, other
    tokens;
  * ``PackedCorpus`` — a memory-mapped uint16/uint32 token file, sampled by
    step-indexed offsets from numpy's ``SeedSequence([seed, step, host])``,
    bit for bit the reference's windows.

Per-host sharding: host h of H draws rows [h·B/H, (h+1)·B/H) of the global
batch.  Batches are int32 CPU tensors {'tokens', 'labels'} (B, S); the
train step moves them to its device.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
  vocab: int
  seq_len: int
  global_batch: int
  seed: int = 0
  corpus_path: Optional[str] = None


def _generator(seed: int, step: int, host: int) -> torch.Generator:
  state = np.random.SeedSequence([seed, step, host]).generate_state(2)
  return torch.Generator().manual_seed(
      int(state[0]) | (int(state[1]) & 0x7FFFFFFF) << 32)


class SyntheticLM:
  """Deterministic synthetic LM stream: the first token uniform in [0, V),
  then steps uniform in [1, 17), times 31 where a 10 % noise mask is set,
  summed mod V."""

  def __init__(self, cfg: DataConfig, n_hosts: int = 1, host_id: int = 0):
    if cfg.global_batch % n_hosts:
      raise ValueError(f"global batch {cfg.global_batch} does not split "
                       f"over {n_hosts} hosts")
    self.cfg = cfg
    self.n_hosts = n_hosts
    self.host_id = host_id

  def batch_at(self, step: int) -> dict:
    c = self.cfg
    b_local = c.global_batch // self.n_hosts
    gen = _generator(c.seed, step, self.host_id)
    first = torch.randint(0, c.vocab, (b_local, 1), generator=gen)
    steps = torch.randint(1, 17, (b_local, c.seq_len - 1), generator=gen)
    noise = torch.rand((b_local, c.seq_len - 1), generator=gen) < 0.1
    steps = torch.where(noise, steps * 31, steps)
    toks = (first + torch.cumsum(steps, dim=1)) % c.vocab
    tokens = torch.cat([first, toks], dim=1).to(torch.int32)
    return {"tokens": tokens, "labels": tokens}


class PackedCorpus:
  """Memory-mapped packed-token corpus, step-indexed window sampling."""

  def __init__(self, cfg: DataConfig, n_hosts: int = 1, host_id: int = 0,
               dtype=np.uint16):
    self.cfg = cfg
    self.n_hosts = n_hosts
    self.host_id = host_id
    self.data = np.memmap(cfg.corpus_path, dtype=dtype, mode="r")
    self.n_tokens = len(self.data)
    if self.n_tokens <= cfg.seq_len + 1:
      raise ValueError(f"corpus too small: {self.n_tokens} tokens for "
                       f"windows of {cfg.seq_len}")

  def batch_at(self, step: int) -> dict:
    c = self.cfg
    b_local = c.global_batch // self.n_hosts
    rng = np.random.default_rng(
        np.random.SeedSequence([c.seed, step, self.host_id]))
    starts = rng.integers(0, self.n_tokens - c.seq_len - 1, b_local)
    rows = np.stack([self.data[s:s + c.seq_len] for s in starts])
    tokens = torch.from_numpy(rows.astype(np.int32))
    return {"tokens": tokens, "labels": tokens}


class Prefetcher:
  """Step-ahead prefetch on a worker thread — hides host-side batch
  construction behind device compute.  Still stateless: wraps any
  ``batch_at`` source, so checkpoint/restart semantics are unchanged.  At
  most ``depth`` batches wait, in ``_ready`` under ``_lock``."""

  def __init__(self, source, depth: int = 2):
    self.source = source
    self.depth = depth
    self._lock = threading.Lock()
    self._ready: dict = {}  # step → batch built ahead

  def batch_at(self, step: int) -> dict:
    # the requested step if it was prefetched, else built now; then step+1
    # in the background
    with self._lock:
      batch = self._ready.pop(step, None)
      for s in [s for s in self._ready if s < step]:  # never asked for
        del self._ready[s]
    if batch is None:
      batch = self.source.batch_at(step)
    threading.Thread(target=self._prefetch, args=(step + 1,),
                     daemon=True).start()
    return batch

  def _prefetch(self, step: int):
    batch = self.source.batch_at(step)
    with self._lock:
      if len(self._ready) < self.depth:
        self._ready[step] = batch


def make_source(cfg: DataConfig, n_hosts: int = 1, host_id: int = 0,
                prefetch: int = 0):
  src = (PackedCorpus(cfg, n_hosts, host_id) if cfg.corpus_path
         else SyntheticLM(cfg, n_hosts, host_id))
  return Prefetcher(src, depth=prefetch) if prefetch else src
