"""Fault-tolerant checkpointing: atomic-commit save, exact-resume restore.

Counterpart of ``repro/train/checkpoint.py``, with its layout on disk (one
directory per step):

    <dir>/step_00000420/
        meta.json            {step, paths, n_processes, extra}
        shard_p0.npz         flattened arrays
    <dir>/LATEST             committed pointer (written last — atomicity)

Writes go to ``step_X.tmp`` and are renamed only after fsync — a crash
mid-save can never corrupt the committed checkpoint (restart reads LATEST).
The state is a tree of dicts whose leaves are tensors or arrays; a list of
per-layer dicts (the port's ``blocks``, an enc-dec model's ``enc`` and
``dec``) is written as the reference's
stacked leaves (``params/blocks/attn/wq`` of shape (L, ...)), so either
package reads the other's checkpoint of the same arrays.  The port runs
one process and writes ``shard_p0.npz``.  A ``train.sharded.ShardedState``
is saved as the same tree ({'params', 'opt': {'m', 'v', 'step'}}), each
leaf gathered to the host, so a checkpoint does not depend on the mesh it
was written from; restoring with a sharded template cuts the leaves onto
that template's mesh.  The data pipeline is stateless (step-indexed), so
params + optimizer state + step is the whole state.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.train import sharded
from repro_torch.train.optimizer import tree_map


def _host(v) -> np.ndarray:
  if isinstance(v, torch.Tensor):
    return v.detach().cpu().numpy()
  return np.asarray(v)


def _flatten(tree, prefix: str = "") -> dict:
  """path → array; a list of layer dicts becomes stacked leaves."""
  if isinstance(tree, sharded.ShardedState):
    tree = tree.gathered("cpu")
  if isinstance(tree, dict):
    out = {}
    for k, v in tree.items():
      out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out
  if isinstance(tree, (list, tuple)):
    layers = [_flatten(sub, prefix) for sub in tree]
    return {path: np.stack([layer[path] for layer in layers])
            for path in layers[0]}
  return {prefix: _host(tree)}


def _unflatten(flat: dict) -> dict:
  root: dict = {}
  for path, v in flat.items():
    parts = path.split("/")
    cur = root
    for p in parts[:-1]:
      cur = cur.setdefault(p, {})
    cur[parts[-1]] = v
  return root


def _fit(template, value, device=None):
  """``value`` (the reference's layout, numpy) in ``template``'s shape: a
  list of layers is split along the leading axis, a tensor leaf becomes a
  tensor of the template's dtype on its device (or on ``device``)."""
  if isinstance(template, dict):
    return {k: _fit(t, value[k], device) for k, t in template.items()}
  if isinstance(template, (list, tuple)):
    return [_fit(t, _layer(value, i), device)
            for i, t in enumerate(template)]
  if isinstance(template, torch.Tensor):
    return torch.as_tensor(np.asarray(value)).to(device or template.device,
                                                 template.dtype)
  return np.asarray(value, getattr(template, "dtype", None))


def _shapes(x: "sharded.Sharded") -> torch.Tensor:
  return torch.empty(x.shape, dtype=x.dtype, device="meta")


def _layer(tree, i: int):
  if isinstance(tree, dict):
    return {k: _layer(v, i) for k, v in tree.items()}
  return tree[i]


def save(ckpt_dir: str, step: int, state: Any, extra: Optional[dict] = None):
  """Atomic checkpoint commit of a tree of dicts (and layer lists)."""
  os.makedirs(ckpt_dir, exist_ok=True)
  name = f"step_{step:08d}"
  tmp = os.path.join(ckpt_dir, name + ".tmp")
  final = os.path.join(ckpt_dir, name)
  if os.path.exists(tmp):
    shutil.rmtree(tmp)
  os.makedirs(tmp)

  arrays = _flatten(state)
  np.savez(os.path.join(tmp, "shard_p0.npz"), **arrays)
  meta = {
      "step": int(step),
      "paths": sorted(arrays),
      "n_processes": 1,
      "extra": extra or {},
  }
  with open(os.path.join(tmp, "meta.json"), "w") as f:
    json.dump(meta, f, indent=1)
    f.flush()
    os.fsync(f.fileno())
  if os.path.exists(final):
    shutil.rmtree(final)
  os.rename(tmp, final)
  # commit pointer last — readers never see a partial checkpoint
  latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
  with open(latest_tmp, "w") as f:
    f.write(name)
    f.flush()
    os.fsync(f.fileno())
  os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
  return final


def latest_step(ckpt_dir: str) -> Optional[int]:
  ptr = os.path.join(ckpt_dir, "LATEST")
  if not os.path.exists(ptr):
    return None
  with open(ptr) as f:
    return int(f.read().strip().split("_")[-1])


class AsyncCheckpointer:
  """Overlap checkpoint I/O with training: ``save`` snapshots the state to
  host memory synchronously and commits to disk on a worker thread.
  ``wait()`` joins the in-flight write (call before exit / next save)."""

  def __init__(self, ckpt_dir: str):
    self.ckpt_dir = ckpt_dir
    self._thread: Optional[threading.Thread] = None

  def save(self, step: int, state: Any, extra: Optional[dict] = None):
    self.wait()
    # a host copy, flat (``save`` flattens "a/b" keys to themselves): the
    # tensors may change at the next step
    host_state = {k: np.array(v, copy=True)
                  for k, v in _flatten(state).items()}
    self._thread = threading.Thread(
        target=save, args=(self.ckpt_dir, step, host_state, extra),
        daemon=True)
    self._thread.start()

  def wait(self):
    if self._thread is not None:
      self._thread.join()
      self._thread = None


def restore(ckpt_dir: str, template: Any = None, step: Optional[int] = None):
  """Returns (state, step).  ``template`` (a matching tree, layer lists
  included) restores its layout, dtypes and devices, or a ``ShardedState``
  its mesh and specs; without it, numpy arrays in the reference's stacked
  layout are returned."""
  if step is None:
    step = latest_step(ckpt_dir)
    if step is None:
      raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
  path = os.path.join(ckpt_dir, f"step_{step:08d}")
  with open(os.path.join(path, "meta.json")) as f:
    meta = json.load(f)
  with np.load(os.path.join(path, "shard_p0.npz")) as z:
    flat = {k: z[k] for k in z.files}
  state = _unflatten(flat)
  if isinstance(template, sharded.ShardedState):
    shapes = {"params": tree_map(_shapes, template.master),
              "opt": {"m": tree_map(_shapes, template.m),
                      "v": tree_map(_shapes, template.v),
                      "step": template.step}}
    host = _fit(shapes, state, "cpu")
    return sharded.shard_state(host["params"], template.specs, template.mesh,
                               host["opt"]), meta["step"]
  if template is not None:
    state = _fit(template, state)
  return state, meta["step"]
