"""Unified model API for the port's LM families (dense, MoE, VLM, SSM,
hybrid, enc-dec):

    model = zoo.init(cfg, generator, device)
    logits, cache, aux = zoo.forward(model, cfg, batch, mode=..., ...)

Counterpart of ``repro/models/zoo.py``.  ``batch`` is a dict
{'tokens': (B, S) int}, plus {'src_embeds': (B, S_src, D)} for the
enc-dec family (and, for the transformer families, precomputed embeddings
in place of the tokens), and for an enc-dec decode the encoder output
{'enc_out'} (or ``enc_out=``).  Caches keep the reference's layouts: dense
{'k', 'v': (L, B, max_len, KV, hd), 'len'} (enc-dec: the decoder's
self-attention, L = dec_layers); SSM {'ssm': {'ssm' (L, B, H, N, P) f32,
'conv' (L, B, K−1, d_inner), 'bc_conv' (L, B, K−1, 2GN)}, 'len'}; hybrid
{'ssm': the SSM state, 'attn': {'k', 'v': (n_apps, B, max_len, KV, hd)},
'len'}; each with an int32 scalar 'len'.  The MoE and VLM families run in
the dense family's ``TransformerLM``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch
from torch import nn

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import common as cm
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import placement
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf_mod

Tensor = torch.Tensor


def init_ssm_lm_params(generator: torch.Generator,
                       cfg: cm.ModelConfig) -> dict:
  """Random SSM-LM weights in the reference's layout, one dict per layer
  under ``blocks``, drawn from ``generator`` on its device."""
  vp, d = tf_mod.padded_vocab(cfg), cfg.d_model
  dev = cm.init_device(generator)

  def normal(shape, std):
    return (cm.randn(generator, shape) * std).to(cfg.param_dtype)

  def ones(shape):
    return torch.ones(shape, dtype=cfg.param_dtype, device=dev)

  return {
      "embed": normal((vp, d), 0.02),
      "final_norm_scale": ones(d),
      "blocks": [{"ln_norm_scale": ones(d),
                  "ssm": ssm_mod.ssm_params(generator, cfg)}
                 for _ in range(cfg.n_layers)],
      "lm_head": normal((vp, d), 0.02),
  }


class SSMLM(nn.Module):
  """Embedding, ``n_layers`` SSM layers, final norm and LM head (the
  reference's ``_init_ssm_lm`` / ``_forward_ssm_lm``)."""

  def __init__(self, cfg: cm.ModelConfig, params: dict):
    super().__init__()
    if cfg.family != "ssm":
      raise ValueError(f"{cfg.name} is a {cfg.family} config, not ssm")
    if len(params["blocks"]) != cfg.n_layers:
      raise ValueError(f"{len(params['blocks'])} blocks for a "
                       f"{cfg.n_layers}-layer config")
    self.cfg = cfg
    self.embed = nn.Parameter(params["embed"], requires_grad=False)
    self.final_norm_scale = nn.Parameter(params["final_norm_scale"],
                                         requires_grad=False)
    if not cfg.tie_embeddings:
      self.lm_head = nn.Parameter(params["lm_head"], requires_grad=False)
    self.blocks = nn.ModuleList(ssm_mod.SSMLayer(cfg, lp)
                                for lp in params["blocks"])

  def forward(self, tokens: Tensor, *, mode: str = "train",
              cache: Optional[dict] = None, impl: str = "xla",
              remat: str = "none"):
    """Returns (logits, new cache or None, aux loss).

    ``remat`` 'full' recomputes each layer in the backward; 'dots', like
    the reference's SSM stack, keeps every activation ('none').

    'train' gives logits for every position; 'prefill' only for the last
    one and the stacked state after the prompt as the cache; 'decode'
    takes S == 1 and an ``init_cache``-layout cache, whose per-layer states
    it updates in place and returns with ``len`` advanced.
    """
    cfg = self.cfg
    if remat not in tf_mod.REMATS:
      raise ValueError(f"remat must be one of {tf_mod.REMATS}, got {remat!r}")
    x = cm.embed(self.embed, tokens, tf_mod.padded_vocab(cfg), cfg.dtype)
    stacked = cache["ssm"] if cache is not None else None
    states = []
    for i, layer in enumerate(self.blocks):
      st = (None if stacked is None else
            {name: t[i] for name, t in stacked.items()})
      x = cm.constrain_acts(x)
      x, new_st = tf_mod.run_layer(layer, "full" if remat == "full" else
                                   "none", x, mode=mode, state=st, impl=impl)
      if mode == "decode":
        for name, t in new_st.items():
          st[name].copy_(t)
      states.append(new_st)
    x = cm.end_stream(x)
    if mode == "prefill":
      x = x[:, -1:]
    x = cm.rms_norm(x, self.final_norm_scale, cfg.norm_eps)
    logits = tf_mod.logits_from(self, cfg, x)
    new_cache = None
    if mode == "prefill":
      new_cache = {"ssm": {name: torch.stack([st[name] for st in states])
                           for name in states[0]},
                   "len": torch.full((), tokens.shape[1], dtype=torch.int32,
                                     device=x.device)}
    elif mode == "decode":
      new_cache = {"ssm": stacked, "len": cache["len"] + 1}
    return logits, new_cache, torch.zeros((), device=x.device)


def init(cfg: cm.ModelConfig, generator: Optional[torch.Generator],
         device=DEFAULT_DEVICE) -> nn.Module:
  """Random weights from ``generator`` (drawn on its device), on ``device``.

  ``generator=None`` with ``device="meta"`` builds the module with every
  parameter an empty meta tensor of its shape: nothing is drawn or
  allocated, at any size (the dry run's models)."""
  dev = resolve_device(device)
  if generator is None and dev.type != "meta":
    raise ValueError("with no generator the weights are not drawn: only "
                     "device='meta' builds such a model")
  if cfg.family == "ssm":
    params = init_ssm_lm_params(generator, cfg)
  elif cfg.family == "hybrid":
    params = hybrid_mod.init_hybrid_params(generator, cfg)
  elif cfg.family == "encdec":
    params = encdec_mod.init_encdec_params(generator, cfg)
  else:
    tf_mod.check_family(cfg)
    params = tf_mod.init_lm_params(generator, cfg)
  return from_params(cfg, params).to(dev)


def from_params(cfg: cm.ModelConfig, params: dict) -> nn.Module:
  """The module of ``cfg``'s family over ``params`` (``param_tree``'s
  layout): its parameters are those tensors themselves, not copies, on
  whatever device they lie."""
  if cfg.family == "ssm":
    return SSMLM(cfg, params)
  if cfg.family == "hybrid":
    return hybrid_mod.HybridLM(cfg, params)
  if cfg.family == "encdec":
    return encdec_mod.EncDecLM(cfg, params)
  tf_mod.check_family(cfg)
  return tf_mod.TransformerLM(cfg, params)


def forward(model, cfg: cm.ModelConfig, batch: dict, *,
            mode: str = "train", cache: Optional[dict] = None,
            enc_out: Optional[Tensor] = None, impl: str = "xla",
            remat: str = "none"):
  """Returns (logits, new_cache_or_None, aux_loss); ``model`` is
  ``init``'s module for ``cfg``'s family.  An enc-dec model reads
  ``batch['enc_out']`` ahead of ``enc_out`` and encodes
  ``batch['src_embeds']`` when neither is given.

  With a ``ShardedLM`` for ``model`` every position of its mesh runs its
  part (``cache`` and ``enc_out`` as ``PerPosition``s, or the batch's
  whole tensors, split over the data lines); the logits come back whole
  (the positions' vocab pieces gathered, the lines' rows concatenated) on
  the mesh's first device, the cache as a ``PerPosition``."""
  if isinstance(model, ShardedLM):
    def body(local, sub, c):
      logits, c, aux = forward(local, cfg, sub, mode=mode, cache=c,
                               impl=impl, remat=remat)
      return cm.gather_vocab(logits), c, aux
    if enc_out is not None:
      batch = dict(batch, enc_out=enc_out)
    out = model.run(body, batch, cache or PerPosition.of(model, None))
    return (model.lines(out, 0), PerPosition({k: o[1] for k, o in
                                               out.items()}),
            out[(0, 0)][2])
  if cfg.family == "encdec":
    return encdec_mod.forward_encdec(
        model, cfg, batch.get("src_embeds"), batch["tokens"], mode=mode,
        cache=cache, enc_out=batch.get("enc_out", enc_out), impl=impl,
        remat=remat)
  inputs = (batch.get("src_embeds", batch.get("tokens"))
            if cfg.family in tf_mod.FAMILIES else batch["tokens"])
  return model(inputs, mode=mode, cache=cache, impl=impl, remat=remat)


def param_tree(model: nn.Module) -> dict:
  """The model's parameters (the tensors themselves, not copies) in the
  reference's tree: ``embed``, ``final_norm_scale``, ``lm_head`` and
  ``blocks`` — here a list of per-layer dicts where the reference stacks
  each leaf along a leading layer axis — and a hybrid's ``shared``; an
  enc-dec model's ``enc`` and ``dec`` (lists of layers, as ``blocks``) and
  ``enc_norm_scale`` in place of ``blocks``."""
  tree: dict = {}
  for name, p in model.named_parameters():  # layers come in index order
    *path, leaf = name.split(".")
    node = tree
    for part, nxt in zip(path, path[1:] + [leaf]):
      if isinstance(node, list):
        if int(part) == len(node):
          node.append({})
        node = node[int(part)]
      else:
        node = node.setdefault(part, [] if nxt.isdigit() else {})
    node[leaf] = p
  return tree


def init_cache(cfg: cm.ModelConfig, batch: int, max_len: int,
               device=DEFAULT_DEVICE, *, mesh=None, specs=None):
  """A zeroed cache; ``max_len`` sizes the KV cache (dense, MoE, VLM, the
  enc-dec decoder's self-attention, and the hybrid's per application) and
  is not read by the SSM state, which has no length.

  With ``mesh``, a ``PerPosition`` of each position's part of it on the
  position's device, cut by ``specs`` (``launch/specs.cache_specs``'s tree:
  with ``seq_shard_decode`` the KV rows over the model axis; SSM heads and
  conv channels over it), which must divide every dimension they cut."""
  if mesh is not None:
    return _init_cache_on(cfg, batch, max_len, mesh, specs)
  dev = resolve_device(device)
  if cfg.family == "ssm":
    return {"ssm": ssm_mod.init_ssm_state(cfg, cfg.n_layers, batch,
                                          device=dev),
            "len": torch.zeros((), dtype=torch.int32, device=dev)}
  if cfg.family == "hybrid":
    return hybrid_mod.init_hybrid_cache(cfg, batch, max_len, device=dev)
  if cfg.family == "encdec":
    return attn_mod.init_cache(cfg, cfg.dec_layers, batch, max_len,
                               device=dev)
  tf_mod.check_family(cfg)
  return attn_mod.init_cache(cfg, cfg.n_layers, batch, max_len, device=dev)


def param_count(model: nn.Module) -> int:
  return sum(p.numel() for p in model.parameters())


# ---------------------------------------------------------------------------
# tensor-parallel serving on a mesh
# ---------------------------------------------------------------------------


# the modules that run as one layer: each gathers its fsdp-cut weights
_LAYERS = (tf_mod.Block, ssm_mod.SSMLayer, encdec_mod.EncoderLayer,
           encdec_mod.DecoderLayer)


class PerPosition(dict):
  """{(row, col): value} for every position of a mesh: the values a
  ``ShardedLM.run`` hands to, or gets from, each position as they are."""

  @classmethod
  def of(cls, model: "ShardedLM", value) -> "PerPosition":
    return cls({pos: value for pos in placement.positions(model.mesh)})


def _head_slice(path: str, ndim: int, cfg: cm.ModelConfig, rank: int,
                tp: int):
  """(dim, lo, hi): the part of a leaf that ``spec_for`` replicates over
  the model axis but position ``rank`` computes with only in part — the kv
  projections of the query heads it holds when tp does not divide the kv
  heads, and the per-head SSM leaves of its heads; None for any other."""
  name = path.rsplit("/", 1)[-1]
  if name in ("wk", "wv", "bk", "bv") and cfg.n_kv_heads % tp:
    _, (k0, k1) = cm.head_range(cfg.n_heads, cfg.n_kv_heads, rank, tp)
    return ndim - 2, k0, k1
  if "/ssm/" in path:
    (h0, h1), _ = cm.head_range(cfg.ssm_heads, cfg.ssm_ngroups, rank, tp)
    if name == "dt_proj":
      return ndim - 1, h0, h1
    if name in ("A_log", "dt_bias", "ssd_skip_D"):
      return 0, h0, h1
    if name == "ssd_norm_scale":
      return 0, h0 * cfg.ssm_headdim, h1 * cfg.ssm_headdim
  return None


@dataclasses.dataclass
class ShardedLM:
  """A model's weights on a mesh for tensor-parallel serving, and one
  module per position over that position's part of them (``shard``).

  ``weights`` is the parameter tree cut by ``common.specs_like`` (a tree
  of ``placement.Sharded``).  Position (i, j) computes with the part
  of each leaf that its model-axis index j selects: its own piece, or a
  view of it where the leaf is replicated but the position needs only its
  heads (``_head_slice``).  With ``par.fsdp`` the layer leaves are also
  cut along ``data``: the position's module holds meta placeholders, and
  each layer gathers its part from the line's column just before it runs
  and frees it after (``common.whole_weights``).
  """

  cfg: cm.ModelConfig
  mesh: object
  par: cm.Parallelism
  weights: dict
  modules: dict = dataclasses.field(init=False, repr=False)

  def __post_init__(self):
    names, sizes = self.mesh.axis_names, self.mesh.shape
    if (names != (self.par.dp, self.par.tp) or
        sizes[self.par.tp] != self.par.tp_size or
        sizes[self.par.dp] != self.par.dp_size):
      raise ValueError(f"Parallelism(data_axes={self.par.data_axes}, "
                       f"model_axis={self.par.tp!r}, tp_size="
                       f"{self.par.tp_size}, dp_size={self.par.dp_size}) "
                       f"does not describe the mesh {sizes}")
    self.modules = {pos: self._module(pos)
                    for pos in placement.positions(self.mesh)}

  def _module(self, pos: tuple) -> nn.Module:
    cfg, mesh, tp = self.cfg, self.mesh, self.par.tp_size
    dev = mesh.devices[pos[0]][pos[1]]
    data = set(self.par.data_axes)
    gathers: dict = {}

    def leaf(path, x):
      spec = tuple(None if set(placement.names(e)) & data else e
                   for e in x.spec)
      box = list(placement.piece_box(x.shape, spec, mesh, pos))
      cut = _head_slice(path, len(box), cfg, pos[1], tp)
      if cut is not None:
        dim, lo, hi = cut
        box[dim] = slice(box[dim].start + lo, box[dim].start + hi)
      own = x.box(pos)
      if all(o.start <= b.start and b.stop <= o.stop
             for o, b in zip(own, box)):
        return x.pieces[pos][tuple(slice(b.start - o.start, b.stop - o.start)
                                   for b, o in zip(box, own))]
      sources = [(x.box(p), x.pieces[p]) for p in x.distinct()]
      placeholder = nn.Parameter(torch.empty(
          [b.stop - b.start for b in box], dtype=x.dtype, device="meta"),
          requires_grad=False)
      gathers[path] = (lambda: placement.assemble(tuple(box), sources, dev,
                                                  x.dtype), placeholder)
      return placeholder

    def walk(tree, prefix):
      if isinstance(tree, dict):
        return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
      if isinstance(tree, list):
        return [walk(v, f"{prefix}/{i}") for i, v in enumerate(tree)]
      return leaf(prefix, tree)

    module = from_params(cfg, walk(self.weights, ""))
    for path, entry in gathers.items():
      *owner, name = path.split("/")
      sub = module.get_submodule(".".join(owner))
      sub.__dict__.setdefault("_gather", {})[name] = entry
      sub._parameters[name] = entry[1]
    if gathers:   # each layer gathers its weights as it runs
      for layer in module.modules():
        if layer is not module and isinstance(layer, _LAYERS):
          layer.register_forward_pre_hook(_gather_layer)
          layer.register_forward_hook(_release_layer)
    return module

  def _rows(self, value, pos: tuple):
    """``value`` for position ``pos``: a ``PerPosition``'s entry, a dict's
    values each so, or a whole tensor's rows of the position's data line
    on its device."""
    if isinstance(value, PerPosition):
      return value[pos]
    if isinstance(value, dict):
      return {k: self._rows(v, pos) for k, v in value.items()}
    if not isinstance(value, Tensor):
      return value
    lines, b = len(self.mesh.devices), value.shape[0]
    if b % lines:
      raise ValueError(f"a batch of {b} rows does not split over {lines} "
                       f"data lines")
    n = b // lines
    return value[pos[0] * n:(pos[0] + 1) * n].to(
        self.mesh.devices[pos[0]][pos[1]], non_blocking=True)

  def run(self, body: Callable, *args) -> PerPosition:
    """``body(module, *args)`` on every position, each in a thread of its
    own with its ``common.Position`` installed, the threads taking turns
    between meetings (``common.Baton``); each argument is taken per
    position (``_rows``).  Returns the results as a ``PerPosition``."""
    order = placement.positions(self.mesh)
    baton = cm.Baton(order)
    groups = [cm.LineGroup(self.par.tp_size, baton,
                           [(i, j) for j in range(self.par.tp_size)])
              for i in range(len(self.mesh.devices))]
    jobs, devices = {}, {}
    for pos in order:
      mine = [self._rows(a, pos) for a in args]
      jobs[pos] = functools.partial(body, self.modules[pos], *mine)
      jobs[pos].position = cm.Position(
          groups[pos[0]], pos[1], self.par.tp, self.par.seq_shard_decode)
      devices[pos] = self.mesh.devices[pos[0]][pos[1]]
    return PerPosition(cm.run_positions(jobs, devices))

  def lines(self, out: PerPosition, index=None) -> Tensor:
    """The lines' first positions' results (their ``index``-th item when
    given), rows concatenated on the mesh's first device."""
    first = self.mesh.devices[0][0]
    parts = [out[(i, 0)] if index is None else out[(i, 0)][index]
             for i in range(len(self.mesh.devices))]
    return torch.cat([t.to(first) for t in parts])


def _gather_layer(layer, args):
  layer._whole = cm.whole_weights(layer)
  layer._whole.__enter__()


def _release_layer(layer, args, out):
  layer.__dict__.pop("_whole").__exit__(None, None, None)


def shard(cfg: cm.ModelConfig, model: nn.Module, mesh,
          par: Optional[cm.Parallelism] = None) -> ShardedLM:
  """``model``'s weights cut onto ``mesh`` by ``specs_like`` (copies; the
  model is untouched) for tensor-parallel serving.  ``par`` defaults to
  the mesh's own sizes with the reference's knobs (fsdp and
  ``seq_shard_decode`` on)."""
  if par is None:
    par = cm.Parallelism(data_axes=(mesh.axis_names[0],),
                         model_axis=mesh.axis_names[1],
                         tp_size=mesh.shape[mesh.axis_names[1]],
                         dp_size=mesh.shape[mesh.axis_names[0]])
  params = param_tree(model)
  return ShardedLM(cfg, mesh, par, placement.shard_tree(
      params, cm.specs_like(params, cfg, par), mesh))


def _init_cache_on(cfg: cm.ModelConfig, batch: int, max_len: int, mesh,
                   specs) -> PerPosition:
  whole = init_cache(cfg, batch, max_len, device="meta")

  def check(t, spec):
    for dim, entry in zip(t.shape, spec):
      parts = 1
      for a in placement.names(entry):
        parts *= mesh.shape[a]
      if dim % parts:
        raise ValueError(f"a cache dimension of {dim} does not split over "
                         f"{parts} positions")
  placement.map2(check, whole, specs)
  out = PerPosition()
  for pos in placement.positions(mesh):
    dev = mesh.devices[pos[0]][pos[1]]

    def zeros(t, spec):
      box = placement.piece_box(t.shape, spec, mesh, pos)
      return torch.zeros([b.stop - b.start for b in box], dtype=t.dtype,
                         device=dev)
    out[pos] = placement.map2(zeros, whole, specs)
  return out
