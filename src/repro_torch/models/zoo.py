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

import contextlib
import dataclasses
import functools
import weakref
from typing import Callable, Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt_mod

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import common as cm
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import placement
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.roofline import collectives

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
  whole tensors, split over the data lines, or whole on every line where
  they do not split); the logits come back whole (the positions' vocab
  pieces gathered, the lines' rows concatenated, or line 0's) on the
  mesh's first device, the cache as a ``PerPosition``."""
  if isinstance(model, ShardedLM):
    def body(local, sub, c):
      logits, c, aux = forward(local, cfg, sub, mode=mode, cache=c,
                               impl=impl, remat=remat)
      return cm.gather_vocab(logits), c, aux
    if enc_out is not None:
      batch = dict(batch, enc_out=enc_out)
    out = model.run(body, batch, cache or PerPosition.of(model, None))
    return model.lines(out, 0), out.item(1), out[(0, 0)][2]
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
# tensor parallelism on a mesh: serving and training
# ---------------------------------------------------------------------------


# the modules that run as one layer: each gathers its fsdp-cut weights
_LAYERS = (tf_mod.Block, ssm_mod.SSMLayer, encdec_mod.EncoderLayer,
           encdec_mod.DecoderLayer)


class PerPosition(dict):
  """{(row, col): value} for every position of a mesh: the values a
  ``ShardedLM.run`` hands to, or gets from, each position as they are.
  ``replicated`` says whether the rows they hold are the whole batch on
  every data line (True), the line's share of it (False) or either
  (None)."""

  def __init__(self, *args, replicated: Optional[bool] = None):
    super().__init__(*args)
    self.replicated = replicated

  @classmethod
  def of(cls, model: "ShardedLM", value) -> "PerPosition":
    return cls({pos: value for pos in placement.positions(model.mesh)})

  def item(self, index) -> "PerPosition":
    """Each position's ``index``-th item, with this one's rows."""
    return PerPosition({pos: v[index] for pos, v in self.items()},
                       replicated=self.replicated)


def head_slice(path: str, ndim: int, cfg: cm.ModelConfig, rank: int,
                tp: int):
  """(dim, lo, hi): the part of a leaf that ``spec_for`` replicates over
  the model axis but position ``rank`` computes with only in part — the
  query biases of the query heads it holds, the kv biases (and the kv
  projections, when tp does not divide the kv heads) of the kv heads those
  query heads read, and the per-head SSM leaves of its heads; None for any
  other."""
  name = path.rsplit("/", 1)[-1]
  if name == "bq":
    (q0, q1), _ = cm.head_range(cfg.n_heads, cfg.n_kv_heads, rank, tp)
    return ndim - 2, q0, q1
  if name in ("bk", "bv") or (name in ("wk", "wv") and cfg.n_kv_heads % tp):
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
  """A model's weights on a mesh, and one module per position over that
  position's part of them, for tensor-parallel serving (``shard``) and
  training (``train.steps.make_train_step`` with ``mesh=``).

  ``weights`` is the parameter tree cut by ``common.specs_like`` (a tree
  of ``placement.Sharded``).  Position (i, j) computes with the part
  of each leaf that its model-axis index j selects: its own piece, or a
  view of it where the leaf is replicated but the position needs only its
  heads (``head_slice``).  With ``par.fsdp`` the layer leaves are also
  cut along ``data``: the position's module holds meta placeholders, and
  each layer gathers its part from the line's column just before it runs
  and frees it after (``common.whole_weights``).

  A batch that does not split over the data lines (``Parallelism.dp_for``
  None, as B = 1 in the long_500k cells) goes whole to every line
  (``run``); its caches take ``launch/specs.cache_specs``' 2-D cut (each
  line the group of kv heads its index selects, where the lines divide
  them), and each position also meets its column over the lines
  (``common.Position.column``) to assemble a decode step's heads.

  In training (``grads``, a ``train.sharded.PositionGrads``) every part a
  position computes with wants a gradient, and ``grads.add(path, pos,
  box, grad)`` receives it, ``box`` the part's slices of the whole leaf:
  an own part is a leaf parameter (a view of the f32 master) whose
  gradient is handed on once the backward has summed it; a part gathered
  along ``data`` hands on its gradient at each use
  (``placement.gather_part``).  Such a part is gathered in the dtype its
  layer computes in (``cfg.dtype``; f32 for the router, whose product runs
  in f32), which is the one-device cast at use, and the tensors the
  backward needs from it are kept as the recipe to gather them again
  (``_Regather``), so a position holds one layer's gathered weights at a
  time, as ZeRO-3 does.  With ``copy_dtype`` (``zero2``) every part is
  instead a copy in that dtype, gathered once when the positions are
  built, and a leaf parameter.  Each gather of a part along ``data`` (the
  forward's, the backward's regather, the recompute's, zero2's copy)
  reports an all-gather over the data axes to a
  ``roofline.collectives.CollectiveCounter`` that is on (``_fetch``).
  """

  cfg: cm.ModelConfig
  mesh: object
  par: cm.Parallelism
  weights: dict
  grads: Optional[object] = None
  copy_dtype: Optional[torch.dtype] = None
  modules: dict = dataclasses.field(init=False, repr=False)
  meetings: int = dataclasses.field(default=0, init=False)
  _regather: "_Regather" = dataclasses.field(init=False, repr=False)

  def __post_init__(self):
    self._regather = _Regather()
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
    data_key, lines = "+".join(self.par.data_axes), len(mesh.devices)
    gathers: dict = {}
    boxes: dict = {}
    regather = self._regather

    def leaf(path, x):
      spec = tuple(None if set(placement.names(e)) & data else e
                   for e in x.spec)
      box = list(placement.piece_box(x.shape, spec, mesh, pos))
      cut = head_slice(path, len(box), cfg, pos[1], tp)
      if cut is not None:
        dim, lo, hi = cut
        box[dim] = slice(box[dim].start + lo, box[dim].start + hi)
      box = boxes[path] = tuple(box)
      own = x.box(pos)
      inside = all(o.start <= b.start and b.stop <= o.stop
                   for o, b in zip(own, box))
      if inside:
        sources = [(own, x.pieces[pos])]
        if self.copy_dtype is not None:
          return placement.assemble(box, sources, dev, self.copy_dtype)
        return x.pieces[pos][tuple(slice(b.start - o.start, b.stop - o.start)
                                   for b, o in zip(box, own))]
      sources = [(x.box(p), x.pieces[p]) for p in x.distinct()]

      def fetch(dtype):
        return functools.partial(_fetch, box, sources, dev, dtype, pos,
                                 data_key, lines)
      if self.copy_dtype is not None:
        return fetch(self.copy_dtype)()
      placeholder = nn.Parameter(torch.empty(
          [b.stop - b.start for b in box], dtype=x.dtype, device="meta"),
          requires_grad=False)
      if self.grads is None:
        gathers[path] = (fetch(x.dtype), placeholder)
        return placeholder
      dtype = torch.float32 if path.endswith(F32_LEAVES) else cfg.dtype
      route = functools.partial(self.grads.add, path, pos, box)
      # no reference back to self: the step's gradient sums are freed with
      # the positions, without waiting for the cycle collector
      gathers[path] = (functools.partial(regather.gathered, fetch(dtype),
                                         route), placeholder)
      return placeholder

    module = from_params(cfg, _map_paths(leaf, self.weights, ""))
    if self.grads is not None:
      for name, p in module.named_parameters():
        path = name.replace(".", "/")
        if path in gathers:
          continue
        p.requires_grad_(True)
        p.register_post_accumulate_grad_hook(functools.partial(
            _hand_on, self.grads, path, pos, boxes[path]))
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

  def splits(self, rows: int) -> bool:
    """Whether a batch of ``rows`` splits over the data lines
    (``Parallelism.dp_for``); if not, every line computes all of it."""
    return self.par.dp_for(rows) is not None

  def _replicated(self, args) -> bool:
    """Whether this run's rows are the whole batch on every line: a whole
    tensor's batch that does not split, or ``PerPosition`` values held
    so; the two must agree."""
    says = set()

    def walk(value):
      if isinstance(value, PerPosition):
        if value.replicated is not None:
          says.add(value.replicated)
      elif isinstance(value, dict):
        for v in value.values():
          walk(v)
      elif isinstance(value, Tensor) and value.ndim:
        says.add(not self.splits(value.shape[0]))
    for a in args:
      walk(a)
    if len(says) > 1:
      raise ValueError("a run mixes a batch split over the data lines with "
                       "one that every line holds whole")
    return says == {True}

  def _rows(self, value, pos: tuple, whole: bool):
    """``value`` for position ``pos``: a ``PerPosition``'s entry, a dict's
    values each so, or on the position's device a whole tensor's rows of
    the position's data line (all of them when ``whole``)."""
    if isinstance(value, PerPosition):
      return value[pos]
    if isinstance(value, dict):
      return {k: self._rows(v, pos, whole) for k, v in value.items()}
    if not isinstance(value, Tensor):
      return value
    if not whole:
      n = value.shape[0] // len(self.mesh.devices)
      value = value[pos[0] * n:(pos[0] + 1) * n]
    return value.to(self.mesh.devices[pos[0]][pos[1]], non_blocking=True)

  def run(self, body: Callable, *args) -> PerPosition:
    """``body(module, *args)`` on every position, each in a thread of its
    own with its ``common.Position`` installed, the threads taking turns
    between meetings (``common.Baton``); each argument is taken per
    position (``_rows``).  A batch that does not split over the data lines
    (``Parallelism.dp_for`` is None: B = 1, say) goes whole to every line,
    as the reference replicates it.  Returns the results as a
    ``PerPosition`` (``replicated`` set so); ``meetings`` counts the
    meetings the first line has held over the runs.  In training a
    checkpointed layer's recompute runs to its end (no early stop), so
    that its gathered weights are released."""
    order = placement.positions(self.mesh)
    lines, tp = len(self.mesh.devices), self.par.tp_size
    whole = self._replicated(args)
    if self.grads is not None:
      body = self._regather.around(body)
    baton = cm.Baton(order)
    groups = [cm.LineGroup(tp, baton, [(i, j) for j in range(tp)],
                           self.par.tp) for i in range(lines)]
    columns = [cm.LineGroup(lines, baton, [(i, j) for i in range(lines)],
                            "+".join(self.par.data_axes)) for j in range(tp)]
    jobs, devices = {}, {}
    for pos in order:
      mine = [self._rows(a, pos, whole) for a in args]
      jobs[pos] = functools.partial(body, self.modules[pos], *mine)
      jobs[pos].position = cm.Position(
          groups[pos[0]], pos[1], self.par.tp, self.par.seq_shard_decode,
          column=columns[pos[1]], line=pos[0])
      devices[pos] = self.mesh.devices[pos[0]][pos[1]]
    stop = (ckpt_mod.set_checkpoint_early_stop(False)
            if self.grads is not None else contextlib.nullcontext())
    with stop:
      out = PerPosition(cm.run_positions(jobs, devices), replicated=whole)
    self.meetings += groups[0].held
    return out

  def lines(self, out: PerPosition, index=None) -> Tensor:
    """The lines' first positions' results (their ``index``-th item when
    given), rows concatenated on the mesh's first device; where every
    line computed the whole batch, line 0's."""
    first = self.mesh.devices[0][0]
    n = 1 if out.replicated else len(self.mesh.devices)
    parts = [out[(i, 0)] if index is None else out[(i, 0)][index]
             for i in range(n)]
    return torch.cat([t.to(first) for t in parts])


def _map_paths(fn: Callable, tree, prefix: str):
  """``fn(path, leaf)`` over a tree of dicts and lists, paths as
  ``common.tree_paths`` gives them."""
  if isinstance(tree, dict):
    return {k: _map_paths(fn, v, f"{prefix}/{k}" if prefix else k)
            for k, v in tree.items()}
  if isinstance(tree, list):
    return [_map_paths(fn, v, f"{prefix}/{i}") for i, v in enumerate(tree)]
  return fn(prefix, tree)


# leaves the block code computes with in f32 (``moe._route``)
F32_LEAVES = ("router",)


def _fetch(box: tuple, sources, device, dtype: torch.dtype, pos: tuple,
           axis: str, lines: int) -> Tensor:
  """Position ``pos``'s part ``box`` copied together from the pieces along
  the data axes (``placement.assemble``): one all-gather over ``lines``
  positions, reported to a ``CollectiveCounter`` that is on."""
  part = placement.assemble(box, sources, device, dtype)
  collectives.record("fsdp_all_gather", axis, "all-gather",
                     collectives.tensor_bytes(part), lines, pos)
  return part


class _Regather:
  """Saved-tensor hooks for training on a mesh: a tensor that the backward
  needs and that is (a view of) a part gathered along ``data`` for one
  layer is saved as the recipe to gather it again, not kept alive; the
  backward's unpacking gathers it anew.  Parts are known by their storage
  while they live (a weak reference, so a freed part is never matched)."""

  def __init__(self):
    self._live: dict = {}

  def gathered(self, fetch: Callable, route) -> Tensor:
    """``placement.gather_part(fetch, route)``, known by its storage while
    it lives, with ``fetch`` as the recipe to gather it again."""
    t = placement.gather_part(fetch, route)
    if not t.numel():
      return t
    key = (t.device, t.untyped_storage().data_ptr())
    self._live[key] = (weakref.ref(t), fetch)
    return t

  def _pack(self, t: Tensor):
    key = (t.device, t.untyped_storage().data_ptr())
    hit = self._live.get(key)
    if hit is None:
      return t
    part = hit[0]()
    if part is None or part.untyped_storage().data_ptr() != key[1]:
      del self._live[key]
      return t
    return hit[1], tuple(t.shape), t.stride(), t.storage_offset()

  @staticmethod
  def _unpack(saved):
    if isinstance(saved, Tensor):
      return saved
    again, shape, stride, offset = saved
    return again().as_strided(shape, stride, offset)

  def around(self, body: Callable) -> Callable:
    """``body`` with these hooks on for the saves it makes (the hooks are
    the calling thread's)."""
    @functools.wraps(body)
    def run(*args):
      with torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack):
        return body(*args)
    return run


def _hand_on(grads, path: str, pos: tuple, box: tuple, p: Tensor) -> None:
  """A position's leaf parameter's summed gradient, handed to ``grads``
  and dropped from the parameter."""
  g, p.grad = p.grad, None
  grads.add(path, pos, box, g)


def _gather_layer(layer, args):
  layer._whole = cm.whole_weights(layer)
  layer._whole.__enter__()


def _release_layer(layer, args, out):
  layer.__dict__.pop("_whole").__exit__(None, None, None)


def mesh_parallelism(mesh) -> cm.Parallelism:
  """``Parallelism`` of ``mesh``'s own axes and sizes with the reference's
  knobs (fsdp and ``seq_shard_decode`` on)."""
  return cm.Parallelism(data_axes=(mesh.axis_names[0],),
                        model_axis=mesh.axis_names[1],
                        tp_size=mesh.shape[mesh.axis_names[1]],
                        dp_size=mesh.shape[mesh.axis_names[0]])


def shard(cfg: cm.ModelConfig, model: nn.Module, mesh,
          par: Optional[cm.Parallelism] = None) -> ShardedLM:
  """``model``'s weights cut onto ``mesh`` by ``specs_like`` (copies; the
  model is untouched) for tensor-parallel serving.  ``par`` defaults to
  the mesh's own sizes with the reference's knobs (fsdp and
  ``seq_shard_decode`` on)."""
  par = mesh_parallelism(mesh) if par is None else par
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
  # the leaves' batch dim (dim 1) is cut over the data lines unless the
  # batch does not split (launch/specs.cache_specs)
  batch_cut = {spec[1] for spec in cm.tree_paths(specs).values()
               if len(spec) > 1}
  out = PerPosition(replicated=batch_cut == {None})
  for pos in placement.positions(mesh):
    dev = mesh.devices[pos[0]][pos[1]]

    def zeros(t, spec):
      box = placement.piece_box(t.shape, spec, mesh, pos)
      return torch.zeros([b.stop - b.start for b in box], dtype=t.dtype,
                         device=dev)
    out[pos] = placement.map2(zeros, whole, specs)
  return out
