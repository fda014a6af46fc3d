"""Capture-safety rules: no host sync on the launch paths, cache-key coverage.

Counterpart of ``repro/analysis/trace_rules.py``.  The reference guards its
``jax.jit``/Pallas regions against trace-time concretization; the port has
no tracer, so the same pass guards the regions that must stay free of host
synchronisation — the kernels' launch paths, which a CUDA graph would
capture and which the serving loop issues asynchronously.

``capture-safety`` analyzes every function declared in ``SYNC_FREE`` (the
roots are declared: nothing in the source marks a captured region) and
the same-module functions that receive tensors from one of them
(one-module call-graph propagation, as the reference propagates tracers).
A value is a tensor when it is a root's declared tensor parameter, a
parameter annotated ``Tensor``, or computed from a tensor; shape and
metadata extractions (``.shape``, ``.dim()``, ``.ndim``, ``.dtype``,
``.device``, ``.numel()``, ``.stride()``, ``.data_ptr()``, ``len()``) are
host values, and so is the result of a function whose return annotation
names no tensor.  Flagged on a tensor:

  * **host reads** — ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``float()``/``int()``/``bool()``, ``np.*``;
  * **Python control flow on its value** — ``if``/``while``/``assert`` and
    conditional expressions;
  * **data-dependent shapes** — ``nonzero``, ``unique``, ``masked_select``,
    ``argwhere``, one-argument ``torch.where`` and boolean-mask indexing,
    whose output size the host must read back;

and anywhere on the path, ``synchronize()``.  A branch taken only for CPU
tensors (``if x.device.type == "cpu":``) runs the plain version, which no
graph captures; it is skipped.  The documented syncs — one per iteration
on the dispatch closure arm, one per chunk on the fused arm, the arena's
sweep — sit outside these roots by design.

``cache-key-coverage`` is the stale-program gate for serve_mmo/engine.py:
every knob fed to ``batching.make_batch_fn`` (the function the executable
cache builds) must either appear in the ``_exec_key`` tuple or be one of
the engine's declared immutable attributes (set in ``__init__`` and never
reassigned — which the rule also verifies).
"""
from __future__ import annotations

import ast
from typing import Optional

from repro_torch.analysis.core import Context, Finding, rule

__all__ = ["SYNC_FREE", "sync_free_roots", "analyze_function"]

# (module suffix, qualified function name) → the names of its tensor
# parameters, or None to take them from the ``Tensor`` annotations: the K1–K4
# wrappers and the arena's tick launch (the nested program that
# RequestArena.tick runs).
SYNC_FREE = {
    ("kernels/ops.py", "semiring_mmo"): None,
    ("kernels/ops.py", "flash_attention"): None,
    ("kernels/ops.py", "ssd_intra_chunk"): None,
    ("kernels/semiring_mmo.py", "semiring_mmo"): None,
    ("kernels/semiring_mmo.py", "_launch"): None,
    ("kernels/closure_megakernel.py", "fixpoint_chunk"): None,
    ("kernels/flash_attention.py", "flash_attention"): None,
    ("kernels/ssd.py", "ssd_intra_chunk"): None,
    ("serve_mmo/arena.py",
     "RequestArena._build_program_specs.make_tick.tick"): ("args",),
}

_STATIC_ATTRS = ("shape", "ndim", "dtype", "device", "is_cuda", "layout",
                 "type", "index")
_STATIC_METHODS = ("dim", "numel", "size", "stride", "data_ptr",
                   "is_contiguous", "element_size", "storage_offset",
                   "nelement", "get_device")
_STATIC_CALLS = ("len", "isinstance", "range", "type", "id", "callable",
                 "getattr", "hasattr")
_COERCIONS = ("float", "int", "bool")
_HOST_METHODS = ("item", "tolist", "cpu", "numpy")
_DYNAMIC_SHAPE = ("nonzero", "unique", "unique_consecutive", "masked_select",
                  "argwhere")
_MASK_CALLS = ("isnan", "isinf", "isfinite", "isneginf", "isposinf",
               "logical_and", "logical_or", "logical_not", "logical_xor",
               "eq", "ne", "lt", "le", "gt", "ge")


def _defs_by_qualname(tree) -> dict:
  """qualified name ('Cls.method.inner') → FunctionDef, every depth."""
  out = {}

  def walk(node, prefix):
    for child in ast.iter_child_nodes(node):
      if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
        name = f"{prefix}{child.name}"
        if not isinstance(child, ast.ClassDef):
          out[name] = child
        walk(child, name + ".")
      else:
        walk(child, prefix)

  walk(tree, "")
  return out


def _param_names(fn) -> list:
  a = fn.args
  names = [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)]
  if a.vararg is not None:
    names.append(a.vararg.arg)
  return names


def _names_tensor(annotation) -> bool:
  return annotation is not None and "Tensor" in ast.unparse(annotation)


def _annotated_tensors(fn) -> set:
  a = fn.args
  return {p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)
          if _names_tensor(p.annotation)}


def _returns_host(fn) -> bool:
  """A return annotation that names no tensor: the call's value is a host
  value whatever its arguments."""
  return fn.returns is not None and not _names_tensor(fn.returns)


def _imported_defs(ctx: Context, tree) -> dict:
  """local name → FunctionDef for ``from repro_torch.x import f`` where the
  module is in the scanned tree, so that a call to an imported function is
  judged by its return annotation too (``kernel_takes(t) -> bool``)."""
  out = {}
  for node in ast.walk(tree):
    if not (isinstance(node, ast.ImportFrom) and node.module):
      continue
    mod = ctx.module(node.module.replace(".", "/") + ".py")
    if mod is None:
      continue
    defs = _defs_by_qualname(mod.tree)
    for alias in node.names:
      fn = defs.get(alias.name)
      if fn is not None:
        out[alias.asname or alias.name] = fn
  return out


def sync_free_roots(ctx: Context, mod) -> list:
  """(FunctionDef, tensor-parameter set) for each SYNC_FREE root in
  ``mod``."""
  defs = _defs_by_qualname(mod.tree)
  roots = []
  for (suffix, qualname), params in SYNC_FREE.items():
    if not (mod.relpath == suffix or mod.relpath.endswith("/" + suffix)):
      continue
    fn = defs.get(qualname)
    if fn is not None:
      roots.append((fn, _annotated_tensors(fn) if params is None
                    else set(params)))
  return roots


def _call_name(call: ast.Call) -> Optional[str]:
  f = call.func
  if isinstance(f, ast.Name):
    return f.id
  if isinstance(f, ast.Attribute):
    return f.attr
  return None


def _is_cpu_test(test) -> bool:
  """``<x>.device.type == "cpu"``: the branch taken for CPU tensors."""
  return (isinstance(test, ast.Compare) and len(test.ops) == 1
          and isinstance(test.ops[0], ast.Eq)
          and isinstance(test.left, ast.Attribute)
          and test.left.attr == "type"
          and isinstance(test.left.value, ast.Attribute)
          and test.left.value.attr == "device"
          and isinstance(test.comparators[0], ast.Constant)
          and test.comparators[0].value == "cpu")


def analyze_function(fn, tensor_params: set, *, path: str,
                     callees: dict) -> tuple:
  """(findings, calls) — ``calls`` maps callee name → list of per-call
  arg-is-tensor tuples (positional) for call-graph propagation.
  ``callees`` maps the names a module calls to their FunctionDefs, whose
  return annotations say whether a call yields a host value."""
  findings = []
  calls: dict = {}
  tensors = set(tensor_params)
  masks: set = set()

  def is_tensor(node) -> bool:
    if node is None:
      return False
    if isinstance(node, ast.Name):
      return node.id in tensors
    if isinstance(node, ast.Constant):
      return False
    if isinstance(node, ast.Attribute):
      if node.attr in _STATIC_ATTRS:
        return False
      return is_tensor(node.value)
    if isinstance(node, ast.Compare):
      if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
        return False  # `x is None` tests the Python object, not the value
      return any(is_tensor(c) for c in (node.left, *node.comparators))
    if isinstance(node, ast.Call):
      fname = _call_name(node)
      if fname in _STATIC_CALLS:
        return False
      if isinstance(node.func, ast.Attribute) and fname in _STATIC_METHODS:
        return False
      target = callees.get(fname) if isinstance(node.func, ast.Name) else None
      if target is not None and _returns_host(target):
        return False
      recv = (is_tensor(node.func.value)
              if isinstance(node.func, ast.Attribute) else False)
      return (recv or any(is_tensor(a) for a in node.args)
              or any(is_tensor(kw.value) for kw in node.keywords))
    if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
      saved = set(tensors)
      for gen in node.generators:
        bind(gen.target, is_tensor(gen.iter))
      result = is_tensor(node.elt)
      tensors.clear()
      tensors.update(saved)
      return result
    return any(is_tensor(c) for c in ast.iter_child_nodes(node))

  def is_mask(node) -> bool:
    """A boolean tensor: a comparison or logical op of tensors."""
    if isinstance(node, ast.Name):
      return node.id in masks
    if isinstance(node, ast.Compare):
      return is_tensor(node)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.Invert,
                                                              ast.Not)):
      return is_mask(node.operand)
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.BitAnd,
                                                            ast.BitOr,
                                                            ast.BitXor)):
      return is_mask(node.left) or is_mask(node.right)
    if isinstance(node, ast.Call):
      return _call_name(node) in _MASK_CALLS and is_tensor(node)
    return False

  def bind(target, value_tensor: bool, value_mask: bool = False):
    for name in _target_names(target):
      (tensors.add if value_tensor else tensors.discard)(name)
      (masks.add if value_mask else masks.discard)(name)

  def _target_names(target):
    if isinstance(target, ast.Name):
      yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
      for e in target.elts:
        yield from _target_names(e)
    elif isinstance(target, ast.Starred):
      yield from _target_names(target.value)

  def flag(node, msg):
    findings.append(Finding(rule="capture-safety", path=path,
                            line=node.lineno, message=msg))

  def record_call(node: ast.Call):
    if isinstance(node.func, ast.Name):
      calls.setdefault(node.func.id, []).append(
          tuple(is_tensor(a) for a in node.args))

  def scan_expr(node):
    """Flag host reads, syncs and data-dependent shapes in an expression."""
    for sub in ast.walk(node):
      if isinstance(sub, ast.IfExp) and is_tensor(sub.test):
        flag(sub.test, f"a conditional expression on a tensor's value in "
                       f"sync-free `{fn.name}` reads it on the host")
      if isinstance(sub, ast.Subscript) and _mask_index(sub.slice):
        flag(sub, f"boolean-mask indexing in sync-free `{fn.name}` has a "
                  f"data-dependent shape the host must read back")
      if not isinstance(sub, ast.Call):
        continue
      record_call(sub)
      fname = _call_name(sub)
      args_tensor = (any(is_tensor(a) for a in sub.args)
                     or any(is_tensor(kw.value) for kw in sub.keywords))
      recv_tensor = (isinstance(sub.func, ast.Attribute)
                     and is_tensor(sub.func.value))
      if fname == "synchronize":
        flag(sub, f"`synchronize()` in sync-free `{fn.name}` blocks the host "
                  f"on the device")
      elif isinstance(sub.func, ast.Name) and fname in _COERCIONS and (
          args_tensor):
        flag(sub, f"`{fname}()` on a tensor in sync-free `{fn.name}` reads "
                  f"it on the host (a device sync)")
      elif fname in _HOST_METHODS and recv_tensor:
        flag(sub, f"`.{fname}()` on a tensor in sync-free `{fn.name}` "
                  f"copies it to the host (a device sync)")
      elif fname in _DYNAMIC_SHAPE and (recv_tensor or args_tensor):
        flag(sub, f"`{fname}` in sync-free `{fn.name}` has a data-dependent "
                  f"output shape the host must read back")
      elif (fname == "where" and len(sub.args) == 1 and not sub.keywords
            and args_tensor):
        flag(sub, f"one-argument `where` in sync-free `{fn.name}` has a "
                  f"data-dependent output shape the host must read back")
      elif (isinstance(sub.func, ast.Attribute)
            and isinstance(sub.func.value, ast.Name)
            and sub.func.value.id in ("np", "numpy") and args_tensor):
        flag(sub, f"`np.{sub.func.attr}` on a tensor in sync-free "
                  f"`{fn.name}` copies it to the host")

  def _mask_index(index) -> bool:
    elts = index.elts if isinstance(index, ast.Tuple) else [index]
    return any(is_mask(e) for e in elts)

  def scan_stmt(node):
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
      # nested defs (programs handed to a cache, helpers): parameters that
      # are annotated tensors are tensors; the body sees the closure's
      for p in _annotated_tensors(node):
        tensors.add(p)
      for s in node.body:
        scan_stmt(s)
      return
    if isinstance(node, ast.Assign):
      scan_expr(node.value)
      vt, vm = is_tensor(node.value), is_mask(node.value)
      for t in node.targets:
        bind(t, vt, vm)
      return
    if isinstance(node, (ast.AugAssign, ast.AnnAssign)):
      if node.value is not None:
        scan_expr(node.value)
        bind(node.target, is_tensor(node.value)
             or (isinstance(node, ast.AugAssign) and is_tensor(node.target)))
      return
    if isinstance(node, ast.If) and _is_cpu_test(node.test):
      for s in node.orelse:  # the CPU branch runs the plain version
        scan_stmt(s)
      return
    if isinstance(node, (ast.If, ast.While)):
      scan_expr(node.test)
      if is_tensor(node.test):
        kind = "if" if isinstance(node, ast.If) else "while"
        flag(node.test,
             f"Python `{kind}` on a tensor's value in sync-free `{fn.name}` "
             f"reads it on the host — use torch.where (or a static "
             f"operand)")
      for s in (*node.body, *node.orelse):
        scan_stmt(s)
      return
    if isinstance(node, ast.For):
      scan_expr(node.iter)
      bind(node.target, is_tensor(node.iter))
      for s in (*node.body, *node.orelse):
        scan_stmt(s)
      return
    if isinstance(node, ast.Assert):
      scan_expr(node.test)
      if is_tensor(node.test):
        flag(node.test,
             f"`assert` on a tensor's value in sync-free `{fn.name}` reads "
             f"it on the host")
      return
    for sub in ast.iter_child_nodes(node):
      if isinstance(sub, ast.expr):
        scan_expr(sub)
      elif isinstance(sub, ast.stmt):
        scan_stmt(sub)

  for stmt in fn.body:
    scan_stmt(stmt)
  return findings, calls


@rule("capture-safety", family="capture")
def _rule_capture_safety(ctx: Context) -> list:
  """No host sync or data-dependent shape on the kernels' launch paths."""
  out = []
  for mod in ctx.modules:
    roots = sync_free_roots(ctx, mod)
    if not roots:
      continue
    defs = {n.name: n for n in ast.walk(mod.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    callees = {**_imported_defs(ctx, mod.tree), **defs}
    root_names = {fn.name for fn, _ in roots}
    # worklist: function name → set of tensor param names (unioned over
    # call sites); seeded by the roots, propagated one module deep
    tensors_by_fn: dict = {}
    root_defs: dict = {}
    for fn, params in roots:
      tensors_by_fn[fn.name] = set(params)
      root_defs[fn.name] = fn
    findings_by_fn: dict = {}
    for _ in range(10):  # fixpoint over the same-module call graph
      changed = False
      for name, tp in sorted(tensors_by_fn.items()):
        fn = root_defs.get(name) or defs.get(name)
        if fn is None:
          continue
        findings, calls = analyze_function(fn, tp, path=mod.relpath,
                                           callees=callees)
        findings_by_fn[name] = findings
        for callee, sites in calls.items():
          target = defs.get(callee)
          if target is None or callee in root_names:
            continue
          params = [p for p in _param_names(target) if p != "self"]
          newly = {params[i]
                   for site in sites for i, t in enumerate(site)
                   if t and i < len(params)}
          if not newly:
            continue
          cur = tensors_by_fn.setdefault(callee, set())
          if not newly <= cur:
            cur |= newly
            changed = True
      if not changed:
        break
    seen = set()
    for findings in findings_by_fn.values():
      for f in findings:
        key = (f.line, f.message)
        if key not in seen:
          seen.add(key)
          out.append(f)
  return out


# ---------------------------------------------------------------------------
# cache-key coverage (serve_mmo/engine.py)
# ---------------------------------------------------------------------------

# engine attributes allowed to feed make_batch_fn WITHOUT being in the
# executable-cache key: immutable after __init__ (verified below).  ``mesh``
# is covered by ``_mesh_sig`` inside the key; ``device`` is fixed when the
# engine is built (one engine serves one device).
_ENGINE_CONSTANT_ATTRS = ("device", "mesh", "_mesh_sig")


def _names_and_self_attrs(node):
  names, attrs = set(), set()
  for sub in ast.walk(node):
    if isinstance(sub, ast.Attribute) and isinstance(sub.value, ast.Name) \
        and sub.value.id == "self":
      attrs.add(sub.attr)
    elif isinstance(sub, ast.Name) and sub.id != "self":
      names.add(sub.id)
  return names, attrs


@rule("cache-key-coverage", family="capture")
def _rule_cache_key_coverage(ctx: Context) -> list:
  """Every make_batch_fn knob must be in _exec_key or engine-constant."""
  mod = ctx.module("serve_mmo/engine.py")
  if mod is None:
    return []
  out = []
  engine = next((n for n in ast.walk(mod.tree)
                 if isinstance(n, ast.ClassDef) and n.name == "MMOEngine"),
                None)
  if engine is None:
    return out
  exec_key = next((n for n in engine.body
                   if isinstance(n, ast.FunctionDef)
                   and n.name == "_exec_key"), None)
  if exec_key is None:
    return [Finding(rule="cache-key-coverage", path=mod.relpath,
                    line=engine.lineno,
                    message="MMOEngine has no _exec_key method — the "
                            "executable cache has no keying discipline to "
                            "check")]
  key_names: set = set()
  key_attrs: set = set()
  for node in ast.walk(exec_key):
    if isinstance(node, ast.Return) and node.value is not None:
      n, a = _names_and_self_attrs(node.value)
      key_names |= n
      key_attrs |= a

  # sub-check: the declared engine constants must really be constant —
  # assigned in __init__ only
  for item in engine.body:
    if not isinstance(item, ast.FunctionDef) or item.name == "__init__":
      continue
    for node in ast.walk(item):
      targets = []
      if isinstance(node, ast.Assign):
        targets = node.targets
      elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        targets = [node.target]
      for t in targets:
        if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
            and t.value.id == "self" and t.attr in _ENGINE_CONSTANT_ATTRS:
          out.append(Finding(
              rule="cache-key-coverage", path=mod.relpath, line=node.lineno,
              message=f"MMOEngine.{item.name} reassigns self.{t.attr}, "
                      f"which cache-key coverage declares immutable — "
                      f"either stop reassigning it or add it to _exec_key"))

  # every make_batch_fn call: each arg's free names must come from the key
  # (lambda defaults like ``lambda s=schedule:`` are resolved through)
  lambda_defaults: dict = {}
  for node in ast.walk(engine):
    if isinstance(node, ast.Lambda):
      args = node.args
      pos = (*args.posonlyargs, *args.args)
      for p, d in zip(pos[len(pos) - len(args.defaults):], args.defaults):
        if isinstance(d, ast.Name):
          lambda_defaults[p.arg] = d.id
  for node in ast.walk(engine):
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, (ast.Name, ast.Attribute))
            and (node.func.id if isinstance(node.func, ast.Name)
                 else node.func.attr) == "make_batch_fn"):
      continue
    for value in (*node.args, *(kw.value for kw in node.keywords)):
      names, attrs = _names_and_self_attrs(value)
      names = {lambda_defaults.get(n, n) for n in names}
      loose_names = names - key_names
      loose_attrs = attrs - key_attrs - set(_ENGINE_CONSTANT_ATTRS)
      for n in sorted(loose_names):
        out.append(Finding(
            rule="cache-key-coverage", path=mod.relpath, line=value.lineno,
            message=f"make_batch_fn consumes `{n}`, which is not in the "
                    f"_exec_key tuple — two programs differing in `{n}` "
                    f"would share one executable-cache slot"))
      for a in sorted(loose_attrs):
        out.append(Finding(
            rule="cache-key-coverage", path=mod.relpath, line=value.lineno,
            message=f"make_batch_fn consumes `self.{a}`, which is neither "
                    f"in _exec_key nor a declared engine constant — "
                    f"stale-program hazard"))
  return out
