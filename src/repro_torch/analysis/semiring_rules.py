"""AST rules for semiring-consistency: literal tables vs the live registry.

Counterpart of ``repro/analysis/semiring_rules.py``.  The codebase's
convention for per-ring constants is the *op-keyed dict* —
``{"minplus": ..., "maxmul": ..., ...}`` — in core/closure.py
(_SELF_VALUES / _MISSING_VALUES), core/semiring.py (_CONTRACTION_PADS),
and wherever the next subsystem grows one.  Three things can rot:

  * a new ring lands in the registry but a table is never extended
    (``semiring-table-coverage`` — every op-keyed dict must cover ALL_OPS
    exactly, no missing mnemonics, no unknown ones);
  * a pad pair stops satisfying ⊗(pa, pb) == ⊕-identity
    (``semiring-pad-consistency`` — any op-keyed dict of 2-tuples is
    treated as a pad table and re-verified numerically against the live
    registry operators; so is the CUDA kernels' ring table, the
    ``SIMD2_RING(OP, identity, pad_a, pad_b, …)`` f32 rows and the
    ``SIMD2_IRING(OP, identity, pad_b, …)`` int32 rows of every ``*.cuh``
    under the tree, each held to ``core.semiring.contraction_pads(op,
    dtype)`` and the ring's ⊕-identity in that dtype);
  * someone hardcodes an identity instead of reading the registry
    (``semiring-hardcoded-identity`` — ±inf literals in the modules that
    implement contraction/padding must come from an op-keyed table or the
    registry; a bare ``torch.inf`` accumulator init is exactly the bug class
    that silently corrupts one ring and not the other eight).

The numeric side of the family (law checking over adversarial floats)
lives in repro_torch.analysis.laws.
"""
from __future__ import annotations

import ast
import re
from typing import Optional

import numpy as np
import torch

from repro_torch.analysis.core import Context, Finding, rule
from repro_torch.core import semiring as sr_mod

__all__ = ["const_float", "op_keyed_dicts"]

# modules whose ±inf literals must be registry-sourced — the contraction /
# padding implementations (the kernels' wrappers, the sharded schedules and
# the arena's slot fill included) plus the sparse seed path.
# core/semiring.py is exempt: it IS the registry, its literals are the
# source of truth.
_IDENTITY_SCOPED = ("core/closure.py", "core/mmo.py", "core/sparse.py",
                    "core/distributed.py", "kernels/semiring_mmo.py",
                    "kernels/closure_megakernel.py", "serve_mmo/batching.py",
                    "serve_mmo/arena.py")

# a dict literal is "op-keyed" when it has at least this many registry
# mnemonics as keys (guards against flagging unrelated small dicts)
_MIN_OP_KEYS = 5


def const_float(node) -> Optional[float]:
  """Evaluate the constant-float spellings the repo uses, else None:
  literals, -x, float("inf"), float(np.inf), np.inf / math.inf / torch.inf."""
  if isinstance(node, ast.Constant) and isinstance(node.value, (int, float,
                                                                bool)):
    return float(node.value)
  if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
    inner = const_float(node.operand)
    return None if inner is None else -inner
  if isinstance(node, ast.Attribute) and node.attr in ("inf", "nan"):
    return float(node.attr)
  if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
      and node.func.id == "float" and len(node.args) == 1
      and not node.keywords):
    arg = node.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
      try:
        return float(arg.value)
      except ValueError:
        return None
    return const_float(arg)
  return None


def _dict_name(module_tree, dict_node) -> str:
  """Assignment-target name of a dict literal (for messages), else ''."""
  for node in ast.walk(module_tree):
    if isinstance(node, ast.Assign) and node.value is dict_node:
      targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
      if targets:
        return targets[0]
    if (isinstance(node, ast.AnnAssign) and node.value is dict_node
        and isinstance(node.target, ast.Name)):
      return node.target.id
  return ""


def op_keyed_dicts(module):
  """(dict node, name, {op: value node}) for every op-keyed dict literal."""
  out = []
  for node in ast.walk(module.tree):
    if not isinstance(node, ast.Dict):
      continue
    keys = {}
    for k, v in zip(node.keys, node.values):
      if isinstance(k, ast.Constant) and isinstance(k.value, str):
        keys[k.value] = v
    if sum(1 for k in keys if k in sr_mod.ALL_OPS) >= _MIN_OP_KEYS:
      out.append((node, _dict_name(module.tree, node), keys))
  return out


@rule("semiring-table-coverage", family="semiring")
def _rule_table_coverage(ctx: Context) -> list:
  """Every op-keyed dict must cover ALL_OPS exactly."""
  out = []
  registered = set(sr_mod.ALL_OPS)
  for mod in ctx.modules:
    for node, name, keys in op_keyed_dicts(mod):
      label = f"op-keyed table {name or '<anonymous>'}"
      missing = sorted(registered - set(keys))
      unknown = sorted(set(keys) - registered)
      if missing:
        out.append(Finding(
            rule="semiring-table-coverage", path=mod.relpath,
            line=node.lineno,
            message=f"{label} is missing registered op(s) "
                    f"{missing} — every ring needs an entry"))
      if unknown:
        out.append(Finding(
            rule="semiring-table-coverage", path=mod.relpath,
            line=node.lineno,
            message=f"{label} has key(s) {unknown} that are not in the "
                    f"semiring registry"))
  return out


@rule("semiring-pad-consistency", family="semiring")
def _rule_pad_consistency(ctx: Context) -> list:
  """Op-keyed pad-pair tables must satisfy ⊗(pa, pb) == ⊕-identity."""
  from repro_torch.analysis.laws import np_ops
  out = []
  for mod in ctx.modules:
    for node, name, keys in op_keyed_dicts(mod):
      label = name or "<anonymous>"
      for op, value in keys.items():
        if op not in sr_mod.ALL_OPS:
          continue
        if not (isinstance(value, (ast.Tuple, ast.List))
                and len(value.elts) == 2):
          continue  # not a pad-pair table entry
        pa, pb = (const_float(e) for e in value.elts)
        if pa is None or pb is None:
          continue  # non-constant pair: not a literal pad table
        sr = sr_mod.get(op)
        _, otimes = np_ops(sr)
        if sr.boolean:
          prod = float(otimes(np.bool_(pa), np.bool_(pb)))
          ident = float(np.bool_(sr.oplus_identity))
        else:
          prod = float(otimes(np.float64(pa), np.float64(pb)))
          ident = float(sr.oplus_identity)
        if np.isnan(prod) or prod != ident:
          out.append(Finding(
              rule="semiring-pad-consistency", path=mod.relpath,
              line=value.lineno,
              message=f"pad table {label}[{op!r}] == ({pa!r}, {pb!r}) but "
                      f"⊗(pa, pb) == {prod!r}, want the ⊕-identity "
                      f"{ident!r} — padded lanes would corrupt results"))
  for relpath, text in ctx.text_files("*.cuh"):
    out.extend(_kernel_ring_findings(relpath, text))
  return out


# The kernels' ring table (kernels/csrc/semiring_ring.cuh): one macro row
# per (ring, value type).  f32 rows spell (OP, identity, pad_a, pad_b, ⊕,
# step); int32 rows (OP, identity, pad_b, ⊕, step) with pad_a = identity.
_RING_ROW = re.compile(r"^SIMD2_RING\(\s*(\w+)\s*,\s*([^,]+?)\s*,\s*([^,]+?)"
                       r"\s*,\s*([^,]+?)\s*,", re.M)
_IRING_ROW = re.compile(r"^SIMD2_IRING\(\s*(\w+)\s*,\s*([^,]+?)\s*,"
                        r"\s*([^,]+?)\s*,", re.M)
_I32 = np.iinfo(np.int32)
_CUDA_CONSTANTS = {"pinf()": float("inf"), "ninf()": float("-inf"),
                   "I32_MAX": int(_I32.max), "I32_MIN": int(_I32.min)}


def _cuda_value(token: str):
  """A ring-table entry (``0.f``, ``pinf()``, ``I32_MAX``, ``1``) as a
  number, else None."""
  token = token.strip()
  if token in _CUDA_CONSTANTS:
    return _CUDA_CONSTANTS[token]
  try:
    return int(token, 0)
  except ValueError:
    pass
  try:
    return float(token.rstrip("fF"))
  except ValueError:
    return None


def _line_of(text: str, offset: int) -> int:
  return text.count("\n", 0, offset) + 1


def kernel_ring_rows(text: str) -> list:
  """(line, dtype name, op, identity, pad_a, pad_b) for every ring-table
  row of a CUDA source; values as ``_cuda_value`` reads them."""
  rows = []
  for m in _RING_ROW.finditer(text):
    opc, ident, pa, pb = m.groups()
    rows.append((_line_of(text, m.start()), "float32", opc.lower(),
                 _cuda_value(ident), _cuda_value(pa), _cuda_value(pb)))
  for m in _IRING_ROW.finditer(text):
    opc, ident, pb = m.groups()
    rows.append((_line_of(text, m.start()), "int32", opc.lower(),
                 _cuda_value(ident), _cuda_value(ident), _cuda_value(pb)))
  return rows


def _kernel_ring_findings(relpath: str, text: str) -> list:
  """The kernels' ring rows against the registry, per value type: the
  identity is the ⊕-identity (saturated for int32), (pad_a, pad_b) are
  ``contraction_pads(op, dtype)``, and ⊗(pad_a, pad_b) is the identity —
  for int32 in exact integer arithmetic, so a pair whose product wraps
  in two's complement is caught."""
  from repro_torch.analysis.laws import np_ops
  out = []
  for line, dtype, op, ident, pa, pb in kernel_ring_rows(text):
    label = f"kernel ring table {dtype} row {op.upper()}"

    def bad(msg, line=line):
      out.append(Finding(rule="semiring-pad-consistency", path=relpath,
                         line=line, message=f"{label}: {msg}"))

    if op not in sr_mod.ALL_OPS:
      bad(f"{op!r} is not in the semiring registry")
      continue
    if None in (ident, pa, pb):
      bad("an entry is not a constant this rule can read")
      continue
    sr = sr_mod.get(op)
    tdtype = torch.int32 if dtype == "int32" else None
    want_ident = (float(sr.oplus_identity) if tdtype is None else
                  sr_mod.oplus_identity(op, tdtype))
    want_pads = tuple(sr_mod.contraction_pads(op, tdtype))
    _, otimes = np_ops(sr)
    if tdtype is None:
      prod = float(otimes(np.float64(pa), np.float64(pb)))
    else:
      prod = int(otimes(np.int64(pa), np.int64(pb)))
    if ident != want_ident:
      bad(f"identity {ident!r}, but the registry's ⊕-identity in {dtype} "
          f"is {want_ident!r}")
    if (pa, pb) != want_pads:
      bad(f"pads ({pa!r}, {pb!r}), but contraction_pads({op!r}, {dtype}) "
          f"is {want_pads!r}")
    if np.isnan(prod) or prod != want_ident:
      bad(f"⊗(pad_a, pad_b) == {prod!r}, want the ⊕-identity "
          f"{want_ident!r} — padded lanes would corrupt results")
  return out


@rule("semiring-hardcoded-identity", family="semiring")
def _rule_hardcoded_identity(ctx: Context) -> list:
  """±inf literals in contraction/padding modules must be table-sourced."""
  out = []
  for mod in ctx.modules:
    if not any(mod.relpath.endswith(s) for s in _IDENTITY_SCOPED):
      continue
    table_spans = set()
    for node, _, _ in op_keyed_dicts(mod):
      table_spans.update(range(node.lineno, (node.end_lineno or node.lineno)
                               + 1))
    seen = set()
    for node in ast.walk(mod.tree):
      if isinstance(node, ast.Dict):
        continue
      value = None
      if isinstance(node, (ast.Call, ast.Attribute)):
        value = const_float(node)
      if value is None or not np.isinf(value):
        continue
      if node.lineno in table_spans or node.lineno in seen:
        continue
      seen.add(node.lineno)
      out.append(Finding(
          rule="semiring-hardcoded-identity", path=mod.relpath,
          line=node.lineno,
          message=f"hardcoded {value!r} outside an op-keyed table — "
                  f"semiring identities/pads must come from the "
                  f"core.semiring registry (one ring's identity is another "
                  f"ring's corruption)"))
  return out
