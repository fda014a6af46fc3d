"""Numeric semiring-law checker — algebra the AST cannot see.

Every registered (⊕, ⊗) pair is exercised over adversarial floats (±inf,
NaN, denormals) with *numpy mirrors* of the registry's torch operators — no
kernel runs, so the whole family runs in milliseconds:

  * ⊕ associativity and commutativity (exact for the min/max/or lattice
    reductions; tolerance-at-working-magnitude for float ``+``, which is
    only associative up to rounding — the honest IEEE statement of the law);
  * ⊕-identity (``x ⊕ id == x``) and ⊗-identity where the registry declares
    one (addnorm's squared difference has none — the paper's "beyond GEMM"
    op is deliberately not a true semiring);
  * the annihilator law ``⊗(id_⊕, x) == id_⊕`` over each ring's *value
    domain* — the domains below are the engine's data contract (e.g. the
    mul-rings carry positive reliabilities, so 0·(−inf) can never meet);
  * NaN propagation — neither operator may silently swallow a NaN;
  * K-pad invariance: ``⊗(pa, pb) == id_⊕`` pointwise AND a full padded
    contraction equals the unpadded one (the property every padded/ragged/
    bisected batch in serve_mmo rests on) — in f32 and again with the int32
    pads (``contraction_pads(op, torch.int32)``), where ⊗ wraps in two's
    complement: there ``⊗(pa, pb)`` must equal the saturated ⊕-identity
    without wrapping, as ``kernels/csrc/semiring_ring.cuh`` states;
  * closure-pad invariance: ``core.closure`` pads adjacencies with
    (_SELF_VALUES, _MISSING_VALUES) sentinels; squaring the padded matrix
    must reproduce the unpadded closure on the original block and may never
    manufacture NaN (this is how those tables are cross-checked — mma's
    "self" is 0, not the ⊗-identity, so a literal-equality check would be
    wrong where this behavioral one is right).

Findings anchor at the registry entry (core/semiring.py) or the sentinel
tables (core/closure.py) so a violation points at the table to fix.
Counterpart of ``repro/analysis/laws.py``.
"""
from __future__ import annotations

import numpy as np

import torch

from repro_torch.analysis.core import Context, Finding, rule
from repro_torch.core import closure as cl_mod
from repro_torch.core import semiring as sr_mod

__all__ = ["np_ops", "check_laws", "check_closure_pads", "LAW_DOMAINS"]

_INF = float("inf")

# Adversarial-but-valid operand sets per ring — each ring's *data contract*,
# i.e. the values the serving layer may actually contract.  Exclusions are
# deliberate and load-bearing:
#   minplus excludes -inf (inf + -inf = NaN; +inf spells "unreachable"),
#   maxplus symmetrically excludes +inf,
#   minmul/maxmul are positive-reliability rings: 0 and ±inf are excluded
#     as ⊗ operands because 0·inf = NaN and the ±inf ⊕-identities enter ⊗
#     only as K-pads (checked separately, as the (pa, pb) *pair*),
#   minmax/maxmin are pure lattice ops: the full extended line is legal.
_FINITE = [0.0, -0.0, 1.0, -1.0, 0.5, 3.0, 1e30, -1e30,
           5e-324, -5e-324, 2.2250738585072014e-308]
_POS = [5e-324, 2.2250738585072014e-308, 0.25, 0.5, 1.0, 3.0, 1e30]
LAW_DOMAINS = {
    "mma": _FINITE,
    "minplus": _FINITE + [_INF],
    "maxplus": _FINITE + [-_INF],
    "minmul": _POS + [_INF],
    "maxmul": _POS,
    "minmax": _FINITE + [_INF, -_INF],
    "maxmin": _FINITE + [_INF, -_INF],
    "orand": [False, True],
    "addnorm": _FINITE,
}


def np_ops(sr):
  """Numpy mirrors of one registry entry's (⊕, ⊗) torch operators."""
  table = {torch.add: np.add, torch.mul: np.multiply,
           torch.minimum: np.minimum, torch.maximum: np.maximum,
           torch.logical_or: np.logical_or, torch.logical_and: np.logical_and}
  oplus = table.get(sr.oplus)
  otimes = table.get(sr.otimes)
  if otimes is None and sr.otimes is sr_mod._sq_diff:
    otimes = lambda a, b: np.square(np.subtract(a, b))  # noqa: E731
  if oplus is None or otimes is None:
    raise NotImplementedError(
        f"no numpy mirror for {sr.name}'s operators — teach "
        f"repro_torch.analysis.laws.np_ops about them")
  return oplus, otimes


def _exact_oplus(sr) -> bool:
  """min/max/or reductions are exact on floats; ``+`` is only associative
  up to rounding."""
  return sr.oplus is not torch.add


def _eq(a, b, *, exact: bool, scale: float = 1.0) -> bool:
  a, b = float(a), float(b)
  if np.isnan(a) or np.isnan(b):
    return False
  if a == b:
    return True
  if exact:
    return False
  tol = 1e-9 * max(1.0, abs(scale))
  return abs(a - b) <= tol


def _anchor_line(module, needle: str) -> int:
  if module is None:
    return 1
  for i, text in enumerate(module.source.splitlines(), start=1):
    if needle in text:
      return i
  return 1


def check_laws(op: str) -> list:
  """Law-violation messages for one ring (empty = clean)."""
  sr = sr_mod.get(op)
  oplus, otimes = np_ops(sr)
  dom = [np.bool_(v) if sr.boolean else np.float64(v)
         for v in LAW_DOMAINS[op]]
  exact = _exact_oplus(sr)
  ident = np.bool_(False) if sr.boolean else np.float64(sr.oplus_identity)
  out = []

  def law(name, cond, detail):
    if not cond:
      out.append(f"{op}: {name} violated: {detail}")

  for a in dom:
    law("oplus-identity", _eq(oplus(a, ident), a, exact=True),
        f"{a!r} ⊕ id == {oplus(a, ident)!r}")
    for b in dom:
      law("oplus-commutativity",
          _eq(oplus(a, b), oplus(b, a), exact=True),
          f"{a!r} ⊕ {b!r} != {b!r} ⊕ {a!r}")
      for c in dom:
        scale = max(abs(float(a)), abs(float(b)), abs(float(c)), 1.0) \
            if not sr.boolean else 1.0
        law("oplus-associativity",
            _eq(oplus(oplus(a, b), c), oplus(a, oplus(b, c)),
                exact=exact, scale=scale),
            f"({a!r} ⊕ {b!r}) ⊕ {c!r} != {a!r} ⊕ ({b!r} ⊕ {c!r})")

  if sr.otimes_identity is not None:
    one = (np.bool_(bool(sr.otimes_identity)) if sr.boolean
           else np.float64(sr.otimes_identity))
    for a in dom:
      law("otimes-identity",
          _eq(otimes(one, a), a, exact=True)
          and _eq(otimes(a, one), a, exact=True),
          f"id_⊗ ⊗ {a!r} == {otimes(one, a)!r}")
    # annihilator only makes sense for rings with a true ⊗ (addnorm's
    # (id-x)² = x² breaks it by construction — and that is exactly why the
    # sparse layer must refuse addnorm seeds, see core/sparse.py)
    for a in dom:
      law("annihilator",
          _eq(otimes(ident, a), ident, exact=True)
          and _eq(otimes(a, ident), ident, exact=True),
          f"id_⊕ ⊗ {a!r} == {otimes(ident, a)!r}")

  if not sr.boolean:
    nan = np.float64(np.nan)
    for a in dom:
      law("nan-propagation",
          np.isnan(oplus(a, nan)) and np.isnan(oplus(nan, a))
          and np.isnan(otimes(a, nan)) and np.isnan(otimes(nan, a)),
          f"an operator swallowed NaN next to {a!r}")

  # -- K-pad invariance ------------------------------------------------------
  pa, pb = sr_mod.contraction_pads(op)
  if sr.boolean:
    pa, pb = np.bool_(pa), np.bool_(pb)
  else:
    pa, pb = np.float64(pa), np.float64(pb)
  prod = otimes(pa, pb)
  law("pad-product", not np.isnan(prod) and _eq(prod, ident, exact=True),
      f"⊗(pad_a={pa!r}, pad_b={pb!r}) == {prod!r}, want id_⊕ == {ident!r}")

  rng = np.random.default_rng(0)
  m, k, n, kpad = 3, 4, 3, 7
  a2 = _sample(rng, op, (m, k))
  b2 = _sample(rng, op, (k, n))
  ap = np.full((m, kpad), pa, dtype=a2.dtype)
  bp = np.full((kpad, n), pb, dtype=b2.dtype)
  ap[:, :k] = a2
  bp[:k, :] = b2
  base = _np_mmo(sr, a2, b2)
  padded = _np_mmo(sr, ap, bp)
  scale = 1.0 if sr.boolean else float(np.max(np.abs(
      base[np.isfinite(base)]), initial=1.0))
  law("kpad-invariance",
      all(_eq(x, y, exact=exact, scale=scale)
          for x, y in zip(base.ravel(), padded.ravel())),
      "padding K with (pad_a, pad_b) changed the contraction result")
  if not sr.boolean:
    out.extend(check_int32_pads(op))
  return out


_I32 = np.iinfo(np.int32)


def _wrap32(v: int) -> int:
  """``v`` wrapped to int32 in two's complement, as the kernels' ⊗ wraps."""
  return int((v - _I32.min) % 2 ** 32 + _I32.min)


def check_int32_pads(op: str) -> list:
  """The int32 K-pads (``contraction_pads(op, torch.int32)``): ⊗ of the
  pair equals the saturated ⊕-identity exactly, with no two's-complement
  wrap (INT32_MAX + INT32_MAX would wrap to −2), and padding K with them
  leaves an int32 contraction unchanged."""
  sr = sr_mod.get(op)
  _, otimes = np_ops(sr)
  pa, pb = (int(p) for p in sr_mod.contraction_pads(op, torch.int32))
  ident = int(sr_mod.oplus_identity(op, torch.int32))
  exact = int(otimes(np.int64(pa), np.int64(pb)))
  out = []
  if exact != ident or not _I32.min <= exact <= _I32.max:
    wrapped = _wrap32(exact)
    out.append(f"{op}: int32 pad-product violated: ⊗(pad_a={pa}, "
               f"pad_b={pb}) == {exact} (int32 wraps it to {wrapped}), want "
               f"id_⊕ == {ident} without wrapping")
    return out
  rng = np.random.default_rng(2)
  m, k, n, kpad = 3, 4, 3, 7
  lo, hi = (1, 50) if op in ("minmul", "maxmul") else (-50, 50)
  a2 = rng.integers(lo, hi, (m, k)).astype(np.int32)
  b2 = rng.integers(lo, hi, (k, n)).astype(np.int32)
  ap = np.full((m, kpad), pa, dtype=np.int32)
  bp = np.full((kpad, n), pb, dtype=np.int32)
  ap[:, :k] = a2
  bp[:k, :] = b2
  with np.errstate(over="ignore"):
    base, padded = _np_mmo(sr, a2, b2), _np_mmo(sr, ap, bp)
  if not np.array_equal(base, padded):
    out.append(f"{op}: int32 kpad-invariance violated: padding K with "
               f"(pad_a={pa}, pad_b={pb}) changed the int32 contraction")
  return out


def _sample(rng, op: str, shape):
  """Random operand block drawn from the ring's value domain."""
  sr = sr_mod.get(op)
  if sr.boolean:
    return rng.random(shape) < 0.5
  if op in ("minmul", "maxmul", "maxmin"):
    # positive-only rings: reliabilities/capacities — 0 is the maxmul/maxmin
    # no-edge sentinel, negative values have no graph meaning
    return rng.uniform(0.25, 2.0, shape)
  return rng.uniform(-1.0, 1.0, shape)


def _np_mmo(sr, a, b):
  """Reference ⊕-over-k contraction with numpy mirrors (host-side only)."""
  oplus, otimes = np_ops(sr)
  prod = otimes(a[:, :, None], b[None, :, :])  # (m, k, n)
  if sr.boolean:
    return np.logical_or.reduce(prod, axis=1)
  return {np.add: np.add, np.minimum: np.minimum,
          np.maximum: np.maximum}[oplus].reduce(prod, axis=1)


def check_closure_pads(op: str) -> list:
  """Behavioral check of closure.py's (_SELF_VALUES, _MISSING_VALUES)
  sentinels: padding an adjacency with isolated vertices must leave the
  closure of the original block unchanged and NaN-free.

  Rings without a ⊗-identity have no isolated-vertex embedding (addnorm's
  (x − missing)² = x² feeds pad vertices back into the real block), and
  ``closure_pad_values`` refuses them — verified here instead of checking
  an invariant that cannot hold."""
  sr = sr_mod.get(op)
  if sr.otimes_identity is None:
    try:
      cl_mod.closure_pad_values(op)
    except ValueError:
      return []
    return [f"{op}: has no ⊗-identity but closure_pad_values accepts it — "
            f"pad vertices would corrupt the real block after one squaring"]
  oplus, _ = np_ops(sr)
  rng = np.random.default_rng(1)
  n, npad = 5, 8
  adj = _sample(rng, op, (n, n))
  missing, self_v = cl_mod.closure_pad_values(op)
  adj[rng.random((n, n)) < 0.3] = missing
  np.fill_diagonal(adj, self_v)
  padded = cl_mod.pad_adjacency(adj, npad, op=op)
  exact = _exact_oplus(sr)
  c, cp = adj.copy(), padded.copy()
  out = []
  for it in range(3):  # per-squaring invariance — no fixpoint needed
    c = oplus(c, _np_mmo(sr, c, c))
    cp = oplus(cp, _np_mmo(sr, cp, cp))
    if not sr.boolean and np.isnan(cp).any():
      out.append(f"{op}: closure-pad sentinels manufacture NaN at "
                 f"squaring {it + 1}")
      break
    block = cp[:n, :n]
    scale = 1.0 if sr.boolean else float(np.max(np.abs(
        c[np.isfinite(c)]), initial=1.0))
    if not all(_eq(x, y, exact=exact, scale=scale)
               for x, y in zip(c.ravel(), block.ravel())):
      out.append(f"{op}: padded closure diverges from the unpadded one at "
                 f"squaring {it + 1} — (_SELF_VALUES, _MISSING_VALUES) are "
                 f"not an isolated-vertex embedding for this ring")
      break
  return out


@rule("semiring-laws", family="semiring")
def _rule_semiring_laws(ctx: Context) -> list:
  """Numerically verify ⊕/⊗ laws, pads, and NaN behavior for every ring."""
  mod = ctx.module("core/semiring.py")
  if mod is None:
    return []
  out = []
  for op in sr_mod.ALL_OPS:
    line = _anchor_line(mod, f'name="{op}"')
    out.extend(Finding(rule="semiring-laws", path=mod.relpath, line=line,
                       message=msg) for msg in check_laws(op))
  return out


@rule("semiring-closure-pads", family="semiring")
def _rule_closure_pads(ctx: Context) -> list:
  """Numerically verify closure.py's adjacency-padding sentinel tables."""
  mod = ctx.module("core/closure.py")
  if mod is None:
    return []
  line = _anchor_line(mod, "_MISSING_VALUES")
  out = []
  for op in sr_mod.ALL_OPS:
    out.extend(Finding(rule="semiring-closure-pads", path=mod.relpath,
                       line=line, message=msg)
               for msg in check_closure_pads(op))
  return out
