"""Static-analysis framework for the SIMD² port (stdlib ``ast`` only).

Three pieces, mirroring what a production linter needs and nothing more:

  * a **rule registry** — rules are functions ``(Context) -> [Finding]``
    registered under a stable rule id and a family name (``semiring`` /
    ``locks`` / ``capture``), so the CLI can run one family or one rule;
  * **suppressions** — ``# repro: ignore[rule-id]`` (or a bare
    ``# repro: ignore``) on the flagged line or the line above silences a
    finding at that site, visibly and greppably;
  * a **baseline** — a checked-in JSON file of grandfathered finding
    fingerprints.  Fingerprints hash (rule, path, message) and deliberately
    exclude the line number, so unrelated edits above a baselined site do
    not resurrect it.  ``python -m repro_torch.analysis`` exits nonzero only on
    findings that are neither suppressed nor baselined: the tree must stay
    at zero *new* findings while grandfathered ones are paid down.

Rules may run numeric checks against the live registries (the semiring law
checker does) — "static" here means *no code under test executes*, not
"no arithmetic".  Counterpart of ``repro/analysis/core.py``: the framework,
the suppression syntax, the fingerprint and the baseline format are the
reference's; the third family checks CUDA-graph capture safety where the
reference checks jit trace safety.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import re
import time
from pathlib import Path
from typing import Callable, Optional

__all__ = ["Finding", "Module", "Context", "Report", "rule", "all_rules",
           "run", "load_context", "load_baseline", "save_baseline",
           "format_human", "format_json", "FAMILIES"]

FAMILIES = ("semiring", "locks", "capture")

_SUPPRESS_RE = re.compile(
    r"#\s*repro:\s*ignore(?:\[(?P<rules>[A-Za-z0-9_\-, ]+)\])?")


@dataclasses.dataclass(frozen=True)
class Finding:
  """One rule violation at one site.

  ``fingerprint`` identifies the finding for baseline matching: it hashes
  the rule id, the module path, and the message — NOT the line number, so
  baselined findings survive unrelated edits elsewhere in the file.  Rules
  therefore write messages that name the symbol, not positional context.
  """

  rule: str
  path: str
  line: int
  message: str

  @property
  def fingerprint(self) -> str:
    raw = f"{self.rule}|{self.path}|{self.message}".encode()
    return hashlib.sha256(raw).hexdigest()[:16]

  def to_json(self) -> dict:
    return {"rule": self.rule, "path": self.path, "line": self.line,
            "message": self.message, "fingerprint": self.fingerprint}

  def __str__(self) -> str:
    return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclasses.dataclass
class Module:
  """One parsed source file: AST + per-line suppression table."""

  path: Path
  relpath: str           # posix path relative to the repo root (stable ids)
  source: str
  tree: ast.Module
  # line → None (suppress every rule) | frozenset of suppressed rule ids
  suppressions: dict

  def suppresses(self, rule_id: str, line: int) -> bool:
    """True when ``line`` (or the line above — comment-above style) carries
    a matching suppression comment."""
    for ln in (line, line - 1):
      entry = self.suppressions.get(ln, _MISSING)
      if entry is _MISSING:
        continue
      if entry is None or rule_id in entry:
        return True
    return False


_MISSING = object()


def _parse_suppressions(source: str) -> dict:
  table: dict = {}
  for i, text in enumerate(source.splitlines(), start=1):
    m = _SUPPRESS_RE.search(text)
    if not m:
      continue
    rules = m.group("rules")
    table[i] = (None if rules is None else
                frozenset(r.strip() for r in rules.split(",") if r.strip()))
  return table


@dataclasses.dataclass
class Context:
  """Everything a rule sees: the scanned tree plus parse results."""

  root: Path
  repo_root: Path
  modules: list

  def module(self, suffix: str) -> Optional[Module]:
    """The unique module whose relpath ends with ``suffix`` (posix), or
    None — rules targeting one file (engine.py) resolve it through this so
    they degrade to no-ops on fixture trees that lack the file."""
    suffix = suffix.lstrip("/")
    hits = [m for m in self.modules
            if m.relpath == suffix or m.relpath.endswith("/" + suffix)]
    return hits[0] if len(hits) == 1 else None

  def relpath(self, path: Path) -> str:
    """``path`` as a finding's posix path (relative to the repo root)."""
    try:
      return path.relative_to(self.repo_root).as_posix()
    except ValueError:
      return path.name

  def text_files(self, pattern: str) -> list:
    """(relpath, text) of every file under the root matching ``pattern``
    (a glob such as ``*.cuh``) — the rules that read kernel sources."""
    return [(self.relpath(p), p.read_text(encoding="utf-8"))
            for p in sorted(self.root.rglob(pattern))
            if "__pycache__" not in p.parts]


def _find_repo_root(root: Path) -> Path:
  for parent in (root, *root.parents):
    if (parent / "pyproject.toml").is_file():
      return parent
  return root


def load_context(root) -> Context:
  root = Path(root).resolve()
  repo_root = _find_repo_root(root)
  modules = []
  for path in sorted(root.rglob("*.py")):
    if "__pycache__" in path.parts:
      continue
    source = path.read_text(encoding="utf-8")
    try:
      tree = ast.parse(source, filename=str(path))
    except SyntaxError as e:
      raise SyntaxError(f"cannot analyze {path}: {e}") from e
    try:
      rel = path.relative_to(repo_root).as_posix()
    except ValueError:
      rel = path.name
    modules.append(Module(path=path, relpath=rel, source=source, tree=tree,
                          suppressions=_parse_suppressions(source)))
  return Context(root=root, repo_root=repo_root, modules=modules)


# ---------------------------------------------------------------------------
# rule registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Rule:
  name: str
  family: str
  doc: str
  fn: Callable


_RULES: dict = {}


def rule(name: str, family: str):
  """Register a rule function ``(Context) -> list[Finding]``."""
  if family not in FAMILIES:
    raise ValueError(f"unknown rule family {family!r}; one of {FAMILIES}")

  def deco(fn):
    if name in _RULES:
      raise ValueError(f"duplicate rule id {name!r}")
    _RULES[name] = Rule(name=name, family=family,
                        doc=(fn.__doc__ or "").strip().splitlines()[0]
                        if fn.__doc__ else "", fn=fn)
    return fn

  return deco


def all_rules() -> dict:
  return dict(_RULES)


def select_rules(spec: Optional[str]) -> list:
  """Resolve a CLI ``--rules`` spec (comma-separated rule ids and/or family
  names) to Rule objects; None selects everything."""
  if not spec:
    return list(_RULES.values())
  out, seen = [], set()
  for token in (t.strip() for t in spec.split(",") if t.strip()):
    if token in FAMILIES:
      picked = [r for r in _RULES.values() if r.family == token]
    elif token in _RULES:
      picked = [_RULES[token]]
    else:
      raise ValueError(
          f"unknown rule or family {token!r}; rules: {sorted(_RULES)}; "
          f"families: {FAMILIES}")
    for r in picked:
      if r.name not in seen:
        seen.add(r.name)
        out.append(r)
  return out


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------

BASELINE_VERSION = 1


def load_baseline(path) -> set:
  """Fingerprints grandfathered by ``path`` (missing file = empty set)."""
  path = Path(path)
  if not path.is_file():
    return set()
  doc = json.loads(path.read_text(encoding="utf-8"))
  if doc.get("version") != BASELINE_VERSION:
    raise ValueError(f"baseline {path} has unsupported version "
                     f"{doc.get('version')!r}")
  return {f["fingerprint"] for f in doc.get("findings", [])}


def save_baseline(path, findings) -> None:
  """Write ``findings`` (new + currently-baselined) as the new baseline."""
  doc = {
      "version": BASELINE_VERSION,
      "findings": sorted(
          ({"fingerprint": f.fingerprint, "rule": f.rule, "path": f.path,
            "message": f.message} for f in findings),
          key=lambda d: (d["rule"], d["path"], d["message"])),
  }
  Path(path).write_text(json.dumps(doc, indent=2) + "\n", encoding="utf-8")


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Report:
  root: str
  rules_run: list
  findings: list       # new findings — these fail the build
  baselined: list      # grandfathered findings still present
  suppressed: int
  elapsed_s: float

  @property
  def ok(self) -> bool:
    return not self.findings


def run(root, *, rules: Optional[str] = None, baseline=None) -> Report:
  """Run ``rules`` (CLI spec or None = all) over the tree at ``root``.

  ``baseline`` is a fingerprint set (see ``load_baseline``) — matching
  findings are reported separately and do not fail the run.
  """
  t0 = time.perf_counter()
  ctx = load_context(root)
  selected = select_rules(rules) if isinstance(rules, (str, type(None))) \
      else list(rules)
  baseline = baseline or set()
  by_path = {m.relpath: m for m in ctx.modules}
  new, grandfathered, suppressed = [], [], 0
  for r in selected:
    for f in r.fn(ctx):
      mod = by_path.get(f.path)
      if mod is not None and mod.suppresses(f.rule, f.line):
        suppressed += 1
      elif f.fingerprint in baseline:
        grandfathered.append(f)
      else:
        new.append(f)
  key = lambda f: (f.path, f.line, f.rule, f.message)  # noqa: E731
  new.sort(key=key)
  grandfathered.sort(key=key)
  return Report(root=str(ctx.root), rules_run=[r.name for r in selected],
                findings=new, baselined=grandfathered,
                suppressed=suppressed,
                elapsed_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# output
# ---------------------------------------------------------------------------


def format_human(report: Report) -> str:
  lines = []
  for f in report.findings:
    lines.append(str(f))
  if report.baselined:
    lines.append(f"({len(report.baselined)} baselined finding(s) still "
                 f"present — pay them down, don't add more)")
  verdict = "OK" if report.ok else f"{len(report.findings)} new finding(s)"
  lines.append(
      f"repro_torch.analysis: {verdict} — {len(report.rules_run)} rule(s) over "
      f"{report.root} in {report.elapsed_s:.2f}s "
      f"({report.suppressed} suppressed, {len(report.baselined)} baselined)")
  return "\n".join(lines)


def format_json(report: Report) -> str:
  return json.dumps({
      "root": report.root,
      "rules": report.rules_run,
      "ok": report.ok,
      "elapsed_s": round(report.elapsed_s, 3),
      "suppressed": report.suppressed,
      "findings": [f.to_json() for f in report.findings],
      "baselined": [f.to_json() for f in report.baselined],
  }, indent=2)
