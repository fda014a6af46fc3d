"""repro_torch.analysis: the reference's analyzer tests against the port's
analyzer (fixture good/bad pairs per rule, suppressions, the baseline round
trip, the CLI), torch-idiom fixtures for capture safety, the kernels' ring
table, parity with the reference's analyzer on framework-neutral fixtures,
and the self-run gate (the shipped port tree must be clean)."""
from __future__ import annotations

import json
import textwrap

import pytest

pytest.importorskip("torch")

from repro import analysis as ref_analysis  # noqa: E402
from repro_torch import analysis  # noqa: E402
from repro_torch.analysis import laws  # noqa: E402
from repro_torch.analysis.__main__ import main as cli_main  # noqa: E402


def _tree(tmp_path, files: dict):
  for rel, src in files.items():
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src), encoding="utf-8")
  return tmp_path


def _run(root, rules):
  return analysis.run(root, rules=rules)


# --- semiring family --------------------------------------------------------

GOOD_TABLE = """
    _T = {"mma": 1, "minplus": 2, "maxplus": 3, "minmul": 4, "maxmul": 5,
          "minmax": 6, "maxmin": 7, "orand": 8, "addnorm": 9}
"""

BAD_TABLE = """
    _T = {"mma": 1, "minplus": 2, "maxplus": 3, "minmul": 4, "maxmul": 5,
          "minmax": 6, "maxmin": 7, "orand": 8, "addnrm": 9}
"""


def test_table_coverage_good(tmp_path):
  root = _tree(tmp_path, {"mod.py": GOOD_TABLE})
  assert _run(root, "semiring-table-coverage").findings == []


def test_table_coverage_bad(tmp_path):
  root = _tree(tmp_path, {"mod.py": BAD_TABLE})
  found = _run(root, "semiring-table-coverage").findings
  msgs = " ".join(f.message for f in found)
  assert "addnorm" in msgs      # missing registered op
  assert "addnrm" in msgs       # unknown key


def test_pad_consistency_flags_broken_pair(tmp_path):
  # minplus pads must satisfy pa + pb == +inf (the ⊕-identity); (0.0, 0.0)
  # sums to 0.0 and would corrupt padded lanes
  root = _tree(tmp_path, {"mod.py": """
      import torch
      _PADS = {"mma": (0.0, 0.0), "minplus": (0.0, 0.0),
               "maxplus": (0.0, -torch.inf),
               "minmul": (torch.inf, torch.inf),
               "maxmul": (-torch.inf, torch.inf),
               "minmax": (torch.inf, torch.inf),
               "maxmin": (-torch.inf, -torch.inf),
               "orand": (0.0, 0.0), "addnorm": (0.0, 0.0)}
  """})
  found = _run(root, "semiring-pad-consistency").findings
  assert any("minplus" in f.message for f in found)
  assert not any("'mma'" in f.message for f in found)


def test_hardcoded_identity_scoped_to_contraction_modules(tmp_path):
  src = """
      import torch
      ACC = torch.full((4,), float("inf"))
  """
  flagged = _tree(tmp_path / "a", {"core/closure.py": src})
  also = _tree(tmp_path / "c", {"serve_mmo/arena.py": src})
  unflagged = _tree(tmp_path / "b", {"core/other.py": src})
  assert len(_run(flagged, "semiring-hardcoded-identity").findings) == 1
  assert len(_run(also, "semiring-hardcoded-identity").findings) == 1
  assert _run(unflagged, "semiring-hardcoded-identity").findings == []


def test_semiring_laws_pass_on_live_registry(tmp_path):
  # the numeric family runs against the live registry regardless of the
  # scanned tree; an empty tree keeps the AST rules quiet
  root = _tree(tmp_path, {"empty.py": ""})
  rep = _run(root, "semiring-laws,semiring-closure-pads")
  assert rep.findings == []


# --- the kernels' ring table (semiring_ring.cuh) ----------------------------

RING_CUH = """
    SIMD2_RING(MMA, 0.f, 0.f, 0.f, x + y, fmaf(a, b, acc))
    SIMD2_RING(MINPLUS, pinf(), pinf(), pinf(), fmin_nan(x, y),
               fmin_nan(acc, a + b))
    SIMD2_RING(MAXMUL, ninf(), ninf(), pinf(), fmax_nan(x, y),
               fmax_nan(acc, a * b))
    SIMD2_RING(ORAND, 0.f, 0.f, 0.f, fmaxf(x, y), fmaxf(acc, fminf(a, b)))
    SIMD2_IRING(MINPLUS, I32_MAX, 0, imin(x, y), imin(acc, wrap_add(a, b)))
    SIMD2_IRING(MAXMUL, I32_MIN, 1, imax(x, y), imax(acc, wrap_mul(a, b)))
    SIMD2_IRING(MINMAX, I32_MAX, I32_MAX, imin(x, y), imin(acc, imax(a, b)))
"""


def test_kernel_ring_table_good(tmp_path):
  root = _tree(tmp_path, {"kernels/csrc/ring.cuh": RING_CUH})
  assert _run(root, "semiring-pad-consistency").findings == []


@pytest.mark.parametrize("good,bad,want", [
    # int32 minplus padded with (INT32_MAX, INT32_MAX): the sum wraps to −2
    ("SIMD2_IRING(MINPLUS, I32_MAX, 0,",
     "SIMD2_IRING(MINPLUS, I32_MAX, I32_MAX,", "int32 row MINPLUS"),
    # an int32 identity that is not the saturated ⊕-identity
    ("SIMD2_IRING(MAXMUL, I32_MIN, 1,", "SIMD2_IRING(MAXMUL, 0, 1,",
     "int32 row MAXMUL"),
    # maxmul's naive identity pad: −inf · −inf = +inf
    ("SIMD2_RING(MAXMUL, ninf(), ninf(), pinf(),",
     "SIMD2_RING(MAXMUL, ninf(), ninf(), ninf(),", "float32 row MAXMUL"),
    # a ring the registry does not know
    ("SIMD2_RING(ORAND,", "SIMD2_RING(XORAND,", "XORAND"),
])
def test_kernel_ring_table_flags_a_wrong_row(tmp_path, good, bad, want):
  assert good in RING_CUH
  root = _tree(tmp_path, {"kernels/csrc/ring.cuh": RING_CUH.replace(good,
                                                                     bad)})
  found = _run(root, "semiring-pad-consistency").findings
  assert found and all(want in f.message for f in found)
  assert all(f.path.endswith("ring.cuh") for f in found)


def test_kernel_ring_rows_read_the_shipped_table():
  from pathlib import Path
  from repro_torch.analysis.semiring_rules import kernel_ring_rows
  src = (Path(analysis.__file__).parents[1] / "kernels" / "csrc"
         / "semiring_ring.cuh").read_text(encoding="utf-8")
  rows = kernel_ring_rows(src)
  f32 = {op for _, dt, op, *_ in rows if dt == "float32"}
  i32 = {op for _, dt, op, *_ in rows if dt == "int32"}
  assert f32 == set(laws.sr_mod.ALL_OPS)
  assert i32 == {"minplus", "maxplus", "minmul", "maxmul", "minmax",
                 "maxmin"}


@pytest.mark.parametrize("op", ["minplus", "maxplus", "minmul", "maxmul",
                                "minmax", "maxmin", "mma", "addnorm"])
def test_int32_kpads_hold_without_wrapping(op):
  assert laws.check_int32_pads(op) == []


def test_int32_pad_check_catches_a_wrapping_pair(monkeypatch):
  from repro_torch.core import semiring as sr_mod
  real = sr_mod.contraction_pads

  def wrapping(op, dtype=None):
    pads = real(op, dtype)
    return (pads[0], pads[0]) if op == "minplus" and dtype is not None \
        else pads
  monkeypatch.setattr(sr_mod, "contraction_pads", wrapping)
  msgs = laws.check_int32_pads("minplus")
  assert msgs and "wraps it to -2" in msgs[0]


# --- locks family -----------------------------------------------------------

LOCKED_CACHE = """
    import threading

    class ExecutableCache:
      def __init__(self):
        self._lock = threading.Lock()
        self._entries = {}
        self._misses = 0

      def get(self, k):
        with self._lock:
          return self._entries.get(k)

      def _insert_locked(self, k, v):
        self._entries[k] = v
"""

UNLOCKED_CACHE = """
    import threading

    class ExecutableCache:
      def __init__(self):
        self._lock = threading.Lock()
        self._entries = {}
        self._misses = 0

      def get(self, k):
        return self._entries.get(k)
"""


def test_lock_discipline_good(tmp_path):
  root = _tree(tmp_path, {"serve_mmo/cache.py": LOCKED_CACHE})
  assert _run(root, "lock-discipline").findings == []


def test_lock_discipline_bad(tmp_path):
  root = _tree(tmp_path, {"serve_mmo/cache.py": UNLOCKED_CACHE})
  found = _run(root, "lock-discipline").findings
  assert len(found) == 1
  assert "ExecutableCache.get" in found[0].message
  assert "_entries" in found[0].message


def test_lock_discipline_nested_def_not_protected(tmp_path):
  # a closure built under the lock may run after the lock is released
  root = _tree(tmp_path, {"serve_mmo/cache.py": """
      import threading

      class ExecutableCache:
        def __init__(self):
          self._lock = threading.Lock()
          self._entries = {}
          self._misses = 0

        def get(self, k):
          with self._lock:
            def later():
              return self._entries.get(k)
          return later
  """})
  found = _run(root, "lock-discipline").findings
  assert len(found) == 1


@pytest.mark.parametrize("path,cls,attr", [
    ("serve_mmo/faults.py", "FaultInjector", "_rules"),
    ("kernels/nvcc.py", "KernelLibrary", "_lib"),
    ("data/pipeline.py", "Prefetcher", "_ready"),
    ("serve_mmo/engine.py", "MMOEngine", "_thread"),
    ("serve_mmo/engine.py", "MMOEngine", "_arenas_ticked"),
])
def test_lock_discipline_covers_the_ports_own_classes(tmp_path, path, cls,
                                                      attr):
  root = _tree(tmp_path, {path: f"""
      import threading

      class {cls}:
        def __init__(self):
          self._lock = threading.Lock()
          self.{attr} = None

        def peek(self):
          return self.{attr}
  """})
  found = _run(root, "lock-discipline").findings
  assert [f"{cls}.peek" in f.message and attr in f.message
          for f in found] == [True]


# --- capture family ---------------------------------------------------------

GOOD_LAUNCH = """
    import torch
    from typing import Optional
    Tensor = torch.Tensor

    def _takes(t: Tensor) -> bool:
      return t.stride(-1) == 1 and t.data_ptr() % 16 == 0

    def flash_attention(q: Tensor, k: Tensor, v: Tensor, *,
                        window: Optional[int] = None,
                        out: Optional[Tensor] = None) -> Tensor:
      if q.device.type == "cpu":
        y = (q @ k.transpose(-1, -2)).softmax(-1) @ v
        assert bool(torch.isfinite(y).all())  # the plain version: no capture
        return y
      if q.shape[-1] not in (64, 128) or q.dim() != 4:
        raise ValueError("head dim")
      if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("contiguous")
      for name, t in (("q", q), ("k", k)):
        if not _takes(t):
          raise ValueError(name)
      win = 0 if window is None else int(window)
      if out is None:
        out = torch.empty_like(q)
      if out.numel() == 0:
        return out
      launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), win,
             float(q.shape[-1]) ** -0.5)
      return out
"""

BAD_LAUNCH = """
    import numpy as np
    import torch
    Tensor = torch.Tensor

    def flash_attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
      if q.abs().max() > 1e4:                 # branch on a tensor's value
        q = q / 2
      m = float(k.max())                      # host read
      live = q[q > 0]                         # boolean-mask indexing
      idx = torch.nonzero(v)                  # data-dependent shape
      n = np.sum(v)                           # numpy on a tensor
      torch.cuda.synchronize()                # explicit sync
      s = q.sum().item()                      # host read
      return q if k.any() else v              # conditional on a tensor
"""


def _capture_tree(tmp_path, src):
  return _tree(tmp_path, {"kernels/flash_attention.py": src})


def test_capture_safety_good(tmp_path):
  root = _capture_tree(tmp_path, GOOD_LAUNCH)
  assert _run(root, "capture-safety").findings == []


def test_capture_safety_bad(tmp_path):
  root = _capture_tree(tmp_path, BAD_LAUNCH)
  msgs = [f.message for f in _run(root, "capture-safety").findings]
  for needle in ("`if`", "`float()`", "boolean-mask", "`nonzero`",
                 "`np.sum`", "`synchronize()`", "`.item()`",
                 "conditional expression"):
    assert any(needle in m for m in msgs), (needle, msgs)


def test_capture_safety_is_scoped_to_the_declared_roots(tmp_path):
  # the same function under a name no SYNC_FREE entry declares
  root = _tree(tmp_path, {"kernels/other.py": BAD_LAUNCH})
  assert _run(root, "capture-safety").findings == []


def test_capture_safety_reads_imported_return_annotations(tmp_path):
  helpers = """
      import torch

      def takes(t: torch.Tensor) -> bool:
        return t.stride(-1) == 1

      def scaled(t: torch.Tensor) -> torch.Tensor:
        return t * 2
  """
  root = _tree(tmp_path, {"repro_torch/kernels/helpers.py": helpers,
                          "repro_torch/kernels/flash_attention.py": """
      import torch
      from repro_torch.kernels.helpers import scaled, takes
      Tensor = torch.Tensor

      def flash_attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
        q = q if takes(q) else q.contiguous()   # a host bool: fine
        if scaled(k).sum():                     # a tensor's value
          pass
        return q
  """})
  found = _run(root, "capture-safety").findings
  assert [f.line for f in found] == [8]


def test_capture_safety_propagates_through_helpers(tmp_path):
  root = _capture_tree(tmp_path, """
      import torch
      Tensor = torch.Tensor

      def helper(t):
        if t.any():          # only bad because the root passes a tensor in
          return t * 2
        return t

      def flash_attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
        return helper(q)
  """)
  found = _run(root, "capture-safety").findings
  assert any("helper" in f.message for f in found)


def test_capture_safety_reaches_the_arena_tick(tmp_path):
  root = _tree(tmp_path, {"serve_mmo/arena.py": """
      class RequestArena:
        def _build_program_specs(self):
          def make_tick():
            def tick(*args):
              c, kv, act, it = args
              if int(it.max()) > 3:
                pass
              return c
            return tick
          return {"tick": make_tick}

        def tick(self):
          return float(self.x)   # the host side of a tick: not a root
  """})
  found = _run(root, "capture-safety").findings
  assert {f.line for f in found} == {7}


def test_cache_key_coverage_flags_unkeyed_knob(tmp_path):
  root = _tree(tmp_path, {"serve_mmo/engine.py": """
      from repro_torch.serve_mmo import batching

      class MMOEngine:
        def __init__(self, device):
          self.device = device
          self.flavor = "x"

        def _exec_key(self, key, rb, backend):
          return (key, rb, backend)

        def go(self, key, rb, backend, block):
          return self.cache.get_or_compile(
              self._exec_key(key, rb, backend),
              lambda: batching.make_batch_fn(
                  key, backend=backend, block=block, device=self.device,
                  mesh=self.mesh, flavor=self.flavor),
              ())
  """})
  msgs = [f.message for f in _run(root, "cache-key-coverage").findings]
  assert any("`block`" in m for m in msgs)       # name not in key tuple
  assert any("self.flavor" in m for m in msgs)   # attr neither keyed nor fixed
  # device and mesh are declared engine constants: not flagged
  assert not any("self.device" in m for m in msgs)
  assert not any("self.mesh" in m for m in msgs)


def test_cache_key_coverage_flags_a_reassigned_constant(tmp_path):
  root = _tree(tmp_path, {"serve_mmo/engine.py": """
      class MMOEngine:
        def _exec_key(self, key):
          return (key, self._mesh_sig)

        def move(self, device):
          self.device = device
  """})
  msgs = [f.message for f in _run(root, "cache-key-coverage").findings]
  assert any("reassigns self.device" in m for m in msgs)


def test_cache_key_coverage_clean_engine_passes(tmp_path):
  root = _tree(tmp_path, {"serve_mmo/engine.py": """
      from repro_torch.serve_mmo import batching

      class MMOEngine:
        def _exec_key(self, key, rb, backend, schedule):
          return (key, rb, backend, schedule, self._mesh_sig)

        def go(self, key, rb, backend, schedule):
          return self.cache.get_or_compile(
              self._exec_key(key, rb, backend, schedule),
              lambda: batching.make_batch_fn(key, backend=backend,
                                             device=self.device,
                                             schedule=schedule),
              ())
  """})
  assert _run(root, "cache-key-coverage").findings == []


# --- suppressions -----------------------------------------------------------


def test_suppression_same_line_and_line_above(tmp_path):
  root = _tree(tmp_path, {"core/closure.py": """
      import torch
      A = float(torch.inf)  # repro: ignore[semiring-hardcoded-identity]
      # repro: ignore[semiring-hardcoded-identity]
      B = float(torch.inf)
      C = float(torch.inf)
  """})
  rep = _run(root, "semiring-hardcoded-identity")
  assert len(rep.findings) == 1          # only C
  assert rep.suppressed == 2


def test_bare_suppression_silences_all_rules(tmp_path):
  root = _tree(tmp_path, {"core/closure.py": """
      import torch
      A = float(torch.inf)  # repro: ignore
  """})
  rep = _run(root, "semiring-hardcoded-identity")
  assert rep.findings == [] and rep.suppressed == 1


def test_wrong_rule_suppression_does_not_silence(tmp_path):
  root = _tree(tmp_path, {"core/closure.py": """
      import torch
      A = float(torch.inf)  # repro: ignore[lock-discipline]
  """})
  assert len(_run(root, "semiring-hardcoded-identity").findings) == 1


# --- baseline ---------------------------------------------------------------


def test_baseline_round_trip(tmp_path):
  root = _tree(tmp_path, {"serve_mmo/cache.py": UNLOCKED_CACHE})
  first = analysis.run(root, rules="lock-discipline")
  assert len(first.findings) == 1
  bl = tmp_path / "baseline.json"
  analysis.save_baseline(bl, first.findings)
  again = analysis.run(root, rules="lock-discipline",
                       baseline=analysis.load_baseline(bl))
  assert again.findings == [] and len(again.baselined) == 1
  assert again.ok


def test_baseline_survives_line_shifts(tmp_path):
  root = _tree(tmp_path, {"serve_mmo/cache.py": UNLOCKED_CACHE})
  bl = tmp_path / "baseline.json"
  analysis.save_baseline(bl, analysis.run(root,
                                          rules="lock-discipline").findings)
  # unrelated edit above the finding moves its line; fingerprint must hold
  shifted = "# a new comment line\n# another\n" + textwrap.dedent(
      UNLOCKED_CACHE)
  (root / "serve_mmo" / "cache.py").write_text(shifted, encoding="utf-8")
  again = analysis.run(root, rules="lock-discipline",
                       baseline=analysis.load_baseline(bl))
  assert again.findings == [] and len(again.baselined) == 1


def test_baseline_rejects_unknown_version(tmp_path):
  bl = tmp_path / "baseline.json"
  bl.write_text(json.dumps({"version": 99, "findings": []}))
  with pytest.raises(ValueError, match="version"):
    analysis.load_baseline(bl)


# --- parity with the reference's analyzer -------------------------------------

SHARED_FIXTURES = {
    "lock discipline": ({"serve_mmo/cache.py": UNLOCKED_CACHE,
                         "serve_mmo/metrics.py": """
        import threading

        class ServeMetrics:
          def __init__(self):
            self._lock = threading.Lock()
            self._counters = {}

          def bump(self, k):
            self._counters[k] = self._counters.get(k, 0) + 1

          def _bucket_locked(self):
            return self._counters
    """}, "lock-discipline"),
    "table coverage": ({"a.py": BAD_TABLE, "b.py": GOOD_TABLE},
                       "semiring-table-coverage"),
    "suppressions": ({"core/closure.py": """
        import math
        A = float(math.inf)  # repro: ignore[semiring-hardcoded-identity]
        B = float(math.inf)
        # repro: ignore
        C = -math.inf
    """}, "semiring-hardcoded-identity"),
}


@pytest.mark.parametrize("name", sorted(SHARED_FIXTURES))
def test_same_findings_as_the_reference_analyzer(tmp_path, name):
  files, rules = SHARED_FIXTURES[name]
  root = _tree(tmp_path, files)
  ours = analysis.run(root, rules=rules)
  ref = ref_analysis.run(root, rules=rules)
  assert [(f.rule, f.path, f.line) for f in ours.findings] == [
      (f.rule, f.path, f.line) for f in ref.findings]
  assert [f.fingerprint for f in ours.findings] == [
      f.fingerprint for f in ref.findings]
  assert ours.suppressed == ref.suppressed


def test_baselines_are_interchangeable_with_the_reference(tmp_path):
  root = _tree(tmp_path, {"serve_mmo/cache.py": UNLOCKED_CACHE})
  bl = tmp_path / "bl.json"
  ref_analysis.save_baseline(bl, ref_analysis.run(
      root, rules="lock-discipline").findings)
  ours = analysis.run(root, rules="lock-discipline",
                      baseline=analysis.load_baseline(bl))
  assert ours.findings == [] and len(ours.baselined) == 1


# --- CLI + self-run ---------------------------------------------------------


def test_cli_exits_zero_on_shipped_tree(capsys):
  assert cli_main([]) == 0
  out = capsys.readouterr().out
  assert "OK" in out


def test_cli_json_output_is_machine_readable(capsys):
  assert cli_main(["--json"]) == 0
  doc = json.loads(capsys.readouterr().out)
  assert doc["ok"] is True
  assert doc["findings"] == []
  assert set(doc["rules"]) >= {"lock-discipline", "capture-safety",
                               "cache-key-coverage", "semiring-laws",
                               "semiring-pad-consistency"}


def test_cli_list_rules_names_the_three_families(capsys):
  assert cli_main(["--list-rules"]) == 0
  out = capsys.readouterr().out
  for fam in ("[semiring]", "[locks]", "[capture]"):
    assert fam in out


def test_cli_exits_nonzero_on_bad_tree(tmp_path, capsys):
  root = _tree(tmp_path, {"serve_mmo/cache.py": UNLOCKED_CACHE})
  assert cli_main(["--root", str(root), "--no-baseline"]) == 1
  assert "lock-discipline" in capsys.readouterr().out


def test_cli_update_baseline_then_clean(tmp_path, capsys):
  root = _tree(tmp_path, {"serve_mmo/cache.py": UNLOCKED_CACHE})
  bl = tmp_path / "bl.json"
  assert cli_main(["--root", str(root), "--baseline", str(bl),
                   "--update-baseline"]) == 0
  assert cli_main(["--root", str(root), "--baseline", str(bl)]) == 0
  capsys.readouterr()


def test_cli_rules_selector_rejects_unknown(capsys):
  with pytest.raises(SystemExit):
    cli_main(["--rules", "no-such-rule"])
  capsys.readouterr()


def test_self_run_is_clean():
  """The acceptance gate: all three families over src/repro_torch, zero
  new findings (no clock: a wall-time bound flips under a loaded host)."""
  from repro_torch.analysis.__main__ import DEFAULT_BASELINE, DEFAULT_ROOT
  report = analysis.run(DEFAULT_ROOT,
                        baseline=analysis.load_baseline(DEFAULT_BASELINE))
  assert report.findings == [], "\n".join(str(f) for f in report.findings)
  fams = {analysis.all_rules()[r].family for r in report.rules_run}
  assert fams == set(analysis.FAMILIES)
  assert report.baselined == []


@pytest.mark.parametrize("path", ["kernels/nvcc.py", "serve_mmo/engine.py",
                                  "serve_mmo/arena.py",
                                  "serve_mmo/batching.py",
                                  "core/area_model.py"])
def test_the_findings_fixed_in_the_port_stay_fixed(path):
  """The analyzer's first run over the port found unlocked reads of
  KernelLibrary._build_log, MMOEngine._thread and the arena's device state,
  and table/identity exceptions without the reference's suppressions."""
  from repro_torch.analysis.__main__ import DEFAULT_ROOT
  report = analysis.run(DEFAULT_ROOT)
  assert not [f for f in report.findings if f.path.endswith(path)]


# --- sanitize ---------------------------------------------------------------


def test_sanitize_is_off_by_default(monkeypatch):
  from repro_torch.analysis import sanitize
  monkeypatch.delenv("REPRO_SANITIZE", raising=False)
  assert sanitize.maybe_enable_sanitize() is False
  assert sanitize.sanitize_requested({"REPRO_SANITIZE": "yes"})
  assert not sanitize.sanitize_requested({"REPRO_SANITIZE": "0"})


def test_sanitize_turns_on_the_nan_checks_and_anomaly_mode(monkeypatch):
  import torch
  from repro_torch.analysis import sanitize
  from repro_torch.kernels import nan_check
  from repro_torch.kernels.semiring_mmo import semiring_mmo
  monkeypatch.setenv("REPRO_SANITIZE", "1")
  monkeypatch.setattr(nan_check, "ENABLED", False)
  anomaly = torch.is_anomaly_enabled()
  try:
    assert sanitize.maybe_enable_sanitize() is True  # the pre-flight passes
    assert nan_check.ENABLED and torch.is_anomaly_enabled()
    a = torch.tensor([[[0.0, 1.0]]])
    b = torch.tensor([[[float("inf")], [2.0]]])
    with pytest.raises(FloatingPointError, match="semiring_mmo"):
      semiring_mmo(a, b, op="minmul")               # 0 · inf
    nan_in = torch.tensor([[[float("nan"), 1.0]]])
    semiring_mmo(nan_in, b, op="minmul")            # NaN in: no raise
  finally:
    torch.autograd.set_detect_anomaly(anomaly)


@pytest.mark.parametrize("kernel", ["fixpoint_chunk", "flash_attention",
                                    "ssd_intra_chunk"])
def test_nan_check_names_the_kernel(monkeypatch, kernel):
  import torch
  from repro_torch.kernels import nan_check
  monkeypatch.setattr(nan_check, "ENABLED", True)
  clean = torch.zeros(2)
  poisoned = torch.tensor([0.0, float("nan")])
  with pytest.raises(FloatingPointError, match=kernel):
    nan_check.checked(kernel, (clean,), (poisoned, clean))
  assert nan_check.checked(kernel, (poisoned,), poisoned) is poisoned
  monkeypatch.setattr(nan_check, "ENABLED", False)
  assert nan_check.checked(kernel, (clean,), poisoned) is poisoned


def test_sanitize_preflight_refuses_a_dirty_tree(monkeypatch, tmp_path):
  from repro_torch.analysis import sanitize
  from repro_torch.analysis import __main__ as cli
  from repro_torch.kernels import nan_check
  import torch
  root = _tree(tmp_path, {"serve_mmo/cache.py": UNLOCKED_CACHE})
  monkeypatch.setenv("REPRO_SANITIZE", "1")
  monkeypatch.setattr(cli, "DEFAULT_ROOT", root)
  monkeypatch.setattr(nan_check, "ENABLED", False)
  anomaly = torch.is_anomaly_enabled()
  try:
    with pytest.raises(RuntimeError, match="pre-flight"):
      sanitize.maybe_enable_sanitize()
  finally:
    torch.autograd.set_detect_anomaly(anomaly)


# --- the faults the first run found -------------------------------------------


def test_drive_reads_the_serving_thread_once():
  """``_drive`` used to read ``self._thread`` twice without the lock, so a
  ``stop()`` between the reads (it sets the attribute to None) raised
  AttributeError in the caller waiting on a future."""
  import threading
  from repro_torch.serve_mmo import MMOEngine, apsp_request
  from repro_torch.apps import graphs

  class Racy(MMOEngine):
    reads = 0

    @property
    def _thread(self):
      # the first read sees a live thread, the next sees stop()'s None
      Racy.reads += 1
      return threading.current_thread() if Racy.reads == 1 else None

    @_thread.setter
    def _thread(self, value):
      pass

  eng = Racy(backend="xla", device="cpu")
  fut = eng.submit(apsp_request(graphs.weighted_digraph(8, 0.3, seed=1)))
  fut._event.set()  # nothing to wait for: _drive returns after its checks
  eng._drive(fut, timeout=0.01)
  assert Racy.reads == 1
