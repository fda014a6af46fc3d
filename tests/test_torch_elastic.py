"""The port's elasticity control plane (``repro_torch.launch.elastic``):
failure detection, stragglers, the re-mesh plan — the reference's four
tests, with its assertions, on ``conftest.FakeClock``."""
import pytest

pytest.importorskip("torch")

from repro_torch.launch.elastic import Coordinator, plan_remesh  # noqa: E402

from conftest import FakeClock  # noqa: E402


def test_failure_detection():
  clk = FakeClock()
  c = Coordinator(["h0", "h1", "h2"], deadline_s=10, clock=clk)
  clk.t = 5
  c.beat("h0")
  c.beat("h1")
  assert c.sweep() == []
  clk.t = 16  # h2 late (11s) → suspect
  c.beat("h0")
  c.beat("h1")
  assert c.sweep() == []
  assert c.hosts["h2"].suspect
  clk.t = 26  # h2 gone (>2×deadline)
  assert c.sweep() == ["h2"]
  assert sorted(c.alive()) == ["h0", "h1"]
  # a returning heartbeat resurrects nothing automatically — dead is dead
  # until re-admission, but suspect clears
  c.beat("h2")
  assert not c.hosts["h2"].suspect


def test_straggler_policy():
  clk = FakeClock()
  c = Coordinator([f"h{i}" for i in range(4)], patience=3, clock=clk,
                  straggler_threshold=1.5)
  for step in range(6):
    clk.t += 1
    for i in range(4):
      ms = 100.0 if i != 3 else 300.0  # h3 is 3× slower
      c.beat(f"h{i}", step_ms=ms)
    out = c.stragglers()
  assert out == ["h3"]


def test_straggler_recovers():
  clk = FakeClock()
  c = Coordinator(["a", "b"], patience=2, clock=clk)
  c.beat("a", 100)
  c.beat("b", 500)
  c.stragglers()
  c.beat("a", 100)
  c.beat("b", 100)  # recovered → streak resets before patience
  for _ in range(5):
    c.beat("a", 100)
    c.beat("b", 105)
    assert c.stragglers() == []


def test_plan_remesh():
  assert plan_remesh(64, 4, model=16) == (16, 16)   # full pod intact
  assert plan_remesh(63, 4, model=16) == (8, 16)    # lost a host → dp 15→8
  assert plan_remesh(4, 4, model=16) == (1, 16)     # minimum viable
  assert plan_remesh(3, 4, model=16) is None        # TP group broken


def test_plan_remesh_on_h100_hosts():
  """Eight cards per host: 32 hosts hold the single pod's (16, 16)."""
  assert plan_remesh(32, 8, model=16) == (16, 16)
  assert plan_remesh(31, 8, model=16) == (8, 16)
  assert plan_remesh(1, 8, model=16) is None
