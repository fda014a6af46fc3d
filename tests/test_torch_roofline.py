"""The port's roofline (``repro_torch.roofline``): the three-term arithmetic
at the H100's rates, the reference's HLO collective parser, and the
dispatch-time counter that takes the place of the reference's HLO walk."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import (AbstractMesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.roofline import hw  # noqa: E402
from repro_torch.roofline.analysis import (  # noqa: E402
    Roofline, axis_group_rate, model_flops_estimate)
from repro_torch.roofline.collectives import collective_bytes  # noqa: E402
from repro_torch.roofline.flops import CostCounter  # noqa: E402


def test_roofline_terms():
  """test_roofline.py::test_roofline_terms with the card's rates."""
  peak, mem = hw.PEAK_OPS["bfloat16"], hw.PEAK_BYTES_S
  r = Roofline(arch="x", shape="train_4k", mesh="single", chips=256,
               hlo_flops=256 * peak,                 # exactly 1s of compute
               hlo_bytes=256 * mem * 0.5,            # 0.5s of memory
               coll_bytes=hw.INTERHOST_BYTES_S * 0.25,  # 0.25s collective
               coll_breakdown={}, model_flops=256 * peak * 0.5)
  assert abs(r.t_compute - 1.0) < 1e-9
  assert abs(r.t_memory - 0.5) < 1e-9
  assert abs(r.t_collective - 0.25) < 1e-9
  assert r.bottleneck == "compute"
  assert abs(r.mfu_bound - 0.5) < 1e-9
  assert r.row()["bottleneck"] == "compute"


def test_collective_term_per_axis_group():
  """Each axis group's bytes at its own link rate: NVLink within a host of
  eight cards, the inter-host rate across hosts."""
  small = AbstractMesh((2, 2), ("data", "model"))
  assert axis_group_rate(small, "model") == hw.NVLINK_BYTES_S
  assert axis_group_rate(small, "data") == hw.NVLINK_BYTES_S
  pod = make_production_mesh()
  assert axis_group_rate(pod, "model") == hw.INTERHOST_BYTES_S
  assert axis_group_rate(pod, "data") == hw.INTERHOST_BYTES_S
  multi = make_production_mesh(multi_pod=True)
  assert axis_group_rate(multi, ("pod", "data")) == hw.INTERHOST_BYTES_S
  host_wide = AbstractMesh((4, 8), ("data", "model"))
  assert axis_group_rate(host_wide, "model") == hw.NVLINK_BYTES_S
  assert axis_group_rate(host_wide, "data") == hw.INTERHOST_BYTES_S
  r = Roofline(arch="x", shape="s", mesh="2x2", chips=4, hlo_flops=0.0,
               hlo_bytes=0.0, coll_bytes=3e9, coll_breakdown={},
               model_flops=1.0,
               coll_axis_bytes={"data": 1e9, "model": 2e9},
               axis_rates={"data": hw.NVLINK_BYTES_S,
                           "model": hw.INTERHOST_BYTES_S})
  want = 1e9 / hw.NVLINK_BYTES_S + 2e9 / hw.INTERHOST_BYTES_S
  assert abs(r.t_collective - want) < 1e-15
  assert r.bottleneck == "collective"


def test_model_flops_estimate():
  assert model_flops_estimate(10.0, "train", 3) == 180.0
  assert model_flops_estimate(10.0, "prefill", 3) == 60.0
  assert model_flops_estimate(10.0, "decode", 3) == 60.0


def test_collective_parser_shapes():
  hlo = '''
  %x = bf16[16,128]{1,0} all-gather(%a), replica_groups=[2,8]<=[16], dimensions={0}
  %y = f32[64]{0} all-reduce-start(%b), replica_groups={{0,1,2,3}}
  '''
  out = collective_bytes(hlo)
  ag = (8 - 1) / 8 * 16 * 128 * 2
  ar = 2 * (4 - 1) / 4 * 64 * 4
  assert abs(out["all-gather"] - ag) < 1e-6
  assert abs(out["all-reduce"] - ar) < 1e-6
  assert out["count:all-gather"] == 1 and out["count:all-reduce"] == 1
  assert abs(out["total"] - (ag + ar)) < 1e-6


@pytest.mark.parametrize("device", ("meta", "cpu"))
def test_a_python_loop_of_matmuls_counts_every_iteration(device):
  """The reference's walker multiplies a scanned body by its trip count;
  a count at dispatch sees each of the 16 iterations."""
  m = 64
  ws = torch.zeros(16, m, m, device=device)
  x = torch.zeros(m, m, device=device)
  with CostCounter() as c:
    for i in range(16):
      x = x @ ws[i]
  assert c.flops == 16 * 2 * m ** 3
  # each step reads x and one layer's weight (a view: its own bytes) and
  # writes the new x
  assert c.bytes == 16 * 3 * m * m * 4
  assert c.peak == 2 * m * m * 4


def test_bytes_and_live_peak_of_a_three_op_program():
  """a * 2 (reads 128 B, writes 128), then a transposed copy of it (128,
  128; the transpose itself is a view and moves nothing), the first result
  freed, then a sum (128, 4): 644 bytes; at most two 128-byte results live
  at once."""
  a = torch.empty(4, 8, device="meta")
  with CostCounter() as c:
    b = a * 2
    d = b.t().contiguous()
    del b
    e = d.sum()
  assert c.flops == 0
  assert c.bytes == 128 + 128 + 128 + 128 + 128 + 4
  assert c.peak == 256
  assert e.shape == ()


def test_gathers_views_and_indexed_writes():
  """An embedding lookup reads the rows it gathers (and its indices), not
  the table; an index_copy_ moves its source's rows; allocations move
  nothing."""
  table = torch.empty(1000, 8, device="meta")
  tokens = torch.zeros(2, 3, dtype=torch.int32, device="meta")
  cache = torch.empty(4, 100, 8, device="meta")
  row = torch.empty(4, 1, 8, device="meta")
  idx = torch.zeros(1, dtype=torch.long, device="meta")
  with CostCounter() as c:
    table[tokens]
  assert c.bytes == 2 * 6 * 8 * 4 + 6 * 4
  with CostCounter() as c:
    cache.index_copy_(1, idx, row)
    torch.empty_like(cache)
  assert c.bytes == 8 + 2 * 4 * 8 * 4
  assert c.peak == cache.numel() * 4   # the empty_like result is held
