"""NVIDIA H100 constants: the peak rates every bound in the port reads.

Counterpart of ``repro/roofline/hw.py`` (TPU v5e constants).  Shared by
``chip_smoke.py``'s kernel bounds and the dispatch cost prior
(``tuning/cost_table.py``) so the two analytic models cannot drift apart.

The rates are the data sheet's for an H100 SXM at its 700 W power limit
(dense, no sparsity): CUDA-core FP32 (the FMA rate, two flops per lane per
clock), the bf16, TF32 and int8 tensor-core rates, and HBM3 bandwidth.  A
card set below 700 W runs slower under load; state its limit beside any
share of these peaks.
"""
from __future__ import annotations

PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "bool": 1979e12}
PEAK_TF32 = 495e12
PEAK_BYTES_S = 3.35e12
# NVLink 4 between the cards of one host: 900 GB/s per card in total,
# 450 GB/s each way (NVIDIA H100 SXM5 data sheet).  The collective model
# (``tuning/cost_table.sharded_prior_seconds``) charges a shard's ring
# traffic at the one-way rate.  The TPU model's ICI_BW_PER_LINK has no
# counterpart here.
NVLINK_BYTES_S = 450e9
# Between hosts: one 400 Gb/s ConnectX-7 InfiniBand port per card in a DGX
# H100 (eight per host; NVIDIA DGX H100 user guide), 50e9 bytes/s each way.
# A collective whose group spans hosts runs at this rate per card.
INTERHOST_BYTES_S = 50e9
CARDS_PER_HOST = 8
# Device memory a program gets on an H100 80GB HBM3:
# torch.cuda.get_device_properties(0).total_memory as chip_smoke.py phase
# 16 reads and prints it (79.18 GiB of the 80 GiB the card carries).
HBM_BYTES = 85_017_493_504

# CUDA-core instruction issue: 132 SMs × 128 lanes, one instruction per lane
# per clock at the SM clock.  A min/max ring term is two instructions (an
# FADD or FMUL and an FMNMX: no fused f32 add-min), and so is an addnorm
# term (FADD, FFMA) and an orand term.
SMS, LANES = 132, 128
# 32-bit integer add and min/max issue at 64 results per clock per SM on
# compute capability 9.0, half the f32 rate (the CUDA C++ Programming
# Guide's arithmetic-instruction throughput table).  An int32 minplus or
# maxplus term is one instruction: the compiler fuses the add and the
# min/max into Hopper's DPX VIADDMNMX (chip_smoke.py's build phase checks
# K1's and K2's int32 instances for it); the other int32 rings take two
# (IMAD or VIMNMX, then VIMNMX).
INT32_LANES = 64
FUSED_INT32_RINGS = ("minplus", "maxplus")

# The SM clock the issue rate is taken at: the H100 SXM boost clock by
# default.  A caller that reads the card's own maximum (nvidia-smi
# ``clocks.max.sm``) sets it with ``set_sm_clock``.
SM_CLOCK_HZ = 1.98e9

# Host time per kernel launch through a wrapper, back to back: the floor of
# any kernel arm's call, whatever its work.  Measured by chip_smoke.py
# (phase 4d: K1 on a 1 × 8 × 8 × 8 minplus, 500 calls between two CUDA
# events) on an NVIDIA H100 80GB HBM3 at 700 W: 0.0337 ms.
LAUNCH_OVERHEAD_S = 3.37e-5


def set_sm_clock(hz: float) -> None:
  """Set the SM clock the CUDA-core issue rate is computed at."""
  global SM_CLOCK_HZ
  if not hz > 0.0:
    raise ValueError(f"SM clock must be positive, got {hz}")
  SM_CLOCK_HZ = float(hz)


def cuda_core_seconds(terms: float) -> float:
  """Two instructions per term at SMS × LANES × the SM clock."""
  return 2.0 * terms / (SMS * LANES * SM_CLOCK_HZ)


def ops_seconds(op: str, dtype: str, terms: float) -> float:
  """Least time for ``terms`` (i, j, k) terms of ring ``op``: mma on the
  tensor cores (bf16 at the bf16 rate; f32, and float16 or int32 widened
  to f32, at the TF32 rate, three products per term for 3×TF32), orand at
  the int8 tensor-core rate, the other rings two CUDA-core instructions
  per term at the issue rate; int32 at ``INT32_LANES`` per SM, one
  instruction per term for minplus and maxplus, else two."""
  if op == "mma":
    return (2.0 * terms / PEAK_OPS["bfloat16"] if dtype == "bfloat16"
            else 3 * 2.0 * terms / PEAK_TF32)
  if op == "orand":
    return 2.0 * terms / PEAK_OPS["bool"]
  if dtype == "int32" and op != "addnorm":
    per_term = 1.0 if op in FUSED_INT32_RINGS else 2.0
    return per_term * terms / (SMS * INT32_LANES * SM_CLOCK_HZ)
  return cuda_core_seconds(terms)
