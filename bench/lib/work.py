"""The benchmark's own count of semiring work, and the H100 peaks it is
held to.

The peaks are a frozen copy of the NVIDIA H100 SXM data sheet as the
port's ``roofline/hw.py`` states them (700 W, dense): CUDA-core issue of
132 SMs x 128 lanes at 1.98 GHz, two instructions per min/max-ring or
addnorm term (an add or multiply, then a min/max or fused multiply-add);
int32 min/max rings at 64 lanes, minplus and maxplus fused into one DPX
instruction; mma on the tensor cores (bf16, or 3xTF32 for float32); orand
at the int8 tensor-core rate; 3.35 TB/s of HBM3.  The benchmark never
reads the program's copy, so a change there cannot move a share here.

Work is what the answer needs, not what a kernel happened to do:

  * a closure request of n vertices is n^3 terms per squaring times the
    squarings the plain reference needs to reach that graph's fixpoint
    (the squarings that changed the iterate), and per squaring its n x n
    iterate read once and written once;
  * a KNN request is q * r * d addnorm terms, its queries and corpus read
    once and its q x r distances written once.  The selection that follows
    is not semiring work.
"""
from __future__ import annotations

SMS, LANES, INT32_LANES = 132, 128, 64
SM_CLOCK_HZ = 1.98e9
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_INT8 = 1979e12
PEAK_BYTES_S = 3.35e12
FUSED_INT32_RINGS = ("minplus", "maxplus")

ITEMSIZE = {"float32": 4, "float16": 2, "bfloat16": 2, "int32": 4,
            "bool": 1}


def ops_seconds(op: str, dtype: str, terms: float) -> float:
  """Least time for ``terms`` (i, k, j) terms of ring ``op`` at the peak
  issue rate of the unit that ring runs on."""
  if op == "mma":
    return (2.0 * terms / PEAK_BF16 if dtype == "bfloat16"
            else 3 * 2.0 * terms / PEAK_TF32)
  if op == "orand":
    return 2.0 * terms / PEAK_INT8
  if dtype == "int32" and op != "addnorm":
    per_term = 1.0 if op in FUSED_INT32_RINGS else 2.0
    return per_term * terms / (SMS * INT32_LANES * SM_CLOCK_HZ)
  return 2.0 * terms / (SMS * LANES * SM_CLOCK_HZ)


def closure_work(n: int, op: str, dtype: str, squarings: int) -> tuple:
  """(terms, bytes) of one closure request."""
  return (float(squarings) * n ** 3,
          float(squarings) * 2.0 * n * n * ITEMSIZE[dtype])


def knn_work(q: int, r: int, d: int, dtype: str = "float32") -> tuple:
  """(terms, bytes) of one KNN request."""
  size = ITEMSIZE[dtype]
  return float(q) * r * d, float((q + r) * d * size + q * r * 4)
