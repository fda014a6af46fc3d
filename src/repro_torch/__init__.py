"""SIMD² on PyTorch and CUDA for NVIDIA Hopper.

A port of the JAX/Pallas package ``repro`` with the same layout and public
names: the semiring registry (``core.semiring``), ``mmo`` and its backend
arms (``core.mmo``), closure solvers (``core.closure``), the paper's
applications (``apps.solvers``) and the batch-mode serving engine
(``serve_mmo``).  The SIMD² unit kernel is hand-written CUDA C++ for
``sm_90a`` (``kernels/csrc/semiring_mmo.cu``), built with ``nvcc`` at first
use.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU, where every kernel wrapper runs its plain PyTorch version.
"""
