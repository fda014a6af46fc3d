"""SIMD² on PyTorch and CUDA for NVIDIA Hopper.

A port of the JAX/Pallas package ``repro`` with the same layout and public
names: the semiring registry (``core.semiring``), ``mmo`` and its backend
arms (``core.mmo``), closure solvers (``core.closure``), the paper's
applications (``apps.solvers``), the serving engine (``serve_mmo``), and
dense-LM serving (``configs``, ``models``, ``train.steps``,
``launch.serve``).  Its kernels — the SIMD² unit, the fused closure
fixpoint and flash attention — are hand-written CUDA C++ for ``sm_90a``
(``kernels/csrc/``), built with ``nvcc`` at first use.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU, where every kernel wrapper runs its plain PyTorch version.
"""
