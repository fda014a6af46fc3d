"""SIMD² on PyTorch and CUDA for NVIDIA Hopper.

A port of the JAX/Pallas package ``repro`` with the same layout and public
names: the semiring registry (``core.semiring``), ``mmo`` and its backend
arms (``core.mmo``), closure solvers (``core.closure``), the paper's
applications (``apps.solvers``), the serving engine (``serve_mmo``), the
sharded schedules (``core.distributed``), LM serving and training on one
device (``configs``, ``models``, ``train``, ``data``, ``launch.serve``,
``launch.train``) and a static analyzer of the port itself
(``analysis``).  Its kernels — the SIMD² unit, the fused closure fixpoint,
flash attention and the SSD intra-chunk term — are hand-written CUDA C++
for ``sm_90a`` (``kernels/csrc/``), built with ``nvcc`` at first use.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU, where every kernel wrapper runs its plain PyTorch version.
"""
