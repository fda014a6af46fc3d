"""Build and load the port's CUDA kernels: ``nvcc`` at first use, ctypes.

Each kernel source in ``csrc/`` compiles into one shared library with a
plain C interface for Hopper (``sm_90a``), under ``build/kernels/`` in the
checkout, named by a hash of the source, the shared headers in ``csrc/`` and
the flags, so an edit to either rebuilds and an unchanged tree reuses the
library.  Nothing here runs at import: building needs ``nvcc``, which only a
machine with the card has.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
  path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
  if not os.path.exists(path):
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin: "
                       "the port's CUDA kernels cannot be built")
  return path


class KernelLibrary:
  """One ``csrc/<name>.cu`` source and the C entry point it exports."""

  def __init__(self, name: str, symbol: str, argtypes: list):
    self.name = name
    self.source = CSRC / f"{name}.cu"
    self.symbol = symbol
    self.argtypes = argtypes
    self._lib = None
    self._lock = threading.Lock()
    self._build_log = ""

  def path(self) -> Path:
    """Where the built library for the current sources lives."""
    digest = hashlib.sha256(self.source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
      digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsimd2_{self.name}_{digest.hexdigest()[:16]}.so"

  def build(self) -> Path:
    """Compile unless this source's library already exists.

    ``-Xptxas -v`` output (registers, shared memory, spills) is kept for
    ``build_log()``.  The library is written under a temporary name and moved
    into place, so a concurrent process never loads a half-written file; the
    lock keeps two threads of one process from compiling it twice.
    """
    with self._lock:
      return self._build_locked()

  def _build_locked(self) -> Path:
    out = self.path()
    if out.exists():
      return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(self.source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
      raise RuntimeError(f"nvcc failed on {self.source.name} with exit code "
                         f"{proc.returncode}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    self._build_log = proc.stdout + proc.stderr
    return out

  def build_log(self) -> str:
    """The compiler's report from this process's build ('' if it loaded a
    library built earlier)."""
    with self._lock:
      return self._build_log

  def load(self):
    """Build (if needed) and load the library; idempotent.  Returns the
    ctypes entry point."""
    return self.function(self.symbol, self.argtypes)

  def function(self, symbol: str, argtypes: list, restype=ctypes.c_int):
    """Another C function of the same library, loading the library first if
    needed."""
    with self._lock:
      if self._lib is None:
        self._lib = ctypes.CDLL(str(self._build_locked()))
      fn = getattr(self._lib, symbol)
      fn.argtypes = argtypes
      fn.restype = restype
      return fn


def build_all(libraries) -> None:
  """Start one ``nvcc`` per library at once and wait for all of them."""
  libraries = list(libraries)
  with ThreadPoolExecutor(max_workers=max(1, len(libraries))) as pool:
    for fut in [pool.submit(lib.build) for lib in libraries]:
      fut.result()
