"""nvcc build and ctypes load of the port's kernel libraries.

Each library is one ``csrc/*.cu`` source with a plain C interface, compiled
with ``nvcc`` for ``sm_90a`` into a shared library at first use, under
``slotvps_tpu_torch/_build/`` (listed in ``.gitignore``), and loaded with
``ctypes``.  A library's file name carries a hash of its source and flags,
so an edited source is rebuilt.  Nothing is compiled or loaded at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional

_PKG = Path(__file__).resolve().parents[2]
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


class KernelLibrary:
    """One ``csrc/<name>.cu`` source, its build and its loaded library.

    ``declare(lib)`` sets ``argtypes``/``restype`` of every C entry point."""

    def __init__(self, name: str, declare: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = _PKG / "csrc" / f"{name}.cu"
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"{self.name}_{digest[:12]}.so"

    def build(self, verbose: bool = False) -> tuple:
        """Compile the library if it is not built yet.

        Returns ``(path, seconds spent compiling)`` (0.0 when it was
        built).  ``verbose`` prints ptxas' register and shared-memory use."""
        path = self.library_path()
        if path.exists():
            return path, 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(self.source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        dt = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({proc.returncode}):\n{proc.stdout}\n"
                               f"{proc.stderr}")
        if verbose and (proc.stdout or proc.stderr):
            print(proc.stdout + proc.stderr, end="")
        os.replace(tmp, path)
        return path, dt

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            path, _ = self.build()
            lib = ctypes.CDLL(str(path))
            self._declare(lib)
            self._lib = lib
        return self._lib
