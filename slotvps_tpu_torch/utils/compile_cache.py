"""Where the port's compiled artifacts live (counterpart of
``slotvps_tpu/utils/compile_cache.py``).

The JAX package points XLA's persistent compilation cache at a directory.
The port compiles two kinds of artifact, each once and named by a hash of
its source and flags: the kernel libraries (``ops/cuda/build.py``
``KernelLibrary``, nvcc) and the host fusion library (``native/``, g++).
Both go to :func:`build_dir`: ``slotvps_tpu_torch/_build/`` unless
:func:`enable_compile_cache` points them elsewhere, as a user whose
package directory is read-only needs.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

DEFAULT_DIR = Path(__file__).resolve().parents[1] / "_build"
_dir = DEFAULT_DIR


def build_dir() -> Path:
    """The directory the next build writes to and loads from."""
    return _dir


def enable_compile_cache(path: Optional[str] = None) -> Path:
    """Build and load the kernel and native libraries under ``path``, else
    under ``SLOTVPS_COMPILE_CACHE`` (the JAX package's variable), else
    under :data:`DEFAULT_DIR`; returns the directory.  A native library
    already loaded from elsewhere is loaded again from there at its next
    use (built there first if it is not)."""
    global _dir
    from slotvps_tpu_torch import native

    new = Path(path or os.environ.get("SLOTVPS_COMPILE_CACHE")
               or DEFAULT_DIR).resolve()
    if new != _dir:
        _dir = new
        native.reset()
    return _dir
