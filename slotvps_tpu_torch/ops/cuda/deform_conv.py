"""Hopper DCN kernel: build, load and wrapper.

``csrc/deform_conv.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, under
``slotvps_tpu_torch/_build/`` (listed in ``.gitignore``), and loaded with
``ctypes``.  The library's name carries a hash of the source, so an edited
source is rebuilt.  Nothing is compiled or loaded at import time.

:func:`deform_conv2d_hopper` keeps the JAX package's layout at its
signature.  On CPU tensors it runs the plain version
(:func:`slotvps_tpu_torch.ops.deform_conv.deform_conv2d`); on CUDA tensors
it launches the kernel or raises — there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from slotvps_tpu_torch.ops.deform_conv import deform_conv2d

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "deform_conv.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"deform_conv_{digest[:12]}.so"


def build(verbose: bool = False) -> tuple:
    """Compile the kernel library if it is not built yet.

    Returns ``(path, seconds spent compiling)`` (0.0 when it was built)."""
    path = library_path()
    if path.exists():
        return path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    if verbose and (proc.stdout or proc.stderr):
        print(proc.stdout + proc.stderr, end="")
    os.replace(tmp, path)
    return path, dt


def _load():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dcn_forward_f32.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.dcn_forward_f32.restype = i
        lib.dcn_error_string.argtypes = [i]
        lib.dcn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def deform_conv2d_hopper(x: torch.Tensor, offset: torch.Tensor,
                         weight: torch.Tensor, halo: int) -> torch.Tensor:
    """3x3 stride-1 pad-1 deformable conv with samples clamped to +-halo.

    x [B, H, W, Cin], offset [B, H, W, 18] ([dy, dx] per tap), weight
    [3, 3, Cin, Cout]; returns [B, H, W, Cout].  f32 only, forward only.
    Each kernel launch adds one to ``deform_conv2d_hopper.launches``."""
    tensors = (x, offset, weight)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "deform_conv2d_hopper is forward-only: run it under "
            "torch.no_grad() (the backward kernel comes with training)")
    if all(t.device.type == "cpu" for t in tensors):
        return deform_conv2d(x, offset, weight, padding=1,
                             max_displacement=halo)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("deform_conv2d_hopper: x, offset and weight must "
                         "all lie on one CUDA device (or all on the CPU)")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("deform_conv2d_hopper takes float32 tensors only")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("deform_conv2d_hopper takes contiguous tensors")
    if x.ndim != 4 or weight.ndim != 4:
        raise ValueError(f"bad ranks: x {tuple(x.shape)}, "
                         f"weight {tuple(weight.shape)}")
    b, h, w, c_in = x.shape
    kh, kw, wc_in, c_out = weight.shape
    if (kh, kw) != (3, 3) or wc_in != c_in:
        raise ValueError(f"weight {tuple(weight.shape)} does not fit x "
                         f"{tuple(x.shape)} (need [3, 3, Cin, Cout])")
    if tuple(offset.shape) != (b, h, w, 18):
        raise ValueError(f"offset {tuple(offset.shape)} != {(b, h, w, 18)}")
    if c_out % 4:
        raise ValueError(f"Cout={c_out} must be a multiple of 4")
    if int(halo) < 0:
        raise ValueError(f"halo {halo} must be >= 0")

    lib = _load()
    out = torch.empty((b, h, w, c_out), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.dcn_forward_f32(x.data_ptr(), offset.data_ptr(),
                                 weight.data_ptr(), out.data_ptr(),
                                 b, h, w, c_in, c_out, int(halo), stream)
    if rc != 0:
        raise RuntimeError("dcn_forward_f32 launch failed: "
                           + lib.dcn_error_string(rc).decode())
    deform_conv2d_hopper.launches += 1
    return out


deform_conv2d_hopper.launches = 0
