"""Hopper DCN kernels: library and wrapper.

``csrc/deform_conv.cu`` is built and loaded by :class:`KernelLibrary`
(``ops/cuda/build.py``: nvcc for ``sm_90a`` at first use, ctypes).  It has
two entry points, one per compute dtype: ``dcn_forward_f32`` (f32 FMA) and
``dcn_forward_bf16`` (bf16 tensor cores, f32 accumulation, the bf16 Pallas
kernel's rounding points).

:func:`deform_conv2d_hopper` keeps the JAX package's layout at its
signature and dispatches on the tensors' dtype.  On CPU tensors it runs the
plain version (:func:`slotvps_tpu_torch.ops.deform_conv.deform_conv2d` at
``compute_dtype=x.dtype``); on CUDA tensors it launches the kernel of that
dtype or raises — there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from slotvps_tpu_torch.ops.cuda.build import KernelLibrary
from slotvps_tpu_torch.ops.deform_conv import deform_conv2d


def _declare(lib: ctypes.CDLL):
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.dcn_forward_f32, lib.dcn_forward_bf16):
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = i
    lib.dcn_error_string.argtypes = [i]
    lib.dcn_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary("deform_conv", _declare)

# dtype -> (C entry point, launch-count key)
_ENTRY = {torch.float32: ("dcn_forward_f32", "float32"),
          torch.bfloat16: ("dcn_forward_bf16", "bfloat16")}


def deform_conv2d_hopper(x: torch.Tensor, offset: torch.Tensor,
                         weight: torch.Tensor, halo: int) -> torch.Tensor:
    """3x3 stride-1 pad-1 deformable conv with samples clamped to +-halo.

    x [B, H, W, Cin], offset [B, H, W, 18] ([dy, dx] per tap), weight
    [3, 3, Cin, Cout], all float32 or all bfloat16; returns [B, H, W, Cout]
    of that dtype.  Forward only.  Each kernel launch adds one to
    ``deform_conv2d_hopper.launches[dtype name]`` ("float32" or
    "bfloat16")."""
    tensors = (x, offset, weight)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "deform_conv2d_hopper is forward-only: run it under "
            "torch.no_grad() (the backward kernel comes with training)")
    if all(t.device.type == "cpu" for t in tensors):
        return deform_conv2d(x, offset, weight, padding=1,
                             max_displacement=halo, compute_dtype=x.dtype)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("deform_conv2d_hopper: x, offset and weight must "
                         "all lie on one CUDA device (or all on the CPU)")
    if x.dtype not in _ENTRY or any(t.dtype != x.dtype for t in tensors):
        raise TypeError("deform_conv2d_hopper takes float32 or bfloat16 "
                        "tensors, all of one dtype; got "
                        f"{[str(t.dtype) for t in tensors]}")
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
    if x.dtype == torch.float32 and c_out % 4:
        raise ValueError(f"Cout={c_out} must be a multiple of 4 in float32")
    if int(halo) < 0:
        raise ValueError(f"halo {halo} must be >= 0")

    entry, key = _ENTRY[x.dtype]
    lib = LIBRARY.load()
    out = torch.empty((b, h, w, c_out), dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(x.data_ptr(), offset.data_ptr(),
                                 weight.data_ptr(), out.data_ptr(),
                                 b, h, w, c_in, c_out, int(halo), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           + lib.dcn_error_string(rc).decode())
    deform_conv2d_hopper.launches[key] += 1
    return out


deform_conv2d_hopper.launches = {"float32": 0, "bfloat16": 0}
