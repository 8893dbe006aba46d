"""Hopper claim-scan kernel: library and wrapper.

``csrc/claim_scan.cu`` is built and loaded by :class:`KernelLibrary`
(``ops/cuda/build.py``).  :func:`claim_scan_hopper` has the signature of
its plain version, :func:`slotvps_tpu_torch.ops.claim_scan.claim_scan`, plus
the slot range the loop visits.  On CPU tensors it runs the plain version;
on CUDA tensors it launches the kernel or raises — there is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from slotvps_tpu_torch.ops.claim_scan import MAX_SLOTS, claim_scan
from slotvps_tpu_torch.ops.cuda.build import KernelLibrary


def _declare(lib: ctypes.CDLL):
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.cs_claim_scan.argtypes = [p, ll, ll, ll, p, p, f, i, i, i, i, i, p,
                                  p, p, p]
    lib.cs_claim_scan.restype = i
    lib.cs_error_string.argtypes = [i]
    lib.cs_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary("claim_scan", _declare)


def claim_scan_hopper(logit: torch.Tensor, labels: torch.Tensor,
                      is_thing: torch.Tensor, valid: torch.Tensor,
                      fraction_threshold: float,
                      slots: Optional[Tuple[int, int]] = None):
    """(keep_things [..., K] bool, owner [..., H, W] int8) of binarized
    planes ``logit`` [K, H, W] or [B, K, H, W] (see :func:`claim_scan`).

    On the card the planes are 1-byte (bool, int8 or uint8) and may have
    any strides that put the H*W pixels of a plane at one stride (the
    contiguous planes, or a permuted [H, W, K] stack).  ``slots = (lo, hi)``
    is a range of slots that holds every valid thing slot of every video
    (default: all K); the kernel launches once per slot of it plus once,
    and adds that to ``claim_scan_hopper.launches``.  The plain version
    ignores it."""
    per_slot = (labels, is_thing, valid)
    if all(t.device.type == "cpu" for t in (logit, *per_slot)):
        return claim_scan(logit, labels, is_thing, valid,
                          fraction_threshold)
    dev = logit.device
    name = "claim_scan_hopper"
    if dev.type != "cuda" or any(t.device != dev for t in per_slot):
        raise ValueError(f"{name}: every tensor must lie on one CUDA device "
                         "(or all on the CPU)")
    batched = logit.ndim == 4
    planes = logit if batched else logit[None]
    if planes.ndim != 4 or planes.element_size() != 1 \
            or planes.dtype.is_floating_point:
        raise TypeError(f"{name}: logit must be 1-byte [K, H, W] or "
                        f"[B, K, H, W] planes, got {logit.dtype} "
                        f"{tuple(logit.shape)}")
    b, k, h, w = planes.shape
    if not 1 <= k <= MAX_SLOTS:
        raise ValueError(f"{name}: K={k} slots; the kernel takes 1..."
                         f"{MAX_SLOTS} (int8 owner maps)")
    sb, sk, sh, sw = planes.stride()
    if h > 1 and sh != w * sw:
        raise ValueError(f"{name}: the pixels of a plane must lie at one "
                         f"stride, got strides {planes.stride()}")
    if h * w >= 2 ** 31:
        raise ValueError(f"{name}: {h}x{w} pixels exceed the int32 counts")
    vecs = []
    for key, t in zip(("labels", "is_thing", "valid"), per_slot):
        t = t if batched else t[None]
        if tuple(t.shape) != (b, k):
            raise ValueError(f"{name}: {key} must be [{k}] (or [B, {k}] "
                             f"with batched planes), got {tuple(t.shape)}")
        vecs.append(t)
    lab, thing, val = vecs
    lo, hi = (0, k) if slots is None else (int(slots[0]), int(slots[1]))
    if not 0 <= lo <= hi <= k:
        raise ValueError(f"{name}: slots {slots} outside [0, {k}]")
    flags = (val.bool() & thing.bool()).to(torch.uint8).contiguous()
    labels32 = lab.to(torch.int32).contiguous()
    owner = torch.empty((b, h, w), dtype=torch.int8, device=dev)
    keep = torch.empty((b, k), dtype=torch.uint8, device=dev)
    scratch = torch.empty(((3 * k + 1) * b,), dtype=torch.int32, device=dev)
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.cs_claim_scan(
            planes.data_ptr(), sb, sk, sw, labels32.data_ptr(),
            flags.data_ptr(), fraction_threshold, b, k, h * w, lo, hi,
            owner.data_ptr(), keep.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("cs_claim_scan launch failed: "
                           + lib.cs_error_string(rc).decode())
    claim_scan_hopper.launches += hi - lo + 1
    keep = keep.bool()
    return (keep, owner) if batched else (keep[0], owner[0])


claim_scan_hopper.launches = 0
