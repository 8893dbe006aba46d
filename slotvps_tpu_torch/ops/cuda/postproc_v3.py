"""Hopper postprocess kernels: library and wrappers.

``csrc/postproc_v3.cu`` is built and loaded by :class:`KernelLibrary`
(``ops/cuda/build.py``).  One wrapper per kernel, each with the signature of
its plain version in :mod:`slotvps_tpu_torch.ops.postproc_v3`:

* :func:`theta_hopper`, :func:`claim_hopper`, :func:`argmax_hopper`,
  :func:`repair_hopper`, :func:`sseg_hopper`.

On CPU tensors a wrapper runs the plain version; on CUDA tensors it
launches its kernel or raises — there is no fallback.  Each kernel launch
adds one to the wrapper's ``launches`` count (the claim loop is one launch
per slot of its range plus one).  The wrappers allocate every output;
kernels launch on PyTorch's current stream and do not synchronise.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from slotvps_tpu_torch.ops import postproc_v3 as plain
from slotvps_tpu_torch.ops.cuda.build import KernelLibrary

MAX_SLOTS = 127   # int8 owner maps


def _declare(lib: ctypes.CDLL):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pp_theta.argtypes = [p, p, f, p, i, i, i, p]
    lib.pp_claim.argtypes = [p, p, p, p, f, i, i, i, i, i, p, p, p, p]
    lib.pp_argmax.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    lib.pp_repair.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.pp_sseg.argtypes = [p, p, i, i, i, p]
    for fn in (lib.pp_theta, lib.pp_claim, lib.pp_argmax, lib.pp_repair,
               lib.pp_sseg):
        fn.restype = i
    lib.pp_error_string.argtypes = [i]
    lib.pp_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary("postproc_v3", _declare)


def _on_card(name: str, m_klow: torch.Tensor, vecs=(), **maps) -> bool:
    """False when every tensor lies on the CPU (run the plain version);
    True when all lie on one CUDA device and fit the kernel; else raises.

    ``maps`` are the full-resolution maps, given as name=(tensor, dtype);
    the per-slot vectors ``vecs`` are checked further by
    :func:`_slot_vec`."""
    tensors = [m_klow, *vecs] + [t for t, _ in maps.values()]
    if all(t.device.type == "cpu" for t in tensors):
        return False
    dev = m_klow.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: every tensor must lie on one CUDA device "
                         "(or all on the CPU)")
    if m_klow.ndim != 3 or m_klow.dtype != torch.float32 \
            or not m_klow.is_contiguous():
        raise TypeError(f"{name}: m_klow must be a contiguous float32 "
                        f"[K, h, w] tensor, got {m_klow.dtype} "
                        f"{tuple(m_klow.shape)}")
    k, h, w = m_klow.shape
    if not 1 <= k <= MAX_SLOTS:
        raise ValueError(f"{name}: K={k} slots; the kernels take 1..."
                         f"{MAX_SLOTS} (int8 owner maps)")
    for key, (t, dtype) in maps.items():
        if tuple(t.shape) != (4 * h, 4 * w) or t.dtype != dtype \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous {dtype} "
                             f"[{4 * h}, {4 * w}] map, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")
    return True


def _slot_vec(name: str, key: str, t: torch.Tensor, n: int, dev,
              dtype=torch.uint8) -> torch.Tensor:
    """A per-slot (or per-tile) vector of length ``n`` on ``dev`` as a
    contiguous ``dtype`` tensor for the kernel."""
    if t.shape != (n,) or t.device != dev:
        raise ValueError(f"{name}: {key} must be a [{n}] tensor on {dev}, "
                         f"got {tuple(t.shape)} on {t.device}")
    return t.to(dtype).contiguous()


def _raise_on(rc: int, fn: str):
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: "
                           + LIBRARY.load().pp_error_string(rc).decode())


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def theta_hopper(m_klow: torch.Tensor, valid: torch.Tensor,
                 pixel_threshold: float) -> torch.Tensor:
    """theta [4h, 4w] f32 (see :func:`plain.theta`)."""
    if not _on_card("theta_hopper", m_klow, (valid,)):
        return plain.theta(m_klow, valid, pixel_threshold)
    k, h, w = m_klow.shape
    dev = m_klow.device
    valid8 = _slot_vec("theta_hopper", "valid", valid, k, dev)
    out = torch.empty((4 * h, 4 * w), dtype=torch.float32, device=dev)
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.pp_theta(m_klow.data_ptr(), valid8.data_ptr(),
                          math.log(pixel_threshold), out.data_ptr(), k, h, w,
                          _stream(dev))
    _raise_on(rc, "pp_theta")
    theta_hopper.launches += 1
    return out


def claim_hopper(m_klow: torch.Tensor, theta_map: torch.Tensor,
                 labels: torch.Tensor, is_thing: torch.Tensor,
                 valid: torch.Tensor, fraction_threshold: float,
                 slots: Optional[Tuple[int, int]] = None):
    """(keep_things [K] bool, owner [4h, 4w] int8) (see
    :func:`plain.claim`).

    ``slots = (lo, hi)`` is a range of slots that holds every valid thing
    slot (default: all K); the kernel path launches once per slot of it
    plus once to apply the last claim, and skips the slots that are not
    valid things on the device.  The plain version ignores it."""
    if not _on_card("claim_hopper", m_klow, (labels, is_thing, valid),
                    theta=(theta_map, torch.float32)):
        return plain.claim(m_klow, theta_map, labels, is_thing, valid,
                           fraction_threshold)
    k, h, w = m_klow.shape
    dev = m_klow.device
    lo, hi = (0, k) if slots is None else (int(slots[0]), int(slots[1]))
    if not 0 <= lo <= hi <= k:
        raise ValueError(f"claim_hopper: slots {slots} outside [0, {k}]")
    name = "claim_hopper"
    flags = (_slot_vec(name, "valid", valid, k, dev, torch.bool)
             & _slot_vec(name, "is_thing", is_thing, k, dev, torch.bool)) \
        .to(torch.uint8)
    labels32 = _slot_vec(name, "labels", labels, k, dev, torch.int32)
    owner = torch.empty((4 * h, 4 * w), dtype=torch.int8, device=dev)
    keep = torch.empty((k,), dtype=torch.uint8, device=dev)
    scratch = torch.empty((3 * k + 1,), dtype=torch.int32, device=dev)
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.pp_claim(m_klow.data_ptr(), theta_map.data_ptr(),
                          labels32.data_ptr(), flags.data_ptr(),
                          fraction_threshold, k, h, w, lo, hi,
                          owner.data_ptr(), keep.data_ptr(),
                          scratch.data_ptr(), _stream(dev))
    _raise_on(rc, "pp_claim")
    claim_hopper.launches += hi - lo + 1
    return keep.bool(), owner


def argmax_hopper(m_klow: torch.Tensor, owner: torch.Tensor,
                  kept: torch.Tensor, is_thing: torch.Tensor):
    """(m_id [4h, 4w] int32, areas_tile [T, K] int32) (see
    :func:`plain.argmax`)."""
    if not _on_card("argmax_hopper", m_klow, (kept, is_thing),
                    owner=(owner, torch.int8)):
        return plain.argmax(m_klow, owner, kept, is_thing)
    k, h, w = m_klow.shape
    dev = m_klow.device
    hb = plain.tile_rows(h)
    kept8 = _slot_vec("argmax_hopper", "kept", kept, k, dev)
    thing8 = _slot_vec("argmax_hopper", "is_thing", is_thing, k, dev)
    m_id = torch.empty((4 * h, 4 * w), dtype=torch.int32, device=dev)
    areas = torch.zeros((h // hb, k), dtype=torch.int32, device=dev)
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.pp_argmax(m_klow.data_ptr(), owner.data_ptr(),
                           kept8.data_ptr(), thing8.data_ptr(),
                           m_id.data_ptr(), areas.data_ptr(), k, h, w, hb,
                           _stream(dev))
    _raise_on(rc, "pp_argmax")
    argmax_hopper.launches += 1
    return m_id, areas


def repair_hopper(m_klow: torch.Tensor, owner: torch.Tensor,
                  m1: torch.Tensor, kept: torch.Tensor,
                  is_thing: torch.Tensor, dirty: torch.Tensor,
                  areas_tile_prev: torch.Tensor):
    """(m1n [4h, 4w] int32, areas_tile [T, K] int32) (see
    :func:`plain.repair`)."""
    if not _on_card("repair_hopper", m_klow,
                    (kept, is_thing, dirty, areas_tile_prev),
                    owner=(owner, torch.int8), m1=(m1, torch.int32)):
        return plain.repair(m_klow, owner, m1, kept, is_thing, dirty,
                            areas_tile_prev)
    k, h, w = m_klow.shape
    dev = m_klow.device
    hb = plain.tile_rows(h)
    t = h // hb
    name = "repair_hopper"
    kept8 = _slot_vec(name, "kept", kept, k, dev)
    thing8 = _slot_vec(name, "is_thing", is_thing, k, dev)
    dirty8 = _slot_vec(name, "dirty", dirty, t, dev)
    if tuple(areas_tile_prev.shape) != (t, k) \
            or areas_tile_prev.dtype != torch.int32 \
            or areas_tile_prev.device != dev:
        raise ValueError(f"{name}: areas_tile_prev must be int32 [{t}, {k}] "
                         f"on {dev}, got {areas_tile_prev.dtype} "
                         f"{tuple(areas_tile_prev.shape)}")
    prev = areas_tile_prev.contiguous()
    m_id = torch.empty((4 * h, 4 * w), dtype=torch.int32, device=dev)
    areas = torch.zeros((t, k), dtype=torch.int32, device=dev)
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.pp_repair(m_klow.data_ptr(), owner.data_ptr(),
                           m1.data_ptr(), kept8.data_ptr(),
                           thing8.data_ptr(), dirty8.data_ptr(),
                           prev.data_ptr(), m_id.data_ptr(),
                           areas.data_ptr(), k, h, w, hb, _stream(dev))
    _raise_on(rc, "pp_repair")
    repair_hopper.launches += 1
    return m_id, areas


def sseg_hopper(score_hwc: torch.Tensor) -> torch.Tensor:
    """The semantic map [4h, 4w] int64 of quarter-res logits [h, w, C] f32
    (see :func:`plain.sseg`)."""
    if score_hwc.device.type == "cpu":
        return plain.sseg(score_hwc)
    if score_hwc.device.type != "cuda":
        raise ValueError("sseg_hopper: the logits must lie on a CUDA device "
                         "(or on the CPU)")
    if score_hwc.ndim != 3 or score_hwc.dtype != torch.float32 \
            or not score_hwc.is_contiguous():
        raise TypeError("sseg_hopper: the logits must be a contiguous "
                        f"float32 [h, w, C] tensor, got {score_hwc.dtype} "
                        f"{tuple(score_hwc.shape)}")
    h, w, c = score_hwc.shape
    if not 1 <= c <= MAX_SLOTS:
        raise ValueError(f"sseg_hopper: C={c} channels; the kernel takes "
                         f"1...{MAX_SLOTS}")
    dev = score_hwc.device
    out = torch.empty((4 * h, 4 * w), dtype=torch.int64, device=dev)
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.pp_sseg(score_hwc.data_ptr(), out.data_ptr(), c, h, w,
                         _stream(dev))
    _raise_on(rc, "pp_sseg")
    sseg_hopper.launches += 1
    return out


for _fn in (theta_hopper, claim_hopper, argmax_hopper, repair_hopper,
            sseg_hopper):
    _fn.launches = 0
