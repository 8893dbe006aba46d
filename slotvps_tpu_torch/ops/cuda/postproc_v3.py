"""Hopper postprocess kernels: library and wrappers.

``csrc/postproc_v3.cu`` is built and loaded by :class:`KernelLibrary`
(``ops/cuda/build.py``).  One wrapper per kernel, each with the signature of
its plain version in :mod:`slotvps_tpu_torch.ops.postproc_v3`:

* :func:`theta_hopper`, :func:`claim_hopper`, :func:`argmax_hopper`,
  :func:`repair_hopper`, :func:`hist_hopper`, :func:`sseg_hopper`.

The same library's K-minor entries have their wrappers in
:mod:`slotvps_tpu_torch.ops.cuda.postproc_fused`.

On CPU tensors a wrapper runs the plain version; on CUDA tensors it
launches its kernel or raises — there is no fallback.  Each kernel launch
adds one to the wrapper's ``launches`` count (the claim loop is one
persistent cooperative launch, whose geometry comes from
:func:`slotvps_tpu_torch.ops.cuda.claim_scan.claim_geometry`;
``argmax_hopper(top2=True)`` counts in ``argmax_hopper.top2_launches``).
The wrappers allocate every output; kernels launch on PyTorch's current
stream and do not synchronise.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from slotvps_tpu_torch.ops import postproc_v3 as plain
from slotvps_tpu_torch.ops.cuda.build import KernelLibrary
from slotvps_tpu_torch.ops.cuda.claim_scan import (card_sms, claim_buffers,
                                                   claim_geometry)

MAX_SLOTS = 127   # int8 owner maps
TILE_COLS = 32    # low-res columns a block of the tiled kernels
# staging bytes a chunk slot of the claim kernel: the four f32 row phases
# of a strip of 256 low-res columns and both halos (csrc/postproc_v3.cu
# CSC)
CLAIM_STAGE = 4 * 4 * (256 + 2)


def tiled_geometry(h: int, w: int, hb: int):
    """(rows a block, grid (x, y)) of the argmax / repair and sseg kernels
    for h x w low-res rows in row tiles of ``hb`` rows (``hb`` divides
    ``h``; the K-minor argmax and sseg take the whole map, ``hb = h``): a
    block owns ``rb`` low-res rows x 32 columns, ``rb`` = 2 when that
    divides the tile, else 1, so that a block never spans two tiles.  The
    C entries compute the same (``csrc/postproc_v3.cu`` ``tiled_rows``;
    ``pp_tiled_geometry`` reports it)."""
    rb = 2 if hb % 2 == 0 else 1
    return rb, (-(-w // TILE_COLS), h // rb)


def _declare(lib: ctypes.CDLL):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pp_theta.argtypes = [p, p, f, p, i, i, i, p]
    lib.pp_theta_hwk.argtypes = [p, p, f, p, i, i, i, p]
    claim = [p, p, p, p, p, f] + [i] * 10 + [p] * 5
    lib.pp_claim.argtypes = claim
    lib.pp_claim_hwk.argtypes = claim
    lib.pp_claim_smem.argtypes = [i] * 5
    lib.pp_claim_smem.restype = ctypes.c_longlong
    lib.pp_argmax.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
    lib.pp_argmax_hwk.argtypes = [p, p, p, p, p, p, i, i, i, p]
    lib.pp_hist.argtypes = [p, ctypes.c_longlong, i, p, p]
    lib.pp_repair.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.pp_sseg.argtypes = [p, p, i, i, i, p]
    lib.pp_tiled_geometry.argtypes = [i, i, i, p]
    lib.pp_tiled_geometry.restype = None
    for fn in (lib.pp_theta, lib.pp_theta_hwk, lib.pp_claim,
               lib.pp_claim_hwk, lib.pp_argmax, lib.pp_argmax_hwk,
               lib.pp_repair, lib.pp_hist, lib.pp_sseg):
        fn.restype = i
    lib.pp_error_string.argtypes = [i]
    lib.pp_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary("postproc_v3", _declare)


def _on_card(name: str, m: torch.Tensor, vecs=(), k_minor: bool = False,
             **maps) -> bool:
    """False when every tensor lies on the CPU (run the plain version);
    True when all lie on one CUDA device and fit the kernel; else raises.

    ``m`` holds the low-res masks, slot-major [K, h, w] or, with
    ``k_minor``, [h, w, K]; ``maps`` are the full-resolution maps, given as
    name=(tensor, dtype); the per-slot vectors ``vecs`` are checked further
    by :func:`_slot_vec`."""
    tensors = [m, *vecs] + [t for t, _ in maps.values()]
    if all(t.device.type == "cpu" for t in tensors):
        return False
    dev = m.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: every tensor must lie on one CUDA device "
                         "(or all on the CPU)")
    dims = "[h, w, K]" if k_minor else "[K, h, w]"
    if m.ndim != 3 or m.dtype != torch.float32 or not m.is_contiguous():
        raise TypeError(f"{name}: the masks must be a contiguous float32 "
                        f"{dims} tensor, got {m.dtype} {tuple(m.shape)}")
    h, w, k = m.shape if k_minor else (*m.shape[1:], m.shape[0])
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
    contiguous ``dtype`` tensor for the kernel; a contiguous bool vector
    goes to uint8 as a view of its bytes (no device copy)."""
    if t.shape != (n,) or t.device != dev:
        raise ValueError(f"{name}: {key} must be a [{n}] tensor on {dev}, "
                         f"got {tuple(t.shape)} on {t.device}")
    if t.dtype == torch.bool and dtype == torch.uint8 and t.is_contiguous():
        return t.view(torch.uint8)
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


def claim_launch(name: str, m: torch.Tensor, theta_map: torch.Tensor,
                 labels: torch.Tensor, is_thing: torch.Tensor,
                 valid: torch.Tensor, fraction_threshold: float,
                 k: int, h: int, w: int, lo: int, hi: int,
                 k_minor: bool = False):
    """The claim kernel's one launch over the valid thing slots in [lo, hi)
    of masks ``m`` (slot-major, or [h, w, K] with ``k_minor``), checked by
    :func:`_on_card`: (keep [K] bool, owner [4h, 4w] int8)."""
    if not 0 <= lo <= hi <= k:
        raise ValueError(f"{name}: slots {(lo, hi)} outside [0, {k}]")
    if 16 * h * w >= 2 ** 31:
        raise ValueError(f"{name}: {4 * h}x{4 * w} pixels exceed the int32 "
                         "counts")
    dev = m.device
    valid = _slot_vec(name, "valid", valid, k, dev, torch.bool)
    thing = _slot_vec(name, "is_thing", is_thing, k, dev, torch.bool)
    labels = _slot_vec(name, "labels", labels, k, dev, torch.int64)
    geo = claim_geometry(1, 4 * h, 4 * w, k, card_sms(dev),
                         stage=CLAIM_STAGE)
    owner = torch.empty((4 * h, 4 * w), dtype=torch.int8, device=dev)
    keep = torch.empty((k,), dtype=torch.bool, device=dev)
    counts, words = claim_buffers(geo, 1, k, 16 * h * w, dev)
    lib = LIBRARY.load()
    entry = lib.pp_claim_hwk if k_minor else lib.pp_claim
    with torch.cuda.device(dev):
        rc = entry(m.data_ptr(), theta_map.data_ptr(), labels.data_ptr(),
                   valid.data_ptr(), thing.data_ptr(), fraction_threshold, k,
                   h, w, lo, hi, geo.blocks, geo.run, geo.chunk,
                   int(geo.own_smem), int(geo.bits_smem), owner.data_ptr(),
                   keep.data_ptr(), counts.data_ptr(),
                   None if words is None else words.data_ptr(), _stream(dev))
    _raise_on(rc, "pp_claim_hwk" if k_minor else "pp_claim")
    return keep, owner


def claim_hopper(m_klow: torch.Tensor, theta_map: torch.Tensor,
                 labels: torch.Tensor, is_thing: torch.Tensor,
                 valid: torch.Tensor, fraction_threshold: float,
                 slots: Optional[Tuple[int, int]] = None):
    """(keep_things [K] bool, owner [4h, 4w] int8) (see
    :func:`plain.claim`).

    ``slots = (lo, hi)`` is a range of slots that holds every valid thing
    slot (default: all K).  The kernel runs the whole loop in one launch
    and visits only the valid thing slots of the range.  The plain version
    ignores it."""
    if not _on_card("claim_hopper", m_klow, (labels, is_thing, valid),
                    theta=(theta_map, torch.float32)):
        return plain.claim(m_klow, theta_map, labels, is_thing, valid,
                           fraction_threshold)
    k, h, w = m_klow.shape
    lo, hi = (0, k) if slots is None else (int(slots[0]), int(slots[1]))
    out = claim_launch("claim_hopper", m_klow, theta_map, labels, is_thing,
                       valid, fraction_threshold, k, h, w, lo, hi)
    claim_hopper.launches += 1
    return out


def argmax_hopper(m_klow: torch.Tensor, owner: torch.Tensor,
                  kept: torch.Tensor, is_thing: torch.Tensor,
                  top2: bool = False):
    """(m_id [4h, 4w] int32, areas_tile [T, K] int32), with ``top2`` (m_id,
    m2_id [4h, 4w] int32, areas_tile) (see :func:`plain.argmax`).  One
    launch either way, counted in ``argmax_hopper.launches`` or, with
    ``top2``, in ``argmax_hopper.top2_launches``."""
    if not _on_card("argmax_hopper", m_klow, (kept, is_thing),
                    owner=(owner, torch.int8)):
        return plain.argmax(m_klow, owner, kept, is_thing, top2=top2)
    k, h, w = m_klow.shape
    dev = m_klow.device
    hb = plain.tile_rows(h)
    kept8 = _slot_vec("argmax_hopper", "kept", kept, k, dev)
    thing8 = _slot_vec("argmax_hopper", "is_thing", is_thing, k, dev)
    m_id = torch.empty((4 * h, 4 * w), dtype=torch.int32, device=dev)
    m2_id = torch.empty_like(m_id) if top2 else None
    areas = torch.empty((h // hb, k), dtype=torch.int32, device=dev)
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.pp_argmax(m_klow.data_ptr(), owner.data_ptr(),
                           kept8.data_ptr(), thing8.data_ptr(),
                           m_id.data_ptr(),
                           m2_id.data_ptr() if top2 else None,
                           areas.data_ptr(), k, h, w, hb, _stream(dev))
    _raise_on(rc, "pp_argmax")
    if top2:
        argmax_hopper.top2_launches += 1
        return m_id, m2_id, areas
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
    areas = torch.empty((t, k), dtype=torch.int32, device=dev)
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


def hist_hopper(m_id: torch.Tensor, k: int) -> torch.Tensor:
    """Per-slot pixel counts [k] int32 of an int32 id map (see
    :func:`plain.hist`); on the card the map is contiguous and 16-byte
    aligned, and 1 <= k <= 4096."""
    if m_id.device.type == "cpu":
        return plain.hist(m_id, k)
    if m_id.device.type != "cuda":
        raise ValueError("hist_hopper: the id map must lie on a CUDA device "
                         "(or on the CPU)")
    if m_id.dtype != torch.int32 or not m_id.is_contiguous() \
            or m_id.data_ptr() % 16:
        raise TypeError("hist_hopper: the id map must be a contiguous, "
                        f"16-byte aligned int32 tensor, got {m_id.dtype}")
    if not 1 <= k <= 4096:
        raise ValueError(f"hist_hopper: k={k}; the kernel takes 1...4096")
    dev = m_id.device
    areas = torch.empty((k,), dtype=torch.int32, device=dev)
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.pp_hist(m_id.data_ptr(), m_id.numel(), k, areas.data_ptr(),
                         _stream(dev))
    _raise_on(rc, "pp_hist")
    hist_hopper.launches += 1
    return areas


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
            hist_hopper, sseg_hopper):
    _fn.launches = 0
argmax_hopper.top2_launches = 0
