"""Hopper claim-scan kernel: library, wrapper and the claim loops' launch
geometry.

``csrc/claim_scan.cu`` is built and loaded by :class:`KernelLibrary`
(``ops/cuda/build.py``).  :func:`claim_scan_hopper` has the signature of
its plain version, :func:`slotvps_tpu_torch.ops.claim_scan.claim_scan`, plus
the slot range the loop visits.  On CPU tensors it runs the plain version;
on CUDA tensors it launches the kernel or raises — there is no fallback.

:func:`claim_geometry` plans the one persistent launch of both claim
kernels (this one and ``claim_kernel`` of ``csrc/postproc_v3.cu``; their
shared loop is ``csrc/claim_loop.cuh``): how many blocks, how many pixels
of each video a block owns, how many valid things one bits pass covers,
and whether the owner tile and the bit words fit in shared memory.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from slotvps_tpu_torch.ops.claim_scan import MAX_SLOTS, claim_scan
from slotvps_tpu_torch.ops.cuda.build import KernelLibrary
from slotvps_tpu_torch.ops.cuda.deform_conv import MAX_SMEM

CLAIM_MIN_RUN = 1024     # pixels a block at least: small maps take fewer
# (chunk, owner tile in shared memory, bit words in shared memory), tried
# in order: narrower chunks (1- or 2-byte words) before leaving shared
# memory, the owner tile before the words; past the last, the videos go in
# groups.
CLAIM_PLANS = ((32, True, True), (16, True, True), (8, True, True),
               (8, False, True), (32, False, False))


class ClaimGeometry(NamedTuple):
    """The launch of one claim loop (``claim_loop.cuh``)."""
    blocks: int        # one per SM at most, all resident
    run: int           # pixels of each video a block owns (a multiple of 16)
    chunk: int         # valid things a bits pass, 1 .. 32
    own_smem: bool     # the owner tile in shared memory (else in the output)
    bits_smem: bool    # the bit words in shared memory (else in `words`)
    group: int         # videos a pass (all of them when they fit)
    smem: int          # dynamic shared memory of a block, bytes


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def word_bytes(chunk: int) -> int:
    """Bytes of one pixel's bit word at this chunk width."""
    return 1 if chunk <= 8 else 2 if chunk <= 16 else 4


def claim_smem(b: int, k: int, run: int, chunk: int, own_smem: bool,
               bits_smem: bool, stage: int = 0) -> int:
    """``claim_loop.cuh`` ``claim_smem_bytes``: labels [B*K] int32, the
    valid-thing lists and each slot's place in them [B*K] bytes each, 67
    int32 a video, ``stage`` bytes a chunk slot of the caller's staging,
    then the owner tile [B*run] and the words [B*run] where they live in
    shared memory; each region 16-byte aligned."""
    return (_round16(4 * b * k) + 2 * _round16(b * k) + _round16(4 * 67 * b)
            + _round16(stage * chunk)
            + (_round16(b * run) if own_smem else 0)
            + (_round16(b * run * word_bytes(chunk)) if bits_smem else 0))


@functools.lru_cache(maxsize=64)
def claim_geometry(b: int, h: int, w: int, k: int, sms: int,
                   smem: int = MAX_SMEM, stage: int = 0) -> ClaimGeometry:
    """The geometry of a claim loop over ``b`` maps of ``h`` x ``w`` pixels
    and ``k`` slots on a card of ``sms`` SMs with ``smem`` bytes of shared
    memory a block; ``stage`` bytes a chunk slot of staging (the theta
    claim's row strips).  One block an SM (fewer when a map has fewer than
    ``CLAIM_MIN_RUN`` pixels a block), each owning a run of pixels of every
    map that is a multiple of 16; the first plan of ``CLAIM_PLANS`` whose
    shared memory fits, or, when none does, the last plan on the most
    videos a pass that fit (the kernel takes the groups in turn)."""
    hw = h * w
    blocks = max(1, min(sms, -(-hw // CLAIM_MIN_RUN)))
    run = _round16(max(1, -(-hw // blocks)))
    blocks = max(1, -(-hw // run))
    for chunk, own, bits in CLAIM_PLANS:
        need = claim_smem(b, k, run, chunk, own, bits, stage)
        if need <= smem:
            return ClaimGeometry(blocks, run, chunk, own, bits, b, need)
    chunk, own, bits = CLAIM_PLANS[-1]
    lo, hi = 0, b          # claim_smem grows with the group: bisect it
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if claim_smem(mid, k, run, chunk, own, bits, stage) <= smem:
            lo = mid
        else:
            hi = mid - 1
    if lo == 0:
        raise ValueError(f"claim loop: one map of {k} slots needs more "
                         f"than {smem} bytes of shared memory a block")
    return ClaimGeometry(blocks, run, chunk, own, bits, lo,
                         claim_smem(lo, k, run, chunk, own, bits, stage))


def claim_buffers(geo: ClaimGeometry, b: int, k: int, hw: int, dev):
    """The loop's device buffers: the counters (a 64-bit counter and an
    int32 pixel count a video and slot, as 3 B K int32; the launcher zeroes
    them) and, when the words leave shared memory, one group's [group, hw
    rounded up to 16] words as bytes (else None)."""
    counts = torch.empty((3 * b * k,), dtype=torch.int32, device=dev)
    words = None if geo.bits_smem else torch.empty(
        (geo.group * _round16(hw) * word_bytes(geo.chunk),),
        dtype=torch.uint8, device=dev)
    return counts, words


@functools.lru_cache(maxsize=None)
def card_sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _declare(lib: ctypes.CDLL):
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.cs_claim_scan.argtypes = [p, ll, ll, ll, p, p, p, f] + [i] * 11 \
        + [p] * 5
    lib.cs_claim_scan.restype = i
    lib.cs_claim_smem.argtypes = [i, i, i, i, i, i]
    lib.cs_claim_smem.restype = ll
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
    (default: all K).  The kernel runs the whole loop in one launch
    (:func:`claim_geometry`), counted in ``claim_scan_hopper.launches``.
    The plain version ignores ``slots``."""
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
    lab, thing, val = (vecs[0].long().contiguous(),
                       vecs[1].bool().contiguous(), vecs[2].bool().contiguous())
    lo, hi = (0, k) if slots is None else (int(slots[0]), int(slots[1]))
    if not 0 <= lo <= hi <= k:
        raise ValueError(f"{name}: slots {slots} outside [0, {k}]")
    geo = claim_geometry(b, h, w, k, card_sms(dev))
    owner = torch.empty((b, h, w), dtype=torch.int8, device=dev)
    keep = torch.empty((b, k), dtype=torch.bool, device=dev)
    counts, words = claim_buffers(geo, b, k, h * w, dev)
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.cs_claim_scan(
            planes.data_ptr(), sb, sk, sw, lab.data_ptr(), val.data_ptr(),
            thing.data_ptr(), fraction_threshold, b, k, h * w, lo, hi,
            geo.blocks, geo.run, geo.chunk, int(geo.own_smem),
            int(geo.bits_smem), geo.group, owner.data_ptr(), keep.data_ptr(),
            counts.data_ptr(), None if words is None else words.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("cs_claim_scan launch failed: "
                           + lib.cs_error_string(rc).decode())
    claim_scan_hopper.launches += 1
    return (keep, owner) if batched else (keep[0], owner[0])


claim_scan_hopper.launches = 0
