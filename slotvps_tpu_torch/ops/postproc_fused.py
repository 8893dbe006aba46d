"""Panoptic post-processing on K-minor masks, plain PyTorch versions
(counterpart of ``slotvps_tpu/ops/pallas/postproc_fused.py``).

Three functions of whole tensors, each the plain version of one hand-written
Hopper kernel (``ops/cuda/postproc_fused.py``) and of one TPU kernel:

* :func:`theta_fused`      — per-pixel binarization threshold
  ``log(thr) + logsumexp`` over the valid slots (``theta_pallas``),
* :func:`claim_scan_fused` — the greedy claim loop over the valid thing
  slots on planes binarized against theta (``claim_scan_fused``),
* :func:`argmax_areas`     — the masked per-pixel argmax and the per-slot
  areas of the whole map (``argmax_areas_pallas``).

Masks arrive K-minor at low resolution, ``m_hwk [h, w, K]`` f32, as the TPU
functions take them; every full-resolution map is row-major ``[4h, 4w]``.
They compute what the slot-major functions of :mod:`ops.postproc_v3
<slotvps_tpu_torch.ops.postproc_v3>` compute on the same masks, so each is
that function on a ``[K, h, w]`` view: the exact x4 upsample
(``upsample_slots``) and the one claim rule (``ops/claim_scan.claim_scan``)
keep a single copy.
"""

from __future__ import annotations

import torch

from slotvps_tpu_torch.ops import postproc_v3


def _slot_major(m_hwk: torch.Tensor) -> torch.Tensor:
    """The [K, h, w] view of K-minor masks (no copy)."""
    if m_hwk.ndim != 3:
        raise ValueError(f"masks must be [h, w, K], got {tuple(m_hwk.shape)}")
    return m_hwk.permute(2, 0, 1)


def theta_fused(m_hwk: torch.Tensor, valid: torch.Tensor,
                pixel_threshold: float) -> torch.Tensor:
    """theta [4h, 4w] f32 (see :func:`postproc_v3.theta`)."""
    return postproc_v3.theta(_slot_major(m_hwk), valid, pixel_threshold)


def claim_scan_fused(m_hwk: torch.Tensor, theta: torch.Tensor,
                     labels: torch.Tensor, is_thing: torch.Tensor,
                     valid: torch.Tensor, fraction_threshold: float):
    """(keep_things [K] bool, owner [4h, 4w] int8, -1 = unowned) of the
    claim loop on the planes ``up_i >= theta`` (see
    :func:`postproc_v3.claim`)."""
    return postproc_v3.claim(_slot_major(m_hwk), theta, labels, is_thing,
                             valid, fraction_threshold)


def argmax_areas(m_hwk: torch.Tensor, owner: torch.Tensor,
                 kept: torch.Tensor, is_thing: torch.Tensor):
    """(m_id [4h, 4w] int32, areas [K] int32): the first slot holding the
    max of the values of :func:`postproc_v3.argmax` (thing slots count only
    where they own the pixel, elsewhere 0.0; slots not kept are -1e30), and
    each slot's pixel count in ``m_id``."""
    m_id, areas_tile = postproc_v3.argmax(_slot_major(m_hwk), owner, kept,
                                          is_thing)
    return m_id, areas_tile.sum(dim=0, dtype=torch.int32)
