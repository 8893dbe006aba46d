"""Fused panoptic post-processing, plain PyTorch versions (counterpart of
``slotvps_tpu/ops/pallas/postproc_v3.py``).

Seven functions of whole tensors, each the plain version of one hand-written
Hopper kernel (``ops/cuda/postproc_v3.py``) and of one TPU kernel:

* :func:`theta`  — per-pixel binarization threshold
  ``log(thr) + logsumexp`` over the valid slots (``theta_v3``),
* :func:`claim`  — the sequential greedy claim loop over valid thing slots
  (``claim_v3``),
* :func:`argmax` — masked per-pixel argmax with per-tile per-slot areas
  (``argmax_v3(per_tile=True)``), and with ``top2`` the runner-up map
  (``argmax_v3(top2=True)``),
* :func:`repair` — one small-area-filter iteration that recomputes the
  argmax on dirty row tiles only (``repair_v3``),
* :func:`hist`   — per-slot pixel counts of an id map (``hist_v3``),
* :func:`sseg`   — the semantic map of quarter-res logits: x4 upsample and
  channel argmax (``sseg_v3``).

Masks arrive slot-major at low resolution, ``m_klow [K, h, w]`` f32; every
full-resolution map is row-major ``[4h, 4w]``.  (The TPU kernels' phase-
blocked ``[4, 4, h, w]`` layout is a lane-tiling device and is not carried
over.)  The x4 upsample is the exact fixed-phase bilinear form of
``ops/interpolate.py`` — rows first, then columns, edges replicated, each
``a*x + b*y`` two separately rounded products and one rounded sum — so the
kernels, which compute the same arithmetic per pixel, agree bit for bit.

Row tiles are the JAX package's: ``hb = gcd(8, h)`` low-res rows, so
``4*hb`` full-res rows and ``T = h / hb`` tiles, and per-tile areas compare
one to one with the JAX kernels' (whose extra columns for padded slots are
always zero).
"""

from __future__ import annotations

import math

import torch

from slotvps_tpu_torch.ops.claim_scan import claim_scan
from slotvps_tpu_torch.ops.interpolate import upsample_x4_bilinear

_NEG = -1e30


def tile_rows(h: int) -> int:
    """Low-res rows per row tile (the JAX kernels' ``hb``)."""
    return math.gcd(8, h)


def upsample_slots(m_klow: torch.Tensor) -> torch.Tensor:
    """[K, h, w] -> [K, 4h, 4w], the exact x4 bilinear upsample."""
    return upsample_x4_bilinear(m_klow.float()[..., None])[..., 0]


def theta(m_klow: torch.Tensor, valid: torch.Tensor,
          pixel_threshold: float) -> torch.Tensor:
    """theta [4h, 4w] f32 = log(thr) + logsumexp over valid slots; a slot
    binarizes to 1 at a pixel iff its upsampled logit is >= theta there
    (softmax over valid slots >= thr).  The sum is ``(log(thr) + max) +
    log(sum exp)``, in the TPU kernel's order; ``log(sum exp)`` is taken in
    float64 and rounded once, so this version is accurate to f32 rounding
    whatever order a kernel sums in."""
    up = upsample_slots(m_klow)
    vals = torch.where(valid[:, None, None], up, _NEG)
    mx = vals.amax(dim=0)
    z = torch.exp((vals - mx).double()).sum(dim=0)
    log_thr = torch.tensor(math.log(pixel_threshold), dtype=torch.float32,
                           device=mx.device)
    return (log_thr + mx) + torch.log(torch.clamp_min(z, 1e-30)).float()


def claim(m_klow: torch.Tensor, theta_map: torch.Tensor,
          labels: torch.Tensor, is_thing: torch.Tensor, valid: torch.Tensor,
          fraction_threshold: float):
    """Greedy claim loop over the valid thing slots in slot order, on the
    planes ``up_i >= theta``: :func:`slotvps_tpu_torch.ops.claim_scan.
    claim_scan` (n = a plane's pixel count, ovl = its pixels already owned
    by a slot of its own class; rejected if ``n == 0``, ``n == 4h*4w`` or
    ``f32(ovl) / f32(max(n, 1)) > f32(fraction_threshold)``; a kept slot
    claims its unowned pixels).
    Returns (keep_things [K] bool, owner [4h, 4w] int8, -1 = unowned)."""
    return claim_scan(upsample_slots(m_klow) >= theta_map, labels, is_thing,
                      valid, fraction_threshold)


def _masked_vals(up, owner, kept, is_thing):
    """[K, H, W] values of the masked argmax: thing slots count only where
    they own the pixel (elsewhere 0.0), slots not kept are -1e30."""
    k = up.shape[0]
    pos = torch.arange(k, device=up.device)[:, None, None]
    vals = torch.where(is_thing[:, None, None] & (owner[None].long() != pos),
                       0.0, up)
    return torch.where(kept[:, None, None], vals, _NEG)


def tile_areas(m_id: torch.Tensor, k: int, hb: int) -> torch.Tensor:
    """[T, K] int32 per-row-tile counts of each slot in ``m_id``."""
    rows = 4 * hb
    t = m_id.shape[0] // rows
    tile = torch.arange(t, device=m_id.device).repeat_interleave(rows)
    idx = tile[:, None] * k + m_id.long()
    return torch.bincount(idx.flatten(), minlength=t * k).reshape(t, k) \
        .to(torch.int32)


def argmax(m_klow: torch.Tensor, owner: torch.Tensor, kept: torch.Tensor,
           is_thing: torch.Tensor, top2: bool = False):
    """Masked argmax (ties to the first slot) + per-tile areas.  Returns
    (m_id [4h, 4w] int32, areas_tile [T, K] int32); with ``top2`` (m_id,
    m2_id, areas_tile), where m2_id [4h, 4w] int32 is the runner-up: the
    argmax with the winner's value set to -1e30 (excluded by index, first
    index on ties, so it names the winner again where every other slot is
    at -1e30 and the winner comes first)."""
    k, h, _ = m_klow.shape
    vals = _masked_vals(upsample_slots(m_klow), owner, kept, is_thing)
    m_id = torch.argmax(vals, dim=0)
    areas = tile_areas(m_id, k, tile_rows(h))
    if not top2:
        return m_id.to(torch.int32), areas
    pos = torch.arange(k, device=vals.device)[:, None, None]
    m2_id = torch.argmax(torch.where(pos == m_id[None], _NEG, vals), dim=0)
    return m_id.to(torch.int32), m2_id.to(torch.int32), areas


def repair(m_klow: torch.Tensor, owner: torch.Tensor, m1: torch.Tensor,
           kept: torch.Tensor, is_thing: torch.Tensor, dirty: torch.Tensor,
           areas_tile_prev: torch.Tensor):
    """One small-area-filter iteration: the masked argmax is recomputed on
    the row tiles flagged in ``dirty`` [T] and copied from ``m1`` /
    ``areas_tile_prev`` on the others.  Returns (m1n [4h, 4w] int32,
    areas_tile [T, K] int32)."""
    k, h, _ = m_klow.shape
    hb = tile_rows(h)
    m_new, areas_new = argmax(m_klow, owner, kept, is_thing)
    rows = dirty.repeat_interleave(4 * hb)[:, None]
    return (torch.where(rows, m_new, m1),
            torch.where(dirty[:, None], areas_new, areas_tile_prev))


def hist(m_id: torch.Tensor, k: int) -> torch.Tensor:
    """Per-slot pixel counts [k] int32 of an id map ``m_id`` (any shape);
    ids outside [0, k) are not counted."""
    ids = m_id.flatten().long()
    ids = torch.where((ids >= 0) & (ids < k), ids, k)
    return torch.bincount(ids, minlength=k + 1)[:k].to(torch.int32)


def sseg(score_hwc: torch.Tensor) -> torch.Tensor:
    """The semantic map of quarter-res logits ``score_hwc`` [h, w, C] f32:
    ``argmax(upsample_x4_bilinear(score), -1)`` [4h, 4w] int64, ties to the
    first channel."""
    return torch.argmax(upsample_x4_bilinear(score_hwc.float()), dim=-1)
