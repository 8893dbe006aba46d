"""Fused panoptic post-processing, plain PyTorch versions (counterpart of
``slotvps_tpu/ops/pallas/postproc_v3.py``).

Four functions of whole tensors, each the plain version of one hand-written
Hopper kernel (``ops/cuda/postproc_v3.py``) and of one TPU kernel:

* :func:`theta`  — per-pixel binarization threshold
  ``log(thr) + logsumexp`` over the valid slots (``theta_v3``),
* :func:`claim`  — the sequential greedy claim loop over valid thing slots
  (``claim_v3``),
* :func:`argmax` — masked per-pixel argmax with per-tile per-slot areas
  (``argmax_v3(per_tile=True)``),
* :func:`repair` — one small-area-filter iteration that recomputes the
  argmax on dirty row tiles only (``repair_v3``).

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
    """Greedy claim loop over the valid thing slots in slot order.

    Slot i binarizes as ``up_i >= theta``; with n = its pixel count and
    ovl = its pixels already owned by a slot of its own class, it is
    rejected if ``n == 0``, ``n == 4h*4w`` or ``f32(ovl) / f32(max(n, 1))
    > f32(fraction_threshold)``; a kept slot claims its unowned pixels.
    Returns (keep_things [K] bool, owner [4h, 4w] int8, -1 = unowned)."""
    k = m_klow.shape[0]
    if k > 127:
        raise ValueError(f"{k} slots do not fit the int8 owner maps")
    up = upsample_slots(m_klow)
    dev = up.device
    n_pix = up.shape[1] * up.shape[2]
    owner = torch.full(up.shape[1:], -1, dtype=torch.int8, device=dev)
    keep = torch.zeros(k, dtype=torch.bool, device=dev)
    frac = torch.tensor(fraction_threshold, dtype=torch.float32, device=dev)
    labels_l = labels.long()
    for i in torch.nonzero(valid & is_thing).flatten().tolist():
        lg = up[i] >= theta_map
        n = lg.sum()
        owned = owner >= 0
        same = owned & (labels_l[owner.long().clamp_min(0)] == labels_l[i])
        ovl = (lg & same).sum()
        reject = ((n == 0) | (n == n_pix)
                  | (ovl.float() / n.clamp_min(1).float() > frac))
        keep_i = ~reject
        owner.masked_fill_(lg & ~owned & keep_i, i)
        keep[i] = keep_i
    return keep, owner


def _masked_argmax(up, owner, kept, is_thing):
    """Per-pixel winner: thing slots count only where they own the pixel
    (elsewhere 0.0), slots not kept are -1e30; ties go to the first
    slot."""
    k = up.shape[0]
    pos = torch.arange(k, device=up.device)[:, None, None]
    vals = torch.where(is_thing[:, None, None] & (owner[None].long() != pos),
                       0.0, up)
    vals = torch.where(kept[:, None, None], vals, _NEG)
    return torch.argmax(vals, dim=0).to(torch.int32)


def tile_areas(m_id: torch.Tensor, k: int, hb: int) -> torch.Tensor:
    """[T, K] int32 per-row-tile counts of each slot in ``m_id``."""
    rows = 4 * hb
    t = m_id.shape[0] // rows
    tile = torch.arange(t, device=m_id.device).repeat_interleave(rows)
    idx = tile[:, None] * k + m_id.long()
    return torch.bincount(idx.flatten(), minlength=t * k).reshape(t, k) \
        .to(torch.int32)


def argmax(m_klow: torch.Tensor, owner: torch.Tensor, kept: torch.Tensor,
           is_thing: torch.Tensor):
    """Masked argmax + per-tile areas.  Returns (m_id [4h, 4w] int32,
    areas_tile [T, K] int32)."""
    k, h, _ = m_klow.shape
    m_id = _masked_argmax(upsample_slots(m_klow), owner, kept, is_thing)
    return m_id, tile_areas(m_id, k, tile_rows(h))


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
