"""Panoptic post-processing, reference path (counterpart of
``slotvps_tpu/models/postprocess.py`` with ``impl="jax"``).

Fixed slot capacity ``K`` with validity flags, as in the JAX package:

 1. threshold keep: class != no-obj and softmax score > threshold,
 2. bilinear x4 upsample of the mask logits to [H, W, K],
 3. slot order: stuff (score desc), things (score desc), invalid,
 4. greedy mask removal over things, with int8 owner maps,
 5. per-pixel argmax over the modified mask stack, duplicate-stuff dedup on
    the first pass,
 6. iterative small-area filter with argmax recompute,
 7. panoptic id remap: stuff -> class id, thing -> 11 + rank, void 255.

The greedy claim loop and the small-area loop are Python loops here; the
claim loop visits only the valid thing slots (any other slot is rejected
before it can claim a pixel, so skipping it changes nothing).  The fused
kernels (``impl="fused"``) and the claim-scan kernel (``impl="pallas"``)
are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from slotvps_tpu.config import PostprocessConfig
from slotvps_tpu_torch.ops.interpolate import (interpolate_bilinear,
                                               upsample_x4_bilinear)

_NEG = -1e30


class PostprocResult(NamedTuple):
    """Fixed-capacity per-frame result (order: stuff desc, things desc,
    invalid).  Host code converts to variable-length lists."""

    kept: torch.Tensor         # [K] bool — survives all filtering
    is_thing: torch.Tensor     # [K] bool
    labels: torch.Tensor       # [K] int64 class ids (0..18)
    scores: torch.Tensor       # [K] f32
    embeddings: torch.Tensor   # [K, D] slot embeddings (for tracking)
    thing_rank: torch.Tensor   # [K] int64 rank among kept things (-1 else)
    panoptic: torch.Tensor     # [H, W] stuff class / 11+rank / 255
    sseg: torch.Tensor         # [H, W] semantic argmax
    n_kept: int
    n_things: int
    n_loop: int                # small-area-filter iterations run


def _slot_order(scores, classes, cfg: PostprocessConfig):
    """Permutation: stuff (score desc), things (score desc), invalid."""
    no_obj = cfg.num_classes - 1
    valid = (classes != no_obj) & (scores > cfg.threshold)
    is_stuff = classes <= cfg.num_stuff - 1
    # score-desc order matching np.argsort(x)[::-1] tie behavior
    by_score = torch.argsort(scores, stable=True).flip(0)
    group = torch.where(valid[by_score],
                        torch.where(is_stuff[by_score], 0, 1), 2)
    perm = by_score[torch.argsort(group, stable=True)]
    return perm, valid


def _mask_removal_scan(logit, labels, is_thing, valid,
                       cfg: PostprocessConfig):
    """Greedy per-slot claim loop (reference :601-639).

    logit: [K, H, W] bool binarized masks.  Returns (kept [K] bool, owner
    [H, W] int8 — claiming slot position or -1).  The owner maps are
    updated in place."""
    if not cfg.apply_mask_removal_only_ins:
        raise NotImplementedError(
            "only apply_mask_removal_only_ins=True is used by the reference "
            "configs (r50_fpn_slotvps.py:72)")
    k, h, w = logit.shape
    if k > 127:
        raise ValueError(f"{k} slots do not fit the int8 owner maps")
    dev = logit.device
    mask_sum = logit.reshape(k, -1).sum(dim=1)
    owner = torch.full((h, w), -1, dtype=torch.int8, device=dev)
    owner_class = torch.full((h, w), -1, dtype=torch.int8, device=dev)
    keep_things = torch.zeros(k, dtype=torch.bool, device=dev)
    for i in torch.nonzero(valid & is_thing).flatten().tolist():
        lg = logit[i]
        n = mask_sum[i]
        cls = labels[i].to(torch.int8)
        same_class_claimed = (owner >= 0) & (owner_class == cls)
        overlap = (lg & same_class_claimed).sum()
        degenerate = (n == 0) | (n == h * w)
        reject = degenerate | (overlap / torch.clamp_min(n, 1)
                               > cfg.fraction_threshold)
        keep_i = ~reject
        claim = lg & (owner < 0) & keep_i
        owner.masked_fill_(claim, i)
        owner_class = torch.where(claim, cls, owner_class)
        keep_things[i] = keep_i
    kept = torch.where(is_thing, keep_things, valid)
    return kept, owner


def _dedup_map(labels, is_thing, kept):
    """First-kept-stuff-position per class (reference :736-741)."""
    k = labels.shape[0]
    pos = torch.arange(k, device=labels.device)
    stuff_kept = kept & ~is_thing
    # first kept position per class: scatter-min over labels
    # (64 bins covers every config: Mapillary has 47 classes)
    first = torch.full((64,), k, dtype=torch.long, device=labels.device)
    first.scatter_reduce_(0, torch.where(stuff_kept, labels, 63),
                          torch.where(stuff_kept, pos, k), reduce="amin")
    mapped = torch.where(stuff_kept, first[labels], pos)
    return torch.where(mapped < k, mapped, pos)


def _argmax_pass(final_vals_hwk, kept, dedup, labels, is_thing):
    """[H, W, K] masked argmax (ties -> first index) + per-slot areas."""
    k = final_vals_hwk.shape[-1]
    vals = torch.where(kept, final_vals_hwk, _NEG)
    m_id = torch.argmax(vals, dim=-1)
    if dedup:
        m_id = _dedup_map(labels, is_thing, kept)[m_id]
    areas = torch.bincount(m_id.flatten(), minlength=k)
    return m_id, torch.where(kept, areas, 0)


def _finish(kept, m_id, classes, scores, embeds, is_thing, sseg, cfg,
            n_loop=0):
    """Panoptic id remap + result assembly."""
    kept_thing = kept & is_thing
    thing_rank = torch.where(kept_thing,
                             torch.cumsum(kept_thing.long(), 0) - 1, -1)
    slot_value = torch.where(kept_thing, cfg.num_stuff + thing_rank,
                             torch.where(kept, classes, 255))
    if bool(kept.any()):
        panoptic = slot_value[m_id]
    else:
        panoptic = torch.full_like(m_id, 255)
    return PostprocResult(
        kept=kept, is_thing=is_thing, labels=classes, scores=scores,
        embeddings=embeds, thing_rank=thing_rank, panoptic=panoptic,
        sseg=sseg, n_kept=int(kept.sum()), n_things=int(kept_thing.sum()),
        n_loop=n_loop)


def _small_fn(cfg: PostprocessConfig):
    if cfg.filter_small_option == "4":
        return lambda areas, cls: areas <= 4
    if cfg.filter_small_option == "4_256":
        return lambda areas, cls: torch.where(cls > cfg.num_stuff - 1,
                                              areas < 256, areas < 4)
    if cfg.filter_small_option == "4096_256":
        return lambda areas, cls: torch.where(cls > cfg.num_stuff - 1,
                                              areas < 256, areas < 4096)
    raise ValueError(cfg.filter_small_option)


def postprocess_frame(
    pred_logits: torch.Tensor,   # [K, C]
    pred_masks: torch.Tensor,    # [K, h, w] quarter-res logits
    embeddings: torch.Tensor,    # [K, D]
    fcn_output: torch.Tensor,    # [H, W, 19] full-res, or [h, w, 19]
    out_size: Tuple[int, int],
    cfg: PostprocessConfig,
) -> PostprocResult:
    """Full per-frame post-processing at the TARGET size ``out_size``."""
    if cfg.impl != "jax":
        raise NotImplementedError(
            f"postprocess impl={cfg.impl!r} (TPU kernels) is not ported "
            "yet; use impl='jax'")
    k = pred_logits.shape[0]
    h, w = out_size
    # reference staging: x4 upsample first, then resize to ori_shape
    if tuple(fcn_output.shape[:2]) == tuple(pred_masks.shape[1:]):
        fcn_output = upsample_x4_bilinear(fcn_output)
    if tuple(fcn_output.shape[:2]) != (h, w):
        fcn_output = interpolate_bilinear(fcn_output, (h, w),
                                          align_corners=False)

    probs = torch.softmax(pred_logits, dim=-1)
    scores = probs.amax(dim=-1)
    classes = probs.argmax(dim=-1)

    perm, valid = _slot_order(scores, classes, cfg)
    scores = scores[perm]
    classes = classes[perm]
    valid = valid[perm]
    embeds = embeddings[perm]
    masks = pred_masks[perm]
    is_thing = classes > cfg.num_stuff - 1

    masks_hwk = masks.permute(1, 2, 0).to(getattr(torch, cfg.stack_dtype))
    if (h, w) == (4 * masks.shape[1], 4 * masks.shape[2]):
        raw_hwk = upsample_x4_bilinear(masks_hwk)
    else:
        raw_hwk = interpolate_bilinear(masks_hwk, (h, w),
                                       align_corners=False)

    if cfg.apply_mask_removal:
        # binarize the per-pixel softmax over VALID slots without
        # materializing it: softmax_k(x) >= thr iff
        # x_k >= log(thr) + logsumexp over valid slots
        masked = torch.where(valid, raw_hwk, _NEG)
        mx = masked.amax(dim=-1, keepdim=True)
        lse = mx.float() + torch.log(torch.clamp_min(
            torch.exp((masked - mx).float()).sum(dim=-1, keepdim=True),
            1e-30))
        log_thr = torch.log(torch.tensor(cfg.pixel_threshold,
                                         dtype=torch.float32,
                                         device=lse.device))
        theta = log_thr + lse                                # [H, W, 1]
        logit_khw = ((raw_hwk.float() >= theta) & valid).permute(2, 0, 1)
        kept, owner = _mask_removal_scan(logit_khw, classes, is_thing,
                                         valid, cfg)
        pos = torch.arange(k, device=owner.device)
        final_vals = torch.where(
            is_thing,
            torch.where(owner[..., None] == pos, raw_hwk, 0.0),
            raw_hwk)
    else:
        kept = valid
        final_vals = raw_hwk

    # argmax fusion + iterative small-area filter (reference :758-790)
    small = _small_fn(cfg)
    m_id, areas = _argmax_pass(final_vals, kept, True, classes, is_thing)
    n_loop = 0
    while bool((kept & small(areas, classes)).any()) and bool(kept.any()):
        kept = kept & ~small(areas, classes)
        m_id, areas = _argmax_pass(final_vals, kept, False, classes,
                                   is_thing)
        n_loop += 1
    sseg = torch.argmax(fcn_output, dim=-1)
    return _finish(kept, m_id, classes, scores, embeds, is_thing, sseg,
                   cfg, n_loop=n_loop)
