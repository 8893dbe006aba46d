"""Panoptic post-processing of the plain reference: the reference path
of ``slotvps_tpu_torch/models/postprocess.py`` at commit
86b90feb98325982c750f329cf213fa73d0ed5b3, whatever ``impl`` names.

Fixed slot capacity ``K`` with validity flags:

 1. threshold keep: class != no-obj and softmax score > threshold,
 2. bilinear x4 upsample of the mask logits to [H, W, K],
 3. slot order: stuff (score desc), things (score desc), invalid,
 4. greedy mask removal over things, with int8 owner maps,
 5. per-pixel argmax over the modified mask stack, duplicate-stuff dedup on
    the first pass,
 6. iterative small-area filter with argmax recompute,
 7. panoptic id remap: stuff -> class id, thing -> 11 + rank, void 255.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from vpsbench.reference.config import PostprocessConfig
from vpsbench.reference.claim_scan import claim_scan
from vpsbench.reference.interpolate import (interpolate_bilinear,
                                               upsample_x4_bilinear)
from vpsbench.cost import cost

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
    capacity: int              # slots the passes ran on (ladder branch)
    n_claim: int               # valid thing slots the claim loop visited


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
    """Greedy per-slot claim loop (reference :601-639) on binarized masks
    ``logit`` [K, H, W] bool, the plain :func:`claim_scan`.  Returns
    (kept [K] bool, owner [H, W] int8 — claiming slot position or -1, the
    number of valid thing slots visited)."""
    if not cfg.apply_mask_removal_only_ins:
        raise NotImplementedError(
            "only apply_mask_removal_only_ins=True is used by the reference "
            "configs (r50_fpn_slotvps.py:72)")
    keep_things, owner = claim_scan(logit, labels, is_thing, valid,
                                    cfg.fraction_threshold)
    n_claim = int((valid & is_thing).sum())
    return torch.where(is_thing, keep_things, valid), owner, n_claim


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
            n_loop=0, n_claim=0):
    """Panoptic id remap + result assembly (one host sync)."""
    kept_thing = kept & is_thing
    thing_rank = torch.where(kept_thing,
                             torch.cumsum(kept_thing.long(), 0) - 1, -1)
    slot_value = torch.where(kept_thing, cfg.num_stuff + thing_rank,
                             torch.where(kept, classes, 255))
    n_kept, n_things = torch.stack([kept.sum(), kept_thing.sum()]).tolist()
    if n_kept:
        panoptic = slot_value[m_id.long()]
    else:
        panoptic = torch.full(m_id.shape, 255, dtype=torch.long,
                              device=m_id.device)
    return PostprocResult(
        kept=kept, is_thing=is_thing, labels=classes, scores=scores,
        embeddings=embeds, thing_rank=thing_rank, panoptic=panoptic,
        sseg=sseg, n_kept=n_kept, n_things=n_things, n_loop=n_loop,
        capacity=kept.shape[0], n_claim=n_claim)


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


@cost.entry("postprocess", lambda *args, out, **kw: cost.io_bytes(args, out))
def postprocess_frame(
    pred_logits: torch.Tensor,   # [K, C]
    pred_masks: torch.Tensor,    # [K, h, w] quarter-res logits
    embeddings: torch.Tensor,    # [K, D]
    fcn_output: torch.Tensor,    # [H, W, 19] full-res, or [h, w, 19]
    out_size: Tuple[int, int],
    cfg: PostprocessConfig,
) -> PostprocResult:
    """Full per-frame post-processing at the TARGET size ``out_size``, the
    reference path; ``vpsbench/cost`` counts the call as its inputs read
    and its outputs written."""
    if cfg.impl not in ("jax", "fused", "pallas"):
        raise ValueError(f"unknown postprocess impl {cfg.impl!r}")
    k = pred_logits.shape[0]
    h, w = out_size
    # quarter-res semantic logits: x4 upsample first, then resize to the
    # target, the reference staging
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
        # x_k >= log(thr) + logsumexp over valid slots; log(sum exp) in
        # float64, rounded once, as ops/postproc_v3.theta takes it
        masked = torch.where(valid, raw_hwk, _NEG)
        mx = masked.amax(dim=-1, keepdim=True)
        lse = mx.float() + torch.log(torch.clamp_min(
            torch.exp((masked - mx).double()).sum(dim=-1, keepdim=True),
            1e-30)).float()
        log_thr = torch.log(torch.tensor(cfg.pixel_threshold,
                                         dtype=torch.float32,
                                         device=lse.device))
        theta = log_thr + lse                                # [H, W, 1]
        logit_khw = ((raw_hwk.float() >= theta) & valid).permute(2, 0, 1)
        kept, owner, n_claim = _mask_removal_scan(logit_khw, classes,
                                                  is_thing, valid, cfg)
        pos = torch.arange(k, device=owner.device)
        final_vals = torch.where(
            is_thing,
            torch.where(owner[..., None] == pos, raw_hwk, 0.0),
            raw_hwk)
    else:
        kept = valid
        final_vals = raw_hwk
        n_claim = 0

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
                   cfg, n_loop=n_loop, n_claim=n_claim)
