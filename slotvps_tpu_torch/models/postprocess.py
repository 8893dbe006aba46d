"""Panoptic post-processing (counterpart of
``slotvps_tpu/models/postprocess.py``): the reference path
(``impl="jax"``), the reference path with the claim-scan kernel
(``impl="pallas"``) and the fused path (``impl="fused"``).

Fixed slot capacity ``K`` with validity flags, as in the JAX package:

 1. threshold keep: class != no-obj and softmax score > threshold,
 2. bilinear x4 upsample of the mask logits to [H, W, K],
 3. slot order: stuff (score desc), things (score desc), invalid,
 4. greedy mask removal over things, with int8 owner maps,
 5. per-pixel argmax over the modified mask stack, duplicate-stuff dedup on
    the first pass,
 6. iterative small-area filter with argmax recompute,
 7. panoptic id remap: stuff -> class id, thing -> 11 + rank, void 255.

The reference path builds the full-resolution [H, W, K] stack and
binarizes it; its greedy claim loop (``ops/claim_scan.py``) and small-area
loop are Python loops, and the claim loop visits only the valid thing slots
(any other slot is rejected before it can claim a pixel, so skipping it
changes nothing).  ``impl="pallas"`` runs the same path with the claim loop
on the Hopper claim-scan kernel (``ops/cuda/claim_scan.py``; its plain
version on CPU tensors), which reads the binarized [H, W, K] stack in place
(no [K, H, W] copy), after one host sync for the valid-thing slot range.

The fused path never builds that stack: four Hopper kernels
(``ops/cuda/postproc_v3.py``; their plain versions on CPU tensors) compute
theta, the claim loop, the masked argmax with per-tile areas, and each
small-area iteration on the dirty row tiles only.  Quarter-res semantic
logits (``semantic_head.fused_sseg``) go to a fifth, ``sseg_hopper``, which
upsamples and argmaxes them in one pass.  It runs on the slot
prefix of the capacity ladder (``detect_capacity``).  Host syncs per
frame: one for the valid-slot counts (ladder branch and claim range), one
per small-area check (``n_loop + 1``) and one for the kept counts.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from slotvps_tpu_torch.config import PostprocessConfig
from slotvps_tpu_torch.ops.claim_scan import claim_scan
from slotvps_tpu_torch.ops.cuda.claim_scan import claim_scan_hopper
from slotvps_tpu_torch.ops.cuda.postproc_v3 import (argmax_hopper,
                                                    claim_hopper,
                                                    repair_hopper,
                                                    sseg_hopper,
                                                    theta_hopper)
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
    ``logit`` [K, H, W] bool: :func:`claim_scan` (``impl="jax"``, on any
    device) or :func:`claim_scan_hopper` (``impl="pallas"``: the kernel on
    the card over the valid-thing slot range, which the slot order puts
    after the valid stuff; one host sync for it).  Returns (kept [K] bool,
    owner [H, W] int8 — claiming slot position or -1, the number of valid
    thing slots visited)."""
    if not cfg.apply_mask_removal_only_ins:
        raise NotImplementedError(
            "only apply_mask_removal_only_ins=True is used by the reference "
            "configs (r50_fpn_slotvps.py:72)")
    if cfg.impl == "pallas":
        n_valid, n_stuff = torch.stack(
            [valid.sum(), (valid & ~is_thing).sum()]).tolist()
        # the K-minor planes as they are: on the card a [K, H, W] copy of
        # the 210 MB stack (K = 100) costs more than the kernel's strided
        # reads (csrc/claim_scan.cu, PERF.md)
        keep_things, owner = claim_scan_hopper(
            logit, labels, is_thing, valid, cfg.fraction_threshold,
            slots=(n_stuff, n_valid))
        n_claim = n_valid - n_stuff
    else:
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


def _postprocess_fused(masks, scores, classes, valid, embeds, is_thing,
                       sseg, thing_slots, cfg: PostprocessConfig):
    """The fused path on slot-major masks [K, h, w] at a 4x target size.

    ``thing_slots = (lo, hi)`` holds every valid thing slot (the slot
    order puts them there): the claim loop (one launch) visits the valid
    thing slots of it."""
    if not cfg.apply_mask_removal_only_ins:
        raise NotImplementedError(
            "only apply_mask_removal_only_ins=True is supported")
    theta = theta_hopper(masks, valid, cfg.pixel_threshold)
    keep_things, owner = claim_hopper(masks, theta, classes, is_thing, valid,
                                      cfg.fraction_threshold,
                                      slots=thing_slots)
    kept = torch.where(is_thing, keep_things, valid)
    small = _small_fn(cfg)
    k = classes.shape[0]

    # the first pass also gives per-tile per-slot pixel counts, so each
    # small-area iteration recomputes the argmax only on the row tiles
    # holding pixels of a removed slot (removals change only the pixels
    # whose winner was removed; clean tiles are exact copies)
    m1, areas_t = argmax_hopper(masks, owner, kept, is_thing)
    dmap = _dedup_map(classes, is_thing, kept)
    m_disp = dmap[m1.long()]
    # fold the per-slot areas onto the first kept stuff slot of each class
    fold = dmap[None, :] == torch.arange(k, device=dmap.device)[:, None]
    areas = torch.where(kept, (fold * areas_t.sum(0)[None, :]).sum(1), 0)
    n_loop = 0
    while bool((kept & small(areas, classes)).any() & kept.any()):
        removed = kept & small(areas, classes)
        kept = kept & ~removed
        dirty = ((areas_t > 0) & removed[None, :]).any(-1)
        m1, areas_t = repair_hopper(masks, owner, m1, kept, is_thing, dirty,
                                    areas_t)
        areas = torch.where(kept, areas_t.sum(0), 0)
        # after any iteration the displayed map is the raw winner map (the
        # reference path's loop recomputes without the dedup)
        m_disp = m1
        n_loop += 1
    return _finish(kept, m_disp, classes, scores, embeds, is_thing, sseg,
                   cfg, n_loop=n_loop,
                   n_claim=thing_slots[1] - thing_slots[0])


def _capacity(n_valid: int, k: int, cap: int) -> int:
    """The capacity ladder: the slot prefix the fused passes run on.  Every
    valid slot lies in the prefix, so the result is exact: half the
    capacity (when that is at least 8 slots), the capacity, or all K."""
    if not 0 < cap < k:
        return k
    half = cap // 2
    if half >= 8 and n_valid <= half:
        return half
    return cap if n_valid <= cap else k


def postprocess_frame(
    pred_logits: torch.Tensor,   # [K, C]
    pred_masks: torch.Tensor,    # [K, h, w] quarter-res logits
    embeddings: torch.Tensor,    # [K, D]
    fcn_output: torch.Tensor,    # [H, W, 19] full-res, or [h, w, 19]
    out_size: Tuple[int, int],
    cfg: PostprocessConfig,
) -> PostprocResult:
    """Full per-frame post-processing at the TARGET size ``out_size``.

    ``impl="fused"`` runs the kernels when the target is 4x the mask size
    and mask removal is on; otherwise, as in the JAX package, the
    reference path, whose claim loop runs on the claim-scan kernel with
    ``impl="pallas"``."""
    if cfg.impl not in ("jax", "fused", "pallas"):
        raise ValueError(f"unknown postprocess impl {cfg.impl!r}")
    k = pred_logits.shape[0]
    h, w = out_size
    fused_ok = (cfg.impl == "fused" and cfg.apply_mask_removal
                and (h, w) == (4 * pred_masks.shape[1],
                               4 * pred_masks.shape[2]))
    # quarter-res semantic logits (semantic_head fused_sseg) go to the sseg
    # kernel on the fused path; every other route keeps the reference
    # staging: x4 upsample first, then resize to ori_shape
    fcn_quarter = tuple(fcn_output.shape[:2]) == tuple(pred_masks.shape[1:])
    if fcn_quarter and not fused_ok:
        fcn_output = upsample_x4_bilinear(fcn_output)
        fcn_quarter = False
    if not fcn_quarter and tuple(fcn_output.shape[:2]) != (h, w):
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

    if fused_ok:
        sseg = (sseg_hopper(fcn_output.float().contiguous()) if fcn_quarter
                else torch.argmax(fcn_output, dim=-1))
        # one host sync: the slot order is valid stuff, valid things,
        # invalid, so these two counts give the ladder branch and the
        # claim loop's range
        n_valid, n_stuff = torch.stack(
            [valid.sum(), (valid & ~is_thing).sum()]).tolist()
        c = _capacity(n_valid, k, cfg.detect_capacity)
        r = _postprocess_fused(
            masks[:c].float().contiguous(), scores[:c], classes[:c],
            valid[:c], embeds[:c], is_thing[:c], sseg, (n_stuff, n_valid),
            cfg)
        if c == k:
            return r
        pad = k - c
        return r._replace(
            kept=torch.cat([r.kept, r.kept.new_zeros(pad)]),
            is_thing=is_thing, labels=classes, scores=scores,
            embeddings=embeds,
            thing_rank=torch.cat([r.thing_rank,
                                  r.thing_rank.new_full((pad,), -1)]))

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
