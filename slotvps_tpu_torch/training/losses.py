"""Training losses of Slot-VPS (counterpart of
``slotvps_tpu/training/losses.py``).

The reference never released its training code; its configs document the
loss recipe (r50_fpn_slotvps.py:55-65, MaX-DeepLab style): a PQ loss over
a slot/GT bipartite matching plus a per-pixel mask-id cross-entropy, the
track head's match loss and an instance-discrimination loss.

The functions here take one sample, as the JAX ones do (the step loops
over the batch).  Hungarian matching is a discrete decision made on the
host: :func:`hungarian` takes every cost matrix of a step, copies them to
the host together, solves each with ``scipy.optimize.linear_sum_assignment``
on ``cost.T`` (GT rows, as ``optax.assignment.hungarian_algorithm`` is
called) and sends all the assignments back in one copy.  Invalid GT rows
have cost 0, so their assignment is arbitrary; no loss reads it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_EPS = 1e-6


def dice_similarity(mask_logits: torch.Tensor,
                    gt_masks: torch.Tensor) -> torch.Tensor:
    """[L, H, W] slot mask logits x [G, H, W] binary GT -> [L, G] dice."""
    p = torch.sigmoid(mask_logits).reshape(mask_logits.shape[0], -1)
    g = gt_masks.reshape(gt_masks.shape[0], -1).to(p.dtype)
    inter = p @ g.T
    denom = p.sum(-1, keepdim=True) + g.sum(-1, keepdim=True).T
    return (2 * inter + _EPS) / (denom + _EPS)


@torch.no_grad()
def match_cost(class_probs: torch.Tensor, dice: torch.Tensor,
               gt_labels: torch.Tensor, gt_valid: torch.Tensor,
               temp: float = 0.3) -> torch.Tensor:
    """[L, G] matching cost -p_class**temp x dice on the valid GT columns,
    0 on the others; no gradient (the matching is a discrete decision)."""
    sim = class_probs[:, gt_labels.long()] ** temp * dice
    return torch.where(gt_valid[None, :], -sim, torch.zeros_like(sim))


def hungarian(costs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """For each [L, G] cost (G <= L) the slot assigned to each GT [G]
    (int64, on the costs' device): one device->host copy of all the
    matrices, one scipy solve each, one host->device copy back."""
    from scipy.optimize import linear_sum_assignment

    if not costs:
        return []
    shapes = [tuple(c.shape) for c in costs]
    if any(g > l for l, g in shapes):
        raise ValueError(f"more GT slots than slots in {shapes}")
    flat = torch.cat([c.reshape(-1) for c in costs]).cpu().numpy()
    out, o = [], 0
    for l, g in shapes:
        cost = flat[o:o + l * g].reshape(l, g)
        o += l * g
        rows, cols = linear_sum_assignment(cost.T)    # rows = GT
        idx = np.zeros(g, np.int64)
        idx[rows] = cols
        out.append(idx)
    back = torch.from_numpy(np.concatenate(out)).to(costs[0].device)
    return list(torch.split(back, [g for _, g in shapes]))


def match_slots(class_probs: torch.Tensor, dice: torch.Tensor,
                gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                temp: float = 0.3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hungarian matching on similarity = p_class**temp x dice for one
    sample.  Returns (slot_idx [G], valid [G]): the slot matched to each
    GT."""
    cost = match_cost(class_probs, dice, gt_labels, gt_valid, temp)
    return hungarian([cost])[0], gt_valid


def pq_loss(
    pred_logits: torch.Tensor,    # [L, C]
    mask_logits: torch.Tensor,    # [L, H, W]
    gt_labels: torch.Tensor,      # [G]
    gt_masks: torch.Tensor,       # [G, H, W] {0,1}
    gt_valid: torch.Tensor,       # [G] bool
    pq_weight: float = 3.0,
    maskid_weight: float = 0.3,
    alpha: float = 0.75,
    temp: float = 0.3,
    fixed_match: bool = False,
    slot_idx: torch.Tensor = None,
) -> Dict[str, torch.Tensor]:
    """MaX-DeepLab-style PQ loss for one frame.

    The assignment is slot i <-> GT i with ``fixed_match=True`` (the JAX
    package's single-batch overfit recipe), else ``slot_idx`` when given
    (the step's batched matching), else :func:`match_slots` here."""
    g = gt_labels.shape[0]
    labels = gt_labels.long()
    class_probs = torch.softmax(pred_logits, dim=-1)
    dice = dice_similarity(mask_logits, gt_masks)
    if fixed_match:
        slot_idx = torch.arange(g, device=pred_logits.device)
    elif slot_idx is None:
        slot_idx, _ = match_slots(class_probs, dice, gt_labels, gt_valid,
                                  temp)
    validf = gt_valid.float()
    n_gt = gt_valid.sum().clamp_min(1)
    # positive term: maximize p_class x dice for matched pairs
    p_matched = class_probs[slot_idx, labels]
    d_matched = dice[slot_idx, torch.arange(g, device=dice.device)]
    pos = -(d_matched.detach() * torch.log(p_matched + _EPS)
            + p_matched.detach() * d_matched)
    loss_pos = alpha * (pos * validf).sum() / n_gt

    # negative term: unmatched slots -> no-object class
    n_slots = pred_logits.shape[0]
    matched = (F.one_hot(slot_idx, n_slots).float()
               * validf[:, None]).amax(0) > 0
    logp = torch.log_softmax(pred_logits, dim=-1)
    loss_neg = -(1 - alpha) * torch.where(
        matched, 0.0, logp[:, -1]).sum() / (~matched).sum().clamp_min(1)

    # mask-id CE: per-pixel slot softmax vs the matched slot id; where GT
    # masks overlap, the first (lowest-index) valid GT owns the pixel
    logp_pix = torch.log_softmax(mask_logits, dim=0)      # [L, H, W]
    covering = (gt_masks > 0) & gt_valid[:, None, None]
    gt_any = covering.any(0)
    first_g = covering.float().argmax(0)                   # [H, W]
    pix_slot = slot_idx[first_g]
    ll = torch.gather(logp_pix.reshape(n_slots, -1), 0,
                      pix_slot.reshape(1, -1))[0].reshape(gt_any.shape)
    loss_maskid = -(ll * gt_any).sum() / gt_any.sum().clamp_min(1)
    return {"loss_pq": pq_weight * (loss_pos + loss_neg),
            "loss_maskid": maskid_weight * loss_maskid}


def pq_loss_with_match(pred_logits, mask_logits, gt_labels, gt_masks,
                       gt_valid, fixed_match: bool = False,
                       slot_idx: torch.Tensor = None, **kw):
    """pq_loss that also returns the GT->slot assignment (for the track
    head's match loss)."""
    if fixed_match:
        slot_idx = torch.arange(gt_labels.shape[0],
                                device=pred_logits.device)
    elif slot_idx is None:
        slot_idx, _ = match_slots(torch.softmax(pred_logits, dim=-1),
                                  dice_similarity(mask_logits, gt_masks),
                                  gt_labels, gt_valid)
    return pq_loss(pred_logits, mask_logits, gt_labels, gt_masks, gt_valid,
                   slot_idx=slot_idx, **kw), slot_idx


def match_loss(
    track_head,                 # models.track_head.TrackHead
    cur_embeds: torch.Tensor,   # [L, D] current-frame slot embeddings
    ref_embeds: torch.Tensor,   # [L, D] reference-frame slot embeddings
    cur_slot_idx: torch.Tensor,  # [G] slot matched to each current GT
    ref_slot_idx: torch.Tensor,  # [G] slot matched to each reference GT
    gt_pids: torch.Tensor,      # [G] 0 = new, j = 1-based ref-GT index
    gt_valid: torch.Tensor,     # [G] bool (current GTs)
    ref_gt_valid: torch.Tensor,  # [G] bool (reference GTs)
    loss_weight: float = 0.5,
) -> torch.Tensor:
    """SimpleTrackHead training loss: cross-entropy on the correlation
    matrix vs the gt_pids targets (reference r50_fpn_slotvps.py:91-96);
    invalid reference columns are masked out of the softmax."""
    score = track_head(cur_embeds[cur_slot_idx], ref_embeds[ref_slot_idx])
    n_ref = ref_gt_valid.shape[0]
    col_valid = torch.cat([torch.ones(1, dtype=torch.bool,
                                      device=score.device), ref_gt_valid])
    score = torch.where(col_valid[None, :], score, -1e30)
    logp = torch.log_softmax(score, dim=-1)
    pids = gt_pids.long()
    # a pid pointing at an invalid ref column can only come from padding
    tgt_ok = gt_valid & (pids <= n_ref) & col_valid[pids.clamp(0, n_ref)]
    ll = torch.gather(logp, 1, pids.clamp(0, score.shape[1] - 1)[:, None]
                      )[:, 0]
    return -loss_weight * (ll * tgt_ok).sum() / tgt_ok.sum().clamp_min(1)


def insdis_loss(
    feat: torch.Tensor,          # [h, w, D] L2-normalized decoder feature
    gt_masks: torch.Tensor,      # [G, h, w] {0,1}
    gt_valid: torch.Tensor,      # [G] bool
    temp: float = 0.3,
    loss_weight: float = 1.0,
) -> torch.Tensor:
    """MaX-DeepLab instance-discrimination loss ('hand_craft' variant):
    each in-mask pixel feature against per-instance mean-feature prototypes
    at temperature ``temp``."""
    m = gt_masks.to(feat.dtype) * gt_valid[:, None, None]     # [G, h, w]
    proto = torch.einsum("ghw,hwd->gd", m, feat)
    proto = proto * torch.rsqrt(proto.square().sum(-1, keepdim=True)
                                + 1e-12)
    logits = torch.einsum("hwd,gd->hwg", feat, proto) / temp
    logits = torch.where(gt_valid, logits, -1e30)
    logp = torch.log_softmax(logits, dim=-1)
    covered = m.amax(0) > 0                                 # [h, w]
    owner = m.argmax(0)                                     # first covering
    ll = torch.gather(logp, -1, owner[..., None])[..., 0]
    return -loss_weight * (ll * covered).sum() / covered.sum().clamp_min(1)
