"""The greedy mask-removal claim loop on binarized planes, plain PyTorch
version (counterpart of ``slotvps_tpu/ops/pallas/claim_scan.py``
``claim_scan_pallas`` and its batched form ``_claim_scan_batched``).

Reference semantics (mmdet/models/detectors/vps_temporal_slots.py:601-639):
slots are visited in slot order; a valid thing slot is rejected if its
binarized plane is degenerate (no pixel or every pixel) or overlaps pixels
already claimed by a slot of its own class by more than
``fraction_threshold`` of its area; otherwise it claims its still unowned
pixels.  Slots that are not valid things never claim a pixel, so only the
valid thing slots are visited.

The Hopper kernel of the same function is
:func:`vpsbench.reference.cuda.claim_scan.claim_scan_hopper`; this
version serves CPU tensors and is the kernel's reference on the card.

Frozen copy of ``slotvps_tpu_torch/ops/claim_scan.py`` at commit
86b90feb98325982c750f329cf213fa73d0ed5b3, for the
benchmark's plain reference: it imports nothing of the port.
"""

from __future__ import annotations

import torch

MAX_SLOTS = 127   # int8 owner maps


def claim_scan(logit: torch.Tensor, labels: torch.Tensor,
               is_thing: torch.Tensor, valid: torch.Tensor,
               fraction_threshold: float):
    """logit: [K, H, W] or [B, K, H, W] binarized planes (bool, or int8 /
    uint8 read as ``!= 0``); labels, is_thing, valid: [K] or [B, K].

    With ``n`` a plane's pixel count (taken before any claim) and ``ovl``
    its pixels owned by a slot of its own class, a valid thing slot is
    rejected when ``n == 0``, ``n == H*W`` or ``f32(ovl) / f32(max(n, 1)) >
    f32(fraction_threshold)`` (one correctly rounded f32 division), and
    kept otherwise; a kept slot claims its unowned pixels.

    Returns (keep_things [..., K] bool, owner [..., H, W] int8: the
    claiming slot's position, -1 where unowned)."""
    if logit.ndim == 4:
        outs = [claim_scan(logit[b], labels[b], is_thing[b], valid[b],
                           fraction_threshold)
                for b in range(logit.shape[0])]
        return (torch.stack([keep for keep, _ in outs]),
                torch.stack([owner for _, owner in outs]))
    if logit.ndim != 3:
        raise ValueError(f"claim_scan: logit must be [K, H, W] or "
                         f"[B, K, H, W], got {tuple(logit.shape)}")
    k, h, w = logit.shape
    if k > MAX_SLOTS:
        raise ValueError(f"{k} slots do not fit the int8 owner maps")
    dev = logit.device
    planes = logit != 0
    mask_sum = planes.reshape(k, -1).sum(dim=1)
    labels_l = labels.long()
    owner = torch.full((h, w), -1, dtype=torch.int8, device=dev)
    keep = torch.zeros(k, dtype=torch.bool, device=dev)
    frac = torch.tensor(fraction_threshold, dtype=torch.float32, device=dev)
    for i in torch.nonzero(valid & is_thing).flatten().tolist():
        lg = planes[i]
        n = mask_sum[i]
        owned = owner >= 0
        same = owned & (labels_l[owner.long().clamp_min(0)] == labels_l[i])
        ovl = (lg & same).sum()
        reject = ((n == 0) | (n == h * w)
                  | (ovl.float() / n.clamp_min(1).float() > frac))
        keep_i = ~reject
        owner.masked_fill_(lg & ~owned & keep_i, i)
        keep[i] = keep_i
    return keep, owner
