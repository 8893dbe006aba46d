"""Sigmoid focal loss (counterpart of ``slotvps_tpu/ops/focal_loss.py``),
plain PyTorch: the JAX package writes it in plain ``jnp`` (no TPU kernel),
as a replacement for the reference's CUDA op
(mmdet/ops/sigmoid_focal_loss/src/sigmoid_focal_loss_cuda.cu, wrapper
mmdet/ops/sigmoid_focal_loss/sigmoid_focal_loss.py:8-38).

Semantics follow that op: ``targets`` holds class indices in
[0, num_classes] where 0 means background; logit column c is class c+1.
No loss of the training step uses it (the reference calls it only on its
train path); it is here for capability parity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       gamma: float = 2.0,
                       alpha: float = 0.25) -> torch.Tensor:
    """Per-element focal loss [N, C] of logits [N, C] and int targets [N]
    in [0, C] (0 = background); the caller sums or averages."""
    _, c = logits.shape
    cls = torch.arange(1, c + 1, dtype=targets.dtype,
                       device=targets.device)[None, :]
    pos = (targets[:, None] == cls).to(logits.dtype)
    p = torch.sigmoid(logits)
    # numerically stable log terms
    log_p = F.logsigmoid(logits)
    log_1p = F.logsigmoid(-logits)
    pos_term = -alpha * torch.pow(1.0 - p, gamma) * log_p
    neg_term = -(1.0 - alpha) * torch.pow(p, gamma) * log_1p
    return pos * pos_term + (1.0 - pos) * neg_term
