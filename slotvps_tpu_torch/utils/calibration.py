"""Detection-regime calibration for random-init weights (counterpart of
``slotvps_tpu/utils/calibration.py``).

A freshly initialized model keeps essentially nothing at the production
keep-threshold 0.85 (the class head carries the focal prior bias), so a
run on random weights would only exercise the postprocessor's empty
branch.  These two functions push the weights into a realistic regime:

  * ``doctor_params`` — amplify the slot queries, sharpen ``fg_bn`` so the
    per-pixel slot softmax binarizes, and give each DCN offset head a
    random per-tap bias (fractional sampling within the halo).
  * ``calibrate_class_head`` — center the final-stage class logits over
    slots and bisect the sharpening scale so ``target_valid`` slots clear
    the keep rule on a probe input.

Both update the model in place (under ``torch.no_grad``) and return it;
their noise comes from an explicit CPU ``torch.Generator``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from slotvps_tpu_torch.models.detector import Detector


@torch.no_grad()
def doctor_params(model: Detector, gen: torch.Generator,
                  offset_range: float = 1.5, fg_scale: float = 2.0,
                  fg_var: float = 0.01) -> Detector:
    """``offset_range`` bounds the per-tap DCN offset biases (pixels); keep
    it within the configured halos."""
    model.init_mask_query.mul_(8.0)
    model.fg_bn.weight.fill_(fg_scale)
    model.fg_bn.running_mean.zero_()
    model.fg_bn.running_var.fill_(fg_var)
    for blk in model.semantic_head.tower:
        bias = (torch.rand(18, generator=gen) - 0.5) * 2 * offset_range
        blk.offset.bias.copy_(bias)
    return model


def _valid_count(logits: np.ndarray, scale: float, no_obj: int,
                 threshold: float) -> int:
    z = logits * scale
    z = z - z.max(axis=-1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(axis=-1, keepdims=True)
    cls = p.argmax(axis=-1)
    return int(((cls != no_obj) & (p.max(axis=-1) > threshold)).sum())


@torch.no_grad()
def calibrate_class_head(model: Detector, final_logits,
                         gen: torch.Generator, target_valid: int = 48,
                         threshold: float = 0.85,
                         noise_std: float = 0.3) -> Tuple[Detector, dict]:
    """Rescale the last decoder stage's class head so ~``target_valid``
    slots clear the keep rule on the probe input.

    ``final_logits``: [L, C] final-stage class logits of the doctored model
    on a representative input.  The head becomes ``w' = s*w``,
    ``b' = s*(b - mean_logits + noise)``, with ``s`` bisected on the keep
    count.  Returns (model, info dict)."""
    logits = np.asarray(torch.as_tensor(final_logits).cpu(), np.float64)
    mean = logits.mean(axis=0, keepdims=True)
    noise = noise_std * torch.randn(logits.shape[1], generator=gen,
                                    dtype=torch.float64).numpy()
    centered = (logits - mean) + noise
    no_obj = logits.shape[1] - 1

    # monotone in s: bracket, then bisect on the count
    lo, hi = 1e-3, 1.0
    while _valid_count(centered, hi, no_obj, threshold) < target_valid \
            and hi < 1e4:
        hi *= 2.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if _valid_count(centered, mid, no_obj, threshold) < target_valid:
            lo = mid
        else:
            hi = mid
    scale = hi
    n_valid = _valid_count(centered, scale, no_obj, threshold)

    head = model.slot_head.stages[-1].class_logits
    dev = head.weight.device
    mean_t = torch.as_tensor(mean[0], dtype=torch.float32, device=dev)
    noise_t = torch.as_tensor(noise, dtype=torch.float32, device=dev)
    head.weight.mul_(scale)
    head.bias.copy_((head.bias - mean_t) * scale + noise_t * scale)
    info = {"scale": float(scale), "n_valid_probe": n_valid,
            "logit_std": max(float(np.abs(centered).std()), 1e-6)}
    return model, info
