"""Deformable PSRoI pooling, plain PyTorch (counterpart of
``slotvps_tpu/ops/deform_pool.py``).

The reference ships a CUDA extension for this
(reference mmdet/ops/dcn/src/deform_pool_cuda.cpp:84-88, python wrappers
mmdet/ops/dcn/deform_pool.py:10-174) but nothing in the live Slot-VPS path
uses it; it exists so ``import mmdet.ops`` works.  The JAX package and the
port provide a working equivalent for the same reason (capability parity):
average pooling over bilinear samples per output bin, the same arithmetic
in the same order.
"""

from __future__ import annotations

from typing import Optional

import torch


def deform_roi_pooling(
    x: torch.Tensor,
    rois: torch.Tensor,
    offset: Optional[torch.Tensor],
    spatial_scale: float,
    out_size: int,
    sample_per_part: int = 4,
    gamma: float = 0.1,
) -> torch.Tensor:
    """Deformable position-sensitive RoI pooling (forward).

    x:      [H, W, C]
    rois:   [R, 4] (x1, y1, x2, y2) in image coords
    offset: optional [R, out_size, out_size, 2] normalized bin offsets
    returns [R, out_size, out_size, C]
    """
    h, w, c = x.shape
    r = rois.shape[0]
    dev = x.device
    x1 = rois[:, 0] * spatial_scale - 0.5
    y1 = rois[:, 1] * spatial_scale - 0.5
    x2 = (rois[:, 2] + 1.0) * spatial_scale - 0.5
    y2 = (rois[:, 3] + 1.0) * spatial_scale - 0.5
    roi_w = torch.clamp_min(x2 - x1, 0.1)
    roi_h = torch.clamp_min(y2 - y1, 0.1)
    bin_w = roi_w / out_size  # [R]
    bin_h = roi_h / out_size

    grid = torch.arange(out_size, dtype=torch.float32, device=dev)
    sub = (torch.arange(sample_per_part, dtype=torch.float32, device=dev)
           + 0.5) / sample_per_part

    # sample grid per roi/bin/subsample: [R, G, S]
    py = (y1[:, None, None] + (grid[None, :, None] + sub[None, None, :])
          * bin_h[:, None, None])
    px = (x1[:, None, None] + (grid[None, :, None] + sub[None, None, :])
          * bin_w[:, None, None])
    # full grid [R, gy, gx, sy, sx]
    full = (r, out_size, out_size, sample_per_part, sample_per_part)
    py_full = py[:, :, None, :, None].expand(full)
    px_full = px[:, None, :, None, :].expand(full)
    if offset is not None:
        py_full = py_full + (gamma * roi_h)[:, None, None, None, None] \
            * offset[..., 0][:, :, :, None, None]
        px_full = px_full + (gamma * roi_w)[:, None, None, None, None] \
            * offset[..., 1][:, :, :, None, None]

    py_c = torch.clamp(py_full, 0.0, h - 1.0)
    px_c = torch.clamp(px_full, 0.0, w - 1.0)
    y0 = torch.floor(py_c).long()
    x0 = torch.floor(px_c).long()
    y1i = torch.clamp_max(y0 + 1, h - 1)
    x1i = torch.clamp_max(x0 + 1, w - 1)
    fy = py_c - y0
    fx = px_c - x0

    flat = x.reshape(h * w, c)

    def g(yy, xx):
        return flat[(yy * w + xx).reshape(-1)].reshape(yy.shape + (c,))

    val = (g(y0, x0) * ((1 - fy) * (1 - fx))[..., None]
           + g(y0, x1i) * ((1 - fy) * fx)[..., None]
           + g(y1i, x0) * (fy * (1 - fx))[..., None]
           + g(y1i, x1i) * (fy * fx)[..., None])
    # in-bounds check against the original (unclipped) positions
    valid = (py_full > -1) & (py_full < h) & (px_full > -1) & (px_full < w)
    val = torch.where(valid[..., None], val, 0.0)
    count = torch.clamp_min(valid.sum(dim=(-2, -1)), 1)[..., None]
    return val.sum(dim=(-3, -2)) / count
