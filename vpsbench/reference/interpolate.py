"""Bilinear / nearest interpolation with exact PyTorch semantics, on NHWC.

Counterpart of ``slotvps_tpu/ops/interpolate.py``: the same arithmetic in
the same order, so the port and the JAX package agree to float rounding.
``F.interpolate`` itself is NCHW and is not used, to keep the NHWC layout
and the fixed-phase form of the integer upsamples.

Frozen copy of ``slotvps_tpu_torch/ops/interpolate.py`` at commit
86b90feb98325982c750f329cf213fa73d0ed5b3, for the
benchmark's plain reference: it imports nothing of the port.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _source_coords(out_size: int, in_size: int, align_corners: bool,
                   device):
    """Per-output-pixel fractional source coordinate, torch convention."""
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    if align_corners:
        if out_size == 1:
            return torch.zeros((out_size,), dtype=torch.float32,
                               device=device)
        scale = (in_size - 1) / (out_size - 1)
        return i * scale
    scale = in_size / out_size
    # half-pixel centers; torch clamps negatives to 0
    return torch.clamp_min((i + 0.5) * scale - 0.5, 0.0)


def interpolate_bilinear(x: torch.Tensor, size: Tuple[int, int],
                         align_corners: bool = False) -> torch.Tensor:
    """``F.interpolate(x, size, mode='bilinear', align_corners=...)``.

    x: [..., H, W, C] (leading batch dims allowed). Returns [..., h, w, C].
    """
    h_out, w_out = size
    h_in, w_in = x.shape[-3], x.shape[-2]
    if (h_out, w_out) == (h_in, w_in):
        return x
    dev = x.device
    ys = _source_coords(h_out, h_in, align_corners, dev)
    xs = _source_coords(w_out, w_in, align_corners, dev)
    y0 = torch.floor(ys).long()
    x0 = torch.floor(xs).long()
    y1 = torch.clamp_max(y0 + 1, h_in - 1)
    x1 = torch.clamp_max(x0 + 1, w_in - 1)
    wy = (ys - y0.float())[:, None, None]  # [h_out, 1, 1]
    wx = (xs - x0.float())[None, :, None]  # [1, w_out, 1]

    xf = x.float()
    nd = x.ndim
    top = xf.index_select(nd - 3, y0)
    bot = xf.index_select(nd - 3, y1)
    tl = top.index_select(nd - 2, x0)
    tr = top.index_select(nd - 2, x1)
    bl = bot.index_select(nd - 2, x0)
    br = bot.index_select(nd - 2, x1)
    out = (tl * (1 - wy) * (1 - wx) + tr * (1 - wy) * wx
           + bl * wy * (1 - wx) + br * wy * wx)
    return out.to(x.dtype)


def upsample_x2_nearest(x: torch.Tensor) -> torch.Tensor:
    """FPN top-down x2 nearest."""
    return x.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)


def _upsample_int_axis(x: torch.Tensor, axis: int, s: int) -> torch.Tensor:
    """Exact integer-factor bilinear upsample (align_corners=False) along
    one axis via the ``s`` fixed interpolation phases.  Matches torch:
    phase p samples at src = i + (2p+1-s)/(2s), edge-clamped."""
    n = x.shape[axis]
    prev = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)],
                     dim=axis)
    nxt = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)],
                    dim=axis)
    phases = []
    for p in range(s):
        off = (2 * p + 1 - s) / (2 * s)
        if off < 0:
            phases.append((-off) * prev + (1 + off) * x)
        elif off == 0:
            phases.append(x)
        else:
            phases.append((1 - off) * x + off * nxt)
    out = torch.stack(phases, dim=axis + 1)
    shape = list(x.shape)
    shape[axis] = s * n
    return out.reshape(shape)


def upsample_int_bilinear(x: torch.Tensor, s: int) -> torch.Tensor:
    """``F.interpolate(x, scale_factor=s, mode='bilinear',
    align_corners=False)`` on [..., H, W, C], exact and gather-free."""
    x = _upsample_int_axis(x, x.ndim - 3, s)
    return _upsample_int_axis(x, x.ndim - 2, s)


def upsample_x4_bilinear(x: torch.Tensor) -> torch.Tensor:
    return upsample_int_bilinear(x, 4)
