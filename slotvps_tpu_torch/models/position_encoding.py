"""Sine position embedding (counterpart of
``slotvps_tpu/models/position_encoding.py`` ``sine_position_embedding``;
reference ``PositionEmbeddingSine`` with ``normalize=True``)."""

from __future__ import annotations

import math

import torch


def sine_position_embedding(h: int, w: int, num_pos_feats: int = 128,
                            temperature: float = 10000.0,
                            normalize: bool = True,
                            scale: float = 2 * math.pi,
                            dtype=torch.float32,
                            device=None) -> torch.Tensor:
    """Returns [H, W, 2*num_pos_feats] (y-features then x-features)."""
    f32 = dict(dtype=torch.float32, device=device)
    y_embed = torch.arange(1, h + 1, **f32)[:, None] * torch.ones((1, w), **f32)
    x_embed = torch.arange(1, w + 1, **f32)[None, :] * torch.ones((h, 1), **f32)
    if normalize:
        eps = 1e-6
        y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, -1:] + eps) * scale

    dim_t = torch.arange(num_pos_feats, **f32)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)

    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    # interleave sin/cos over even/odd feature pairs (reference :253-254)
    pos_x = torch.stack((torch.sin(pos_x[:, :, 0::2]),
                         torch.cos(pos_x[:, :, 1::2])), dim=3
                        ).reshape(h, w, num_pos_feats)
    pos_y = torch.stack((torch.sin(pos_y[:, :, 0::2]),
                         torch.cos(pos_y[:, :, 1::2])), dim=3
                        ).reshape(h, w, num_pos_feats)
    return torch.cat((pos_y, pos_x), dim=-1).to(dtype)
