"""ContextBlock (GCNet), the optional ResNet-stage plugin (counterpart of
``slotvps_tpu/models/context_block.py``; reference
mmdet/ops/context_block.py:13-104).

Global-context channel attention: a 1x1 conv gives per-pixel attention
logits, a softmax over all pixels pools one context vector, a bottleneck
(1x1 -> LayerNorm -> ReLU -> 1x1, the last zero-initialized) transforms it
and the result is added at every position.

Frozen copy of ``slotvps_tpu_torch/models/context_block.py`` at commit
86b90feb98325982c750f329cf213fa73d0ed5b3, for the
benchmark's plain reference: it imports nothing of the port.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from vpsbench.reference import layers as L


class _ChannelAdd(nn.Module):
    def __init__(self, gen: torch.Generator, in_channels: int, planes: int):
        super().__init__()
        self.conv1 = L.init_conv(gen, 1, 1, in_channels, planes)
        self.ln = L.Norm(planes)
        self.conv2 = L.init_conv(gen, 1, 1, planes, in_channels, init="zero")


class ContextBlock(nn.Module):
    def __init__(self, gen: torch.Generator, in_channels: int,
                 ratio: float = 1.0 / 16):
        super().__init__()
        self.conv_mask = L.init_conv(gen, 1, 1, in_channels, 1)
        self.channel_add = _ChannelAdd(gen, in_channels,
                                       int(in_channels * ratio))

    def forward(self, x):
        """x: [B, H, W, C]."""
        b, h, w, c = x.shape
        attn = torch.softmax(self.conv_mask(x).reshape(b, h * w), dim=-1)
        context = (attn[:, None, :] @ x.reshape(b, h * w, c)
                   ).reshape(b, 1, 1, c)
        t = self.channel_add.conv1(context)
        t = L.relu(self.channel_add.ln(t))
        return x + self.channel_add.conv2(t)


def init_context_block(gen: torch.Generator, in_channels: int,
                       ratio: float = 1.0 / 16) -> ContextBlock:
    return ContextBlock(gen, in_channels, ratio)
