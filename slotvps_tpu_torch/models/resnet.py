"""ResNet backbone (NHWC, frozen BatchNorm).

Counterpart of ``slotvps_tpu/models/resnet.py``: ``style='pytorch'``
(stride on each bottleneck's 3x3 conv), every BatchNorm applied with its
running statistics (``norm_eval=True`` in the reference).  The DCN/GCNet
stage plugins and the R52 deep stem are not ported yet.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from slotvps_tpu_torch.models import layers as L

ARCH_SETTINGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


class _Downsample(nn.Module):
    def __init__(self, gen, c_in, c_out):
        super().__init__()
        self.conv = L.init_conv(gen, 1, 1, c_in, c_out, bias=False)
        self.bn = L.FrozenBatchNorm(c_out)

    def forward(self, x, stride):
        return self.bn(self.conv(x, stride=stride, padding=0))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, gen, c_in, planes, stride):
        super().__init__()
        c_out = planes * self.expansion
        self.stride = stride
        self.conv1 = L.init_conv(gen, 1, 1, c_in, planes, bias=False)
        self.bn1 = L.FrozenBatchNorm(planes)
        self.conv2 = L.init_conv(gen, 3, 3, planes, planes, bias=False)
        self.bn2 = L.FrozenBatchNorm(planes)
        self.conv3 = L.init_conv(gen, 1, 1, planes, c_out, bias=False)
        self.bn3 = L.FrozenBatchNorm(c_out)
        self.downsample = (_Downsample(gen, c_in, c_out)
                           if stride != 1 or c_in != c_out else None)
        self.c_out = c_out

    def forward(self, x):
        out = L.relu(self.bn1(self.conv1(x, padding=0)))
        out = L.relu(self.bn2(self.conv2(out, stride=self.stride,
                                         padding=1)))
        out = self.bn3(self.conv3(out, padding=0))
        identity = x if self.downsample is None \
            else self.downsample(x, self.stride)
        return L.relu(out + identity)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, gen, c_in, planes, stride):
        super().__init__()
        self.stride = stride
        self.conv1 = L.init_conv(gen, 3, 3, c_in, planes, bias=False)
        self.bn1 = L.FrozenBatchNorm(planes)
        self.conv2 = L.init_conv(gen, 3, 3, planes, planes, bias=False)
        self.bn2 = L.FrozenBatchNorm(planes)
        self.downsample = (_Downsample(gen, c_in, planes)
                           if stride != 1 or c_in != planes else None)
        self.c_out = planes

    def forward(self, x):
        out = L.relu(self.bn1(self.conv1(x, stride=self.stride, padding=1)))
        out = self.bn2(self.conv2(out, padding=1))
        identity = x if self.downsample is None \
            else self.downsample(x, self.stride)
        return L.relu(out + identity)


def _max_pool_3x3_s2(x):
    """torch ``nn.MaxPool2d(3, stride=2, padding=1)`` on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2,
                        padding=1).permute(0, 2, 3, 1)


class ResNet(nn.Module):
    def __init__(self, gen: torch.Generator, depth: int = 50,
                 out_indices: Sequence[int] = (0, 1, 2, 3)):
        super().__init__()
        block, stage_blocks = ARCH_SETTINGS[depth]
        blk_cls = Bottleneck if block == "bottleneck" else BasicBlock
        self.out_indices = tuple(out_indices)
        self.conv1 = L.init_conv(gen, 7, 7, 3, 64, bias=False)
        self.bn1 = L.FrozenBatchNorm(64)
        c_in = 64
        for si, nblocks in enumerate(stage_blocks):
            planes = 64 * 2 ** si
            stride = 1 if si == 0 else 2
            blocks = []
            for bi in range(nblocks):
                blk = blk_cls(gen, c_in, planes, stride if bi == 0 else 1)
                c_in = blk.c_out
                blocks.append(blk)
            self.add_module(f"layer{si + 1}", nn.ModuleList(blocks))
        self.num_stages = len(stage_blocks)

    def forward(self, x) -> List[torch.Tensor]:
        """``apply_resnet``: x [B, H, W, 3] -> the feature maps at strides
        4/8/16/32 selected by ``out_indices``."""
        x = L.relu(self.bn1(self.conv1(x, stride=2, padding=3)))
        x = _max_pool_3x3_s2(x)
        outs = []
        for si in range(self.num_stages):
            for blk in getattr(self, f"layer{si + 1}"):
                x = blk(x)
            if si in self.out_indices:
                outs.append(x)
        return outs


def init_resnet(gen: torch.Generator, depth: int = 50,
                out_indices: Sequence[int] = (0, 1, 2, 3)) -> ResNet:
    return ResNet(gen, depth, out_indices)
