"""ResNet backbone (NHWC, frozen BatchNorm).

Counterpart of ``slotvps_tpu/models/resnet.py``: ``style='pytorch'``
(stride on each bottleneck's 3x3 conv), every BatchNorm applied with its
running statistics (``norm_eval=True`` in the reference).  With the
per-stage plugins of the reference (resnet.py:152-211): the DCN plugin
replaces a bottleneck's 3x3 conv by a deformable one, its offsets from a
zero-initialized ``conv2_offset`` at conv2's stride, computed by the plain
``ops/deform_conv.py`` ``deform_conv2d`` (the JAX package's XLA DCN, not
its kernel; halo 8); the GCNet context block runs after ``bn3``.  The R52
deep stem replaces the 7x7/2 stem conv by three 3x3 convs (3->64 s2,
64->64, 64->128), each with BN and ReLU.

Frozen copy of ``slotvps_tpu_torch/models/resnet.py`` at commit
86b90feb98325982c750f329cf213fa73d0ed5b3, for the
benchmark's plain reference: it imports nothing of the port.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from vpsbench.reference import layers as L
from vpsbench.reference.context_block import init_context_block
from vpsbench.reference.deform_conv import deform_conv2d

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

    def __init__(self, gen, c_in, planes, stride, dcn=False, gcb=False,
                 gcb_ratio=1.0 / 16):
        super().__init__()
        c_out = planes * self.expansion
        self.stride = stride
        self.conv1 = L.init_conv(gen, 1, 1, c_in, planes, bias=False)
        self.bn1 = L.FrozenBatchNorm(planes)
        self.conv2 = L.init_conv(gen, 3, 3, planes, planes, bias=False)
        self.bn2 = L.FrozenBatchNorm(planes)
        self.conv3 = L.init_conv(gen, 1, 1, planes, c_out, bias=False)
        self.bn3 = L.FrozenBatchNorm(c_out)
        # DCN plugin: the offset head starts at zero (reference
        # resnet.py:176-182)
        self.conv2_offset = (L.init_conv(gen, 3, 3, planes, 18, init="zero")
                             if dcn else None)
        self.gcb = init_context_block(gen, c_out, gcb_ratio) if gcb else None
        self.downsample = (_Downsample(gen, c_in, c_out)
                           if stride != 1 or c_in != c_out else None)
        self.c_out = c_out

    def forward(self, x):
        out = L.relu(self.bn1(self.conv1(x, padding=0)))
        if self.conv2_offset is not None:
            # offsets at conv2's stride, then the deformable conv2
            # (reference resnet.py:235-244)
            offset = self.conv2_offset(out, stride=self.stride, padding=1)
            out = deform_conv2d(out, offset,
                                self.conv2.weight.permute(2, 3, 1, 0),
                                stride=self.stride, padding=1)
        else:
            out = self.conv2(out, stride=self.stride, padding=1)
        out = L.relu(self.bn2(out))
        out = self.bn3(self.conv3(out, padding=0))
        if self.gcb is not None:
            out = self.gcb(out)
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
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 dcn_stages: Optional[Sequence[bool]] = None,
                 gcb_stages: Optional[Sequence[bool]] = None,
                 gcb_ratio: float = 1.0 / 16, r52_stem: bool = False):
        super().__init__()
        block, stage_blocks = ARCH_SETTINGS[depth]
        dcn_stages = dcn_stages or (False,) * len(stage_blocks)
        gcb_stages = gcb_stages or (False,) * len(stage_blocks)
        self.out_indices = tuple(out_indices)
        self.r52_stem = r52_stem
        if r52_stem:
            # R52 deep stem (reference resnet.py:421-424, 472-515)
            self.conv1 = L.init_conv(gen, 3, 3, 3, 64, bias=False)
            self.bn1 = L.FrozenBatchNorm(64)
            self.conv2 = L.init_conv(gen, 3, 3, 64, 64, bias=False)
            self.bn2 = L.FrozenBatchNorm(64)
            self.conv3 = L.init_conv(gen, 3, 3, 64, 128, bias=False)
            self.bn3 = L.FrozenBatchNorm(128)
            c_in = 128
        else:
            self.conv1 = L.init_conv(gen, 7, 7, 3, 64, bias=False)
            self.bn1 = L.FrozenBatchNorm(64)
            c_in = 64
        for si, nblocks in enumerate(stage_blocks):
            planes = 64 * 2 ** si
            stride = 1 if si == 0 else 2
            blocks = []
            for bi in range(nblocks):
                s = stride if bi == 0 else 1
                if block == "bottleneck":
                    blk = Bottleneck(gen, c_in, planes, s, dcn=dcn_stages[si],
                                     gcb=gcb_stages[si], gcb_ratio=gcb_ratio)
                else:
                    blk = BasicBlock(gen, c_in, planes, s)
                c_in = blk.c_out
                blocks.append(blk)
            self.add_module(f"layer{si + 1}", nn.ModuleList(blocks))
        self.num_stages = len(stage_blocks)

    def forward(self, x) -> List[torch.Tensor]:
        """``apply_resnet``: x [B, H, W, 3] -> the feature maps at strides
        4/8/16/32 selected by ``out_indices``."""
        if self.r52_stem:
            x = L.relu(self.bn1(self.conv1(x, stride=2, padding=1)))
            x = L.relu(self.bn2(self.conv2(x, padding=1)))
            x = L.relu(self.bn3(self.conv3(x, padding=1)))
        else:
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
                out_indices: Sequence[int] = (0, 1, 2, 3),
                dcn_stages: Optional[Sequence[bool]] = None,
                gcb_stages: Optional[Sequence[bool]] = None,
                gcb_ratio: float = 1.0 / 16, r52_stem: bool = False) -> ResNet:
    return ResNet(gen, depth, out_indices, dcn_stages=dcn_stages,
                  gcb_stages=gcb_stages, gcb_ratio=gcb_ratio,
                  r52_stem=r52_stem)


