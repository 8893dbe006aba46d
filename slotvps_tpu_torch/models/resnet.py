"""ResNet backbone (NHWC, frozen BatchNorm).

Counterpart of ``slotvps_tpu/models/resnet.py``: ``style='pytorch'``
(stride on each bottleneck's 3x3 conv), every BatchNorm applied with its
running statistics (``norm_eval=True`` in the reference).  The DCN/GCNet
stage plugins and the R52 deep stem are not ported yet.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

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


def iter_bns(backbone: ResNet) -> Iterator[L.FrozenBatchNorm]:
    """The backbone's BatchNorms in forward call order (the JAX package's
    ``_iter_bns``; ``calibrate_bn_stats`` checks the order against the
    forward's own calls)."""
    yield backbone.bn1
    for si in range(backbone.num_stages):
        for blk in getattr(backbone, f"layer{si + 1}"):
            yield blk.bn1
            yield blk.bn2
            if isinstance(blk, Bottleneck):
                yield blk.bn3
            if blk.downsample is not None:
                yield blk.downsample.bn


@torch.no_grad()
def calibrate_bn_stats(backbone: ResNet, x: torch.Tensor, eps: float = 1e-5,
                       check: bool = True) -> ResNet:
    """Write every backbone BN's running statistics, in place, from the
    batch statistics of one forward pass over ``x`` [B, H, W, 3]: at each
    site the f32 mean and *biased* variance over (B, H, W) of its input,
    with which that site then normalizes (the JAX package's
    ``calibrate_bn_stats`` and ``_bn_stat_collector``).

    A random-init backbone under identity statistics compounds activation
    magnitude across its BN sites (the JAX package measured ~1e22 on the
    FPN outputs at flagship depth); this calibration is the random-init
    analog of a pretrained checkpoint's statistics, used by
    ``utils/synthetic.overfit`` before each step.  Runs without autograd.
    With ``check``, the frozen forward with the written statistics must
    reproduce the collecting forward within 1e-3 of each output's max
    (a mis-paired statistic would not); it raises otherwise."""
    sites = list(iter_bns(backbone))
    stats, seen = [], []

    def collect(bn, inputs, _out):
        xf = inputs[0].float()
        v, m = torch.var_mean(xf, dim=(0, 1, 2), correction=0)
        stats.append((m, v))
        seen.append(bn)
        return L.batch_norm_eval(inputs[0], bn.weight, bn.bias, m, v, eps)

    hooks = [bn.register_forward_hook(collect) for bn in sites]
    try:
        outs = backbone(x)
    finally:
        for h in hooks:
            h.remove()
    if len(seen) != len(sites) or any(a is not b
                                      for a, b in zip(seen, sites)):
        raise RuntimeError(f"BN calibration: the forward called "
                           f"{len(seen)} BatchNorms, not the {len(sites)} "
                           "of iter_bns in its order")
    for bn, (m, v) in zip(sites, stats):
        bn.running_mean.copy_(m)
        bn.running_var.copy_(v)
    if check:
        for a, b in zip(backbone(x), outs):
            if not bool(((a - b).abs() <= 1e-3 * b.abs().max()).all()):
                raise RuntimeError("BN stat calibration replay mismatch "
                                   "(pairing bug)")
    return backbone
