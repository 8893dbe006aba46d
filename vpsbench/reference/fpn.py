"""FPN neck (counterpart of ``slotvps_tpu/models/fpn.py``).

1x1 laterals + top-down nearest x2 upsample + 3x3 output convs; extra
levels by stride-2 subsampling (``num_outs=5`` with 4 inputs).

Frozen copy of ``slotvps_tpu_torch/models/fpn.py`` at commit
86b90feb98325982c750f329cf213fa73d0ed5b3, for the
benchmark's plain reference: it imports nothing of the port.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn

from vpsbench.reference import layers as L
from vpsbench.reference.interpolate import upsample_x2_nearest


class FPN(nn.Module):
    def __init__(self, gen: torch.Generator, in_channels: Sequence[int],
                 out_channels: int):
        super().__init__()
        self.lateral = nn.ModuleList(
            L.init_conv(gen, 1, 1, c, out_channels, init="xavier")
            for c in in_channels)
        self.fpn = nn.ModuleList(
            L.init_conv(gen, 3, 3, out_channels, out_channels, init="xavier")
            for _ in in_channels)

    def forward(self, inputs: Sequence[torch.Tensor],
                num_outs: int = 5) -> List[torch.Tensor]:
        laterals = [conv(x, padding=0) for conv, x in zip(self.lateral,
                                                          inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] \
                + upsample_x2_nearest(laterals[i])
        outs = [conv(lat, padding=1) for conv, lat in zip(self.fpn,
                                                          laterals)]
        while len(outs) < num_outs:
            # stride-2 max pool with 1x1 window == strided slice
            outs.append(outs[-1][:, ::2, ::2, :])
        return outs


def init_fpn(gen, in_channels, out_channels) -> FPN:
    return FPN(gen, in_channels, out_channels)
