"""SimpleTrackHead (counterpart of ``slotvps_tpu/models/track_head.py``).

Two FC(256->256) layers with ReLU between (not after) on both query sets,
then a correlation matrix ``x @ ref.T`` with an all-zero "new object"
column prepended.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from slotvps_tpu_torch.config import TrackHeadConfig
from slotvps_tpu_torch.models import layers as L


class TrackHead(nn.Module):
    def __init__(self, gen: torch.Generator, cfg: TrackHeadConfig):
        super().__init__()
        d = cfg.in_channels_query
        self.fcs = nn.ModuleList(L.init_linear(gen, d, d, init="normal001")
                                 for _ in range(cfg.num_fcs_query))

    def _embed(self, x):
        n = len(self.fcs)
        for i, fc in enumerate(self.fcs):
            x = fc(x)
            if i < n - 1:
                x = L.relu(x)
        return x

    def forward(self, x_query, ref_x_query):
        """``apply_track_head``: x_query [N, D] current embeddings,
        ref_x_query [M, D] previous.
        Returns match scores [N, M+1]; column 0 is the "new object" score."""
        prod = self._embed(x_query) @ self._embed(ref_x_query).T
        dummy = torch.zeros((prod.shape[0], 1), dtype=prod.dtype,
                            device=prod.device)
        return torch.cat([dummy, prod], dim=1)


def init_track_head(gen, cfg: TrackHeadConfig) -> TrackHead:
    return TrackHead(gen, cfg)
