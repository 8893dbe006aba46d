"""UPSNet-style FPN semantic head (counterpart of
``slotvps_tpu/models/semantic_head.py``).

One shared tower of three (deformable conv -> GN(32) -> ReLU) blocks runs
on each of P2..P5, each level at its own DCN halo (``cfg.level_halo``):

    DCN(256->256) GN ReLU, DCN(256->128) GN ReLU, DCN(128->128) GN ReLU

Each deformable conv predicts its offsets with a zero-initialised 3x3 conv.

The port's ``SemanticHeadConfig.dcn_impl`` takes the JAX package's
strings, with these meanings:

* ``"jax"``        — the plain PyTorch DCN (``ops/deform_conv.py``), halo
  ``dcn_halo or 8``;
* ``"pallas_f32"`` — the hand-written Hopper kernel in f32
  (``ops/cuda/deform_conv.py``), halo ``dcn_halo or 4``;
* ``"pallas"``     — the same kernel in bf16, halo ``dcn_halo or 4``.

On the two kernel routes the input and the weight go to the kernel in the
route's compute dtype (f32 for "pallas_f32", bf16 for "pallas"), the
offsets in f32 (the bf16 model's bf16 offsets widen exactly), and the
output comes back in the activations' dtype without another rounding, as
``deform_conv2d_pallas`` does: in an f32 model "pallas" computes in bf16
and returns f32.  Both routes are differentiable (the backward kernel).
On CPU tensors the wrapper runs the plain versions at that dtype.

:func:`semantic_loss` is the head's training loss (weighted CE with an
ignore label).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from slotvps_tpu_torch.config import SemanticHeadConfig
from slotvps_tpu_torch.models import layers as L
from slotvps_tpu_torch.ops.cuda.deform_conv import deform_conv2d_hopper
from slotvps_tpu_torch.ops.deform_conv import deform_conv2d
from slotvps_tpu_torch.ops.interpolate import (upsample_int_bilinear,
                                               upsample_x4_bilinear)
from slotvps_tpu_torch.utils import cost


class DCNBlock(nn.Module):
    def __init__(self, gen, c_in, c_out):
        super().__init__()
        # offset predictor: zero-init (deform_conv_with_offset.py:21-27)
        self.offset = L.Conv2d(torch.zeros(18, c_in, 3, 3), torch.zeros(18))
        self.conv = L.init_conv(gen, 3, 3, c_in, c_out, bias=False,
                                init="xavier")
        self.gn = L.Norm(c_out)

    def forward(self, x, gn_groups, impl="jax", halo=0):
        offset = self.offset(x, padding=1)
        weight = self.conv.weight.permute(2, 3, 1, 0)  # -> [3, 3, Cin, Cout]
        out = cost.entry_with_backward(
            "dcn", lambda *args: _deform_conv(*args, impl, halo),
            _dcn_works, x, offset, weight)
        out = L.group_norm(out, self.gn.weight, self.gn.bias,
                           num_groups=gn_groups)
        return L.relu(out)


def _dcn_works(x, offset, weight):
    """The DCN's forward and backward Work (``utils/cost.py``)."""
    b, h, w, cin = x.shape
    cout = weight.shape[-1]
    xs, offs, ws = (t.element_size() for t in (x, offset, weight))
    return (cost.dcn_forward(b, h, w, cin, cout, xs, offs, ws),
            cost.dcn_backward(b, h, w, cin, cout, xs, ws, xs, offs, xs))


def _deform_conv(x, offset, weight, impl, halo):
    """The semantic tower's deformable conv on ``impl``'s route: the
    branch point of the kernel and its plain version
    (``utils/cost.py`` counts the DCN's formulas here)."""
    if impl in ("pallas", "pallas_f32"):
        dtype = torch.bfloat16 if impl == "pallas" else torch.float32
        return deform_conv2d_hopper(x.contiguous(), offset.contiguous(),
                                    weight, halo or 4, compute_dtype=dtype)
    if impl == "jax":
        return deform_conv2d(x, offset, weight, padding=1,
                             max_displacement=halo or 8)
    raise ValueError(f"unknown dcn_impl {impl!r}")


class SemanticHead(nn.Module):
    def __init__(self, gen: torch.Generator, cfg: SemanticHeadConfig):
        super().__init__()
        self.tower = nn.ModuleList([
            DCNBlock(gen, cfg.in_channels, cfg.in_channels),
            DCNBlock(gen, cfg.in_channels, cfg.out_channels),
            DCNBlock(gen, cfg.out_channels, cfg.out_channels),
        ])
        self.conv_pred = L.init_conv(gen, 1, 1, cfg.out_channels * 4,
                                     cfg.num_classes, init="xavier")

    def forward(self, inputs: Sequence[torch.Tensor],
                cfg: SemanticHeadConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
        """``apply_semantic_head``: inputs FPN [P2, P3, P4, P5] (NHWC).
        ``cfg`` picks the DCN implementation and halos at call time.

        Returns (fcn_output [B, 4h, 4w, C], fcn_score [B, h, w, C],
        feat_before — 128-ch tower outputs coarsest-first [P5, P4, P3, P2]).
        """
        if len(inputs) != cfg.num_levels:
            raise ValueError(f"{len(inputs)} levels, want {cfg.num_levels}")
        fpn_px = []
        for lvl, x in enumerate(inputs):
            for block in self.tower:
                x = block(x, cfg.gn_groups, impl=cfg.dcn_impl,
                          halo=cfg.level_halo(lvl))
            fpn_px.append(x)
        feat_before = fpn_px[::-1]

        ups = [fpn_px[0]]
        for lvl in range(1, 4):
            ups.append(upsample_int_bilinear(fpn_px[lvl], 2 ** lvl))
        feat = torch.cat(ups, dim=-1)
        fcn_score = self.conv_pred(feat, padding=0)
        if cfg.fused_sseg:
            return fcn_score, fcn_score, feat_before
        return upsample_x4_bilinear(fcn_score), fcn_score, feat_before


def init_semantic_head(gen, cfg: SemanticHeadConfig) -> SemanticHead:
    return SemanticHead(gen, cfg)


def semantic_loss(fcn_score: torch.Tensor, seg_label: torch.Tensor,
                  cfg: SemanticHeadConfig,
                  count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted CE with ignore label (reference upsnetFPN.py:87-98).

    fcn_score [B, h, w, C] logits, seg_label [B, h, w] int.  The summed
    log-likelihood of the valid pixels is divided by ``count``, by default
    their number (at least 1); a data-parallel step passes its rank's share
    of the whole batch's count (``training/step.py``)."""
    valid = seg_label != cfg.ignore_label
    labels = torch.where(valid, seg_label, 0).long()
    logp = torch.log_softmax(fcn_score.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    if count is None:
        count = valid.sum().clamp_min(1)
    loss = -(ll * valid).sum() / count
    return cfg.loss_weight * loss
