"""Top-level VPS detector: backbone -> FPN -> semantic head -> slot decoder.

Counterpart of ``slotvps_tpu/models/detector.py``: one module tree, and the
same two-step inference split — ``extract_features`` once per frame (its
result is carried as the next frame's reference features) and
``decode_pair`` for the joint two-frame slot decode.

Ported configuration space: the ResNet backbone without stage plugins or
R52 stem, sine position embeddings and ``compute_dtype="float32"``; the
rest raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn as nn

from slotvps_tpu_torch.config import ModelConfig
from slotvps_tpu_torch.models import layers as L
from slotvps_tpu_torch.models.fpn import init_fpn
from slotvps_tpu_torch.models.position_encoding import sine_position_embedding
from slotvps_tpu_torch.models.resnet import init_resnet
from slotvps_tpu_torch.models.semantic_head import init_semantic_head
from slotvps_tpu_torch.models.slot_head import apply_slot_head, init_slot_head
from slotvps_tpu_torch.models.track_head import init_track_head


class FrameFeatures(NamedTuple):
    """Per-frame backbone-side features carried across video steps."""

    feat_trans: Tuple[torch.Tensor, ...]  # 4 levels, coarsest first, 128ch
    fcn_output: torch.Tensor              # [B, H, W, 19] full-res logits


class FrameOutputs(NamedTuple):
    """Raw per-frame model outputs (fixed slot capacity)."""

    pred_logits: torch.Tensor   # [B, L, num_classes]
    pred_masks: torch.Tensor    # [B, L, H/4, W/4] mask logits
    embeddings: torch.Tensor    # [B, L, D] slot output embeddings
    fcn_output: torch.Tensor    # [B, H, W, 19]


def check_supported(cfg: ModelConfig):
    """Raise NotImplementedError for configuration the port lacks."""
    r = cfg.resnet
    unsupported = []
    if cfg.backbone != "resnet":
        unsupported.append(f"backbone={cfg.backbone!r}")
    if any(r.dcn_stages) or any(r.gcb_stages) or r.r52_stem:
        unsupported.append("ResNet stage plugins / R52 stem")
    if cfg.pos_embedding not in ("sine", "v2"):
        unsupported.append(f"pos_embedding={cfg.pos_embedding!r}")
    if cfg.compute_dtype != "float32":
        unsupported.append(f"compute_dtype={cfg.compute_dtype!r}")
    if cfg.slot_head.retriever_impl != "jax":
        unsupported.append("retriever_impl='pallas' (slot-attention kernel)")
    if unsupported:
        raise NotImplementedError("not ported yet: " + ", ".join(unsupported))


class Detector(nn.Module):
    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        d = cfg.slot_head.dh_dim
        out_ch = cfg.semantic_head.out_channels
        self.backbone = init_resnet(gen, cfg.resnet.depth,
                                    cfg.resnet.out_indices)
        self.fpn = init_fpn(gen, cfg.fpn_in_channels(), cfg.fpn.out_channels)
        self.semantic_head = init_semantic_head(gen, cfg.semantic_head)
        self.slot_head = init_slot_head(gen, cfg.slot_head)
        self.track_head = init_track_head(gen, cfg.track_head)
        # learned slot queries (vps_capsule.py:71, xavier init)
        self.init_mask_query = nn.Parameter(L.xavier_uniform(
            gen, (cfg.proposal_num, d), cfg.proposal_num, d))
        # capsule-level shared 1x1 transform (vps_capsule.py:76-79)
        self.conv_trans = L.init_conv(gen, 1, 1, out_ch, out_ch)
        self.fg_bn = L.FrozenBatchNorm(1)
        self.feat_bn = L.FrozenBatchNorm(d)
        with torch.no_grad():
            self.fg_bn.weight.fill_(0.1)  # reference init (vps_capsule:129)


def init_model(gen: torch.Generator, cfg: ModelConfig,
               device="cuda") -> Detector:
    """Build the model from ``gen`` on the CPU and move it to ``device``
    (the card unless the caller asks for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"init_model(device={str(device)!r}): CUDA is not available; "
            "pass device='cpu' to build the model on the CPU")
    return Detector(gen, cfg).to(device).eval()


def extract_features(model: Detector, cfg: ModelConfig,
                     img: torch.Tensor) -> FrameFeatures:
    """Backbone -> FPN -> semantic head -> conv_trans for one frame batch.

    img: [B, H, W, 3] normalized (NHWC)."""
    img = img.float()
    feats = model.backbone(img)
    fpn_outs = model.fpn(feats, num_outs=cfg.fpn.num_outs)
    fcn_output, _, feat_before = model.semantic_head(
        fpn_outs[:cfg.semantic_head.num_levels], cfg.semantic_head)
    feat_trans = tuple(model.conv_trans(f, padding=0) for f in feat_before)
    return FrameFeatures(feat_trans=feat_trans,
                         fcn_output=fcn_output.float())


def _position_embeddings(cfg: ModelConfig,
                         feat_trans: Sequence[torch.Tensor]):
    return [sine_position_embedding(f.shape[1], f.shape[2],
                                    num_pos_feats=cfg.pos_hidden_dim // 2,
                                    dtype=f.dtype, device=f.device)
            for f in feat_trans]


def decode_pair(model: Detector, cfg: ModelConfig,
                ref_feats: FrameFeatures,
                cur_feats: FrameFeatures) -> FrameOutputs:
    """Joint two-frame slot decode + final mask logits for the current frame
    (vps_temporal_slots.py:270-308 + generate_final_outputs :144-160)."""
    pos = _position_embeddings(cfg, cur_feats.feat_trans)
    ref_pos = _position_embeddings(cfg, ref_feats.feat_trans)
    all_logits, all_embeds, all_feats = apply_slot_head(
        model.slot_head, cfg.slot_head,
        features=[list(ref_feats.feat_trans), list(cur_feats.feat_trans)],
        init_queries=model.init_mask_query,
        pos=[ref_pos, pos])
    logits = all_logits[1][-1]      # current frame, last stage [B, L, C]
    embeds = all_embeds[1][-1]      # [B, L, D]
    fine = _feat_norm(model, all_feats[1][-1])   # [B, h, w, D]
    b, h, w, d = fine.shape
    masks = (embeds @ fine.reshape(b, h * w, d).transpose(1, 2)
             ).reshape(b, -1, h, w)
    return FrameOutputs(pred_logits=logits.float(),
                        pred_masks=_fg_bn(model, masks).float(),
                        embeddings=embeds.float(),
                        fcn_output=cur_feats.fcn_output)


def _feat_norm(model: Detector, feat):
    """feat_bn + channel L2-normalize as ``f * rsqrt(sumsq + 1e-12)`` — the
    JAX package's form, not ``F.normalize`` (``x / max(||x||, eps)``)."""
    f = model.feat_bn(feat)
    sumsq = torch.sum(torch.square(f), dim=-1, keepdim=True)
    return f * torch.rsqrt(sumsq + 1e-12)


def _fg_bn(model: Detector, mask_logits):
    p = model.fg_bn
    scale = p.weight[0] * torch.rsqrt(p.running_var[0] + 1e-5)
    bias = p.bias[0] - p.running_mean[0] * scale
    return mask_logits * scale.to(mask_logits.dtype) \
        + bias.to(mask_logits.dtype)
