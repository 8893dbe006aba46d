"""Top-level VPS detector: backbone -> FPN -> semantic head -> slot decoder.

Counterpart of ``slotvps_tpu/models/detector.py``: one module tree, and the
same two-step inference split — ``extract_features`` once per frame (its
result is carried as the next frame's reference features) and
``decode_pair`` for the joint two-frame slot decode (``forward_frame`` runs
both from pixels).  Training calls the
backbone module directly (the JAX package's ``apply_backbone`` picks a
backbone function; here ``model.backbone`` is that choice) and
``decode_pair_train`` (per-stage auxiliary outputs, the reference frame's
outputs and the normalized fine feature).

Ported configuration space: every per-frame model the JAX package builds
— the ResNet backbone (with its DCN and GCNet stage plugins and the R52
stem) or the Swin backbone (``swinl_fpn_slotvps``), sine or learned
position embeddings; ``compute_dtype`` "float32" or "bfloat16" (parameters
stay f32 and are cast to the activations' dtype), and
``slot_head.retriever_impl`` "jax" (plain slot attention) or "pallas" (the
Hopper slot-attention kernel, bf16 or f32).  Another dtype or Retriever
route raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn as nn

from slotvps_tpu_torch.config import ModelConfig
from slotvps_tpu_torch.models import layers as L
from slotvps_tpu_torch.models.fpn import init_fpn
from slotvps_tpu_torch.models.position_encoding import (
    LearnedPositionEmbedding, sine_position_embedding)
from slotvps_tpu_torch.models.resnet import init_resnet
from slotvps_tpu_torch.models.semantic_head import init_semantic_head
from slotvps_tpu_torch.models.swin import init_swin
from slotvps_tpu_torch.models.slot_head import (apply_slot_head,
                                                init_slot_head,
                                                retriever_attention,
                                                retriever_attention_pallas)
from slotvps_tpu_torch.models.track_head import init_track_head
from slotvps_tpu_torch.ops.interpolate import upsample_int_bilinear


class FrameFeatures(NamedTuple):
    """Per-frame backbone-side features carried across video steps."""

    feat_trans: Tuple[torch.Tensor, ...]  # 4 levels, coarsest first, 128ch
    # [B, H, W, 19] full-res logits — or [B, H/4, W/4, 19] quarter-res
    # when semantic_head.fused_sseg=True (postprocess fuses the upsample)
    fcn_output: torch.Tensor


class FrameOutputs(NamedTuple):
    """Raw per-frame model outputs (fixed slot capacity)."""

    pred_logits: torch.Tensor   # [B, L, num_classes]
    pred_masks: torch.Tensor    # [B, L, H/4, W/4] mask logits
    embeddings: torch.Tensor    # [B, L, D] slot output embeddings
    fcn_output: torch.Tensor    # [B, H, W, 19]


def check_supported(cfg: ModelConfig):
    """Raise NotImplementedError for configuration the port lacks."""
    unsupported = []
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        unsupported.append(f"compute_dtype={cfg.compute_dtype!r}")
    if cfg.slot_head.retriever_impl not in ("jax", "pallas"):
        unsupported.append(
            f"retriever_impl={cfg.slot_head.retriever_impl!r}")
    if unsupported:
        raise NotImplementedError("not ported yet: " + ", ".join(unsupported))


class Detector(nn.Module):
    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        d = cfg.slot_head.dh_dim
        out_ch = cfg.semantic_head.out_channels
        if cfg.backbone == "resnet":
            r = cfg.resnet
            self.backbone = init_resnet(
                gen, r.depth, r.out_indices, dcn_stages=r.dcn_stages,
                gcb_stages=r.gcb_stages, gcb_ratio=r.gcb_ratio,
                r52_stem=r.r52_stem)
        elif cfg.backbone == "swin":
            self.backbone = init_swin(gen, cfg.swin)
        else:
            raise ValueError(f"backbone={cfg.backbone!r}")
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
        self.pos_embed = (LearnedPositionEmbedding(gen,
                                                   cfg.pos_hidden_dim // 2)
                          if cfg.pos_embedding in ("learned", "v3") else None)


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

    img: [B, H, W, 3] normalized (NHWC), cast here to
    ``cfg.compute_dtype``; the semantic logits come back in f32."""
    img = img.to(getattr(torch, cfg.compute_dtype))
    feats = model.backbone(img)
    fpn_outs = model.fpn(feats, num_outs=cfg.fpn.num_outs)
    fcn_output, _, feat_before = model.semantic_head(
        fpn_outs[:cfg.semantic_head.num_levels], cfg.semantic_head)
    feat_trans = tuple(model.conv_trans(f, padding=0) for f in feat_before)
    return FrameFeatures(feat_trans=feat_trans,
                         fcn_output=fcn_output.float())


def _position_embeddings(model: Detector, cfg: ModelConfig,
                         feat_trans: Sequence[torch.Tensor]):
    if model.pos_embed is not None:
        return [model.pos_embed(f.shape[1], f.shape[2], dtype=f.dtype)
                for f in feat_trans]
    return [sine_position_embedding(f.shape[1], f.shape[2],
                                    num_pos_feats=cfg.pos_hidden_dim // 2,
                                    dtype=f.dtype, device=f.device)
            for f in feat_trans]


def decode_pair(model: Detector, cfg: ModelConfig,
                ref_feats: FrameFeatures,
                cur_feats: FrameFeatures) -> FrameOutputs:
    """Joint two-frame slot decode + final mask logits for the current frame
    (vps_temporal_slots.py:270-308 + generate_final_outputs :144-160)."""
    pos = _position_embeddings(model, cfg, cur_feats.feat_trans)
    ref_pos = _position_embeddings(model, cfg, ref_feats.feat_trans)
    retriever_fn = (retriever_attention_pallas
                    if cfg.slot_head.retriever_impl == "pallas"
                    else retriever_attention)
    all_logits, all_embeds, all_feats = apply_slot_head(
        model.slot_head, cfg.slot_head,
        features=[list(ref_feats.feat_trans), list(cur_feats.feat_trans)],
        init_queries=model.init_mask_query,
        pos=[ref_pos, pos],
        retriever_fn=retriever_fn)
    logits = all_logits[1][-1]      # current frame, last stage [B, L, C]
    embeds = all_embeds[1][-1]      # [B, L, D]
    fine = _feat_norm(model, all_feats[1][-1])   # [B, h, w, D]
    return FrameOutputs(pred_logits=logits.float(),
                        pred_masks=_mask_logits(model, fine, embeds).float(),
                        embeddings=embeds.float(),
                        fcn_output=cur_feats.fcn_output)


def _mask_logits(model: Detector, feat, embeds):
    """fg_bn(einsum("bhwc,blc->blhw", feat, embeds))."""
    b, h, w, d = feat.shape
    masks = (embeds @ feat.reshape(b, h * w, d).transpose(1, 2)
             ).reshape(b, -1, h, w)
    return _fg_bn(model, masks)


def decode_pair_train(model: Detector, cfg: ModelConfig,
                      ref_feats: FrameFeatures, cur_feats: FrameFeatures):
    """Like :func:`decode_pair` but also returns per-stage auxiliary outputs
    for deep supervision (reference return_intermediate=True; stage s uses
    the decoder feature of level ``s // 2``, its mask logits upsampled to the
    finest level) with the plain Retriever.

    Returns (final FrameOutputs of the current frame, aux [(logits
    [B, L, C], mask logits [B, L, h, w])] for every stage but the last,
    extras {"ref": the reference frame's FrameOutputs, "fine_feat": the
    normalized finest decoder feature [B, h, w, D] f32})."""
    pos = _position_embeddings(model, cfg, cur_feats.feat_trans)
    ref_pos = _position_embeddings(model, cfg, ref_feats.feat_trans)
    all_logits, all_embeds, all_feats = apply_slot_head(
        model.slot_head, cfg.slot_head,
        features=[list(ref_feats.feat_trans), list(cur_feats.feat_trans)],
        init_queries=model.init_mask_query,
        pos=[ref_pos, pos])
    normed = [_feat_norm(model, f) for f in all_feats[1]]
    fine = normed[-1]
    h4, w4 = fine.shape[1:3]
    final = FrameOutputs(
        pred_logits=all_logits[1][-1].float(),
        pred_masks=_mask_logits(model, fine, all_embeds[1][-1]).float(),
        embeddings=all_embeds[1][-1].float(),
        fcn_output=cur_feats.fcn_output)
    aux = []
    for s in range(all_logits[1].shape[0] - 1):
        m = _mask_logits(model, normed[min(s // 2, len(normed) - 1)],
                         all_embeds[1][s])
        if m.shape[-2:] != (h4, w4):
            m = upsample_int_bilinear(m.permute(0, 2, 3, 1),
                                      h4 // m.shape[-2]).permute(0, 3, 1, 2)
        aux.append((all_logits[1][s].float(), m.float()))
    ref_fine = _feat_norm(model, all_feats[0][-1])
    ref_final = FrameOutputs(
        pred_logits=all_logits[0][-1].float(),
        pred_masks=_mask_logits(model, ref_fine, all_embeds[0][-1]).float(),
        embeddings=all_embeds[0][-1].float(),
        fcn_output=ref_feats.fcn_output)
    return final, aux, {"ref": ref_final, "fine_feat": fine.float()}


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


def forward_frame(model: Detector, cfg: ModelConfig, img: torch.Tensor,
                  ref_img: torch.Tensor) -> FrameOutputs:
    """The whole one-frame forward from pixels (both frames), the shape the
    reference runs per test step (vps_temporal_slots.py:207-308): one
    backbone pass over the batch ``[ref; cur]``, then :func:`decode_pair`."""
    feats = extract_features(model, cfg, torch.cat([ref_img, img], dim=0))
    b = img.shape[0]
    ref_feats = FrameFeatures(
        feat_trans=tuple(f[:b] for f in feats.feat_trans),
        fcn_output=feats.fcn_output[:b])
    cur_feats = FrameFeatures(
        feat_trans=tuple(f[b:] for f in feats.feat_trans),
        fcn_output=feats.fcn_output[b:])
    return decode_pair(model, cfg, ref_feats, cur_feats)
