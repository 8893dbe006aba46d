"""Checkpoints: the port's own save/load, and reference ``.pth`` loading
(counterpart of ``slotvps_tpu/utils/checkpoint.py``).

The reference saves mmcv ``.pth`` checkpoints (``{'state_dict': ...,
'meta': ...}`` or a bare state dict).  :func:`convert_slotvps_checkpoint`
maps that state dict's keys onto the JAX package's parameter tree, with the
JAX package's code and numpy arrays for leaves; :func:`from_jax_params`
(``utils/convert.py``) then turns the tree into the port's ``state_dict``.
So the port has one layout map, the one its tests hold against the JAX
package, and no second key table.  Layout transforms on the way in: conv
OIHW -> HWIO, linear [out, in] -> [in, out], MHA ``in_proj_weight``
[3d, d] -> [d, 3d]; ``from_jax_params`` inverts each exactly, so every
value arrives bit for bit.

:func:`save_checkpoint` and :func:`load_checkpoint` write and read the
port's ``state_dict`` with ``torch.save`` / ``torch.load``.  They do not
read the JAX package's orbax directories (the card's machine has no
orbax): :func:`load_checkpoint` raises on a directory.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch

from slotvps_tpu_torch.utils.convert import from_jax_params


def save_checkpoint(path: str, model) -> None:
    """``torch.save`` of ``model``'s ``state_dict``, on the CPU."""
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               path)


def load_checkpoint(path: str, like=None):
    """The state dict :func:`save_checkpoint` wrote; with ``like`` (a
    model), loaded into it (strict) and ``like`` returned."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: an orbax checkpoint of the JAX package, "
            "which the port does not read; pass a .pth of the reference or a "
            "file written by slotvps_tpu_torch.utils.checkpoint."
            "save_checkpoint")
    state = torch.load(path, map_location="cpu")
    if like is None:
        return state
    like.load_state_dict(state, strict=True)
    return like


# ---------------------------------------------------------------------------
# reference state dict -> the JAX package's parameter tree (numpy leaves)
# ---------------------------------------------------------------------------


def _arr(t):
    return np.asarray(t)


def _conv_w(t):
    return _arr(t).transpose(2, 3, 1, 0)   # OIHW -> HWIO


def _lin_w(t):
    return _arr(t).T


def _bn(sd, prefix):
    return {"scale": _arr(sd[f"{prefix}.weight"]),
            "bias": _arr(sd[f"{prefix}.bias"]),
            "mean": _arr(sd[f"{prefix}.running_mean"]),
            "var": _arr(sd[f"{prefix}.running_var"])}


def _norm(sd, prefix):
    return {"scale": _arr(sd[f"{prefix}.weight"]),
            "bias": _arr(sd[f"{prefix}.bias"])}


def _conv(sd, prefix, bias=True):
    p = {"w": _conv_w(sd[f"{prefix}.weight"])}
    if bias and f"{prefix}.bias" in sd:
        p["b"] = _arr(sd[f"{prefix}.bias"])
    return p


def _linear(sd, prefix, bias=True):
    p = {"w": _lin_w(sd[f"{prefix}.weight"])}
    if bias and f"{prefix}.bias" in sd:
        p["b"] = _arr(sd[f"{prefix}.bias"])
    return p


def convert_torchvision_resnet(sd: Mapping, depth: int = 50) -> Dict:
    """torchvision/mmcv ResNet state dict -> the backbone subtree."""
    from slotvps_tpu_torch.models.resnet import ARCH_SETTINGS

    block, stage_blocks = ARCH_SETTINGS[depth]
    out = {"conv1": _conv(sd, "conv1", bias=False), "bn1": _bn(sd, "bn1")}
    if "conv3.weight" in sd:
        # the R52 deep stem (reference resnet.py:472-515): top-level
        # conv2/bn2 + conv3/bn3 exist only in this variant
        out["conv2"] = _conv(sd, "conv2", bias=False)
        out["bn2"] = _bn(sd, "bn2")
        out["conv3"] = _conv(sd, "conv3", bias=False)
        out["bn3"] = _bn(sd, "bn3")
    n_convs = 3 if block == "bottleneck" else 2
    for si, nb in enumerate(stage_blocks):
        stage = []
        for bi in range(nb):
            pre = f"layer{si + 1}.{bi}"
            bp = {}
            for ci in range(1, n_convs + 1):
                bp[f"conv{ci}"] = _conv(sd, f"{pre}.conv{ci}", bias=False)
                bp[f"bn{ci}"] = _bn(sd, f"{pre}.bn{ci}")
            if f"{pre}.downsample.0.weight" in sd:
                bp["downsample"] = {
                    "conv": _conv(sd, f"{pre}.downsample.0", bias=False),
                    "bn": _bn(sd, f"{pre}.downsample.1"),
                }
            stage.append(bp)
        out[f"layer{si + 1}"] = stage
    return out


def convert_swin(sd: Mapping, cfg) -> Dict:
    """Reference SwinTransformer state dict -> the backbone subtree
    (``cfg`` a SwinConfig).  Key layout of
    mmdet/models/backbones/swin_transformer.py: ``patch_embed.{proj,
    norm}``, ``layers.{s}.blocks.{b}.{norm1, attn.qkv, attn.proj,
    attn.relative_position_bias_table, norm2, mlp.fc1, mlp.fc2}``,
    ``layers.{s}.downsample.{reduction, norm}``, the out norms ``norm{i}``.
    ``attn.relative_position_index`` is a derived buffer: the port
    recomputes it and does not read it."""
    out: Dict = {
        "patch_embed": {
            "proj": _conv(sd, "patch_embed.proj"),
            "norm": (_norm(sd, "patch_embed.norm")
                     if "patch_embed.norm.weight" in sd else None),
        },
    }
    for si, depth in enumerate(cfg.depths):
        blocks = []
        for bi in range(depth):
            pre = f"layers.{si}.blocks.{bi}"
            blocks.append({
                "norm1": _norm(sd, f"{pre}.norm1"),
                "qkv": _linear(sd, f"{pre}.attn.qkv"),
                "proj": _linear(sd, f"{pre}.attn.proj"),
                "rel_pos_bias": _arr(
                    sd[f"{pre}.attn.relative_position_bias_table"]),
                "norm2": _norm(sd, f"{pre}.norm2"),
                "fc1": _linear(sd, f"{pre}.mlp.fc1"),
                "fc2": _linear(sd, f"{pre}.mlp.fc2"),
            })
        stage: Dict = {"blocks": blocks}
        if f"layers.{si}.downsample.reduction.weight" in sd:
            stage["downsample"] = {
                "reduction": _linear(
                    sd, f"layers.{si}.downsample.reduction", bias=False),
                "norm": _norm(sd, f"layers.{si}.downsample.norm"),
            }
        out[f"stage{si}"] = stage
    for i in cfg.out_indices:
        out[f"out_norm{i}"] = _norm(sd, f"norm{i}")
    return out


def _retriever(sd, pre):
    return {
        "to_q": _linear(sd, f"{pre}.to_q"),
        "to_k": _linear(sd, f"{pre}.to_k"),
        "to_v": _linear(sd, f"{pre}.to_v"),
        "norm_q": _norm(sd, f"{pre}.norm_q"),
        "norm_k": _norm(sd, f"{pre}.norm_k"),
        "norm_v": _norm(sd, f"{pre}.norm_v"),
        "norm1": _norm(sd, f"{pre}.norm1"),
    }


def convert_slotvps_checkpoint(sd: Mapping, cfg) -> Dict:
    """A reference checkpoint's state dict (VPS_Temporal_Slots) -> the JAX
    package's parameter tree, numpy leaves.  ``cfg`` is a ModelConfig; the
    key layout follows mmdet/models/detectors/{vps_temporal_slots,
    vps_capsule, dynamic_mask_head, simple_track_head}.py."""
    im = "image_model"
    params: Dict = {}
    bb_sd = {k[len(f"{im}.backbone."):]: v for k, v in sd.items()
             if k.startswith(f"{im}.backbone.")}
    if cfg.backbone == "swin":
        params["backbone"] = convert_swin(bb_sd, cfg.swin)
    else:
        params["backbone"] = convert_torchvision_resnet(bb_sd,
                                                        cfg.resnet.depth)
    n_lat = len(cfg.fpn_in_channels())
    params["fpn"] = {
        "lateral": [_conv(sd, f"{im}.neck.lateral_convs.{i}.conv")
                    for i in range(n_lat)],
        "fpn": [_conv(sd, f"{im}.neck.fpn_convs.{i}.conv")
                for i in range(n_lat)],
    }
    # the semantic head's shared tower, the Sequential deform_convs.0:
    # indices 0/3/6 = DCNWithOffset, 1/4/7 = GroupNorm
    tower = []
    for i in (0, 3, 6):
        pre = f"{im}.panopticFPN.deform_convs.0.{i}"
        tower.append({
            "offset": _conv(sd, f"{pre}.conv_offset"),
            "conv": _conv(sd, f"{pre}.conv", bias=False),
            "gn": _norm(sd, f"{im}.panopticFPN.deform_convs.0.{i + 1}"),
        })
    params["semantic_head"] = {
        "tower": tower,
        "conv_pred": _conv(sd, f"{im}.panopticFPN.conv_pred.conv"),
    }
    stages = []
    for lvl, n in enumerate(cfg.slot_head.per_dh_num_heads):
        for j in range(n):
            pre = f"{im}.dynamic_mask_head.head_series_{lvl}.{j}"
            sp = {
                "self_attn": {
                    "in_proj": {
                        "w": _lin_w(sd[f"{pre}.self_attn.in_proj_weight"]),
                        "b": _arr(sd[f"{pre}.self_attn.in_proj_bias"]),
                    },
                    "out_proj": _linear(sd, f"{pre}.self_attn.out_proj"),
                },
                "inst_interact": _retriever(sd, f"{pre}.inst_interact"),
                "linear1": _linear(sd, f"{pre}.linear1"),
                "linear2": _linear(sd, f"{pre}.linear2"),
                "norm1": _norm(sd, f"{pre}.norm1"),
                "norm2": _norm(sd, f"{pre}.norm2"),
                "norm3": _norm(sd, f"{pre}.norm3"),
                "cls_module": [
                    {"lin": _linear(sd, f"{pre}.cls_module.{3 * i}",
                                    bias=False),
                     "ln": _norm(sd, f"{pre}.cls_module.{3 * i + 1}")}
                    for i in range(cfg.slot_head.num_cls)
                ],
                "reg_module": [
                    {"lin": _linear(sd, f"{pre}.reg_module.{3 * i}",
                                    bias=False),
                     "ln": _norm(sd, f"{pre}.reg_module.{3 * i + 1}")}
                    for i in range(cfg.slot_head.num_reg)
                ],
                "class_logits": _linear(sd, f"{pre}.class_logits"),
            }
            tq = f"{pre}.temporal_query_head"
            if f"{tq}.linear1.weight" in sd:
                sp["temporal"] = {
                    "inst_interact": _retriever(sd, f"{tq}.inst_interact"),
                    "linear1": _linear(sd, f"{tq}.linear1"),
                    "linear2": _linear(sd, f"{tq}.linear2"),
                    "norm2": _norm(sd, f"{tq}.norm2"),
                    "norm3": _norm(sd, f"{tq}.norm3"),
                }
            stages.append(sp)
    params["slot_head"] = {
        "stages": stages,
        "conv_trans": _conv(sd, f"{im}.dynamic_mask_head.conv_trans.conv"),
    }
    params["track_head"] = {
        "fcs": [_linear(sd, f"temporal_track_head.fcs_query.{i}")
                for i in range(cfg.track_head.num_fcs_query)],
    }
    params["init_mask_query"] = _arr(sd[f"{im}.init_mask_query.weight"])
    params["conv_trans"] = _conv(sd, f"{im}.conv_trans.conv")
    params["fg_bn"] = _bn(sd, f"{im}.fg_bn")
    params["feat_bn"] = _bn(sd, f"{im}.feat_bn")
    return params


def load_torch_checkpoint(path: str, cfg) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` (``{'state_dict': ..., 'meta': ...}`` or a bare
    state dict) -> the port's ``state_dict`` for ``cfg`` (a ModelConfig),
    for ``model.load_state_dict(..., strict=True)``."""
    ckpt = torch.load(path, map_location="cpu")
    sd = ckpt.get("state_dict", ckpt)
    sd = {k: v.numpy() if isinstance(v, torch.Tensor) else v
          for k, v in sd.items()}
    return from_jax_params(convert_slotvps_checkpoint(sd, cfg), cfg)
