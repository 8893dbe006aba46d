"""Panoptic Retriever slot decoder (counterpart of
``slotvps_tpu/models/slot_head.py``).

Seven decoder stages over four coarse-to-fine feature levels.  Between
levels the previous level's 256-ch map is upsampled x2 (bilinear) and
concatenated with the current level's 128-ch input, then fused by a shared
1x1 conv; level 0 tiles its input x3.  Each stage runs per frame: slot
self-attention -> Retriever cross-attention (softmax over SLOTS) -> FFN,
each with residual + LayerNorm; the temporal stages then run the Video
Retriever over both frames' slots.  Frames ride the batch axis for the
dense work.

The Retriever's attention core has two routes, picked by
``SlotHeadConfig.retriever_impl`` in ``detector.decode_pair``:
:func:`retriever_attention` (plain PyTorch in the activations' dtype, the
JAX package's ``"jax"`` route) and :func:`retriever_attention_pallas` (the
Hopper slot-attention kernel, ``ops/cuda/slot_attention.py``, with the
JAX Pallas kernel's numerics: f32 scores, softmax and output).  The two
cores are the branch point that ``utils/cost.py`` counts by its formula.

Frozen copy of ``slotvps_tpu_torch/models/slot_head.py`` at commit
86b90feb98325982c750f329cf213fa73d0ed5b3, for the
benchmark's plain reference: it imports nothing of the port; the Retriever's
core is the plain one.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from vpsbench.reference.config import SlotHeadConfig
from vpsbench.reference import layers as L
from vpsbench.reference import lowp
from vpsbench.reference.interpolate import upsample_int_bilinear
from vpsbench.cost import cost

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


class Retriever(nn.Module):
    """Parameters of MaskDynamicConv / SlotsDynamicConv."""

    def __init__(self, gen, d):
        super().__init__()
        self.to_q = L.init_linear(gen, d, d)
        self.to_k = L.init_linear(gen, d, d)
        self.to_v = L.init_linear(gen, d, d)
        self.norm_q = L.Norm(d)
        self.norm_k = L.Norm(d)
        self.norm_v = L.Norm(d)
        self.norm1 = L.Norm(d)


class TemporalHead(nn.Module):
    def __init__(self, gen, cfg: SlotHeadConfig):
        super().__init__()
        t = cfg.temporal_query_attention
        self.inst_interact = Retriever(gen, t.d_model)
        self.linear1 = L.init_linear(gen, t.d_model, t.dim_feedforward)
        self.linear2 = L.init_linear(gen, t.dim_feedforward, t.d_model)
        self.norm2 = L.Norm(t.d_model)
        self.norm3 = L.Norm(t.d_model)


class _LinLN(nn.Module):
    def __init__(self, gen, d):
        super().__init__()
        self.lin = L.init_linear(gen, d, d, bias=False)
        self.ln = L.Norm(d)

    def forward(self, x):
        return L.relu(self.ln(self.lin(x)))


class Stage(nn.Module):
    def __init__(self, gen, cfg: SlotHeadConfig, with_temporal: bool):
        super().__init__()
        d = cfg.dh_dim
        self.self_attn = L.MultiheadAttention(gen, d)
        self.inst_interact = Retriever(gen, d)
        self.linear1 = L.init_linear(gen, d, cfg.dim_feedforward)
        self.linear2 = L.init_linear(gen, cfg.dim_feedforward, d)
        self.norm1 = L.Norm(d)
        self.norm2 = L.Norm(d)
        self.norm3 = L.Norm(d)
        self.cls_module = nn.ModuleList(_LinLN(gen, d)
                                        for _ in range(cfg.num_cls))
        self.reg_module = nn.ModuleList(_LinLN(gen, d)
                                        for _ in range(cfg.num_reg))
        self.class_logits = L.init_linear(gen, d, cfg.num_classes)
        if cfg.use_focal:
            # focal-style bias init (reference dynamic_mask_head.py:123-136)
            bias_value = -math.log((1 - cfg.prior_prob) / cfg.prior_prob)
            with torch.no_grad():
                self.class_logits.bias.fill_(bias_value)
        self.temporal = TemporalHead(gen, cfg) if with_temporal else None


class SlotHead(nn.Module):
    def __init__(self, gen: torch.Generator, cfg: SlotHeadConfig):
        super().__init__()
        n_stages = sum(cfg.per_dh_num_heads)
        self.stages = nn.ModuleList(
            Stage(gen, cfg, cfg.temporal_query_attention is not None
                  and s in cfg.apply_temporal_query_atten_stages)
            for s in range(n_stages))
        self.conv_trans = L.init_conv(gen, 1, 1, cfg.trans_in_dim,
                                      cfg.dh_dim, init="xavier")


def init_slot_head(gen, cfg: SlotHeadConfig) -> SlotHead:
    return SlotHead(gen, cfg)


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def _retriever_qkv(p: Retriever, slots, features, pos):
    """The Retriever's normalized projections: q [B, L, D] of the slots,
    k (from the features plus ``pos``) and v [B, H, W, D]."""
    q = p.norm_q(p.to_q(slots))
    k_in = features if pos is None else features + pos.to(features.dtype)
    return q, p.norm_k(p.to_k(k_in)), p.norm_v(p.to_v(features))


def _core_work(q, k, v, *args, out):
    b, n_slots, d = q.shape
    return cost.slot_attention(b, n_slots, k.shape[1] * k.shape[2], d,
                               q.element_size())


@cost.entry("slot_attention", _core_work)
def _attention_core(q, k, v, softmax_dim):
    """softmax(q k^T) v with the softmax over slots (or pixels), in the
    activations' dtype."""
    b, h, w, d = k.shape
    attn = lowp.q(q) @ lowp.q(k.reshape(b, h * w, d)).transpose(1, 2)
    if softmax_dim == "slots":
        attn = torch.softmax(attn, dim=1)
    elif softmax_dim == "hw":
        attn = torch.softmax(attn, dim=-1)
    else:
        raise ValueError(softmax_dim)
    return lowp.q(attn) @ lowp.q(v.reshape(b, h * w, d))     # [B, L, D]


def retriever_attention(p: Retriever, slots, features, pos,
                        softmax_dim="slots"):
    """MaskDynamicConv (reference dynamic_mask_head.py:423-461).

    slots: [B, L, D]; features: [B, H, W, D]; pos: [H, W, D] or None.
    Softmax over the SLOT axis (inverted/slot attention), not pixels.
    """
    q, k, v = _retriever_qkv(p, slots, features, pos)
    return L.relu(p.norm1(_attention_core(q, k, v, softmax_dim)))


def slots_attention(p: Retriever, q_slots, kv_slots, softmax_dim="slots"):
    """SlotsDynamicConv (reference dynamic_mask_head.py:550-572)."""
    q = p.norm_q(p.to_q(q_slots))
    k = p.norm_k(p.to_k(kv_slots))
    v = p.norm_v(p.to_v(kv_slots))
    attn = lowp.q(q) @ lowp.q(k).transpose(1, 2)
    attn = torch.softmax(attn, dim=1 if softmax_dim == "slots" else 2)
    out = lowp.q(attn) @ lowp.q(v)
    return L.relu(p.norm1(out))


def _temporal_head(p: TemporalHead, slots, cfg: SlotHeadConfig):
    """Video Retriever (reference dynamic_mask_head.py:494-527).
    slots: [B, F*L, D] concatenated over frames."""
    t = cfg.temporal_query_attention
    act = L.ACTIVATIONS[t.activation]
    out = slots_attention(p.inst_interact, slots, slots, t.softmax_dim)
    slots = p.norm2(slots + out)
    ffn = L.ffn(p.linear1, p.linear2, act, slots)
    return p.norm3(slots + ffn)


def _stage_till_ffn(p: Stage, features, slots, pos, cfg: SlotHeadConfig,
                    retriever_fn):
    """Self-attn + Retriever + FFN (reference :342-388)."""
    act = L.ACTIVATIONS[cfg.activation]
    attn_out = p.self_attn(slots, slots, slots, cfg.nhead)
    slots = p.norm1(slots + attn_out)
    inter = retriever_fn(p.inst_interact, slots, features, pos,
                         cfg.softmax_dim)
    slots = p.norm2(slots + inter)
    ffn = L.ffn(p.linear1, p.linear2, act, slots)
    return p.norm3(slots + ffn)


def _stage_after_ffn(p: Stage, slots):
    """cls/reg towers (reference :390-400). Returns (logits, next_query)."""
    cls_f = slots
    for m in p.cls_module:
        cls_f = m(cls_f)
    reg_f = slots
    for m in p.reg_module:
        reg_f = m(reg_f)
    return p.class_logits(cls_f), reg_f


def apply_slot_head(
    model: SlotHead,
    cfg: SlotHeadConfig,
    features: Sequence[Sequence[torch.Tensor]],
    init_queries: torch.Tensor,
    pos: Sequence[Sequence[torch.Tensor]],
    retriever_fn=retriever_attention,
) -> Tuple[list, list, list]:
    """Run the 7-stage decoder over ``F`` frames jointly.

    features: per frame, per level [B, H, W, 128] (coarsest first).
    init_queries: [L, D] learned slot queries (shared across frames).
    pos: per frame, per level [H, W, D] sine embeddings.
    retriever_fn: the Retriever (:func:`retriever_attention` or
    :func:`retriever_attention_pallas`).

    Returns per frame: stacked class logits [S, B, L, C], stacked slot
    embeddings [S, B, L, D], and the per-level updated 256-ch features.
    """
    n_frames = len(features)
    n_levels = cfg.feat_num_levels
    bs = features[0][0].shape[0]
    dtype = features[0][0].dtype

    queries = [init_queries[None].expand(bs, *init_queries.shape).to(dtype)
               for _ in range(n_frames)]
    inter_logits: List[List[torch.Tensor]] = [[] for _ in range(n_frames)]
    inter_embeds: List[List[torch.Tensor]] = [[] for _ in range(n_frames)]

    cat_feats = [torch.cat([features[f][lvl] for f in range(n_frames)],
                           dim=0) for lvl in range(n_levels)]

    stage_idx = 0
    updated: List[torch.Tensor] = [None] * n_levels
    for lvl in range(n_levels):
        curr = cat_feats[lvl]
        if lvl > 0:
            up = upsample_int_bilinear(updated[lvl - 1], 2)
            if cfg.merge_operation == "concat":
                curr = torch.cat((up, curr), dim=-1)
            else:
                curr = curr + up
            curr = model.conv_trans(curr, padding=0)
        elif cfg.dh_dim != curr.shape[-1] \
                and cfg.trans_in_dim == curr.shape[-1] * 3:
            # level-0 special case (reference :182-185): tile channels x3
            curr = torch.cat((curr, curr, curr), dim=-1)
            curr = model.conv_trans(curr, padding=0)
        updated[lvl] = curr

        frame_feats = torch.chunk(curr, n_frames, dim=0)
        for _ in range(cfg.per_dh_num_heads[lvl]):
            sp = model.stages[stage_idx]
            slots_f = [
                _stage_till_ffn(sp, frame_feats[f], queries[f], pos[f][lvl],
                                cfg, retriever_fn)
                for f in range(n_frames)
            ]
            if sp.temporal is not None:
                cat_slots = torch.cat(slots_f, dim=1)  # [B, F*L, D]
                cat_slots = cat_slots + _temporal_head(sp.temporal,
                                                       cat_slots, cfg)
                slots_f = list(torch.chunk(cat_slots, n_frames, dim=1))
            for f in range(n_frames):
                logits, embed = _stage_after_ffn(sp, slots_f[f])
                inter_logits[f].append(logits)
                inter_embeds[f].append(embed)
                # queries detached between stages (reference :211)
                queries[f] = embed.detach()
            stage_idx += 1

    out_feats = [[torch.chunk(updated[lvl], n_frames, dim=0)[f]
                  for lvl in range(n_levels)] for f in range(n_frames)]
    return ([torch.stack(il) for il in inter_logits],
            [torch.stack(ie) for ie in inter_embeds],
            out_feats)
