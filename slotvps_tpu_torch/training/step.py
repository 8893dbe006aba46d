"""Training step: two-frame forward, the PQ / mask-id / semantic / match /
instance-discrimination losses, AdamW (counterpart of
``slotvps_tpu/training/step.py``).

The reference's optimizer settings (r50_fpn_slotvps.py:198-199): AdamW,
lr 1e-4, weight decay 1e-4, betas (0.9, 0.999), eps 1e-8, the gradient
clipped by its global norm at 1.0 as ``optax.clip_by_global_norm`` does it.
The frozen BatchNorm statistics are buffers: no gradient, no update (the
JAX package masks them out of its optimizer); their weight and bias train.

The step updates the model in place (the JAX step returns new parameters)
and returns its metrics as device tensors, so it makes no host sync beyond
the matching's one round trip (``training/losses.hungarian``).  Training is
ported for ``compute_dtype="float32"``, with either backbone and any
``dcn_impl``: "pallas" computes the DCN in bf16 through the backward
kernel, as the JAX package trains.

Data parallel: given a process group, ``train_step`` is one step on the
batch that the group's ranks hold together, as the JAX package's mesh step
is one step on the global batch.  Each rank's gradients are averaged over
the group after ``backward`` (:func:`average_gradients`), so every rank
takes the same update.  Every loss term but the semantic one is a mean of
per-sample terms, which a mean of the ranks' means reproduces when the
ranks hold equal batches; the semantic loss divides by the valid pixels of
the whole batch, so ``loss_fn`` all-reduces that count and scales the
rank's share by it.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple, \
    Union

import torch
import torch.distributed as dist

from slotvps_tpu_torch.config import ModelConfig
from slotvps_tpu_torch.models.detector import (Detector, FrameFeatures,
                                               decode_pair_train)
from slotvps_tpu_torch.models.semantic_head import semantic_loss
from slotvps_tpu_torch.training.losses import (dice_similarity, hungarian,
                                               insdis_loss, match_cost,
                                               match_loss, pq_loss)


class TrainBatch(NamedTuple):
    """Fixed-capacity training batch (pads to G GT slots).

    ``gt_pids`` are the track-id targets: 0 = new object, j = 1-based index
    into the reference frame's GT list (reference
    cityscapes_vps.py:246-248)."""

    img: torch.Tensor         # [B, H, W, 3]
    ref_img: torch.Tensor     # [B, H, W, 3]
    gt_labels: torch.Tensor   # [B, G] int32
    gt_masks: torch.Tensor    # [B, G, H/4, W/4] {0,1}
    gt_valid: torch.Tensor    # [B, G] bool
    gt_semantic: torch.Tensor  # [B, H/4, W/4] int32 (255 = ignore)
    ref_gt_labels: torch.Tensor  # [B, G] int32
    ref_gt_masks: torch.Tensor   # [B, G, H/4, W/4] {0,1}
    ref_gt_valid: torch.Tensor   # [B, G] bool
    gt_pids: torch.Tensor        # [B, G] int32

    def to(self, device) -> "TrainBatch":
        return TrainBatch(*(torch.as_tensor(a).to(device) for a in self))


def make_train_batch(img, ref_img, gt_labels, gt_masks, gt_valid,
                     gt_semantic, ref_gt_labels=None, ref_gt_masks=None,
                     ref_gt_valid=None, gt_pids=None) -> TrainBatch:
    """TrainBatch of tensors from arrays or tensors; reference-frame GT
    defaults to mirroring the current frame with identity pids."""
    if ref_gt_labels is None:
        ref_gt_labels, ref_gt_masks, ref_gt_valid = (gt_labels, gt_masks,
                                                     gt_valid)
    gt_valid = torch.as_tensor(gt_valid)
    if gt_pids is None:
        g = gt_valid.shape[-1]
        gt_pids = torch.where(gt_valid, torch.arange(1, g + 1,
                                                     dtype=torch.int32), 0)
    return TrainBatch(*(torch.as_tensor(a) for a in (
        img, ref_img, gt_labels, gt_masks, gt_valid, gt_semantic,
        ref_gt_labels, ref_gt_masks, ref_gt_valid, gt_pids)))


def _clip_by_global_norm(grads, max_norm: float):
    """In place, as optax: every g scaled by max_norm / ||g|| where the
    global norm ||g|| (all tensors) is >= max_norm; no epsilon.  A few
    multi-tensor launches, no host sync."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.where(norm < max_norm, 1.0,
                                           max_norm / norm))
    return norm


class AdamW:
    """``optax.chain(clip_by_global_norm(clip_norm), adamw(lr, b1, b2, eps,
    weight_decay))`` over the model's parameters (buffers are not
    parameters: the frozen BN statistics are never touched).

    ``lr`` is a float or a schedule ``count -> lr``; update n (from 0) uses
    ``lr(n)``, as optax counts.  A parameter that got no gradient is updated
    with a zero one (weight decay and the moments' decay apply), as every
    leaf is in the JAX tree."""

    def __init__(self, params, lr: Union[float, Callable] = 1e-4,
                 weight_decay: float = 1e-4, clip_norm: float = 1.0,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = lr if callable(lr) else (lambda count: lr)
        self.clip_norm = clip_norm
        self.count = 0
        self._opt = torch.optim.AdamW(self.params, lr=float(self.schedule(0)),
                                      betas=betas, eps=eps,
                                      weight_decay=weight_decay)

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def step(self):
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        _clip_by_global_norm([p.grad for p in self.params], self.clip_norm)
        for group in self._opt.param_groups:
            group["lr"] = float(self.schedule(self.count))
        self._opt.step()
        self.count += 1

    def state_dict(self) -> Dict:
        return {"count": self.count, "adamw": self._opt.state_dict()}

    def load_state_dict(self, state: Dict):
        self.count = int(state["count"])
        self._opt.load_state_dict(state["adamw"])


def make_optimizer(model: torch.nn.Module, lr=1e-4,
                   weight_decay: float = 1e-4,
                   clip_norm: float = 1.0) -> AdamW:
    """AdamW with the reference's settings over ``model``'s parameters."""
    return AdamW(model.parameters(), lr=lr, weight_decay=weight_decay,
                 clip_norm=clip_norm)


def check_trainable(cfg: ModelConfig):
    """Raise NotImplementedError for bf16 compute: the port trains in f32,
    as every JAX entry point does."""
    if cfg.compute_dtype != "float32":
        raise NotImplementedError("training is ported for compute_dtype="
                                  f"'float32', not {cfg.compute_dtype!r}")


def loss_fn(model: Detector, cfg: ModelConfig, batch: TrainBatch,
            loss_pano_weight: float = 0.5, fixed_match: bool = False,
            group: Optional[dist.ProcessGroup] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """(total loss, metrics): the JAX ``loss_fn``, term for term and in its
    order.  Without ``fixed_match`` every matching of the step (current
    frame, reference frame, each auxiliary stage; each sample) is solved in
    one host round trip.  With a process ``group``, ``batch`` is this
    rank's part of the group's batch, and the semantic term is this rank's
    share of the whole batch's (see the module's docstring)."""
    check_trainable(cfg)
    # forward both frames jointly (same path as inference)
    both = torch.cat([batch.ref_img, batch.img], dim=0)
    feats = model.backbone(both)
    fpn_outs = model.fpn(feats, num_outs=cfg.fpn.num_outs)
    _, fcn_score, feat_before = model.semantic_head(
        fpn_outs[:cfg.semantic_head.num_levels], cfg.semantic_head)
    feat_trans = tuple(model.conv_trans(f, padding=0) for f in feat_before)
    b = batch.img.shape[0]
    ref_feats = FrameFeatures(feat_trans=tuple(f[:b] for f in feat_trans),
                              fcn_output=fcn_score[:b].float())
    cur_feats = FrameFeatures(feat_trans=tuple(f[b:] for f in feat_trans),
                              fcn_output=fcn_score[b:].float())
    outs, aux, extras = decode_pair_train(model, cfg, ref_feats, cur_feats)
    ref_outs = extras["ref"]

    cur_gt = (batch.gt_labels, batch.gt_masks, batch.gt_valid)
    ref_gt = (batch.ref_gt_labels, batch.ref_gt_masks, batch.ref_gt_valid)
    # (logits, masks, GT) of every supervised output: the current frame,
    # the reference frame, the auxiliary stages
    groups = [(outs.pred_logits, outs.pred_masks, cur_gt),
              (ref_outs.pred_logits, ref_outs.pred_masks, ref_gt)]
    groups += [(a_logits, a_masks, cur_gt) for a_logits, a_masks in aux]
    g = batch.gt_labels.shape[-1]
    if fixed_match:
        slot_idx = [[torch.arange(g, device=batch.img.device)] * b
                    for _ in groups]
    else:
        costs = [match_cost(torch.softmax(lg[i], dim=-1),
                            dice_similarity(mk[i], gt[1][i]), gt[0][i],
                            gt[2][i])
                 for lg, mk, gt in groups for i in range(b)]
        flat = hungarian(costs)
        slot_idx = [flat[k * b:(k + 1) * b] for k in range(len(groups))]

    def frame_losses(k):
        lg, mk, (labels, masks, valid) = groups[k]
        per = [pq_loss(lg[i], mk[i], labels[i], masks[i], valid[i],
                       slot_idx=slot_idx[k][i]) for i in range(b)]
        return {key: torch.stack([p[key] for p in per]).mean()
                for key in per[0]}

    metrics = frame_losses(0)
    # reference-frame supervision (both frames carry GT in the reference's
    # train pipeline)
    metrics["loss_ref"] = sum(frame_losses(1).values())
    # deep supervision over the intermediate decoder stages
    if aux:
        metrics["loss_aux"] = sum(sum(frame_losses(k).values())
                                  for k in range(2, len(groups))) / len(aux)
    metrics["loss_match"] = torch.stack([
        match_loss(model.track_head, outs.embeddings[i],
                   ref_outs.embeddings[i], slot_idx[0][i], slot_idx[1][i],
                   batch.gt_pids[i], batch.gt_valid[i],
                   batch.ref_gt_valid[i]) for i in range(b)]).mean()
    metrics["loss_insdis"] = torch.stack([
        insdis_loss(extras["fine_feat"][i], batch.gt_masks[i],
                    batch.gt_valid[i]) for i in range(b)]).mean()
    sem_count = None
    if group is not None:
        count = (batch.gt_semantic != cfg.semantic_head.ignore_label).sum()
        dist.all_reduce(count, group=group)
        sem_count = count.clamp_min(1) / dist.get_world_size(group)
    metrics["loss_sem"] = loss_pano_weight * semantic_loss(
        fcn_score[b:], batch.gt_semantic, cfg.semantic_head, sem_count)
    total = sum(metrics.values())
    metrics["loss_total"] = total
    return total, metrics


# gradient bucket of the data-parallel step (DistributedDataParallel's
# default bucket_cap_mb)
BUCKET_BYTES = 25 * 2 ** 20


def average_gradients(params: Sequence[torch.Tensor],
                      group: dist.ProcessGroup):
    """Replace each parameter's gradient (zeros where it got none) by its
    mean over ``group``'s ranks: the gradients, in parameter order (the
    same on every rank), flattened into buckets of at most BUCKET_BYTES
    of one dtype, one ``all_reduce`` a bucket."""
    world = dist.get_world_size(group)
    buckets, size = [], 0
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        g = p.grad
        n = g.numel() * g.element_size()
        if (not buckets or size + n > BUCKET_BYTES
                or g.dtype != buckets[-1][0].dtype):
            buckets.append([])
            size = 0
        buckets[-1].append(g)
        size += n
    for bucket in buckets:
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=group)
        flat /= world
        for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
            g.copy_(part.view_as(g))


def _mean_over_ranks(metrics: Dict, group: dist.ProcessGroup) -> Dict:
    """The metrics averaged over the group (one all_reduce): the global
    step's loss terms."""
    flat = torch.stack([v.detach().float() for v in metrics.values()])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    return dict(zip(metrics, flat.unbind()))


def train_step(model: Detector, optimizer: AdamW, batch: TrainBatch,
               cfg: ModelConfig, fixed_match: bool = False,
               group: Optional[dist.ProcessGroup] = None) -> Dict:
    """One AdamW step on ``batch``, in place; returns the metrics (device
    tensors, detached).  With a process ``group`` it is the data-parallel
    step: ``batch`` is this rank's part, the gradients and the metrics are
    averaged over the group before the update."""
    optimizer.zero_grad()
    total, metrics = loss_fn(model, cfg, batch, fixed_match=fixed_match,
                             group=group)
    total.backward()
    if group is not None:
        average_gradients([p for p in model.parameters()
                           if p.requires_grad], group)
        metrics = _mean_over_ranks(metrics, group)
    optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}
