"""The streaming frame step of the plain reference: normalize, extract
the frame's features, decode against the previous frame's, the reference
postprocess, then the host's greedy track ids.

Frozen copy of ``slotvps_tpu_torch/inference.py`` (``InferencePipeline``
and ``finish_frame``) at commit 86b90feb98325982c750f329cf213fa73d0ed5b3,
on the reference's modules.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from vpsbench.reference.detector import decode_pair, extract_features
from vpsbench.reference.postprocess import postprocess_frame
from vpsbench.reference.tracking import TrackState


class FrameResult(NamedTuple):
    """The port's ``FrameResult`` fields that the comparison reads."""

    sseg: np.ndarray        # [H, W] uint8 semantic argmax
    panoptic: np.ndarray    # [H, W] uint8: stuff class, 11 + thing rank, 255
    cls_inds: np.ndarray    # [n_things] 1-based thing class
    cls_prob: np.ndarray    # [n_things] scores
    obj_ids: np.ndarray     # [n_things] track ids


def normalize(frames: torch.Tensor, dcfg) -> torch.Tensor:
    """uint8 BGR [B, H, W, 3] -> normalized f32 RGB (the test pipeline's
    mean and std; the clips need no /32 padding)."""
    x = frames.flip(-1) if dcfg.to_rgb else frames
    x = x.float()
    mean = torch.tensor(dcfg.mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(dcfg.std, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def finish_frame(post, is_first: bool, track: TrackState, match_fn,
                 stuff_num: int) -> FrameResult:
    """Variable-length lists and greedy id assignment against ``track``'s
    pool (reference vps_temporal_slots.py:332-409, :459-465)."""
    kept = post.kept.cpu().numpy()
    is_thing = post.is_thing.cpu().numpy()
    labels = post.labels.cpu().numpy()
    scores = post.scores.cpu().numpy()
    embeds = post.embeddings.cpu().numpy()

    kept_idx = np.nonzero(kept)[0]
    thing_idx = np.nonzero(kept & is_thing)[0]
    cls_inds = labels[thing_idx] - (stuff_num - 1)
    cls_prob = scores[thing_idx]

    cur_emb = embeds[kept_idx]
    if is_first or track.embeddings is None:
        all_ids = track.start(cur_emb)
    elif len(kept_idx) == 0:
        all_ids = np.zeros((0,), np.int64)
    else:
        all_ids = track.update(np.asarray(match_fn(cur_emb,
                                                   track.embeddings)),
                               cur_emb)
    thing_pos_in_kept = np.searchsorted(kept_idx, thing_idx)
    obj_ids = all_ids[thing_pos_in_kept] if len(all_ids) else \
        np.zeros((0,), np.int64)
    return FrameResult(
        sseg=post.sseg.cpu().numpy().astype(np.uint8),
        panoptic=post.panoptic.cpu().numpy().astype(np.uint8),
        cls_inds=cls_inds.astype(np.int64),
        cls_prob=cls_prob.astype(np.float32),
        obj_ids=obj_ids.astype(np.int64))


class Record(NamedTuple):
    """One frame as the reference computed it, in the fields that the
    program's recorded frames have (``vpsbench/capture.py``)."""

    ref_feats: object
    cur_feats: object
    outputs: object
    post: object
    is_first: bool
    result: FrameResult


@torch.inference_mode()
def run_video(model, cfg, frames: torch.Tensor, records: bool = False
              ) -> List:
    """One video, uint8 [T, H, W, 3] on the model's device, frame by frame
    with carried features and tracks: its FrameResults, or with
    ``records`` one :class:`Record` a frame."""
    track = TrackState()
    size = tuple(frames.shape[1:3])
    dev = frames.device

    def match(cur, prev):
        return model.track_head(torch.from_numpy(cur).to(dev),
                                torch.from_numpy(prev).to(dev)).cpu().numpy()

    out, prev = [], None
    for t in range(frames.shape[0]):
        cur = extract_features(model, cfg.model,
                               normalize(frames[t:t + 1], cfg.data))
        ref = prev or cur
        outs = decode_pair(model, cfg.model, ref, cur)
        post = postprocess_frame(outs.pred_logits[0], outs.pred_masks[0],
                                 outs.embeddings[0], outs.fcn_output[0],
                                 size, cfg.model.postprocess)
        res = finish_frame(post, t == 0, track, match, cfg.model.stuff_num)
        out.append(Record(ref, cur, outs, post, t == 0, res) if records
                   else res)
        prev = cur
    return out
