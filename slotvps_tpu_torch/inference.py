"""Streaming per-frame inference (counterpart of ``slotvps_tpu/inference.py``
``InferencePipeline``, ``finish_frame`` and ``run_video``).

Per frame: upload the uint8 frame, normalize on the device, extract
features, decode against the previous frame's carried features,
postprocess, then assign track ids on the host with the port's
:class:`slotvps_tpu_torch.tracking.TrackState`.  The batched and whole-clip
pipelines of the JAX package are not ported yet.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from slotvps_tpu_torch.config import Config
from slotvps_tpu_torch.tracking import TrackState
from slotvps_tpu_torch.models.detector import (Detector, FrameFeatures,
                                               check_supported, decode_pair,
                                               extract_features)
from slotvps_tpu_torch.models.postprocess import (PostprocResult,
                                                  postprocess_frame)


def _device_normalize(img: torch.Tensor, dcfg,
                      valid_hw=None) -> torch.Tensor:
    """Test-time normalization of uint8 BGR frames on the device:
    BGR->RGB, ``(x - mean) / std``, and zeros in the /32 padding outside
    ``valid_hw`` (the reference pads after normalizing).  Float inputs pass
    through untouched."""
    if img.dtype != torch.uint8:
        return img
    x = img.flip(-1) if dcfg.to_rgb else img
    x = x.float()
    mean = torch.tensor(dcfg.mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(dcfg.std, dtype=torch.float32, device=x.device)
    x = (x - mean) / std
    if valid_hw is not None and tuple(valid_hw) != tuple(x.shape[1:3]):
        h, w = valid_hw
        rows = torch.arange(x.shape[1], device=x.device) < h
        cols = torch.arange(x.shape[2], device=x.device) < w
        x = torch.where((rows[:, None] & cols[None, :])[None, :, :, None],
                        x, 0.0)
    return x


def _compact_post(post: PostprocResult) -> PostprocResult:
    """Panoptic / semantic maps are uint8-valued by construction (stuff
    0..10, things 11+rank with rank < 127, void 255): cast on the device so
    the device->host copy moves a quarter of the bytes."""
    return post._replace(panoptic=post.panoptic.to(torch.uint8),
                         sseg=post.sseg.to(torch.uint8))


class FrameResult(NamedTuple):
    """Host-side per-frame result, reference ``pano_results`` dict, plus
    the postprocess's regime diagnostics."""

    sseg: np.ndarray        # [H, W] uint8 semantic argmax
    panoptic: np.ndarray    # [H, W] uint8 fused map
    cls_inds: np.ndarray    # [n_things] 1-based thing class
    cls_prob: np.ndarray    # [n_things] scores
    obj_ids: np.ndarray     # [n_things] track ids
    n_loop: int = 0         # small-area-filter iterations
    capacity: int = 0       # slots the postprocess passes ran on
    n_claim: int = 0        # valid thing slots the claim loop visited


class InferencePipeline:
    """Streaming per-frame inference with carried video state.

    The pipeline leaves PyTorch's process-wide precision flags alone: on
    the card, call :func:`slotvps_tpu_torch.utils.precision.setup_precision`
    first (the CLI and ``chip_smoke.py`` do) so that f32 convolutions and
    bf16 matmuls reduce in full f32, as the JAX package does."""

    def __init__(self, model: Detector, config: Config,
                 image_size: Optional[tuple] = None,
                 valid_hw: Optional[tuple] = None):
        """``image_size`` = (ori_h, ori_w) target output size;
        ``valid_hw`` = un-padded (img_h, img_w) of uint8 uploads."""
        check_supported(config.model)
        self.model = model
        self.config = config
        self.image_size = image_size
        self.valid_hw = valid_hw
        self.device = next(model.parameters()).device
        self._track = TrackState()
        self._prev_feats: Optional[FrameFeatures] = None
        self.stuff_num = config.model.stuff_num

    def reset_video(self):
        self._track.reset()
        self._prev_feats = None

    def _extract(self, img: np.ndarray) -> FrameFeatures:
        x = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        return extract_features(self.model, self.config.model,
                                _device_normalize(x, self.config.data,
                                                  self.valid_hw))

    def _decode_post(self, ref_feats, cur_feats) -> PostprocResult:
        cfg = self.config.model
        outs = decode_pair(self.model, cfg, ref_feats, cur_feats)
        out_size = self.image_size or (4 * outs.pred_masks.shape[2],
                                       4 * outs.pred_masks.shape[3])
        return _compact_post(postprocess_frame(
            outs.pred_logits[0], outs.pred_masks[0], outs.embeddings[0],
            outs.fcn_output[0], tuple(out_size), cfg.postprocess))

    def _match(self, cur_emb: np.ndarray, prev_emb: np.ndarray):
        return self.model.track_head(
            torch.from_numpy(cur_emb).to(self.device),
            torch.from_numpy(prev_emb).to(self.device)).cpu().numpy()

    @torch.inference_mode()
    def process_frame(self, img: np.ndarray, is_first: bool,
                      ref_img: Optional[np.ndarray] = None) -> FrameResult:
        """img: [1, H, W, 3], uint8 BGR or normalized float.  ``is_first``
        starts a new video; ``ref_img`` forces explicit reference-frame
        pixels, otherwise the previous frame's features are reused."""
        if is_first:
            self.reset_video()
        cur_feats = self._extract(img)
        if self._prev_feats is not None:
            ref_feats = self._prev_feats
        elif ref_img is not None:
            ref_feats = self._extract(ref_img)
        else:
            ref_feats = cur_feats
        post = self._decode_post(ref_feats, cur_feats)
        self._prev_feats = cur_feats
        return finish_frame(post, is_first, self._track, self._match,
                            self.stuff_num)


def finish_frame(post: PostprocResult, is_first: bool, track: TrackState,
                 match_fn, stuff_num: int) -> FrameResult:
    """Host-side per-frame assembly: variable-length lists + greedy id
    assignment against ``track``'s pool (reference
    vps_temporal_slots.py:332-409, :459-465).

    ``match_fn(cur_emb, prev_emb)`` runs the track head on numpy inputs."""
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
    # export thing ids only (reference :338-339, :408-409)
    thing_pos_in_kept = np.searchsorted(kept_idx, thing_idx)
    obj_ids = all_ids[thing_pos_in_kept] if len(all_ids) else \
        np.zeros((0,), np.int64)

    return FrameResult(
        sseg=post.sseg.cpu().numpy().astype(np.uint8),
        panoptic=post.panoptic.cpu().numpy().astype(np.uint8),
        cls_inds=cls_inds.astype(np.int64),
        cls_prob=cls_prob.astype(np.float32),
        obj_ids=obj_ids.astype(np.int64),
        n_loop=post.n_loop, capacity=post.capacity, n_claim=post.n_claim,
    )


def run_video(pipeline: InferencePipeline,
              frames: Sequence[np.ndarray]) -> List[FrameResult]:
    """Run one video clip (list of [1, H, W, 3] frames)."""
    return [pipeline.process_frame(img, is_first=(t == 0))
            for t, img in enumerate(frames)]
