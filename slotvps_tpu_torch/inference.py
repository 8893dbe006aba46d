"""Inference pipelines (counterpart of ``slotvps_tpu/inference.py``):
streaming (``InferencePipeline``, ``finish_frame``, ``run_video``),
lockstep batched over videos (``BatchedVideoPipeline``) and whole-clip
(``VideoScanner``).

Streaming, per frame: upload the uint8 frame, normalize on the device,
extract features, decode against the previous frame's carried features,
postprocess, then assign track ids on the host with the port's
:class:`slotvps_tpu_torch.tracking.TrackState`.  The batched pipeline runs
frame t of B videos through the backbone and decoder as one batch, then
postprocesses and tracks each video as the streaming path does.  The
scanner keeps a clip's per-frame outputs and its track pool
(``tracking_device.py``) on the device and reads them back once per clip.

``InferencePipeline`` leaves PyTorch's process-wide precision flags to its
caller; the two serving pipelines call
:func:`slotvps_tpu_torch.utils.precision.setup_precision` (f32 convolutions
and matmuls in full f32, bf16 products reduced in f32) when they are built.
"""

from __future__ import annotations

import contextlib
import copy
import warnings
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from slotvps_tpu_torch.config import Config
from slotvps_tpu_torch.tracking import TrackState
from slotvps_tpu_torch.tracking_device import init_pool, track_step
from slotvps_tpu_torch.utils.precision import setup_precision
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


class _Pipeline:
    """What every pipeline shares: the model and config, the target size
    ``image_size`` = (ori_h, ori_w), the un-padded ``valid_hw`` = (img_h,
    img_w) of uint8 uploads, and the per-frame device steps."""

    def __init__(self, model: Detector, config: Config,
                 image_size: Optional[tuple] = None,
                 valid_hw: Optional[tuple] = None):
        check_supported(config.model)
        self.model = model
        self.config = config
        self.image_size = image_size
        self.valid_hw = valid_hw
        self.device = next(model.parameters()).device
        self.stuff_num = config.model.stuff_num

    def _extract(self, img) -> FrameFeatures:
        """Features of a frame batch [B, H, W, 3] (numpy, or a tensor)."""
        x = torch.as_tensor(np.ascontiguousarray(img)
                            if isinstance(img, np.ndarray) else img)
        return extract_features(self.model, self.config.model,
                                _device_normalize(x.to(self.device),
                                                  self.config.data,
                                                  self.valid_hw))

    def _decode(self, ref_feats, cur_feats) -> list:
        """decode_pair of the frame batch, as a list of decoder outputs
        whose batch entries follow each other (one here)."""
        return [decode_pair(self.model, self.config.model, ref_feats,
                            cur_feats)]

    def _post(self, decoded) -> List[PostprocResult]:
        """Each batch entry's postprocess, in order."""
        pcfg = self.config.model.postprocess
        posts = []
        for outs in decoded:
            out_size = self.image_size or (4 * outs.pred_masks.shape[2],
                                           4 * outs.pred_masks.shape[3])
            posts += [_compact_post(postprocess_frame(
                outs.pred_logits[i], outs.pred_masks[i], outs.embeddings[i],
                outs.fcn_output[i], tuple(out_size), pcfg))
                for i in range(outs.pred_logits.shape[0])]
        return posts

    def _decode_post(self, ref_feats, cur_feats) -> List[PostprocResult]:
        """decode_pair, then each batch entry's postprocess."""
        return self._post(self._decode(ref_feats, cur_feats))

    def _match(self, cur_emb: np.ndarray, prev_emb: np.ndarray):
        """The track head on host embeddings (for finish_frame)."""
        return self.model.track_head(
            torch.from_numpy(cur_emb).to(self.device),
            torch.from_numpy(prev_emb).to(self.device)).cpu().numpy()


class InferencePipeline(_Pipeline):
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
        super().__init__(model, config, image_size, valid_hw)
        self._track = TrackState()
        self._prev_feats: Optional[FrameFeatures] = None

    def reset_video(self):
        self._track.reset()
        self._prev_feats = None

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
        post = self._decode_post(ref_feats, cur_feats)[0]
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


class _Replica(_Pipeline):
    """One model copy of a :class:`BatchedVideoPipeline` and the device
    state of its videos: on the card its own stream and two pinned upload
    buffers.

    ``extract_features`` takes the replica's frames one frame at a time
    (:meth:`_extract`); ``decode_pair`` takes them as one batch in bf16 and
    one frame at a time in f32 (:meth:`_decode`).  Uploads go through a
    pinned host buffer with an asynchronous copy; the two buffers
    alternate, and a buffer is refilled only after the event recorded
    behind its last copy has completed."""

    def __init__(self, model: Detector, config: Config,
                 image_size: Optional[tuple], valid_hw: Optional[tuple]):
        super().__init__(model, config, image_size, valid_hw)
        self.stream = None
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
        self._pinned: List[Optional[torch.Tensor]] = [None, None]
        self._copied: List[Optional[torch.cuda.Event]] = [None, None]
        self._uploads = 0

    def on_stream(self):
        """The context in which the replica's work is issued: its stream
        (and card), after all work issued so far on the card's current
        stream (the weights' copies, the caller's)."""
        if self.stream is None:
            return contextlib.nullcontext()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        return torch.cuda.stream(self.stream)

    def _extract(self, img) -> FrameFeatures:
        """Features of frame t of the replica's videos [b, H, W, 3], taken
        one frame at a time and concatenated: at batch b the backbone's
        cuDNN convolutions pick other algorithms than at batch 1 and give a
        frame other floats (in bf16 on most elements), which the calibrated
        decode turns into other kept slots; at batch 1 each frame gets the
        streaming path's features."""
        extract = super()._extract
        feats = [extract(img[i:i + 1]) for i in range(img.shape[0])]
        return FrameFeatures(
            tuple(torch.cat(level)
                  for level in zip(*(f.feat_trans for f in feats))),
            torch.cat([f.fcn_output for f in feats]))

    def _decode(self, ref_feats, cur_feats) -> list:
        """In bf16 the decoder gives each frame at batch b the floats of
        batch 1 and runs as one batch; in f32 it does not (cuBLAS picks
        other f32 GEMM kernels when the slot projections' rows grow from K
        to b*K, and the decoder's outputs move in their last bits), so it
        takes one frame at a time."""
        if self.config.model.compute_dtype != "float32":
            return super()._decode(ref_feats, cur_feats)

        def frame(f, i):
            return FrameFeatures(tuple(level[i:i + 1]
                                       for level in f.feat_trans),
                                 f.fcn_output[i:i + 1])

        decode = super()._decode
        return [outs for i in range(cur_feats.fcn_output.shape[0])
                for outs in decode(frame(ref_feats, i), frame(cur_feats, i))]

    def _upload(self, frames: Sequence[np.ndarray]) -> torch.Tensor:
        """Frame t of the replica's videos, [b, H, W, 3], on its device.
        On the card through a pinned buffer with an asynchronous copy on
        the current stream (the replica's, under :meth:`on_stream`)."""
        host = torch.from_numpy(np.concatenate(frames, axis=0))
        if self.device.type != "cuda":
            return host.to(self.device)
        j = self._uploads % 2
        self._uploads += 1
        if self._copied[j] is not None:
            # the copy out of this buffer two uploads ago may still run
            self._copied[j].synchronize()
        buf = self._pinned[j]
        if buf is None or buf.shape != host.shape or buf.dtype != host.dtype:
            buf = self._pinned[j] = torch.empty_like(host, pin_memory=True)
        buf.copy_(host)
        dev = buf.to(self.device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._copied[j] = event
        return dev


class BatchedVideoPipeline(_Pipeline):
    """Lockstep batched multi-video inference over one or more devices (the
    JAX package's ``BatchedVideoPipeline``, the configuration its bench
    measures).

    The video axis is split over ``n_devices`` replicas of the model: the
    largest divisor of ``batch`` that is at most ``len(devices)`` (default:
    the model's device), as the JAX package shards it over a mesh.  Replica
    r holds a copy of the model on ``devices[r]`` (the model itself on its
    own device; a list may name a device twice) and videos ``[r * b, (r +
    1) * b)``, ``b = batch / n_devices``, with its own uploads and, on the
    card, its own stream (:class:`_Replica`).  Each step issues every
    replica's backbone and decoder, then each replica's postprocess, then
    the next frames' uploads, and only then reads back and tracks the step
    before, so the cards overlap.  The postprocess runs per video, and each
    video keeps its own :class:`TrackState` and goes through
    :func:`finish_frame`, so each video's results are those of the
    streaming :class:`InferencePipeline` on that video, bit for bit.

    Videos share a length and a frame shape.  Builds call
    :func:`setup_precision`."""

    def __init__(self, model: Detector, config: Config, batch: int,
                 image_size: Optional[tuple] = None,
                 devices: Optional[Sequence] = None,
                 valid_hw: Optional[tuple] = None):
        super().__init__(model, config, image_size, valid_hw)
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        devices = [self.device] if devices is None else [
            torch.device(d) for d in devices]
        if not devices:
            raise ValueError("devices must name at least one device")
        setup_precision()
        self.batch = batch
        self.n_devices = max(d for d in range(1, len(devices) + 1)
                             if batch % d == 0)
        copies = {self.device: model}
        self.replicas = []
        for dev in devices[:self.n_devices]:
            if dev not in copies:
                copies[dev] = copy.deepcopy(model).to(dev)
            self.replicas.append(_Replica(copies[dev], config, image_size,
                                          valid_hw))

    @torch.inference_mode()
    def run_videos(self, videos: Sequence[Sequence[np.ndarray]]
                   ) -> List[List[FrameResult]]:
        """videos: ``batch`` clips, each a list of [1, H, W, 3] frames
        (uint8 BGR or normalized float) of one length.  Returns one
        FrameResult list per video."""
        if len(videos) != self.batch:
            raise ValueError(f"{len(videos)} videos for a batch of "
                             f"{self.batch}")
        t_len = len(videos[0])
        if t_len == 0 or any(len(v) != t_len for v in videos):
            raise ValueError("the videos of a batch must share a length "
                             "of at least one frame")
        lb = self.batch // self.n_devices
        reps = self.replicas
        tracks = [TrackState() for _ in range(self.batch)]
        results: List[List[FrameResult]] = [[] for _ in range(self.batch)]

        def upload(t):
            imgs = []
            for r, rep in enumerate(reps):
                with rep.on_stream():
                    imgs.append(rep._upload(
                        [v[t] for v in videos[r * lb:(r + 1) * lb]]))
            return imgs

        def drain(posts):
            is_first = len(results[0]) == 0
            for r, rep in enumerate(reps):
                with rep.on_stream():
                    for i, post in enumerate(posts[r]):
                        v = r * lb + i
                        results[v].append(finish_frame(
                            post, is_first, tracks[v], self._match,
                            self.stuff_num))

        refs, pending = [None] * len(reps), None
        imgs = upload(0)
        for t in range(t_len):
            curs, decoded = [], []
            for rep, img, ref in zip(reps, imgs, refs):
                with rep.on_stream():
                    cur = rep._extract(img)
                    decoded.append(rep._decode(cur if t == 0 else ref, cur))
                curs.append(cur)
            posts = []
            for rep, dec in zip(reps, decoded):
                with rep.on_stream():
                    posts.append(rep._post(dec))
            if t + 1 < t_len:
                imgs = upload(t + 1)
            refs = curs
            if pending is not None:
                drain(pending)
            pending = posts
        drain(pending)
        return results


def _warn_pool_saturation(ids: np.ndarray, pool_capacity: int) -> None:
    """Track ids >= capacity were assigned but their embeddings dropped
    (``tracking_device.update_pool``): later frames can never re-match
    those tracks, unlike the unbounded host loop — say so."""
    if ids.size and int(ids.max()) >= pool_capacity:
        warnings.warn(
            f"VideoScanner track pool saturated: max id {int(ids.max())} "
            f">= pool_capacity {pool_capacity}; tracks past capacity "
            "cannot be re-matched (raise pool_capacity or use the "
            "streaming InferencePipeline)", RuntimeWarning)


class VideoScanner(_Pipeline):
    """Whole-clip inference (the JAX package's ``VideoScanner``, there one
    jitted ``lax.scan``): a Python loop over the clip's frames that carries
    the reference features and the track pool from frame to frame, runs
    the track head and :func:`tracking_device.track_step` on the device,
    and keeps each frame's outputs on the device until one readback at the
    end of the clip.

    The tracking adds no host sync; the postprocess keeps its own (the
    reference path: one per small-area check, the valid-thing count of the
    claim loop, the kept counts; the fused path: see
    ``models/postprocess.py``), so a frame still waits on the device a few
    times.  The pool holds ``pool_capacity`` tracks (default 256); ids past
    it are assigned but cannot be re-matched, with a warning.  Builds call
    :func:`setup_precision`."""

    def __init__(self, model: Detector, config: Config,
                 image_size: Optional[tuple] = None,
                 pool_capacity: int = 256,
                 valid_hw: Optional[tuple] = None):
        super().__init__(model, config, image_size, valid_hw)
        setup_precision()
        self.pool_capacity = pool_capacity

    @torch.inference_mode()
    def run_video(self, frames: Sequence[np.ndarray]) -> List[FrameResult]:
        """frames: one video, a list of [1, H, W, 3] frames (uint8 BGR or
        normalized float)."""
        pool = init_pool(self.pool_capacity, self.model.init_mask_query
                         .shape[-1], device=self.device)
        outs, prev = [], None
        for img in frames:
            cur = self._extract(img)
            post = self._decode_post(prev or cur, cur)[0]
            match = self.model.track_head(post.embeddings, pool.embeddings)
            ids, pool = track_step(pool, match, post.embeddings, post.kept)
            outs.append((post.kept, post.is_thing, post.labels, post.scores,
                         post.panoptic, post.sseg, ids,
                         (post.n_loop, post.capacity, post.n_claim)))
            prev = cur
        kept, is_thing, labels, scores, panoptic, sseg, ids = [
            torch.stack([o[i] for o in outs]).cpu().numpy()
            for i in range(7)]
        _warn_pool_saturation(ids, self.pool_capacity)
        results = []
        for t, o in enumerate(outs):
            idx = np.nonzero(kept[t] & is_thing[t])[0]
            n_loop, capacity, n_claim = o[7]
            results.append(FrameResult(
                sseg=sseg[t].astype(np.uint8),
                panoptic=panoptic[t].astype(np.uint8),
                cls_inds=(labels[t][idx]
                          - (self.stuff_num - 1)).astype(np.int64),
                cls_prob=scores[t][idx].astype(np.float32),
                obj_ids=ids[t][idx].astype(np.int64),
                n_loop=n_loop, capacity=capacity, n_claim=n_claim))
        return results
