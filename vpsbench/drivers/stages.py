"""The stage pass of a traced run: the frame step cut at the port's
public stage functions, a synchronize around each stage, the median over
the frames after the first (``chip_smoke.py``'s ``phase_stages``)."""

from __future__ import annotations

import statistics
import time
from typing import Dict, List, Sequence

import numpy as np
import torch


def sync(device) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, (time.perf_counter() - t0) * 1e3


@torch.inference_mode()
def stage_ms(model, cfg, videos: Sequence[Sequence[np.ndarray]],
             n_frames: int) -> Dict[str, float]:
    """ms a frame of each stage over ``n_frames`` lockstep steps of
    ``videos`` (B = len(videos)): extract (per frame, as the pipelines
    run the backbone), decode (one batch), postprocess and finish (per
    video)."""
    from slotvps_tpu_torch.inference import (_compact_post,
                                             _device_normalize,
                                             finish_frame)
    from slotvps_tpu_torch.models.detector import (FrameFeatures,
                                                   decode_pair,
                                                   extract_features)
    from slotvps_tpu_torch.models.postprocess import postprocess_frame
    from slotvps_tpu_torch.tracking import TrackState

    dev = next(model.parameters()).device
    m = cfg.model
    b = len(videos)
    size = tuple(videos[0][0].shape[1:3])
    tracks = [TrackState() for _ in range(b)]

    def match(cur, prev):
        return model.track_head(torch.from_numpy(cur).to(dev),
                                torch.from_numpy(prev).to(dev)).cpu().numpy()

    def extract(t):
        feats = [extract_features(model, m, _device_normalize(
            torch.from_numpy(v[t]).to(dev), cfg.data)) for v in videos]
        return FrameFeatures(
            tuple(torch.cat(lv) for lv in zip(*(f.feat_trans
                                                 for f in feats))),
            torch.cat([f.fcn_output for f in feats]))

    def post(outs):
        return [_compact_post(postprocess_frame(
            outs.pred_logits[i], outs.pred_masks[i], outs.embeddings[i],
            outs.fcn_output[i], size, m.postprocess)) for i in range(b)]

    rows: List[Dict[str, float]] = []
    prev = None
    for t in range(n_frames):
        cur, t_ext = _timed(lambda: extract(t), dev)
        outs, t_dec = _timed(lambda: decode_pair(model, m, prev or cur,
                                                 cur), dev)
        posts, t_post = _timed(lambda: post(outs), dev)
        _, t_fin = _timed(lambda: [
            finish_frame(p, t == 0, tracks[i], match, m.stuff_num)
            for i, p in enumerate(posts)], dev)
        prev = cur
        rows.append({"extract": t_ext / b, "decode": t_dec / b,
                     "post": t_post / b, "finish": t_fin / b})
    return {k: statistics.median(r[k] for r in rows[1:]) for k in rows[0]}
