"""How ``correct`` is decided: a sample of the window's videos, judged
stage by stage against the plain reference on the same weights and frames.

After the window the driver runs the cell's entry once more on the same
inputs, whole videos as the window ran them, with the program's stage
boundaries recorded (``capture.py``): for each frame of a sampled video,
the decoder's inputs and outputs, the postprocess's result as the
tracking step got it, the first-frame flag and the answer.  The reference (``reference/``, f32,
plain routes) then follows the program:

* ``replay_miss``: the share of the sampled videos' frames whose answer in
  the judged call differs from the window's (the program is
  deterministic: limit 0);
* ``carry_miss``: the share of frames whose decoder did not get the
  frame before's features as its reference frame (the frame itself at the
  first) or whose tracking step was not told first at the first frame
  alone (exact: limit 0);
* ``sseg_gap`` (features, from the raw frame): over every pixel, the
  widest gap by which the reference's semantic logit of the class the
  program answered lies below the reference's best logit;
* ``feat_gap`` (features, from the raw frame): the largest difference
  between the program's decoder features and the reference's, over the
  largest reference feature, the worst level;
* ``logit_gap`` (decoder, from the program's features): the largest
  difference of the class logits between the program's decoder and the
  reference's decoder run on the program's features, over the largest
  reference class logit;
* ``mask_gap`` (decoder, from the program's features): the same of the
  mask logits;
* ``post_miss`` (postprocess, from the program's decoder outputs): the
  share of pixels whose panoptic answer differs from the reference
  postprocess of the program's decoder outputs;
* ``id_miss`` (tracking, from the program's postprocess result): the share
  of frames whose things' classes or track ids differ from the reference's
  tracking step on that result.

Every number is the worst over the judged frames and videos.  The last two
have nothing to compare where no judged frame kept a slot (the answer is
void everywhere): they then read None.  The control
(:func:`control_records`) is the reference itself in the program's place,
its products' operands rounded to float8 (``reference/lowp.py``) and its
postprocess stack in bf16 (the port's own ``stack_dtype`` option), judged
the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from vpsbench.reference import detector as rdet, lowp, pipeline
from vpsbench.reference.interpolate import upsample_x4_bilinear
from vpsbench.reference.postprocess import postprocess_frame
from vpsbench.reference.tracking import TrackState

NUMBERS = ("replay_miss", "carry_miss", "sseg_gap", "feat_gap",
           "logit_gap", "mask_gap", "post_miss", "id_miss")


def sample(seed: int, n_videos: int, n_check: int) -> List[int]:
    """``n_check`` of ``n_videos`` videos drawn from the seed, one from each
    of ``n_check`` equal runs of the videos (both halves of a batch)."""
    rng = np.random.default_rng(int(seed) % (1 << 63) + 17)
    edges = np.linspace(0, n_videos, n_check + 1).astype(int)
    return [int(rng.integers(lo, hi)) for lo, hi in zip(edges[:-1],
                                                        edges[1:])
            if hi > lo]


def _f32(feats):
    return type(feats)(tuple(f.float() for f in feats.feat_trans),
                       feats.fcn_output.float())


def _same_feats(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(
        a.feat_trans + (a.fcn_output,), b.feat_trans + (b.fcn_output,)))


def same_answer(a, b) -> bool:
    """Two FrameResults give the same answer."""
    return all(np.array_equal(np.asarray(getattr(a, k)),
                              np.asarray(getattr(b, k)))
               for k in ("sseg", "panoptic", "cls_inds", "obj_ids",
                         "cls_prob"))


def _rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a.float() - ref).abs().max()
                 / ref.abs().max().clamp_min(1e-30))


@torch.inference_mode()
def judge_video(ref_model, ref_cfg, frames: torch.Tensor,
                records: Sequence, window: Sequence = None
                ) -> Dict[str, float]:
    """The numbers of one video: ``frames`` uint8 [T, H, W, 3] on the
    reference's device, ``records`` its first frames as the program
    computed them (``capture.Record`` fields), ``window`` the answers that
    the window gave for the video (None: no replay to hold)."""
    if len(records) > frames.shape[0]:
        raise ValueError(f"{len(records)} records for {frames.shape[0]} "
                         "frames")
    m = ref_cfg.model
    size = tuple(frames.shape[1:3])
    dev = frames.device
    track = TrackState()

    def match(cur, prev):
        return ref_model.track_head(torch.from_numpy(cur).to(dev),
                                    torch.from_numpy(prev).to(dev)
                                    ).cpu().numpy()

    n = {k: 0.0 for k in NUMBERS}
    kept = False
    for t, rec in enumerate(records):
        res = rec.result
        if window is not None and not same_answer(res, window[t]):
            n["replay_miss"] += 1 / len(records)
        carried = records[t - 1].cur_feats if t else rec.cur_feats
        if rec.is_first != (t == 0) or not _same_feats(rec.ref_feats,
                                                       carried):
            n["carry_miss"] += 1 / len(records)

        feats = rdet.extract_features(
            ref_model, m, pipeline.normalize(frames[t:t + 1], ref_cfg.data))
        fcn = feats.fcn_output[0]
        if fcn.shape[:2] != size:
            fcn = upsample_x4_bilinear(fcn)
        chosen = torch.as_tensor(np.asarray(res.sseg)).to(dev).long()
        gap = fcn.amax(-1) - fcn.gather(-1, chosen[..., None])[..., 0]
        n["sseg_gap"] = max(n["sseg_gap"], float(gap.max()))
        n["feat_gap"] = max([n["feat_gap"]] + [
            _rel(p, r) for p, r in zip(rec.cur_feats.feat_trans,
                                       feats.feat_trans)])

        outs = rdet.decode_pair(ref_model, m, _f32(rec.ref_feats),
                                _f32(rec.cur_feats))
        prog = rec.outputs
        n["logit_gap"] = max(n["logit_gap"], _rel(prog.pred_logits,
                                                  outs.pred_logits))
        n["mask_gap"] = max(n["mask_gap"], _rel(prog.pred_masks,
                                                outs.pred_masks))

        post = postprocess_frame(prog.pred_logits[0].float(),
                                 prog.pred_masks[0].float(),
                                 prog.embeddings[0].float(),
                                 prog.fcn_output[0].float(), size,
                                 m.postprocess)
        miss = np.asarray(res.panoptic) != post.panoptic.cpu().numpy()
        n["post_miss"] = max(n["post_miss"], float(miss.mean()))
        kept = kept or post.n_kept > 0 or bool(rec.post.kept.any())

        tracked = pipeline.finish_frame(rec.post, rec.is_first, track, match,
                                        m.stuff_num)
        if not (np.array_equal(tracked.cls_inds, res.cls_inds)
                and np.array_equal(tracked.obj_ids, res.obj_ids)):
            n["id_miss"] += 1 / len(records)
    if not kept:
        n["post_miss"] = n["id_miss"] = None
    return n


def control_records(ref_model, ref_cfg, frames: torch.Tensor,
                    dtype=torch.float8_e4m3fn) -> List:
    """The control's frames of one video, as ``capture.Record`` fields:
    the reference with every product's operands rounded to ``dtype`` and
    its postprocess stack in bf16."""
    m = ref_cfg.model
    low = dataclasses.replace(ref_cfg, model=dataclasses.replace(
        m, postprocess=dataclasses.replace(m.postprocess,
                                           stack_dtype="bfloat16")))
    with lowp.rounded(dtype):
        return pipeline.run_video(ref_model, low, frames, records=True)


def worst(readings: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """Each number's largest reading over videos (None where no video
    read it)."""
    return {k: max((r[k] for r in readings if r[k] is not None),
                   default=None) for k in readings[0]}


def met(value, limit) -> bool:
    """A number is met at or under its limit; None has nothing to hold."""
    return value is None or value <= limit


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(met(numbers[k], limits[k]) for k in limits)
