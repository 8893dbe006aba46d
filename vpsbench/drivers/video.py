"""What the video drivers share: the run's set-up from the seed, the
window's end-to-end metrics and host readings, the traced run's record,
and the judging of the program's answers against the plain reference.

A driver of a video entry (``batched.py``, ``stream.py``) subclasses
:class:`VideoDriver` with the loop that drives its entry: ``_pipeline()``,
``warm()``, ``window(seconds)``, ``profiled(step)``, ``judged()`` and
``stages()``.  ``vpsbench/run.py`` drives every driver through the methods
of this class alone, so a driver of another kind of entry (a train step)
is a new module with the same methods.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from vpsbench import clips, judge, manifest, trace, weights


def host_clock() -> Dict[str, float]:
    """The wall clock and this thread's CPU time: where the two part, the
    thread waited (for the card, or for a CPU); where they keep together,
    the host's speed paces the thread."""
    return {"wall_s": time.perf_counter(), "cpu_s": time.thread_time()}


def host_span(start: Dict[str, float]) -> Dict[str, float]:
    """The readings of :func:`host_clock` since ``start``."""
    end = host_clock()
    return {k: end[k] - start[k] for k in start}


class VideoDriver:
    """The weights, regime and clips of ``seed``, made on ``device`` and
    loaded into the port (``self.model``) and into the reference
    (``self.ref``, kept on the CPU until the program is released), and the
    videos ``self.sample`` that the judge reads."""

    def __init__(self, cfg_json: Dict, mix: Dict, seed: int, device):
        from slotvps_tpu_torch import config as pconfig

        self.cfg_json, self.mix, self.device = cfg_json, mix, device
        self.cfg = manifest.build_config(pconfig, cfg_json)
        self.ref_cfg = manifest.reference_config(cfg_json)
        w, h = self.cfg.data.img_scale
        with torch.inference_mode(False):
            ref = weights.reference_model(self.ref_cfg, seed, device)
            weights.apply_regime(ref, self.ref_cfg, cfg_json["regime"], seed,
                                 (h, w), device)
        self.model = weights.port_model(self.cfg, ref.state_dict(), device)
        self.ref = ref.to("cpu")
        self.videos = [clips.host_video(seed, v, h, w, mix["frames"], device)
                       for v in range(mix["videos"])]
        self.sample = judge.sample(seed, mix["videos"], mix["check_videos"])
        self.pipe = self._pipeline()

    def end_to_end(self, window: Dict) -> Dict[str, float]:
        """The window's end-to-end metrics (``setup_s`` is the run's)."""
        return {"frames_per_s": window["frames"] / window["window_s"]}

    def attempted(self, window: Dict) -> int:
        return window["frames"]

    def traced(self) -> Dict:
        """What the traced run's readers read besides the window: the
        profiled steps (``trace.profile``) and the stage pass."""
        return {"trace": trace.profile(self, self.device),
                "stages": self.stages()}

    def release(self) -> None:
        """Free the program; the reference takes the card."""
        self.pipe = self.model = None
        self.ref.to(self.device)

    def _frames(self, v: int, n: int) -> torch.Tensor:
        return torch.from_numpy(np.concatenate(self.videos[v][:n])).to(
            self.device)

    def check(self, records: Dict[int, List], window: Dict) -> Dict:
        """The numbers of the judged videos (the largest over them)."""
        return judge.worst([judge.judge_video(
            self.ref, self.ref_cfg, self._frames(v, len(recs)), recs,
            window["results"].get(v)) for v, recs in sorted(records.items())])

    def control(self) -> Dict:
        """The control's numbers on the judged videos: the reference with
        its products' operands in float8 in the program's place."""
        readings = []
        for v in self.sample:
            frames = self._frames(v, self.mix["frames"])
            readings.append(judge.judge_video(
                self.ref, self.ref_cfg, frames,
                judge.control_records(self.ref, self.ref_cfg, frames)))
        return judge.worst(readings)

    def work(self) -> Dict:
        """One frame's counted work, on the reference in the program's
        compute dtype."""
        count_cfg = manifest.reference_config(self.cfg_json,
                                              self.cfg.model.compute_dtype)
        return frame_work(self.ref, count_cfg,
                          torch.from_numpy(self.videos[0][0]).to(self.device))


def frame_work(ref_model, count_cfg, frame: torch.Tensor) -> Dict:
    """One frame's counted work (``vpsbench/cost``): ``count_cfg`` is the
    reference's config in the program's compute dtype; ``frame`` uint8
    [1, H, W, 3].  Its flops and the formulas of its DCN, slot-attention
    and postprocess branch points."""
    from vpsbench.cost import cost
    from vpsbench.reference import detector as rdet, pipeline
    from vpsbench.reference.postprocess import postprocess_frame

    m = count_cfg.model
    with torch.inference_mode(), cost.count() as c:
        feats = rdet.extract_features(ref_model, m,
                                      pipeline.normalize(frame,
                                                         count_cfg.data))
        outs = rdet.decode_pair(ref_model, m, feats, feats)
        postprocess_frame(outs.pred_logits[0], outs.pred_masks[0],
                          outs.embeddings[0], outs.fcn_output[0],
                          tuple(frame.shape[1:3]), m.postprocess)
    return {"flops": c.flops, "entries": list(c.entries)}
