"""The program's own state at its stage boundaries, for the judged call.

While :meth:`Capture.active` is on, the port's streaming and batched
pipelines run as they are, but two of the stage functions that
``slotvps_tpu_torch/inference.py`` calls by name (``decode_pair`` and
``finish_frame``) pass through recorders.  Each
call's rows are numbered in the order the pipeline issues them (a batch
of B frames is B rows); the rows that ``keep(row)`` selects are kept on
the device: the decoder's inputs (both frames' features) and outputs, the
postprocess's result, and the tracking step's input, its first-frame flag
and the frame's answer.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, NamedTuple


class Record(NamedTuple):
    """One frame of one video, as the program computed it."""

    ref_feats: object      # FrameFeatures of the reference frame, batch 1
    cur_feats: object      # FrameFeatures of the frame, batch 1
    outputs: object        # FrameOutputs of the decoder, batch 1
    post: object           # the PostprocResult that the tracking step got
    is_first: bool
    result: object         # the FrameResult: the program's answer


def _row(x, i):
    """Row ``i`` of a NamedTuple of tensors (or of tuples of tensors) as a
    batch of one, copied."""
    return type(x)(*(tuple(t[i:i + 1].clone() for t in f)
                     if isinstance(f, tuple) else f[i:i + 1].clone()
                     for f in x))


class Capture:
    def __init__(self, keep: Callable[[int], bool]):
        self.keep = keep
        self.counts = {"decode": 0, "finish": 0}
        self.decoded: Dict[int, tuple] = {}
        self.records: Dict[int, Record] = {}

    def _rows(self, stage: str, n: int) -> List[int]:
        start = self.counts[stage]
        self.counts[stage] += n
        return list(range(start, start + n))

    @contextlib.contextmanager
    def active(self):
        from slotvps_tpu_torch import inference

        real_decode = inference.decode_pair
        real_finish = inference.finish_frame

        def decode_pair(model, cfg, ref_feats, cur_feats):
            out = real_decode(model, cfg, ref_feats, cur_feats)
            for i, row in enumerate(self._rows("decode",
                                               out.pred_logits.shape[0])):
                if self.keep(row):
                    self.decoded[row] = (_row(ref_feats, i),
                                         _row(cur_feats, i), _row(out, i))
            return out

        def finish_frame(post, is_first, *args, **kwargs):
            res = real_finish(post, is_first, *args, **kwargs)
            row = self._rows("finish", 1)[0]
            if self.keep(row):
                self.records[row] = Record(*self.decoded.pop(row), post,
                                           bool(is_first), res)
            return res

        inference.decode_pair = decode_pair
        inference.finish_frame = finish_frame
        try:
            yield self
        finally:
            inference.decode_pair = real_decode
            inference.finish_frame = real_finish


def video_records(capture: Capture, rows: List[int]) -> List[Record]:
    """The records of ``rows`` (a video's frames, in order)."""
    missing = [r for r in rows if r not in capture.records]
    if missing:
        raise RuntimeError(f"the judged call recorded no frame at rows "
                           f"{missing[:5]}")
    return [capture.records[r] for r in rows]


def frame_row(t: int, v: int, batch: int) -> int:
    """The row of frame ``t`` of video ``v`` in a lockstep batch."""
    return t * batch + v

