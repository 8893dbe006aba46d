"""Batched evaluation: ``BatchedVideoPipeline(batch=B).run_videos`` on B
videos, call after call, one client in a closed loop.

A mix gives ``batch`` (videos a call), ``videos`` (= ``batch``),
``frames`` (a video's length: every call's, the judged call's too),
``warm_frames`` (the warm-up call's length), ``trace_skip`` and
``trace_steps`` (the lockstep steps of a whole call that the profiler
skips, then records), ``stage_frames`` and ``check_videos``.  Every call
of the window runs the same B videos; the results of the window's last
call are held to the judged call's (``judged``)."""

from __future__ import annotations

import time
from typing import Callable, Dict, List

from vpsbench.capture import Capture, frame_row, video_records
from vpsbench.drivers.stages import stage_ms, sync
from vpsbench.drivers.video import VideoDriver, host_clock, host_span


class Driver(VideoDriver):
    def _pipeline(self):
        from slotvps_tpu_torch.inference import BatchedVideoPipeline

        size = tuple(self.videos[0][0].shape[1:3])
        return BatchedVideoPipeline(self.model, self.cfg,
                                    batch=self.mix["batch"], image_size=size)

    def _run(self, n_frames: int):
        out = self.pipe.run_videos([v[:n_frames] for v in self.videos])
        sync(self.device)
        return out

    def warm(self) -> None:
        self._run(self.mix["warm_frames"])

    def window(self, seconds: float) -> Dict:
        """Whole calls until ``seconds`` have passed; the window ends with
        the last call's readback.  Each call's host readings
        (``host_clock``) are kept."""
        n = self.mix["frames"]
        calls, frames = [], 0
        t0 = time.perf_counter()
        while True:
            start = host_clock()
            results = self._run(n)
            calls.append(host_span(start))
            frames += len(self.videos) * n
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        return {"window_s": window_s, "frames": frames, "calls": calls,
                "results": {v: results[v] for v in self.sample}}

    def profiled(self, step: Callable[[], None]) -> int:
        """One whole call, ``step()`` at the start of each lockstep step
        (as its backbone is issued); returns the frames a step."""
        rep = self.pipe.replicas[0]
        extract = rep._extract

        def stepped(img):
            step()
            return extract(img)

        rep._extract = stepped
        try:
            self._run(self.mix["frames"])
        finally:
            del rep._extract
        return len(self.videos)

    def judged(self) -> Dict[int, List]:
        """One more whole call on the same videos with the program's stage
        boundaries recorded: each sampled video's frames
        (``capture.Record``)."""
        n, b = self.mix["frames"], len(self.videos)
        cap = Capture(lambda row: row % b in self.sample)
        with cap.active():
            self._run(n)
        return {v: video_records(cap, [frame_row(t, v, b) for t in range(n)])
                for v in self.sample}

    def stages(self) -> Dict[str, float]:
        return stage_ms(self.model, self.cfg, self.videos,
                        self.mix["stage_frames"])
