"""Streaming: one video after another through
``InferencePipeline.process_frame``, B = 1, one client in a closed loop.

A mix gives ``videos`` (the pool, cycled in order), ``frames`` (a video's
length), ``warm_frames``, ``trace_skip`` and ``trace_steps`` (the frames
of a whole video that the profiler skips, then records),
``stage_frames`` and ``check_videos``.  Each frame's time runs from the
call to its returned ``FrameResult`` (host arrays: the call ends in the
device->host copy).  The window ends after the frame in which ``seconds``
have passed; each sampled video as last completed in the window is held
to the judged pass (``judged``)."""

from __future__ import annotations

import time
from typing import Callable, Dict, List

from vpsbench.capture import Capture, video_records
from vpsbench.drivers.stages import stage_ms, sync
from vpsbench.drivers.video import VideoDriver, host_clock, host_span


class Driver(VideoDriver):
    def _pipeline(self):
        from slotvps_tpu_torch.inference import InferencePipeline
        from slotvps_tpu_torch.utils.precision import setup_precision

        setup_precision()        # as the port's CLI does before streaming
        size = tuple(self.videos[0][0].shape[1:3])
        return InferencePipeline(self.model, self.cfg, image_size=size)

    def _video(self, v: int, n: int, step: Callable[[], None] = None):
        out = []
        for t in range(n):
            if step is not None:
                step()
            out.append(self.pipe.process_frame(self.videos[v][t],
                                               is_first=(t == 0)))
        sync(self.device)
        return out

    def warm(self) -> None:
        self._video(0, self.mix["warm_frames"])

    def window(self, seconds: float) -> Dict:
        """Frames until ``seconds`` have passed; each frame's latency and
        each video's host readings (``host_clock``) are kept."""
        n = self.mix["frames"]
        latencies, calls, done = [], [], {}
        v, t, current = 0, 0, []
        t0 = time.perf_counter()
        start = host_clock()
        while True:
            s = time.perf_counter()
            res = self.pipe.process_frame(self.videos[v][t], is_first=(t == 0))
            latencies.append(time.perf_counter() - s)
            if v in self.sample:
                current.append(res)
            t += 1
            if t == n:
                calls.append(host_span(start))
                start = host_clock()
                if v in self.sample:
                    done[v] = current
                v, t, current = (v + 1) % len(self.videos), 0, []
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        return {"window_s": window_s, "frames": len(latencies),
                "latencies": latencies, "calls": calls, "results": done}

    def profiled(self, step: Callable[[], None]) -> int:
        """One whole video, ``step()`` before each frame; returns the
        frames a step."""
        self._video(0, self.mix["frames"], step)
        return 1

    def judged(self) -> Dict[int, List]:
        """The sampled videos once more, whole, one after another, with the
        program's stage boundaries recorded (``capture.Record``)."""
        n = self.mix["frames"]
        cap = Capture(lambda row: True)
        with cap.active():
            for v in self.sample:
                self._video(v, n)
        return {v: video_records(cap, list(range(i * n, (i + 1) * n)))
                for i, v in enumerate(self.sample)}

    def stages(self) -> Dict[str, float]:
        return stage_ms(self.model, self.cfg, self.videos[:1],
                        self.mix["stage_frames"])
