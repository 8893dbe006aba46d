"""Frames a second in the profiled steps (the frames in them over their
host-clock length): beside the window's ``frames_per_s`` it shows what
the profiler costs, and so how far the other device-trace metrics read a
slower run than the window's."""


def read(record):
    t = record.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return t["frames"] / t["window_s"]
