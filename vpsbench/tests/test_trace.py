"""The profiled steps' summary (``vpsbench/trace.summarize``) on events
made by hand."""

import pytest

from vpsbench import trace


class Event:
    def __init__(self, name, device, start, end, annotation=False):
        self._name, self._device = name, device
        self._start, self._end, self._annotation = start, end, annotation

    def name(self):
        return self._name

    def device_type(self):
        return f"DeviceType.{self._device}"

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def is_user_annotation(self):
        return self._annotation


def test_annotations_are_no_operations():
    """The profiler's step annotation, mirrored on the card over the whole
    step, neither makes the card busy nor names a gap."""
    events = [Event("ProfilerStep#11", "CUDA", 0, 1000, annotation=True),
              Event("ProfilerStep#11", "CPU", 0, 1000, annotation=True),
              Event("step_region", "CUDA", 0, 1000, annotation=True),
              Event("aten::add", "CPU", 100, 200),
              Event("add_kernel", "CUDA", 150, 350),
              Event("add_kernel", "CUDA", 300, 400),
              Event("Memcpy DtoH", "CUDA", 700, 800),
              Event("late_kernel", "CUDA", 1000, 1100)]
    s = trace.summarize(events, 0, 1000)
    assert s["busy_s"] == pytest.approx(350e-9)
    assert s["window_s"] == pytest.approx(1000e-9)
    assert s["launches"] == 2
    assert s["by_name"] == {"add_kernel": (pytest.approx(300e-9), 2),
                            "Memcpy DtoH": (pytest.approx(100e-9), 1)}
    names = {name for name, _ in s["idle_gaps"]}
    assert names == {"(host Python, no torch operation)"}
    assert sum(sec for _, sec in s["idle_gaps"]) == pytest.approx(650e-9)
