"""What a traced run reads of the card: the profiled steps' device
activity.

After the window the cell's entry runs one more whole call under
``torch.profiler`` (host and card) with a schedule: it records a few
steady steps from the middle of the call, neither its first frames nor
its last.  Its events stay in memory and only a summary is kept: each
device operation's total time and count, the union of the device's busy
intervals, the recorded steps' host-clock length, and their longest idle
gaps (the 200 longest, summed by the innermost host operation running at
each gap's middle).
"""

from __future__ import annotations

import bisect
import collections
import time
from typing import Dict, List, Tuple

from vpsbench.drivers.stages import sync

_TOP = 10
_NAMED_GAPS = 200   # the longest idle gaps, each named by the host


def _is_launch(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _annotation(event) -> bool:
    """A span that the profiler or the program annotated (the profiler's
    ``ProfilerStep#<n>``, a ``record_function``), on the host or, as the
    profiler mirrors it, on the card: no operation."""
    marked = getattr(event, "is_user_annotation", None)
    return bool(marked and marked()) or event.name().startswith(
        "ProfilerStep#")


def summarize(events, t0_ns: int, t1_ns: int) -> Dict:
    """The summary of the kineto events (``name()``, ``device_type()``,
    ``start_ns()``, ``duration_ns()``) between ``t0_ns`` and ``t1_ns``: the
    device operations that start in it, their busy time within it;
    annotations are neither device nor host operations."""
    dev, host = [], []
    for e in events:
        if _annotation(e):
            continue
        s = e.start_ns()
        rec = (s, s + e.duration_ns(), e.name())
        if not str(e.device_type()).endswith("CUDA"):
            host.append(rec)
        elif t0_ns <= s < t1_ns:
            dev.append(rec)
    by_name: Dict[str, List[float]] = collections.defaultdict(
        lambda: [0.0, 0])
    for s, e, name in dev:
        by_name[name][0] += (e - s) * 1e-9
        by_name[name][1] += 1
    busy = _union([(max(s, t0_ns), min(e, t1_ns)) for s, e, _ in dev
                   if e > t0_ns and s < t1_ns])
    busy_s = sum(e - s for s, e in busy) * 1e-9
    edges = [t0_ns] + [x for iv in busy for x in iv] + [t1_ns]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host.sort()
    starts = [h[0] for h in host]
    longest = max((e - s for s, e, _ in host), default=0)
    idle: Dict[str, float] = collections.defaultdict(float)
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:_NAMED_GAPS]:
        mid = (s + e) // 2
        best = None
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            hs, he, name = host[i]
            if mid - hs > longest:
                break
            if he >= mid and (best is None or he - hs < best[1] - best[0]):
                best = (hs, he, name)
        idle[best[2] if best else "(host Python, no torch operation)"] += \
            (e - s) * 1e-9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {
        "window_s": (t1_ns - t0_ns) * 1e-9,
        "busy_s": busy_s,
        "launches": sum(n for name, (_, n) in by_name.items()
                        if _is_launch(name)),
        "by_name": {name: tuple(v) for name, v in by_name.items()},
        "device_ops": [[name, v[0]] for name, v in ops[:_TOP]],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                            key=lambda kv: -kv[1])[:_TOP],
    }


def _step_spans(events, first: int, last: int) -> List[Tuple[int, int]]:
    """The host spans of the profiler's steps ``first``..``last``."""
    spans = {}
    for e in events:
        name = e.name()
        if name.startswith("ProfilerStep#"):
            n = int(name.split("#")[1])
            if first <= n <= last:
                spans[n] = (e.start_ns(), e.start_ns() + e.duration_ns())
    return [spans[n] for n in sorted(spans)]


def profile(driver, device) -> Dict:
    """The profiled steps of one whole call of ``driver``'s entry
    (``driver.profiled(step)``, which calls ``step()`` as each lockstep
    step starts): the profiler skips the mix's ``trace_skip`` steps, warms
    up on the next and records ``trace_steps``.  The traced window runs
    from the start of the first recorded step to the end of the last, by
    the host clock; ``frames`` is the frames in it, ``call_s`` the whole
    call's host-clock time."""
    from torch.profiler import (ProfilerActivity, profile as torch_profile,
                                schedule)

    skip, steps = driver.mix["trace_skip"], driver.mix["trace_steps"]
    if skip < 1 or skip + steps >= driver.mix["frames"]:
        raise ValueError(f"the mix's trace_skip {skip} and trace_steps "
                         f"{steps} must lie inside its {driver.mix['frames']}"
                         " frames, with a step before and after")
    kept = {}

    def ready(prof):
        events = prof.profiler.kineto_results.events()
        spans = _step_spans(events, skip + 1, skip + steps)
        if len(spans) != steps:
            raise RuntimeError(f"the profiler recorded {len(spans)} of "
                               f"{steps} steps")
        kept.update(summarize(events, spans[0][0], spans[-1][1]))

    sync(device)
    t0 = time.perf_counter()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       schedule=schedule(wait=skip, warmup=1, active=steps,
                                         repeat=1),
                       on_trace_ready=ready) as prof:
        per_step = driver.profiled(prof.step)
        sync(device)
    kept["call_s"] = time.perf_counter() - t0
    kept["frames"] = per_step * steps
    return kept
