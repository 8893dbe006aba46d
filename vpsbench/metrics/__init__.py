"""The readers of the per-layer metrics, one module a metric, each with
``read(record) -> float | None`` (None: nothing to read in this run).

A traced run's record holds ``window`` (the driver's window: its
``frames``, ``window_s`` and, where the mix gives them, ``latencies``, the
per-frame seconds), ``trace`` (``vpsbench/trace.py``'s summary of the
profiled steps), ``work`` (one frame's counted work), ``stages`` (the
stage pass's ms a frame) and ``peaks`` (the configuration's)."""

from __future__ import annotations

import re
from typing import Dict, Optional


def least_seconds(work, peaks: Dict) -> float:
    """The least time the card could take for ``work``: the longest of its
    bytes over the memory bandwidth, its matrix products over the tensor
    cores' peak and its other operations over the CUDA cores' peak."""
    return max(work.bytes / peaks["bytes_per_s"],
               work.products / peaks["products_flops"],
               (work.gathers + work.elementwise) / peaks["vector_flops"])


def kernel_seconds(record: Dict, pattern: str) -> float:
    """The profiled steps' device seconds in operations whose name matches
    ``pattern``."""
    return sum(sec for name, (sec, _) in record["trace"]["by_name"].items()
               if re.search(pattern, name))


def roofline(record: Dict, entry: str, pattern: str) -> Optional[float]:
    """The share (%) of the least time of the frame's ``entry`` branch
    points, times the profiled frames, in the device time of the kernels
    matching ``pattern``."""
    if "trace" not in record or "work" not in record:
        return None
    spent = kernel_seconds(record, pattern)
    if spent <= 0:
        return None
    least = sum(least_seconds(w, record["peaks"])
                for name, w in record["work"]["entries"] if name == entry)
    return 100.0 * least * record["trace"]["frames"] / spent
