"""Model statistics and timing (counterpart of
``slotvps_tpu/utils/profiler.py``): the parameter count in the reference's
format (printed by the train CLI, reference tools/test_eval_vpq.py:104-106),
a wall-clock timing harness fenced by ``torch.cuda.synchronize`` on the
card, and a ``torch.profiler`` trace context.

The JAX package's ``cost_analysis`` reads FLOPs and bytes from XLA's
compiled program; PyTorch runs eagerly and has no such program, so it has
no counterpart here.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch


def count_params(module: torch.nn.Module) -> int:
    """The entries of ``module``'s ``state_dict``: its parameters and the
    frozen BatchNorm statistics, the leaves of the JAX package's tree."""
    return sum(t.numel() for t in module.state_dict().values())


def params_to_string(n: int) -> str:
    """Reference format (mmdet/utils/flops_counter.py:103)."""
    if n >= 1e6:
        return f"{n / 1e6:.2f} M"
    if n >= 1e3:
        return f"{n / 1e3:.2f} k"
    return str(n)


def _sync(out):
    """Wait for the devices of ``out``'s tensors (the current stream of
    each card they lie on)."""
    tensors = [out] if isinstance(out, torch.Tensor) else (
        [t for t in (out.values() if isinstance(out, dict) else out)
         if isinstance(t, torch.Tensor)]
        if isinstance(out, (dict, list, tuple)) else [])
    for dev in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def time_fn(fn: Callable, *args, iters: int = 8, warmup: int = 2) -> float:
    """Mean wall seconds per call of ``fn(*args)`` over ``iters`` calls
    after ``warmup``, fenced by ``torch.cuda.synchronize`` on each card
    the output lies on."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the host and, where CUDA is available,
    the card, written under ``log_dir`` for TensorBoard / Perfetto."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
