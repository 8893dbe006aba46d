"""Operand rounding for the comparison's control.

The control of ``vpsbench/judge.py`` is the reference computed one
precision below the configuration's: every operand of a product
(convolution, linear layer, attention, the DCN's tap products) rounded to
float8 e4m3 with a per-tensor scale (its largest magnitude onto the
format's largest value), the way fp8 inference scales a tensor.  Outside
:func:`rounded` the products take their operands as they are.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional

import torch

_FORMAT: contextvars.ContextVar[Optional[torch.dtype]] = \
    contextvars.ContextVar("vpsbench_operand_format", default=None)


@contextlib.contextmanager
def rounded(dtype: Optional[torch.dtype]) -> Iterator[None]:
    """Round every product's operands to ``dtype`` inside (None: not)."""
    token = _FORMAT.set(dtype)
    try:
        yield
    finally:
        _FORMAT.reset(token)


def q(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the active format with a per-tensor scale, back in
    its own dtype; ``x`` itself where no format is active."""
    dtype = _FORMAT.get()
    if dtype is None or not x.is_floating_point() or x.numel() == 0:
        return x
    xf = x.float()
    scale = torch.finfo(dtype).max / xf.abs().amax().clamp_min(1e-30)
    return ((xf * scale).to(dtype).float() / scale).to(x.dtype)
