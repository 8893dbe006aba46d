"""Hopper kernels of the K-minor postprocess: wrappers.

The counterparts of ``slotvps_tpu/ops/pallas/postproc_fused.py``'s three
TPU kernels are the ``*_hwk`` entries of ``csrc/postproc_v3.cu`` (its
library, :data:`slotvps_tpu_torch.ops.cuda.postproc_v3.LIBRARY`): the
theta, claim and argmax kernels read K-minor masks ``[h, w, K]`` through
their strides, with no transposed copy.  One wrapper per kernel, each with
the signature of its plain version in
:mod:`slotvps_tpu_torch.ops.postproc_fused`:

* :func:`theta_fused_hopper`, :func:`claim_scan_fused_hopper`,
  :func:`argmax_areas_hopper`.

On CPU tensors a wrapper runs the plain version; on CUDA tensors it
launches its kernel or raises — there is no fallback.  Each kernel launch
adds one to the wrapper's ``launches`` count (the claim loop is one
persistent launch, which finds the valid thing slots on the device).  The
wrappers allocate every output; kernels launch on PyTorch's current
stream and do not synchronise.
"""

from __future__ import annotations

import math

import torch

from slotvps_tpu_torch.ops import postproc_fused as plain
from slotvps_tpu_torch.ops.cuda.postproc_v3 import (LIBRARY, _on_card,
                                                    _raise_on, _slot_vec,
                                                    _stream, claim_launch)


def theta_fused_hopper(m_hwk: torch.Tensor, valid: torch.Tensor,
                       pixel_threshold: float) -> torch.Tensor:
    """theta [4h, 4w] f32 (see :func:`plain.theta_fused`)."""
    name = "theta_fused_hopper"
    if not _on_card(name, m_hwk, (valid,), k_minor=True):
        return plain.theta_fused(m_hwk, valid, pixel_threshold)
    h, w, k = m_hwk.shape
    dev = m_hwk.device
    valid8 = _slot_vec(name, "valid", valid, k, dev)
    out = torch.empty((4 * h, 4 * w), dtype=torch.float32, device=dev)
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.pp_theta_hwk(m_hwk.data_ptr(), valid8.data_ptr(),
                              math.log(pixel_threshold), out.data_ptr(), k, h,
                              w, _stream(dev))
    _raise_on(rc, "pp_theta_hwk")
    theta_fused_hopper.launches += 1
    return out


def claim_scan_fused_hopper(m_hwk: torch.Tensor, theta: torch.Tensor,
                            labels: torch.Tensor, is_thing: torch.Tensor,
                            valid: torch.Tensor, fraction_threshold: float):
    """(keep_things [K] bool, owner [4h, 4w] int8) (see
    :func:`plain.claim_scan_fused`).  The kernel path is the claim kernel
    on K-minor strides, in one launch with no host sync."""
    name = "claim_scan_fused_hopper"
    if not _on_card(name, m_hwk, (labels, is_thing, valid), k_minor=True,
                    theta=(theta, torch.float32)):
        return plain.claim_scan_fused(m_hwk, theta, labels, is_thing, valid,
                                      fraction_threshold)
    h, w, k = m_hwk.shape
    out = claim_launch(name, m_hwk, theta, labels, is_thing, valid,
                       fraction_threshold, k, h, w, 0, k, k_minor=True)
    claim_scan_fused_hopper.launches += 1
    return out


def argmax_areas_hopper(m_hwk: torch.Tensor, owner: torch.Tensor,
                        kept: torch.Tensor, is_thing: torch.Tensor):
    """(m_id [4h, 4w] int32, areas [K] int32) (see
    :func:`plain.argmax_areas`)."""
    name = "argmax_areas_hopper"
    if not _on_card(name, m_hwk, (kept, is_thing), k_minor=True,
                    owner=(owner, torch.int8)):
        return plain.argmax_areas(m_hwk, owner, kept, is_thing)
    h, w, k = m_hwk.shape
    dev = m_hwk.device
    kept8 = _slot_vec(name, "kept", kept, k, dev)
    thing8 = _slot_vec(name, "is_thing", is_thing, k, dev)
    m_id = torch.empty((4 * h, 4 * w), dtype=torch.int32, device=dev)
    areas = torch.empty((k,), dtype=torch.int32, device=dev)
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.pp_argmax_hwk(m_hwk.data_ptr(), owner.data_ptr(),
                               kept8.data_ptr(), thing8.data_ptr(),
                               m_id.data_ptr(), areas.data_ptr(), k, h, w,
                               _stream(dev))
    _raise_on(rc, "pp_argmax_hwk")
    argmax_areas_hopper.launches += 1
    return m_id, areas


for _fn in (theta_fused_hopper, claim_scan_fused_hopper,
            argmax_areas_hopper):
    _fn.launches = 0
