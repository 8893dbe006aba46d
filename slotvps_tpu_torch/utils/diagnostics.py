"""DCN sampling-halo diagnostics (counterpart of
``slotvps_tpu/utils/diagnostics.py``).

The reference CUDA deformable conv samples at unbounded offsets
(``deform_conv_cuda_kernel.cu`` ``deformable_im2col``); the port's DCN, the
plain version and the Hopper kernel alike, clamps each tap into a +-halo
window of its rigid position.  A trained ``conv_offset`` head whose offsets
exceed the halo would clamp silently.  These helpers measure the offsets a
checkpoint's heads emit, per pyramid level (fine levels emit smaller
offsets than coarse ones), so that loading a checkpoint can raise any
level whose halo would clamp (``cli/test_eval_vpq.py``).
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import torch


def effective_halo(sh_cfg) -> Tuple[int, ...]:
    """The per-level halos a SemanticHeadConfig runs with (0 = the route's
    default: 8 for the plain DCN, 4 for the kernel routes), as a tuple of
    ``num_levels`` entries."""
    default = 4 if sh_cfg.dcn_impl.startswith("pallas") else 8
    if isinstance(sh_cfg.dcn_halo, tuple):
        return tuple(h or default for h in sh_cfg.dcn_halo)
    return (sh_cfg.dcn_halo or default,) * sh_cfg.num_levels


def measure_max_dcn_offset(model, cfg, image=None, hw=(256, 512),
                           seed: int = 0, images=None) -> np.ndarray:
    """Per-level max |offset| component that any semantic-tower DCN block
    of ``model`` emits on calibration input(s).

    ``images``: normalized [1, H, W, 3] frames at eval resolution (offsets
    depend on the input, so calibrate on what eval will see); without them,
    one random-normal ``hw`` image from ``seed`` (numpy), a coarse lower
    estimate only.  Walks backbone -> FPN -> each tower block per level and
    takes the offset conv's output before the DCN uses it; each block's
    features for the next go through the DCN at halo 16, the f32 kernel on
    the card (whose tiling does not depend on the halo) and the plain
    version on the CPU.  Returns [num_levels] f32 (P2..P5), the max over
    all inputs."""
    dev = next(model.parameters()).device
    if images is None:
        if image is None:
            rng = np.random.default_rng(seed)
            image = torch.from_numpy(
                rng.standard_normal((1, *hw, 3)).astype(np.float32))
        images = [image]
    sh = cfg.semantic_head

    @torch.no_grad()
    def run(img):
        img = img.to(dev, getattr(torch, cfg.compute_dtype))
        fpn_outs = model.fpn(model.backbone(img), num_outs=cfg.fpn.num_outs)
        maxima = []
        for x in fpn_outs[:sh.num_levels]:
            lvl_max = []
            for block in model.semantic_head.tower:
                off = block.offset(x, padding=1)
                lvl_max.append(off.float().abs().max())
                # unclamped-within-16 features for the next block
                x = block(x, sh.gn_groups, impl="pallas_f32", halo=16)
            maxima.append(torch.stack(lvl_max).max())
        return torch.stack(maxima).cpu().numpy()

    return np.stack([run(im) for im in images]).max(axis=0)


def check_dcn_halo(model, cfg, image=None, warn: bool = True, images=None,
                   margin: float = 1.25
                   ) -> Tuple[float, Tuple[int, ...], Tuple[int, ...]]:
    """The checkpoint's per-level offset range against the configured
    halos.

    The recommendation pads the measured maximum by ``margin`` (25 %)
    before comparing with the halo in effect, since frames the calibration
    did not see can emit larger offsets.  Returns ``(max_offset,
    halos_in_effect, recommended_halos)``: the global max (for the log
    line) and two per-level tuples; ``recommended[l] > in_effect[l]`` only
    where the padded offsets of level l would clamp."""
    eff = effective_halo(cfg.semantic_head)
    mx = measure_max_dcn_offset(model, cfg, image=image, images=images)
    rec = tuple(max(e, int(np.ceil(margin * m))) for e, m in zip(eff, mx))
    if warn and rec != eff:
        warnings.warn(
            f"converted conv_offset heads emit offsets up to "
            f"{[round(float(m), 2) for m in mx]} px per level but the DCN "
            f"halos in effect are {eff} px — samples would be clamped "
            f"(the reference CUDA kernel is unbounded). Raise "
            f"SemanticHeadConfig.dcn_halo to {rec}.", RuntimeWarning)
    return float(mx.max()), eff, rec
