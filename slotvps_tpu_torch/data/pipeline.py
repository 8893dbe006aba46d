"""Test-time image preprocessing, matching the reference recipe exactly.

Reference pipeline (configs/cityscapes/r50_fpn_slotvps.py:147-161):
LoadRefImageFromFile -> MultiScaleFlipAug[(2048,1024), flip=False] ->
Resize(keep_ratio) -> Normalize(mean/std, to_rgb) -> Pad(size_divisor=32).

Images are read BGR (mmcv.imread == cv2.imread), converted to RGB, scaled
with ``imrescale`` semantics (scale factor = min(max_w/w, max_h/h), new size
rounded with +0.5), normalized, zero-padded bottom/right to /32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def imrescale_size(w: int, h: int, scale: Tuple[int, int]) -> Tuple[int, int]:
    """mmcv.imrescale new size for keep_ratio resize; scale = (max_w, max_h)."""
    max_w, max_h = scale
    f = min(max_w / w, max_h / h)
    return int(w * f + 0.5), int(h * f + 0.5)


def preprocess(
    img_bgr: np.ndarray,
    scale: Tuple[int, int] = (2048, 1024),
    mean=(123.675, 116.28, 103.53),
    std=(58.395, 57.12, 57.375),
    to_rgb: bool = True,
    size_divisor: int = 32,
    keep_uint8: bool = False,
) -> Tuple[np.ndarray, dict]:
    """uint8 BGR HxWx3 -> normalized float32 [1, H', W', 3] + meta.

    ``keep_uint8`` defers the BGR->RGB conversion + normalization to the
    device (inference._device_normalize): the array returned is padded
    uint8 BGR, 4x fewer host->device bytes.  The resize happens on the
    uint8 image either way, and the deferred affine runs the identical
    f32 ``(x - mean) / std``, so the two paths produce the same values
    (bit-exact where XLA's f32 divide is IEEE — pinned by
    tests/test_batched_inference.py::test_uint8_upload_matches_float)."""
    h, w = img_bgr.shape[:2]
    new_w, new_h = imrescale_size(w, h, scale)
    if (new_w, new_h) != (w, h):
        assert cv2 is not None, "cv2 required for resizing"
        img_bgr = cv2.resize(img_bgr, (new_w, new_h),
                             interpolation=cv2.INTER_LINEAR)
    pad_h = (size_divisor - new_h % size_divisor) % size_divisor
    pad_w = (size_divisor - new_w % size_divisor) % size_divisor
    meta = {
        "ori_shape": (h, w),
        "img_shape": (new_h, new_w),
        "pad_shape": (new_h + pad_h, new_w + pad_w),
        "scale_factor": new_w / w,
    }
    if keep_uint8:
        if pad_h or pad_w:
            img_bgr = np.pad(img_bgr, ((0, pad_h), (0, pad_w), (0, 0)))
        return img_bgr[None], meta
    img = img_bgr.astype(np.float32)
    if to_rgb:
        img = img[..., ::-1]
    img = (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    if pad_h or pad_w:
        img = np.pad(img, ((0, pad_h), (0, pad_w), (0, 0)))
    return img[None].astype(np.float32), meta


def multi_scale_flip_aug(
    img_bgr: np.ndarray,
    scales=((2048, 1024),),
    flip: bool = False,
    **preprocess_kw,
):
    """MultiScaleFlipAug general branches (reference test_aug.py:8-41).

    One preprocessed variant per (scale, flip) combination.  Two reference
    quirks preserved: ``flip=True`` tests ONLY the flipped copy
    (test_aug.py:21-22 replaces ``[False, True]`` with ``[True]``), and a
    numeric scale entry is a resize *ratio* (``img_scale=[1]`` = original
    size, :15-16).  The shipped configs use the single-scale no-flip branch
    (configs/cityscapes/r50_fpn_slotvps.py:149-150), which degenerates to
    one plain :func:`preprocess` call.

    Returns a list of ``(img [1, H, W, 3], meta)``; each meta carries
    ``scale`` and ``flip`` so a consumer can un-flip its outputs.
    """
    h, w = img_bgr.shape[:2]
    variants = []
    flips = [True] if flip else [False]
    for scale in scales:
        if isinstance(scale, (int, float)):
            scale = (int(w * scale + 0.5), int(h * scale + 0.5))
        for fl in flips:
            src = img_bgr[:, ::-1] if fl else img_bgr
            arr, meta = preprocess(np.ascontiguousarray(src),
                                   scale=tuple(scale), **preprocess_kw)
            meta["scale"] = tuple(scale)
            meta["flip"] = fl
            variants.append((arr, meta))
    return variants
