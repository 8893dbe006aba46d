"""Train-time data transforms — the reference's released train pipeline
(the port's copy of ``slotvps_tpu/data/transforms.py``, numpy and cv2
only; ``bbox_overlaps`` is ``eval/detection.py``'s).

Reference pipeline (configs/cityscapes/r50_fpn_slotvps.py:123-146):
  Resize(img_scale=(2048,1024), keep_ratio, ratio_range=(0.8,1.5)) ->
  RandomFlip(0.5) -> Normalize -> RandomCrop(800,1600) -> Pad(/32) ->
  SegResizeFlipCropPadRescale([1, 0.25]) -> FixedImageRandomShift

Each transform is a pure numpy/cv2 function mirroring the reference's
semantics (mmdet/datasets/pipelines/transforms.py: Resize :15, RandomFlip
:704, RandomCrop :906, Pad :780, SegResizeFlipCropPadRescale :1049,
FixedImageRandomShift :247, PhotoMetricDistortion :1201).  The driver
``apply_train_pipeline`` reproduces the order and the joint handling of the
current frame, reference frame(s), boxes, masks, and semantic maps.

One deliberate divergence: the reference pads the semantic map with 0
(mmcv.impad default), leaking class-0 labels into padded rows; we pad with
the ignore label 255 (only reachable when the crop is not /32-aligned —
never with the default (800, 1600) crop).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from slotvps_tpu_torch.eval.detection import bbox_overlaps

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


@dataclasses.dataclass
class TrainAugConfig:
    """Knobs of the reference train pipeline (r50_fpn_slotvps.py:123-146)."""

    img_scale: Tuple[int, int] = (2048, 1024)   # (w, h) budget
    ratio_range: Tuple[float, float] = (0.8, 1.5)
    flip_ratio: float = 0.5
    crop_size: Tuple[int, int] = (800, 1600)    # (h, w)
    size_divisor: int = 32
    seg_scale: float = 0.25
    shift_padding: int = 50
    photometric: bool = False                   # not in the released config
    mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    std: Tuple[float, float, float] = (58.395, 57.12, 57.375)
    to_rgb: bool = True
    ignore_label: int = 255


@dataclasses.dataclass
class FrameGT:
    """Per-frame ground truth carried through the pipeline."""

    bboxes: np.ndarray            # [N, 4] float32 x1y1x2y2
    labels: np.ndarray            # [N] int64 (1-based thing class)
    obj_ids: np.ndarray           # [N] int64 track/instance ids
    masks: List[np.ndarray]       # N binary [H, W] uint8
    semantic: Optional[np.ndarray] = None  # [H, W] uint8/int label map

    def select(self, keep: np.ndarray) -> "FrameGT":
        idx = np.where(keep)[0]
        return FrameGT(
            bboxes=self.bboxes[keep],
            labels=self.labels[keep],
            obj_ids=self.obj_ids[keep],
            masks=[self.masks[i] for i in idx],
            semantic=self.semantic,
        )


def rescale_factor(h: int, w: int, scale: Tuple[int, int]) -> float:
    """mmcv.imrescale tuple semantics: scale bounds the (long, short) edges
    regardless of tuple order."""
    long_edge, short_edge = max(scale), min(scale)
    return min(long_edge / max(h, w), short_edge / min(h, w))


def imrescale(img: np.ndarray, scale, interpolation="bilinear"):
    """mmcv.imrescale: float scale factor or (edge, edge) tuple; new size is
    ``int(dim * f + 0.5)``.  Returns (resized, f)."""
    h, w = img.shape[:2]
    f = scale if isinstance(scale, (int, float)) \
        else rescale_factor(h, w, scale)
    new_w, new_h = int(w * f + 0.5), int(h * f + 0.5)
    interp = {"bilinear": cv2.INTER_LINEAR,
              "nearest": cv2.INTER_NEAREST}[interpolation]
    return cv2.resize(img, (new_w, new_h), interpolation=interp), f


def bbox_flip(bboxes: np.ndarray, width: int) -> np.ndarray:
    """mmcv horizontal bbox flip: x' = w - x - 1."""
    out = bboxes.copy()
    out[:, 0] = width - bboxes[:, 2] - 1
    out[:, 2] = width - bboxes[:, 0] - 1
    return out


def photometric_distortion(img_bgr: np.ndarray, rng,
                           ref_bgr: np.ndarray = None,
                           brightness_delta=32,
                           contrast_range=(0.5, 1.5),
                           saturation_range=(0.5, 1.5),
                           hue_delta=18,
                           no_swap_channel=False,
                           convert_uint8=True):
    """PhotoMetricDistortion (reference transforms.py:1201-1385): random
    brightness / contrast (before or after HSV) / saturation / hue /
    channel-swap on the unnormalized BGR image, each with p=0.5.

    Matches the reference's float pipeline: the image stays float32 through
    the BGR<->HSV round trip (cv2 CV_32F: H in [0, 360), S in [0, 1]) with
    no intermediate uint8 quantization; hue wraps at 360 by a single
    +-360 correction.  When ``ref_bgr`` is given the SAME random draws are
    applied to it (the reference applies identical deltas to 'ref_img');
    returns (img, ref) then, else img alone.
    """
    imgs = [img_bgr.astype(np.float32)]
    if ref_bgr is not None:
        imgs.append(ref_bgr.astype(np.float32))
    if rng.integers(2):
        delta = rng.uniform(-brightness_delta, brightness_delta)
        imgs = [im + delta for im in imgs]
    mode = rng.integers(2)
    if mode == 1 and rng.integers(2):
        alpha = rng.uniform(*contrast_range)
        imgs = [im * alpha for im in imgs]
    imgs = [cv2.cvtColor(im, cv2.COLOR_BGR2HSV) for im in imgs]
    if rng.integers(2):
        satu = rng.uniform(*saturation_range)
        for im in imgs:
            im[..., 1] *= satu
    if rng.integers(2):
        hue = rng.uniform(-hue_delta, hue_delta)
        for im in imgs:
            im[..., 0] += hue
            im[..., 0][im[..., 0] > 360] -= 360
            im[..., 0][im[..., 0] < 0] += 360
    imgs = [cv2.cvtColor(im, cv2.COLOR_HSV2BGR) for im in imgs]
    if mode == 0 and rng.integers(2):
        alpha = rng.uniform(*contrast_range)
        imgs = [im * alpha for im in imgs]
    if not no_swap_channel and rng.integers(2):
        perm = rng.permutation(3)
        imgs = [im[..., perm] for im in imgs]
    if convert_uint8:
        imgs = [im.astype(np.uint8) for im in imgs]
    return imgs[0] if ref_bgr is None else (imgs[0], imgs[1])


def _resize_frame(img, gt: FrameGT, f: float, shape_after):
    img2, _ = imrescale(img, f)
    bboxes = gt.bboxes * f
    h2, w2 = img2.shape[:2]
    bboxes[:, 0::2] = np.clip(bboxes[:, 0::2], 0, w2 - 1)
    bboxes[:, 1::2] = np.clip(bboxes[:, 1::2], 0, h2 - 1)
    masks = [imrescale(m, f, "nearest")[0] for m in gt.masks]
    return img2, dataclasses.replace(gt, bboxes=bboxes, masks=masks)


def _crop_frame(img, gt: FrameGT, coords) -> Optional[Tuple]:
    y1, y2, x1, x2 = coords
    img2 = img[y1:y2, x1:x2]
    h2, w2 = img2.shape[:2]
    bboxes = gt.bboxes - np.array([x1, y1, x1, y1], np.float32)
    bboxes[:, 0::2] = np.clip(bboxes[:, 0::2], 0, w2 - 1)
    bboxes[:, 1::2] = np.clip(bboxes[:, 1::2], 0, h2 - 1)
    valid = (bboxes[:, 2] > bboxes[:, 0]) & (bboxes[:, 3] > bboxes[:, 1])
    if not valid.any():
        return None
    gt2 = dataclasses.replace(gt, bboxes=bboxes,
                              masks=[m[y1:y2, x1:x2] for m in gt.masks])
    gt2 = gt2.select(valid)
    return img2, gt2


def _pad(img, divisor, value=0.0):
    h, w = img.shape[:2]
    ph = (divisor - h % divisor) % divisor
    pw = (divisor - w % divisor) % divisor
    if not (ph or pw):
        return img
    widths = ((0, ph), (0, pw)) + ((0, 0),) * (img.ndim - 2)
    return np.pad(img, widths, constant_values=value)


def _replay_on_seg(seg, f, flip, crop_coords, pad_shape, seg_scale,
                   ignore_label):
    """SegResizeFlipCropPadRescale (reference transforms.py:1049-1141):
    replay resize(nearest)/flip/crop/pad on the label map, then produce the
    1/4-scale copy."""
    seg2, _ = imrescale(seg, f, "nearest")
    if flip:
        seg2 = seg2[:, ::-1]
    y1, y2, x1, x2 = crop_coords
    seg2 = seg2[y1:y2, x1:x2]
    if seg2.shape[:2] != tuple(pad_shape):
        out = np.full(pad_shape, ignore_label, seg2.dtype)
        out[:seg2.shape[0], :seg2.shape[1]] = seg2
        seg2 = out
    seg_nx, _ = imrescale(seg2, seg_scale, "nearest")
    return np.ascontiguousarray(seg2), np.ascontiguousarray(seg_nx)


def fixed_image_random_shift(img, gt: FrameGT, seg, rng,
                             padding=50) -> Optional[Tuple]:
    """FixedImageRandomShift (reference transforms.py:247-412): turn a
    static copy into a pseudo-video frame by cropping a shifted window and
    rescaling it back to the original size; boxes/masks/seg follow."""
    h, w = img.shape[:2]
    xshift = int(padding * rng.random()) + 1
    xshift *= 1 if rng.standard_normal() > 0 else -1
    yshift = int(padding * rng.random()) + 1
    yshift *= 1 if rng.standard_normal() > 0 else -1

    ymin = int(max(0, -yshift))
    ymax = int(min(h, h - yshift))
    xmin = int(max(0, -xshift))
    xmax = int(min(w, w - xshift))
    ratio = max(w // h, 1)
    xmax = xmin + (ymax - ymin) * ratio
    if xmax > w:
        xmax = w
        if (xmax - xmin) % 2 != 0:
            xmax -= 1
        ymax = ymin + (xmax - xmin) // ratio

    crop = img[ymin:ymax, xmin:xmax]
    ch, cw = crop.shape[:2]
    img2, f = imrescale(crop, (h, w))

    bboxes = gt.bboxes - np.array([xmin, ymin, xmin, ymin], np.float32)
    bboxes[:, 0::2] = np.clip(bboxes[:, 0::2], 0, cw - 1)
    bboxes[:, 1::2] = np.clip(bboxes[:, 1::2], 0, ch - 1)
    valid = (bboxes[:, 2] > bboxes[:, 0]) & (bboxes[:, 3] > bboxes[:, 1])
    if not valid.any():
        return None
    bboxes = bboxes * f
    bboxes[:, 0::2] = np.clip(bboxes[:, 0::2], 0, img2.shape[1] - 1)
    bboxes[:, 1::2] = np.clip(bboxes[:, 1::2], 0, img2.shape[0] - 1)
    gt2 = dataclasses.replace(
        gt, masks=[m[ymin:ymax, xmin:xmax] for m in gt.masks])
    gt2 = gt2.select(valid)
    gt2 = dataclasses.replace(
        gt2, bboxes=bboxes[valid],
        masks=[imrescale(m, f, "nearest")[0] for m in gt2.masks])

    seg2 = None
    if seg is not None:
        seg2, _ = imrescale(seg[ymin:ymax, xmin:xmax], f, "nearest")
    # the rescaled window can be 1px off the original size (mmcv rounding);
    # clip/pad to keep the pair stackable
    if img2.shape[:2] != (h, w):
        img2 = _pad(img2[:h, :w], max(h, w))[:h, :w]
        if seg2 is not None:
            out = np.full((h, w), 255, seg2.dtype)
            s = seg2[:h, :w]
            out[:s.shape[0], :s.shape[1]] = s
            seg2 = out
        gt2 = dataclasses.replace(
            gt2, masks=[_pad(m[:h, :w], max(h, w))[:h, :w]
                        for m in gt2.masks])
    return img2, gt2, seg2


def expand(img: np.ndarray, gt: FrameGT, rng,
           mean=(0, 0, 0), to_rgb=True, ratio_range=(1, 4)):
    """Expand (reference transforms.py:1397-1449): with p=1/2, place the
    image on a mean-filled canvas of ratio x its size at a random corner
    offset; boxes translate, masks zero-pad.  ``mean`` is reversed when
    ``to_rgb`` (the canvas fills the BGR image with the config's RGB mean
    flipped, :1410-1413)."""
    if rng.integers(2):
        return img, gt
    fill = tuple(mean[::-1] if to_rgb else mean)
    h, w, c = img.shape
    ratio = rng.uniform(*ratio_range)
    eh, ew = int(h * ratio), int(w * ratio)
    left = int(rng.uniform(0, ew - w))
    top = int(rng.uniform(0, eh - h))
    canvas = np.full((eh, ew, c), fill).astype(img.dtype)
    canvas[top:top + h, left:left + w] = img
    bboxes = gt.bboxes + np.tile((left, top), 2).astype(gt.bboxes.dtype)
    masks = []
    for m in gt.masks:
        mm = np.zeros((eh, ew), m.dtype)
        mm[top:top + h, left:left + w] = m
        masks.append(mm)
    return canvas, dataclasses.replace(gt, bboxes=bboxes, masks=masks)


def min_iou_random_crop(img: np.ndarray, gt: FrameGT, rng,
                        min_ious=(0.1, 0.3, 0.5, 0.7, 0.9),
                        min_crop_size=0.3):
    """MinIoURandomCrop (reference transforms.py:1452-1534): sample a crop
    whose IoU with every GT box meets a randomly drawn threshold (mode 1 =
    return unchanged); keep only boxes whose centers fall inside, clip
    them, and crop the masks.

    One deliberate divergence: the reference's ``random.uniform(w - new_w)``
    (:1486-1487) is numpy ``uniform(low=w-new_w, high=1.0)`` — an upstream
    mmdet quirk that pins the crop corner between 1 and w-new_w; we sample
    the intended ``uniform(0, w-new_w)``."""
    h, w = img.shape[:2]
    sample_mode = (1, *min_ious, 0)
    while True:
        mode = sample_mode[rng.integers(len(sample_mode))]
        if mode == 1:
            return img, gt
        min_iou = mode
        for _ in range(50):
            new_w = rng.uniform(min_crop_size * w, w)
            new_h = rng.uniform(min_crop_size * h, h)
            if new_h / new_w < 0.5 or new_h / new_w > 2:
                continue
            left = rng.uniform(0, w - new_w)
            top = rng.uniform(0, h - new_h)
            patch = np.array((int(left), int(top), int(left + new_w),
                              int(top + new_h)))
            overlaps = bbox_overlaps(patch.reshape(-1, 4),
                                     gt.bboxes.reshape(-1, 4)).reshape(-1)
            if overlaps.size and overlaps.min() < min_iou:
                continue
            center = (gt.bboxes[:, :2] + gt.bboxes[:, 2:]) / 2
            keep = ((center[:, 0] > patch[0]) & (center[:, 1] > patch[1])
                    & (center[:, 0] < patch[2]) & (center[:, 1] < patch[3]))
            if not keep.any():
                continue
            gt2 = gt.select(keep)
            bboxes = gt2.bboxes.copy()
            bboxes[:, 2:] = bboxes[:, 2:].clip(max=patch[2:])
            bboxes[:, :2] = bboxes[:, :2].clip(min=patch[:2])
            bboxes -= np.tile(patch[:2], 2)
            img2 = img[patch[1]:patch[3], patch[0]:patch[2]]
            masks = [m[patch[1]:patch[3], patch[0]:patch[2]]
                     for m in gt2.masks]
            return img2, dataclasses.replace(gt2, bboxes=bboxes,
                                             masks=masks)


# severity constants of the public imagecorruptions package (the reference
# Corrupt transform, transforms.py:1537-1551, delegates to it wholesale;
# its remaining corruptions need scipy/scikit-image and are out of scope)
_CORRUPTIONS = {
    "gaussian_noise": ([0.08, 0.12, 0.18, 0.26, 0.38],
                       lambda x, c, r: x + r.normal(size=x.shape, scale=c)),
    "shot_noise": ([60, 25, 12, 5, 3],
                   lambda x, c, r: r.poisson(x * c) / c),
    "impulse_noise": ([0.03, 0.06, 0.09, 0.17, 0.27], None),
    "speckle_noise": ([0.15, 0.2, 0.35, 0.45, 0.6],
                      lambda x, c, r: x * (1 + r.normal(size=x.shape,
                                                        scale=c))),
    "contrast": ([0.4, 0.3, 0.2, 0.1, 0.05],
                 lambda x, c, r: (x - x.mean(axis=(0, 1), keepdims=True))
                 * c + x.mean(axis=(0, 1), keepdims=True)),
    "brightness": ([0.1, 0.2, 0.3, 0.4, 0.5],
                   lambda x, c, r: x + c),
    "gaussian_blur": ([1, 2, 3, 4, 6], "blur"),
    "pixelate": ([0.6, 0.5, 0.4, 0.3, 0.25], "pixelate"),
}


def corrupt_image(img: np.ndarray, corruption: str, severity: int = 1,
                  rng=None) -> np.ndarray:
    """Corrupt (reference transforms.py:1537-1551) without the external
    ``imagecorruptions`` dependency: the numpy/cv2-implementable subset
    with that package's severity constants.  img: uint8 HxWx3."""
    if corruption not in _CORRUPTIONS:
        raise ValueError(
            f"unsupported corruption '{corruption}'; available: "
            f"{sorted(_CORRUPTIONS)}")
    rng = rng or np.random.default_rng(0)
    c_tab, fn = _CORRUPTIONS[corruption]
    c = c_tab[severity - 1]
    x = img.astype(np.float32) / 255.0
    if fn == "blur":
        out = cv2.GaussianBlur(x, (0, 0), sigmaX=c)
    elif fn == "pixelate":
        h, w = img.shape[:2]
        small = cv2.resize(img, (int(w * c), int(h * c)),
                           interpolation=cv2.INTER_AREA)
        return cv2.resize(small, (w, h), interpolation=cv2.INTER_NEAREST)
    elif corruption == "impulse_noise":
        out = x.copy()
        flip = rng.random(x.shape[:2]) < c
        salt = rng.random(x.shape[:2]) < 0.5
        out[flip & salt] = 1.0
        out[flip & ~salt] = 0.0
    else:
        out = fn(x, c, rng)
    return np.clip(out * 255.0, 0, 255).astype(np.uint8)


def gt_pids_from_obj_ids(gt_obj_ids: Sequence[int],
                         ref_obj_ids: Sequence[int]) -> np.ndarray:
    """Track-id labels: 1-based index into the reference frame's surviving
    instances, 0 = new object (reference cityscapes_vps.py:246-248)."""
    ref = list(ref_obj_ids)
    return np.asarray(
        [ref.index(i) + 1 if i in ref else 0 for i in gt_obj_ids], np.int64)


def apply_train_pipeline(
    img: np.ndarray,                 # current frame, uint8 BGR
    gt: FrameGT,                     # with .semantic set (label map)
    ref_img: Optional[np.ndarray],   # reference frame or None (= static)
    ref_gt: Optional[FrameGT],
    aug: TrainAugConfig,
    rng: np.random.Generator,
    pseudo_video: bool = False,      # True = ref is a copy; shift it
) -> Optional[Dict]:
    """Run the full reference train pipeline on one (cur, ref) pair.

    Returns None when a crop/shift leaves a frame with no GT (the reference
    resamples another index, datasets/custom.py:138-146)."""
    if ref_img is None:
        ref_img, ref_gt = img, gt
        pseudo_video = True

    if aug.photometric:
        if pseudo_video:
            img = photometric_distortion(img, rng)
            ref_img = img
        else:
            img, ref_img = photometric_distortion(img, rng, ref_img)

    # 1. Resize: one random ratio shared by both frames
    ratio = rng.random() * (aug.ratio_range[1] - aug.ratio_range[0]) \
        + aug.ratio_range[0]
    scale = (int(aug.img_scale[0] * ratio), int(aug.img_scale[1] * ratio))
    f = rescale_factor(img.shape[0], img.shape[1], scale)
    img, gt = _resize_frame(img, gt, f, None)
    ref_img, ref_gt = _resize_frame(ref_img, ref_gt, f, None)

    # 2. RandomFlip: one coin shared by both frames
    flip = rng.random() < aug.flip_ratio
    if flip:
        w_now = img.shape[1]
        img = img[:, ::-1]
        ref_img = ref_img[:, ::-1]
        gt = dataclasses.replace(gt, bboxes=bbox_flip(gt.bboxes, w_now),
                                 masks=[m[:, ::-1] for m in gt.masks])
        ref_gt = dataclasses.replace(
            ref_gt, bboxes=bbox_flip(ref_gt.bboxes, w_now),
            masks=[m[:, ::-1] for m in ref_gt.masks])

    # 3. Normalize
    mean = np.asarray(aug.mean, np.float32)
    std = np.asarray(aug.std, np.float32)

    def norm(im):
        im = im.astype(np.float32)
        if aug.to_rgb:
            im = im[..., ::-1]
        return (im - mean) / std

    img = norm(img)
    ref_img = norm(ref_img)

    # 4. RandomCrop: one offset shared by both frames
    ch, cw = aug.crop_size
    margin_h = max(img.shape[0] - ch, 0)
    margin_w = max(img.shape[1] - cw, 0)
    oy = int(rng.integers(0, margin_h + 1))
    ox = int(rng.integers(0, margin_w + 1))
    coords = (oy, oy + ch, ox, ox + cw)
    cur = _crop_frame(img, gt, coords)
    ref = _crop_frame(ref_img, ref_gt, coords)
    if cur is None or ref is None:
        return None
    img, gt = cur
    ref_img, ref_gt = ref

    # 5. Pad to /32
    img = _pad(img, aug.size_divisor)
    ref_img = _pad(ref_img, aug.size_divisor)
    pad_shape = img.shape[:2]
    gt = dataclasses.replace(
        gt, masks=[_pad(m, aug.size_divisor) for m in gt.masks])
    ref_gt = dataclasses.replace(
        ref_gt, masks=[_pad(m, aug.size_divisor) for m in ref_gt.masks])

    # 6. Replay on the semantic map + 1/4-scale copy
    seg = seg_nx = None
    if gt.semantic is not None:
        seg, seg_nx = _replay_on_seg(gt.semantic, f, flip, coords,
                                     pad_shape, aug.seg_scale,
                                     aug.ignore_label)
    ref_seg = None
    if ref_gt.semantic is not None:
        ref_seg, _ = _replay_on_seg(ref_gt.semantic, f, flip, coords,
                                    pad_shape, aug.seg_scale,
                                    aug.ignore_label)

    # 7. Pseudo-video: shift the reference copy
    if pseudo_video:
        shifted = fixed_image_random_shift(ref_img, ref_gt, ref_seg, rng,
                                           padding=aug.shift_padding)
        if shifted is None:
            return None
        ref_img, ref_gt, ref_seg = shifted

    gt_pids = gt_pids_from_obj_ids(gt.obj_ids, ref_gt.obj_ids)

    return dict(
        img=np.ascontiguousarray(img),
        ref_img=np.ascontiguousarray(ref_img),
        gt=gt, ref_gt=ref_gt, gt_pids=gt_pids,
        gt_semantic_seg=seg, gt_semantic_seg_nx=seg_nx,
        ref_semantic_seg=ref_seg,
        flip=flip, scale_factor=f, crop_coords=coords,
    )
