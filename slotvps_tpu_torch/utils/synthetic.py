"""Synthetic multi-object scenes (the port's copy of the numpy part of
``slotvps_tpu/utils/synthetic.py``).

A scene of colored things on a layered stuff background, rendered at any
resolution, its translating video, and a TrainBatch for one (frame, ref)
pair of it: the training data of ``chip_smoke.py``'s train phase and of
the CPU tests, with no dataset on disk.  The JAX package's overfit recipe
(weight caps, grouped optimizer) is not ported.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

# Cityscapes 19-class ids: stuff 0..10, things 11..18
_STUFF_LAYERS = (
    (10, 0.00, 0.25, (70, 130, 180)),   # sky
    (2, 0.25, 0.55, (70, 70, 70)),      # building
    (0, 0.55, 1.00, (128, 64, 128)),    # road
)
_THING_CLASSES = (11, 12, 13, 14, 15, 16, 17, 18)

# the data pipeline's normalization (data/pipeline.py; reference
# img_norm_cfg) — images render as BGR uint8 like cv2.imread output
_MEAN = np.asarray((123.675, 116.28, 103.53), np.float32)
_STD = np.asarray((58.395, 57.12, 57.375), np.float32)


class Scene(NamedTuple):
    img: np.ndarray        # [H, W, 3] uint8 (BGR)
    masks: np.ndarray      # [G, H, W] uint8 — thing masks then stuff masks
    labels: np.ndarray     # [G] int32
    is_thing: np.ndarray   # [G] bool
    semantic: np.ndarray   # [H, W] uint8 (19-class ids)


def norm_img(img: np.ndarray) -> np.ndarray:
    """BGR uint8 -> normalized RGB float32 [1, H, W, 3] (the exact
    transform of data/pipeline.preprocess)."""
    return ((img[..., ::-1].astype(np.float32) - _MEAN) / _STD)[None]


def make_scene(h: int, w: int, n_things: int = 12, seed: int = 0) -> Scene:
    """Render a layered stuff background + ``n_things`` colored ellipses
    placed on a jittered grid (non-overlapping by construction)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.uint8)
    semantic = np.zeros((h, w), np.uint8)
    stuff_masks = []
    for cls, top, bot, color in _STUFF_LAYERS:
        m = np.zeros((h, w), np.uint8)
        m[int(top * h):int(bot * h)] = 1
        img[m > 0] = color
        semantic[m > 0] = cls
        stuff_masks.append(m)

    cols = int(np.ceil(np.sqrt(n_things * w / h)))
    rows = int(np.ceil(n_things / cols))
    ch, cw = h // rows, w // cols
    yy, xx = np.mgrid[0:h, 0:w]
    thing_masks, thing_labels = [], []
    for i in range(n_things):
        r, c = divmod(i, cols)
        ry = ch * 0.18 * rng.uniform(0.7, 1.3)
        rx = cw * 0.22 * rng.uniform(0.7, 1.3)
        cy = r * ch + ch / 2 + rng.uniform(-0.12, 0.12) * ch
        cx = c * cw + cw / 2 + rng.uniform(-0.12, 0.12) * cw
        m = ((((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1.0) \
            .astype(np.uint8)
        cls = _THING_CLASSES[i % len(_THING_CLASSES)]
        # distinct saturated color per instance
        hue = (i * 360 / n_things) % 360
        color = _hsv_bgr(hue, 0.85, 0.9)
        img[m > 0] = color
        semantic[m > 0] = cls
        thing_masks.append(m)
        thing_labels.append(cls)
    # stuff masks exclude thing pixels (panoptic semantics)
    things_any = np.clip(sum(thing_masks), 0, 1).astype(np.uint8)
    stuff_masks = [m * (1 - things_any) for m in stuff_masks]

    masks = np.stack(thing_masks + stuff_masks)
    labels = np.asarray(thing_labels + [c for c, *_ in _STUFF_LAYERS],
                        np.int32)
    is_thing = np.asarray([True] * n_things + [False] * len(stuff_masks))
    return Scene(img, masks, labels, is_thing, semantic)


def _hsv_bgr(hue: float, s: float, v: float) -> Tuple[int, int, int]:
    c = v * s
    x = c * (1 - abs((hue / 60.0) % 2 - 1))
    m = v - c
    r, g, b = [(c, x, 0), (x, c, 0), (0, c, x),
               (0, x, c), (x, 0, c), (c, 0, x)][int(hue // 60) % 6]
    return (int((b + m) * 255), int((g + m) * 255), int((r + m) * 255))


def scene_frames(scene: Scene, n_frames: int, shift: int = 16
                 ) -> List[np.ndarray]:
    """Video of the scene translating ``shift`` px/frame (wrap-around) —
    normalized [1, H, W, 3] frames ready for extract_features."""
    return [norm_img(np.roll(scene.img, t * shift, axis=1))
            for t in range(n_frames)]


def scene_train_batch(scene: Scene, shift: int = 16, g_cap: int = 20):
    """TrainBatch (CPU tensors) for one (frame, ref) pair of the
    translating scene.

    GT masks/semantic at quarter resolution (TrainBatch contract);
    ``gt_pids`` = 1-based identity for things (the ref frame holds the
    same objects), 0 (new/none) for stuff, matching the reference's
    track-target grammar (cityscapes_vps.py:246-248)."""
    from slotvps_tpu_torch.training.step import make_train_batch

    h, w = scene.img.shape[:2]
    g = len(scene.labels)
    assert g <= g_cap, (g, g_cap)
    q = lambda m: m[::4, ::4].astype(np.float32)

    ref_img = np.roll(scene.img, -shift, axis=1)
    gt_masks = np.zeros((1, g_cap, h // 4, w // 4), np.float32)
    ref_masks = np.zeros((1, g_cap, h // 4, w // 4), np.float32)
    labels = np.zeros((1, g_cap), np.int32)
    valid = np.zeros((1, g_cap), bool)
    pids = np.zeros((1, g_cap), np.int32)
    for i in range(g):
        gt_masks[0, i] = q(scene.masks[i])
        ref_masks[0, i] = q(np.roll(scene.masks[i], -shift, axis=1))
        labels[0, i] = scene.labels[i]
        valid[0, i] = True
        if scene.is_thing[i]:
            pids[0, i] = i + 1
    semantic = scene.semantic[::4, ::4].astype(np.int32)[None]

    return make_train_batch(
        img=norm_img(scene.img), ref_img=norm_img(ref_img),
        gt_labels=labels, gt_masks=gt_masks, gt_valid=valid,
        gt_semantic=semantic, ref_gt_labels=labels, ref_gt_masks=ref_masks,
        ref_gt_valid=valid, gt_pids=pids)
