"""Panoptic segment-id <-> RGB color utilities.

Standalone replacements for ``panopticapi.utils`` (not vendored in this
environment): ``rgb2id``/``id2rgb`` use the COCO panoptic convention
``id = R + 256*G + 256^2*B``, and :class:`IdGenerator` assigns one distinct
color per (category, instance) pair.

The reference calls a patched two-argument ``IdGenerator.get_color(sem, seq)``
(reference tools/dataset/cityscapes_vps.py:49,56,175 — their "fixed version
... to be used in multi-threading env").  Ours is deterministic: a thing
instance's color is derived from the category base color and the per-category
sequence index by a fixed probing schedule, so repeated runs produce
byte-identical ``pan_pred/*.png``.  VPQ only requires segment ids to be
distinct and temporally consistent, which this guarantees.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def rgb2id(color: np.ndarray) -> np.ndarray:
    """[..., 3] uint8/int RGB -> [...] uint32 segment id."""
    color = np.asarray(color)
    if color.dtype == np.uint8:
        color = color.astype(np.uint32)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


def id2rgb(id_map: np.ndarray) -> np.ndarray:
    """[...] int segment id -> [..., 3] uint8 RGB."""
    id_map = np.asarray(id_map)
    rgb = np.zeros(id_map.shape + (3,), dtype=np.uint8)
    rem = id_map.astype(np.uint32)
    for i in range(3):
        rgb[..., i] = rem % 256
        rem = rem // 256
    return rgb


class IdGenerator:
    """Deterministic per-(category, instance) color assignment.

    ``categories`` is a dict id -> {'id', 'isthing', 'color', ...} (the COCO
    panoptic ``categories`` records).  Stuff categories always map to their
    base color; thing instances get distinct colors near the base color.
    """

    # fixed pseudo-random-looking but deterministic 3-vector steps
    _STEPS = np.array(
        [
            [7, -13, 29],
            [-17, 23, -5],
            [11, 31, -19],
            [-29, -7, 13],
            [19, -23, -31],
            [23, 5, 17],
            [-11, 13, 37],
            [37, -19, 7],
        ],
        dtype=np.int64,
    )

    def __init__(self, categories: Dict[int, dict]):
        self.categories = categories
        self.taken_colors = {(0, 0, 0)}
        for cat in categories.values():
            if not cat["isthing"]:
                self.taken_colors.add(tuple(cat["color"]))

    def _probe(self, base: np.ndarray, seq_id: int) -> tuple:
        # deterministic probing: walk outward from the base color
        for attempt in range(4096):
            k = seq_id + attempt
            step = self._STEPS[k % len(self._STEPS)] * (1 + k // len(self._STEPS))
            cand = tuple(int(v) for v in np.clip(base + step, 0, 255))
            if cand not in self.taken_colors:
                return cand
        raise RuntimeError("could not find a free color")

    def get_color(self, cat_id: int, seq_id: int = -1) -> tuple:
        """Color for instance ``seq_id`` of category ``cat_id``.

        ``seq_id < 0`` (stuff) returns the category base color.
        """
        cat = self.categories[int(cat_id)]
        base = np.asarray(cat["color"], dtype=np.int64)
        if seq_id < 0 or not cat["isthing"]:
            return tuple(int(v) for v in base)
        if seq_id == 0 and tuple(int(v) for v in base) not in self.taken_colors:
            color = tuple(int(v) for v in base)
        else:
            color = self._probe(base, int(seq_id))
        self.taken_colors.add(color)
        return color


# Cityscapes 19-class palette in the *eval order* used by the reference GT
# jsons (panoptic_gt_val_city_vps.json): stuff 0..10, things 11..18.
CITYSCAPES_CATEGORIES: Sequence[dict] = [
    {"id": 0, "name": "road", "isthing": 0, "color": [128, 64, 128]},
    {"id": 1, "name": "sidewalk", "isthing": 0, "color": [244, 35, 232]},
    {"id": 2, "name": "building", "isthing": 0, "color": [70, 70, 70]},
    {"id": 3, "name": "wall", "isthing": 0, "color": [102, 102, 156]},
    {"id": 4, "name": "fence", "isthing": 0, "color": [190, 153, 153]},
    {"id": 5, "name": "pole", "isthing": 0, "color": [153, 153, 153]},
    {"id": 6, "name": "traffic light", "isthing": 0, "color": [250, 170, 30]},
    {"id": 7, "name": "traffic sign", "isthing": 0, "color": [220, 220, 0]},
    {"id": 8, "name": "vegetation", "isthing": 0, "color": [107, 142, 35]},
    {"id": 9, "name": "terrain", "isthing": 0, "color": [152, 251, 152]},
    {"id": 10, "name": "sky", "isthing": 0, "color": [70, 130, 180]},
    {"id": 11, "name": "person", "isthing": 1, "color": [220, 20, 60]},
    {"id": 12, "name": "rider", "isthing": 1, "color": [255, 0, 0]},
    {"id": 13, "name": "car", "isthing": 1, "color": [0, 0, 142]},
    {"id": 14, "name": "truck", "isthing": 1, "color": [0, 0, 70]},
    {"id": 15, "name": "bus", "isthing": 1, "color": [0, 60, 100]},
    {"id": 16, "name": "train", "isthing": 1, "color": [0, 80, 100]},
    {"id": 17, "name": "motorcycle", "isthing": 1, "color": [0, 0, 230]},
    {"id": 18, "name": "bicycle", "isthing": 1, "color": [119, 11, 32]},
]
