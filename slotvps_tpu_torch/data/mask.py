"""COCO mask decoding without pycocotools.

The reference decodes training annotations with ``pycocotools.mask``
(reference mmdet/datasets/pipelines/loading.py:224-238: polygons ->
frPyObjects+merge, RLE dicts -> decode).  This module implements the same
formats natively: compressed COCO RLE (char-encoded varints), uncompressed
RLE (count lists), and polygon rasterization.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np


def _rle_from_string(s: bytes) -> List[int]:
    """Decode COCO's char-compressed RLE counts (LEB128-style, signed
    deltas every other count) — the inverse of pycocotools rleFrString."""
    counts = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def decode_rle(rle: dict) -> np.ndarray:
    """RLE dict {'size': [h, w], 'counts': bytes|str|list} -> [h, w] uint8.

    COCO runs are column-major, starting with zeros."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        if isinstance(counts, str):
            counts = counts.encode("ascii")
        counts = _rle_from_string(counts)
    counts = np.asarray(counts, np.int64)
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    mask = np.repeat(vals, counts)
    total = h * w
    if mask.size < total:
        mask = np.pad(mask, (0, total - mask.size))
    return mask[:total].reshape(w, h).T  # column-major


def polygons_to_mask(polygons: Sequence[Sequence[float]], h: int,
                     w: int) -> np.ndarray:
    """Rasterize COCO polygons to a binary mask (merge of all parts)."""
    from PIL import Image, ImageDraw

    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in polygons:
        pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly), 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return np.asarray(img, np.uint8)


def decode_mask(segm: Union[dict, list], h: int, w: int) -> np.ndarray:
    """Any COCO segmentation record -> [h, w] uint8 binary mask."""
    if isinstance(segm, dict):
        return decode_rle(segm)
    return polygons_to_mask(segm, h, w)


def encode_rle(mask: np.ndarray) -> dict:
    """[h, w] binary -> uncompressed RLE (for tests/round trips)."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).T.reshape(-1)  # column-major
    change = np.nonzero(np.diff(flat))[0] + 1
    idx = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(idx).tolist()
    if flat[0] == 1:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}
