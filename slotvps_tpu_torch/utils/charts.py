"""Metric chart utilities.

Reference parity: tools/utils.py:14-104 (``draw_line_chart``,
``draw_line_charts``, ``save_color_map``) — the optional per-video /
per-category VPQ figures behind ``--draw_line_charts``
(reference tools/eval_vpq.py:523-538).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def draw_line_chart(
    x: Sequence,
    ys: Sequence[Sequence[float]],
    labels: Sequence[str],
    x_label: str = "x",
    y_label: str = "y",
    rotation: float = 0,
    fontsize: float = 10,
    title: str = "",
    save_path: Optional[str] = None,
):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(16, 9))
    for y, label in zip(ys, labels):
        ax.plot(range(len(x)), y, marker="o", markersize=2, label=label)
    ax.set_xticks(range(len(x)))
    ax.set_xticklabels(x, rotation=rotation, fontsize=fontsize)
    ax.set_xlabel(x_label)
    ax.set_ylabel(y_label)
    ax.set_title(title)
    ax.legend(fontsize=fontsize)
    ax.grid(True, alpha=0.3)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def draw_line_charts(x, ys_groups, labels_groups, dpi, fontsize, output_dir):
    """Per-video metric figures (reference tools/utils.py:35-91)."""
    import os.path as osp

    names = ["vpq", "vsq", "vrq", "errp"]
    for ys, labels, name in zip(ys_groups, labels_groups, names):
        draw_line_chart(x, ys, labels, x_label="video", y_label=name,
                        fontsize=fontsize, title=f"{name}_per_video",
                        save_path=osp.join(output_dir, f"{name}_fig.png"))


def save_color_map(img: np.ndarray, path: str, apply_color_map: bool = True,
                   clip: bool = True):
    """Save a label map as a colorized PNG (reference tools/utils.py:93)."""
    from PIL import Image

    img = np.asarray(img)
    if clip:
        img = np.clip(img, 0, 255)
    if apply_color_map and img.ndim == 2:
        from slotvps_tpu_torch.eval.color import CITYSCAPES_CATEGORIES

        palette = np.zeros((256, 3), np.uint8)
        for cat in CITYSCAPES_CATEGORIES:
            palette[cat["id"]] = cat["color"]
        img = palette[img.astype(np.uint8)]
    Image.fromarray(img.astype(np.uint8)).save(path)
