"""Image-level Panoptic Quality (counterpart of ``slotvps_tpu/eval/pq.py``).

Reference parity: tools/dataset/base_dataset.py:104-235 (``evaluate_panoptic``
/ ``pq_compute``, the UPSNet-lineage alternate metric path used for VIPER).
Image PQ is exactly tube PQ with a window of one frame, so this delegates to
the VPQ machinery of :mod:`slotvps_tpu_torch.eval.vpq`.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from slotvps_tpu_torch.eval.vpq import (_METRICS, PQStat,
                                        vpq_compute_single_core)


def pq_compute(
    gt_jsons: Sequence[dict],
    pred_jsons: Sequence[dict],
    gt_pans: Sequence[np.ndarray],
    pred_pans: Sequence[np.ndarray],
    categories: Dict[int, dict],
    output_dir: Optional[str] = None,
) -> dict:
    """Standard single-frame PQ over a list of frames; with ``output_dir``
    also writes ``pq.txt``."""
    pq_stat = PQStat()
    for gt_json, pred_json, gt_pan, pred_pan in zip(
            gt_jsons, pred_jsons, gt_pans, pred_pans):
        pq_stat += vpq_compute_single_core(
            [(gt_json, pred_json, gt_pan, pred_pan, None)],
            categories, nframes=1)

    results = {}
    for name, isthing in _METRICS:
        results[name], per_class = pq_stat.pq_average(categories, isthing)
        if name == "All":
            results["per_class"] = per_class

    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "pq.txt"), "w") as f:
            f.write("{:10s}| {:>5s}  {:>5s}  {:>5s} {:>5s}\n".format(
                "", "PQ", "SQ", "RQ", "N"))
            for name, _ in _METRICS:
                r = results[name]
                f.write("{:10s}| {:5.1f}  {:5.1f}  {:5.1f} {:5d}\n".format(
                    name, 100 * r["pq"], 100 * r["sq"], 100 * r["rq"],
                    r["n"]))
    return results
