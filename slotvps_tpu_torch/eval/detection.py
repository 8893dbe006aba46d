"""Generic detection evaluation: bbox IoU, mean AP, recalls.

The port's copy of ``slotvps_tpu/eval/detection.py``, numpy only, same
names, same behaviour.  Reference parity: mmdet/core/evaluation/
{bbox_overlaps.py:4, mean_ap.py:220 ``eval_map``, recall.py:62
``eval_recalls``, class_names.py} — the train-time detection metrics of the
vendored mmdetection (not exercised by the released Slot-VPS test path,
provided for capability parity).  VOC-style AP with the mmdet '+1' area
convention and 'area'/'11points' modes.  ``data/transforms.py`` takes its
``bbox_overlaps`` from here.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def bbox_overlaps(bboxes1: np.ndarray, bboxes2: np.ndarray,
                  mode: str = "iou") -> np.ndarray:
    """IoU/IoF between [N, 4] and [M, 4] (x1, y1, x2, y2), mmdet '+1'
    convention (reference bbox_overlaps.py:4-40)."""
    assert mode in ("iou", "iof")
    bboxes1 = bboxes1.astype(np.float32)
    bboxes2 = bboxes2.astype(np.float32)
    rows, cols = bboxes1.shape[0], bboxes2.shape[0]
    ious = np.zeros((rows, cols), np.float32)
    if rows * cols == 0:
        return ious
    area1 = (bboxes1[:, 2] - bboxes1[:, 0] + 1) * (
        bboxes1[:, 3] - bboxes1[:, 1] + 1)
    area2 = (bboxes2[:, 2] - bboxes2[:, 0] + 1) * (
        bboxes2[:, 3] - bboxes2[:, 1] + 1)
    for i in range(rows):
        x_start = np.maximum(bboxes1[i, 0], bboxes2[:, 0])
        y_start = np.maximum(bboxes1[i, 1], bboxes2[:, 1])
        x_end = np.minimum(bboxes1[i, 2], bboxes2[:, 2])
        y_end = np.minimum(bboxes1[i, 3], bboxes2[:, 3])
        overlap = np.maximum(x_end - x_start + 1, 0) * np.maximum(
            y_end - y_start + 1, 0)
        union = area1[i] + area2 - overlap if mode == "iou" else area1[i]
        ious[i] = overlap / np.maximum(union, np.finfo(np.float32).eps)
    return ious


def average_precision(recalls: np.ndarray, precisions: np.ndarray,
                      mode: str = "area") -> np.ndarray:
    """AP from recall/precision curves (reference mean_ap.py:9-56)."""
    no_scale = recalls.ndim == 1
    if no_scale:
        recalls = recalls[None]
        precisions = precisions[None]
    num_scales = recalls.shape[0]
    ap = np.zeros(num_scales, np.float32)
    if mode == "area":
        zeros = np.zeros((num_scales, 1), recalls.dtype)
        ones = np.ones((num_scales, 1), recalls.dtype)
        mrec = np.hstack((zeros, recalls, ones))
        mpre = np.hstack((zeros, precisions, zeros))
        for i in range(mpre.shape[1] - 1, 0, -1):
            mpre[:, i - 1] = np.maximum(mpre[:, i - 1], mpre[:, i])
        for i in range(num_scales):
            ind = np.where(mrec[i, 1:] != mrec[i, :-1])[0]
            ap[i] = np.sum(
                (mrec[i, ind + 1] - mrec[i, ind]) * mpre[i, ind + 1])
    elif mode == "11points":
        for i in range(num_scales):
            for thr in np.arange(0, 1 + 1e-3, 0.1):
                precs = precisions[i, recalls[i, :] >= thr]
                ap[i] += precs.max() if precs.size else 0
        ap /= 11
    else:
        raise ValueError(mode)
    return ap[0] if no_scale else ap


def _tpfp_default(det: np.ndarray, gt: np.ndarray, gt_ignore: np.ndarray,
                  iou_thr: float) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy score-ordered TP/FP marking (reference mean_ap.py:59-134,
    single-scale)."""
    num_dets = det.shape[0]
    num_gts = gt.shape[0]
    tp = np.zeros(num_dets, np.float32)
    fp = np.zeros(num_dets, np.float32)
    if num_gts == 0:
        fp[:] = 1
        return tp, fp
    ious = bbox_overlaps(det[:, :4], gt)
    ious_max = ious.max(axis=1) if num_gts else np.zeros(num_dets)
    ious_argmax = ious.argmax(axis=1) if num_gts else np.zeros(num_dets, int)
    sort_inds = np.argsort(-det[:, -1])
    gt_covered = np.zeros(num_gts, bool)
    for i in sort_inds:
        if ious_max[i] >= iou_thr:
            matched = ious_argmax[i]
            if gt_ignore is not None and gt_ignore[matched]:
                continue
            if not gt_covered[matched]:
                gt_covered[matched] = True
                tp[i] = 1
            else:
                fp[i] = 1
        else:
            fp[i] = 1
    return tp, fp


def eval_map(
    det_results: Sequence[Sequence[np.ndarray]],
    gt_bboxes: Sequence[np.ndarray],
    gt_labels: Sequence[np.ndarray],
    iou_thr: float = 0.5,
    mode: str = "area",
) -> Tuple[float, List[dict]]:
    """Mean AP (reference mean_ap.py:220-375, simplified: no per-scale
    ranges, labels are 1-based like mmdet).

    det_results: per image, per class list of [n, 5] (x1 y1 x2 y2 score).
    """
    num_classes = len(det_results[0])
    eval_results = []
    for c in range(num_classes):
        cls_dets, cls_gts = [], []
        for dets, bboxes, labels in zip(det_results, gt_bboxes, gt_labels):
            cls_dets.append(dets[c])
            cls_gts.append(bboxes[labels == c + 1])
        tp_all, fp_all, scores = [], [], []
        num_gts = 0
        for det, gt in zip(cls_dets, cls_gts):
            tp, fp = _tpfp_default(det, gt, None, iou_thr)
            tp_all.append(tp)
            fp_all.append(fp)
            scores.append(det[:, -1])
            num_gts += gt.shape[0]
        scores = np.concatenate(scores)
        tp_all = np.concatenate(tp_all)
        fp_all = np.concatenate(fp_all)
        order = np.argsort(-scores)
        tp_cum = np.cumsum(tp_all[order])
        fp_cum = np.cumsum(fp_all[order])
        eps = np.finfo(np.float32).eps
        recalls = tp_cum / max(num_gts, eps)
        precisions = tp_cum / np.maximum(tp_cum + fp_cum, eps)
        ap = average_precision(recalls, precisions, mode) \
            if len(scores) else 0.0
        eval_results.append({
            "num_gts": num_gts, "num_dets": len(scores),
            "recall": recalls[-1] if len(recalls) else 0.0,
            "precision": precisions[-1] if len(precisions) else 0.0,
            "ap": float(ap),
        })
    aps = [r["ap"] for r in eval_results if r["num_gts"] > 0]
    mean_ap = float(np.mean(aps)) if aps else 0.0
    return mean_ap, eval_results


def eval_recalls(
    gts: Sequence[np.ndarray],
    proposals: Sequence[np.ndarray],
    proposal_nums: Sequence[int] = (100, 300, 1000),
    iou_thrs: Sequence[float] = (0.5,),
) -> np.ndarray:
    """Proposal recall matrix [num_proposal_nums, num_thrs]
    (reference recall.py:9-94)."""
    img_num = len(gts)
    all_ious = []
    for i in range(img_num):
        prop = proposals[i]
        if prop.shape[1] == 5:
            prop = prop[np.argsort(-prop[:, 4])][:, :4]
        ious = bbox_overlaps(gts[i], prop[:max(proposal_nums)])
        all_ious.append(ious)
    recalls = np.zeros((len(proposal_nums), len(iou_thrs)))
    for pi, pn in enumerate(proposal_nums):
        tmp = np.zeros(len(iou_thrs))
        total = 0
        for ious in all_ious:
            sub = ious[:, :pn]
            total += sub.shape[0]
            if sub.size == 0:
                continue
            for ti, thr in enumerate(iou_thrs):
                # greedy per-gt best matching (reference recall.py:9-40)
                ious_c = sub.copy()
                matched = 0
                for _ in range(min(sub.shape)):
                    best = ious_c.max()
                    if best < thr:
                        break
                    gi, pj = np.unravel_index(ious_c.argmax(), ious_c.shape)
                    ious_c[gi, :] = -1
                    ious_c[:, pj] = -1
                    matched += 1
                tmp[ti] += matched
        recalls[pi] = tmp / max(total, 1)
    return recalls


def xyxy2xywh(bbox) -> list:
    """COCO bbox convention, mmdet '+1' width/height
    (reference coco_utils.py:84-91)."""
    b = np.asarray(bbox).tolist()
    return [b[0], b[1], b[2] - b[0] + 1, b[3] - b[1] + 1]


def det2json(img_ids, results) -> list:
    """Per-image per-class detection arrays -> COCO result dicts
    (reference coco_utils.py:109-123).

    results[i][label] is an [N, 5] array (x1, y1, x2, y2, score); COCO
    ``category_id`` is ``label + 1``."""
    out = []
    for img_id, result in zip(img_ids, results):
        for label, bboxes in enumerate(result):
            for row in np.asarray(bboxes):
                out.append(dict(image_id=img_id, bbox=xyxy2xywh(row[:4]),
                                score=float(row[4]),
                                category_id=label + 1))
    return out


def proposal2json(img_ids, results) -> list:
    """Class-agnostic proposals -> COCO dicts (reference
    coco_utils.py:94-106): every entry gets category_id 1."""
    out = []
    for img_id, bboxes in zip(img_ids, results):
        for row in np.asarray(bboxes):
            out.append(dict(image_id=img_id, bbox=xyxy2xywh(row[:4]),
                            score=float(row[4]), category_id=1))
    return out


def json2det(json_results, img_ids, num_classes) -> list:
    """Inverse of :func:`det2json`: COCO result dicts back to per-image
    per-class [N, 5] arrays (the round trip the reference gets from
    pycocotools ``loadRes``, coco_utils.py:34)."""
    by_img = {i: [[] for _ in range(num_classes)] for i in img_ids}
    for d in json_results:
        x, y, w, h = d["bbox"]
        by_img[d["image_id"]][d["category_id"] - 1].append(
            [x, y, x + w - 1, y + h - 1, d["score"]])
    return [[np.asarray(c, np.float32).reshape(-1, 5) for c in
             by_img[i]] for i in img_ids]


def results2json(img_ids, results, out_file: str) -> dict:
    """Write detection/proposal results as COCO json files (reference
    coco_utils.py:192-220).  Returns {result_type: path}."""
    import json

    files = {}
    if isinstance(results[0], list):
        payload = det2json(img_ids, results)
        files["bbox"] = f"{out_file}.bbox.json"
        files["proposal"] = f"{out_file}.bbox.json"
        with open(files["bbox"], "w") as fh:
            json.dump(payload, fh)
    elif isinstance(results[0], np.ndarray):
        payload = proposal2json(img_ids, results)
        files["proposal"] = f"{out_file}.proposal.json"
        with open(files["proposal"], "w") as fh:
            json.dump(payload, fh)
    else:
        raise TypeError(f"invalid results element: {type(results[0])}")
    return files


def confusion_matrix(gt_label: np.ndarray, pred_label: np.ndarray,
                     class_num: int) -> np.ndarray:
    """Semantic-segmentation confusion matrix (reference
    tools/dataset/base_dataset.py:471-489): counts[c_gt, c_pred]."""
    index = (gt_label.astype(np.int64) * class_num
             + pred_label.astype(np.int64)).ravel()
    counts = np.bincount(index, minlength=class_num * class_num)
    return counts.reshape(class_num, class_num).astype(np.float64)
