"""Video Panoptic Quality (VPQ) — tube-matching metric.

Behavioral re-implementation of the reference evaluator
(tools/eval_vpq.py:22-414): slide an ``nframes``-long window over each
video, stack the per-frame panoptic id maps into tubes, match GT/pred tubes
at tube-IoU > 0.5 (with VOID subtraction), and accumulate PQ statistics plus
the ID-switch consistency counters (``ids_sum``/``ids_false``).

Inputs are (segments_info json, RGB panoptic PNG) pairs exactly like the
reference's ``pred.json`` + ``pan_pred/*.png`` artifacts, so outputs are
directly comparable.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

OFFSET = 256 * 256 * 256
VOID = 0


@dataclasses.dataclass
class PQStatCat:
    """Per-category accumulators (reference tools/eval_vpq.py:22-42)."""

    iou: float = 0.0
    tp: int = 0
    fp: int = 0
    fn: int = 0
    ids_sum: int = 0
    ids_false: int = 0

    def __iadd__(self, other: "PQStatCat") -> "PQStatCat":
        self.iou += other.iou
        self.tp += other.tp
        self.fp += other.fp
        self.fn += other.fn
        self.ids_sum += other.ids_sum
        self.ids_false += other.ids_false
        return self


class PQStat:
    """Aggregate over categories (reference tools/eval_vpq.py:44-111)."""

    def __init__(self):
        self.pq_per_cat: Dict[int, PQStatCat] = defaultdict(PQStatCat)

    def __getitem__(self, i: int) -> PQStatCat:
        return self.pq_per_cat[i]

    def __iadd__(self, other: "PQStat") -> "PQStat":
        for label, stat in other.pq_per_cat.items():
            self.pq_per_cat[label] += stat
        return self

    def pq_average(self, categories: Dict[int, dict], isthing: Optional[bool]):
        pq = sq = rq = n = 0
        ids_sum = ids_false = 0
        ids_errp = 0.0  # SUM of per-class ratios (reference :100-111)
        tps = fps = fns = 0
        per_class: Dict[int, dict] = {}
        for label, info in categories.items():
            if isthing is not None and (info["isthing"] == 1) != isthing:
                continue
            stat = self.pq_per_cat[label]
            if stat.tp + stat.fp + stat.fn == 0:
                per_class[label] = {
                    "pq": 0.0, "sq": 0.0, "rq": 0.0, "iou": 0.0,
                    "tp": 0, "fp": 0, "fn": 0,
                    "ids_sum": 0, "ids_false": 0, "ids_errp": 0,
                }
                continue
            n += 1
            denom = stat.tp + 0.5 * stat.fp + 0.5 * stat.fn
            pq_c = stat.iou / denom
            sq_c = stat.iou / stat.tp if stat.tp else 0.0
            rq_c = stat.tp / denom
            per_class[label] = {
                "pq": pq_c, "sq": sq_c, "rq": rq_c, "iou": stat.iou,
                "tp": stat.tp, "fp": stat.fp, "fn": stat.fn,
                "ids_sum": stat.ids_sum, "ids_false": stat.ids_false,
                "ids_errp": (stat.ids_false / stat.ids_sum) if stat.ids_sum else 0,
            }
            pq += pq_c
            sq += sq_c
            rq += rq_c
            tps += stat.tp
            fps += stat.fp
            fns += stat.fn
            ids_sum += stat.ids_sum
            ids_false += stat.ids_false
            ids_errp += per_class[label]["ids_errp"]
        if n > 0:
            result = {"pq": pq / n, "sq": sq / n, "rq": rq / n, "n": n}
        else:
            result = {"pq": 0, "sq": 0, "rq": 0, "n": 0}
        # NOTE the reference's aggregate ``ids_errp`` is the SUM of the
        # per-class ratios (tools/eval_vpq.py:100-111) — that value feeds
        # the vpq-{k}.txt All/Things/Stuff rows (:374-377).  The aggregate
        # ratio ids_false/ids_sum is used only for vpq-final (:360),
        # recomputed there from the counters.
        result.update(
            ids_sum=ids_sum,
            ids_false=ids_false,
            ids_errp=ids_errp,
            tps=tps, fps=fps, fns=fns,
        )
        return result, per_class


def _pan_to_id(pan_rgb: np.ndarray) -> np.ndarray:
    pan = np.uint32(pan_rgb)
    return pan[:, :, 0] + pan[:, :, 1] * 256 + pan[:, :, 2] * 256 * 256


def _collect_segms(segments_info: Sequence[dict]) -> Dict[int, dict]:
    """id -> segment record; duplicate ids merge area
    (reference tools/eval_vpq.py:137-148)."""
    segms: Dict[int, dict] = {}
    for el in segments_info:
        if el["id"] in segms:
            segms[el["id"]]["area"] += el["area"]
        else:
            segms[el["id"]] = dict(el)
    return segms


def vpq_compute_single_core(
    gt_pred_set: Sequence[Tuple[dict, dict, np.ndarray, np.ndarray, dict]],
    categories: Dict[int, dict],
    nframes: int = 2,
) -> PQStat:
    """VPQ stats for one video at one window size.

    ``gt_pred_set`` is a list of per-frame tuples
    (gt_json, pred_json, gt_pan_rgb, pred_pan_rgb, gt_image_json) — same
    layout as the reference (tools/eval_vpq.py:114-295).
    """
    vpq_stat = PQStat()
    ids_memory: Dict[int, int] = {}  # gt tube id -> last matched pred id

    for idx in range(0, len(gt_pred_set) - nframes + 1):
        vid_pan_gt, vid_pan_pred = [], []
        gt_segms_list, pred_segms_list = [], []
        for gt_json, pred_json, gt_pan, pred_pan, _ in gt_pred_set[idx: idx + nframes]:
            pan_gt = _pan_to_id(gt_pan)
            pan_pred = _pan_to_id(pred_pan)
            gt_segms = _collect_segms(gt_json["segments_info"])
            pred_segms = _collect_segms(pred_json["segments_info"])

            # pred area recomputation + sanity checks
            # (reference tools/eval_vpq.py:150-165)
            pred_labels_set = set(pred_segms.keys())
            labels, labels_cnt = np.unique(pan_pred, return_counts=True)
            for label, cnt in zip(labels, labels_cnt):
                if label not in pred_segms:
                    if label == VOID:
                        continue
                    raise KeyError(
                        f"Segment ID {label} in PNG but not in JSON.")
                pred_segms[label]["area"] = int(cnt)
                pred_labels_set.discard(int(label))
                if pred_segms[label]["category_id"] not in categories:
                    raise KeyError(
                        f"Segment ID {label} has unknown category_id "
                        f"{pred_segms[label]['category_id']}.")
            if pred_labels_set:
                raise KeyError(
                    f"Segment IDs {sorted(pred_labels_set)} in JSON but "
                    "not in PNG.")

            vid_pan_gt.append(pan_gt)
            vid_pan_pred.append(pan_pred)
            gt_segms_list.append(gt_segms)
            pred_segms_list.append(pred_segms)

        # tube-level aggregation
        vid_pan_gt = np.stack(vid_pan_gt)
        vid_pan_pred = np.stack(vid_pan_pred)
        vid_gt_segms: Dict[int, dict] = {}
        vid_pred_segms: Dict[int, dict] = {}
        for gt_segms, pred_segms in zip(gt_segms_list, pred_segms_list):
            for k, v in gt_segms.items():
                if k in vid_gt_segms:
                    vid_gt_segms[k]["area"] += v["area"]
                else:
                    vid_gt_segms[k] = dict(v)
            for k, v in pred_segms.items():
                if k in vid_pred_segms:
                    vid_pred_segms[k]["area"] += v["area"]
                else:
                    vid_pred_segms[k] = dict(v)

        # confusion counts via combined gt*OFFSET+pred key
        combined = vid_pan_gt.astype(np.uint64) * OFFSET + vid_pan_pred.astype(
            np.uint64)
        labels, labels_cnt = np.unique(combined, return_counts=True)
        gt_pred_map = {
            (int(label // OFFSET), int(label % OFFSET)): int(cnt)
            for label, cnt in zip(labels, labels_cnt)
        }

        gt_matched, pred_matched = set(), set()
        for (gt_label, pred_label), intersection in gt_pred_map.items():
            if gt_label not in vid_gt_segms or pred_label not in vid_pred_segms:
                continue
            if vid_gt_segms[gt_label]["iscrowd"] == 1:
                continue
            cat = vid_gt_segms[gt_label]["category_id"]
            if cat != vid_pred_segms[pred_label]["category_id"]:
                continue
            union = (
                vid_pred_segms[pred_label]["area"]
                + vid_gt_segms[gt_label]["area"]
                - intersection
                - gt_pred_map.get((VOID, pred_label), 0)
            )
            iou = intersection / union
            assert iou <= 1.0, f"INVALID IOU VALUE : {gt_label}"
            if iou > 0.5:
                vpq_stat[cat].tp += 1
                vpq_stat[cat].iou += iou
                gt_matched.add(gt_label)
                pred_matched.add(pred_label)
                # ID-switch consistency (reference tools/eval_vpq.py:237-246)
                vpq_stat[cat].ids_sum += 1
                if gt_label in ids_memory and pred_label != ids_memory[gt_label]:
                    vpq_stat[cat].ids_false += 1
                ids_memory[gt_label] = pred_label

        # FN: unmatched, non-crowd GT tubes
        crowd_labels_dict: Dict[int, int] = {}
        for gt_label, gt_info in vid_gt_segms.items():
            if gt_label in gt_matched:
                continue
            if gt_info["iscrowd"] == 1:
                crowd_labels_dict[gt_info["category_id"]] = gt_label
                continue
            vpq_stat[gt_info["category_id"]].fn += 1
            vpq_stat[gt_info["category_id"]].ids_sum += 1

        # FP: unmatched pred tubes, unless mostly VOID/CROWD-covered
        for pred_label, pred_info in vid_pred_segms.items():
            if pred_label in pred_matched:
                continue
            intersection = gt_pred_map.get((VOID, pred_label), 0)
            if pred_info["category_id"] in crowd_labels_dict:
                intersection += gt_pred_map.get(
                    (crowd_labels_dict[pred_info["category_id"]], pred_label), 0)
            if intersection / pred_info["area"] > 0.5:
                continue
            vpq_stat[pred_info["category_id"]].fp += 1

    return vpq_stat


_METRICS = (("All", None), ("Things", True), ("Stuff", False))


def vpq_compute(
    gt_pred_split: Sequence[Sequence],
    categories: Dict[int, dict],
    nframes: int,
    output_dir: Optional[str] = None,
) -> dict:
    """Aggregate VPQ over all videos at one window size
    (reference tools/eval_vpq.py:298-414).  Returns a result dict and,
    if ``output_dir`` is given, writes ``vpq-{k}.txt``."""
    vpq_stat = PQStat()
    per_video = []
    for gt_pred_set in gt_pred_split:
        tmp = vpq_compute_single_core(gt_pred_set, categories, nframes=nframes)
        video_res = {
            name: tmp.pq_average(categories, isthing)[0]
            for name, isthing in _METRICS
        }
        per_video.append(video_res)
        vpq_stat += tmp

    k = (nframes - 1) * 5
    results = {}
    for name, isthing in _METRICS:
        results[name], per_class = vpq_stat.pq_average(categories, isthing)
        if name == "All":
            results["per_class"] = per_class
    results["k"] = k
    results["per_video"] = per_video
    all_stats = results["All"]
    results["vpq_errp"] = 100 * (
        all_stats["ids_false"] / all_stats["ids_sum"]
        if all_stats["ids_sum"] else 0.0
    )

    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)
        _write_vpq_txt(os.path.join(output_dir, f"vpq-{k}.txt"), results)
    return results


def _write_vpq_txt(path: str, results: dict) -> None:
    """Same table layout as the reference (tools/eval_vpq.py:366-392)."""
    with open(path, "w") as f:
        f.write("================================================\n")
        f.write("{:10s}| {:>5s}  {:>5s}  {:>5s} {:>5s} {:>5s} {:>5s} {:>5s}"
                .format("", "PQ", "SQ", "RQ", "N", "ERRP", "SUM", "FALSE\n"))
        f.write("-" * (10 + 7 * 7) + "\n")
        for name, _ in _METRICS:
            r = results[name]
            f.write(
                "{:10s}| {:5.1f}  {:5.1f}  {:5.1f} {:5d} {:5.1f} {:5.1f} {:5.1f}\n"
                .format(name, 100 * r["pq"], 100 * r["sq"], 100 * r["rq"],
                        r["n"], 100 * r["ids_errp"], r["ids_sum"],
                        r["ids_false"]))
        f.write("{:4s}| {:>5s} {:>5s} {:>5s} {:>6s} {:>7s} {:>7s} {:>7s} "
                "{:>7s} {:>7s} {:>7s}\n"
                .format("IDX", "PQ", "SQ", "RQ", "IoU", "TP", "FP", "FN",
                        "ERRP", "SUM", "FALSE"))
        for idx, r in results["per_class"].items():
            f.write(
                "{:4d} | {:5.1f} {:5.1f} {:5.1f} {:6.1f} {:7d} {:7d} {:7d} "
                "{:7.1f} {:7.1f} {:7.1f}\n"
                .format(idx, 100 * r["pq"], 100 * r["sq"], 100 * r["rq"],
                        r["iou"], r["tp"], r["fp"], r["fn"],
                        100 * r["ids_errp"], r["ids_sum"], r["ids_false"]))


def save_diff_figs(pred_pans, gt_pans, file_names, output_dir: str) -> None:
    """Per-frame error maps: uint8 channel-wise ``pred - gt`` (wrapping,
    numpy uint8 semantics) zeroed wherever the gt pixel is 0, written to
    ``<output_dir>/pan_diff/<id>.png`` — bit-compatible with the
    reference's ``--save_diff_fig`` (tools/eval_vpq.py:463-470)."""
    from PIL import Image

    diff_dir = os.path.join(output_dir, "pan_diff")
    os.makedirs(diff_dir, exist_ok=True)
    for pred, gt, name in zip(pred_pans, gt_pans, file_names):
        diff = np.asarray(pred, np.uint8) - np.asarray(gt, np.uint8)
        diff[np.where(gt == 0)] = 0
        Image.fromarray(diff).save(os.path.join(diff_dir, name))


def final_eval(
    pred_jsons: Sequence[dict],
    gt_jsons: Sequence[dict],
    gt_pans: Sequence[np.ndarray],
    pred_pans: Sequence[np.ndarray],
    categories: Dict[int, dict],
    output_dir: Optional[str] = None,
    nframes_per_video: int = 6,
    window_sizes: Sequence[int] = (1, 2, 3, 4),
    verbose: bool = True,
    draw_charts: bool = False,
) -> dict:
    """Full VPQ evaluation over all λ windows
    (reference tools/eval_vpq.py:417-564).

    Arguments are per-frame lists of equal length (a multiple of
    ``nframes_per_video``).  Returns the summary dict and writes
    ``vpq-{0,5,10,15}.txt`` + ``vpq-final.txt`` if ``output_dir`` is set.
    """
    assert len(gt_jsons) == len(pred_jsons) == len(gt_pans) == len(pred_pans)
    vid_num = len(gt_jsons) // nframes_per_video
    gt_pred_all = list(zip(gt_jsons, pred_jsons, gt_pans, pred_pans,
                           [None] * len(gt_jsons)))
    # reference uses np.array_split (tools/eval_vpq.py:480); plain slicing
    # is equivalent here since len is a multiple of nframes_per_video
    gt_pred_split = [
        gt_pred_all[i * nframes_per_video: (i + 1) * nframes_per_video]
        for i in range(vid_num)
    ]

    summary = {"vpq_all": [], "vpq_thing": [], "vpq_stuff": [], "vpq_errp": [],
               "vsq_all": [], "vrq_all": [], "per_k": {}}
    for nframes in window_sizes:
        t0 = time.time()
        results = vpq_compute(gt_pred_split, categories, nframes, output_dir)
        k = results["k"]
        if verbose:
            print(f"==> {k}-frame vpq_stat: {time.time() - t0:.1f} sec")
        summary["per_k"][k] = results
        summary["vpq_all"].append(100 * results["All"]["pq"])
        summary["vpq_thing"].append(100 * results["Things"]["pq"])
        summary["vpq_stuff"].append(100 * results["Stuff"]["pq"])
        summary["vsq_all"].append(100 * results["All"]["sq"])
        summary["vrq_all"].append(100 * results["All"]["rq"])
        summary["vpq_errp"].append(results["vpq_errp"])

    for key in ("vpq_all", "vpq_thing", "vpq_stuff", "vpq_errp",
                "vsq_all", "vrq_all"):
        summary[key] = float(np.mean(summary[key])) if summary[key] else 0.0

    # per-category vpq: one list per window size, category order = sorted id
    # (reference tools/eval_vpq.py:310-314, 548-556, vpq_cats.json :522)
    cat_ids = sorted(categories)
    cats_x = [categories[c]["name"] for c in cat_ids]
    cats_vpq = [
        [100 * summary["per_k"][(nf - 1) * 5]["per_class"][c]["pq"]
         for c in cat_ids]
        for nf in window_sizes
    ]
    summary["per_category"] = {
        name: float(np.mean([row[i] for row in cats_vpq]))
        for i, name in enumerate(cats_x)
    }
    if verbose:
        print("------per-category vpq------:")
        for name in cats_x:
            pad = " " * max(15 - len(name), 1)
            print(f"category: {name}, {pad}, average vpq: "
                  f"{str(summary['per_category'][name])[:5]}")

    if output_dir is not None:
        with open(os.path.join(output_dir, "vpq-final.txt"), "w") as f:
            f.write("vpq_all:%.4f\n" % summary["vpq_all"])
            f.write("vpq_thing:%.4f\n" % summary["vpq_thing"])
            f.write("vpq_stuff:%.4f\n" % summary["vpq_stuff"])
            f.write("vpq_errp:%.4f\n" % summary["vpq_errp"])
        with open(os.path.join(output_dir, "vpq-final.json"), "w") as f:
            json.dump({k: v for k, v in summary.items() if k != "per_k"}, f)
        with open(os.path.join(output_dir, "vpq_cats.json"), "w") as f:
            json.dump(cats_vpq, f)
        if draw_charts:
            _draw_final_charts(summary, cats_x, cats_vpq, window_sizes,
                               output_dir)
    return summary


def _draw_final_charts(summary, cats_x, cats_vpq, window_sizes, output_dir):
    """Per-video and per-category figures (reference
    tools/eval_vpq.py:523-538, behind --draw_line_charts)."""
    from slotvps_tpu_torch.utils.charts import draw_line_chart

    ks = [(nf - 1) * 5 for nf in window_sizes]
    per_video = summary["per_k"][ks[0]]["per_video"]
    x = list(range(len(per_video)))
    for metric in ("pq", "sq", "rq"):
        ys, labels = [], []
        for k in ks:
            for name in ("All", "Things", "Stuff"):
                ys.append([100 * v[name][metric]
                           for v in summary["per_k"][k]["per_video"]])
                labels.append(f"{name}_v{metric}_k_{k}")
        draw_line_chart(x, ys, labels, x_label="video", y_label=f"v{metric}",
                        title=f"v{metric}_per_video",
                        save_path=os.path.join(output_dir,
                                               f"v{metric}_fig.png"))
    draw_line_chart(cats_x, cats_vpq,
                    [f"cats_vpq_k_{k}" for k in ks], x_label="category",
                    y_label="cats_vpq", rotation=30, fontsize=8.5,
                    title="vpq_cats_fig",
                    save_path=os.path.join(output_dir, "vpq_cats_fig.png"))
