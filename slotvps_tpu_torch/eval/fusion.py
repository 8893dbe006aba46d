"""Host-side panoptic fusion: per-frame reconciliation + tube-id coloring.

Behavioral re-implementation of the reference eval helpers:

- :func:`unify_pan_result` — reconcile the semantic argmax map against the
  instance map per region (majority vote), apply the stuff-area limit, emit a
  3-channel [sem, ins, obj] uint8 image
  (reference tools/dataset/cityscapes_vps.py:215-303).
- :func:`convert_2ch_track` — assign temporally-consistent RGB colors to
  tubes via an obj-id memory across a video's frames, emit pred.json
  ``segments_info`` records
  (reference tools/dataset/cityscapes_vps.py:140-213).
- :func:`inference_panoptic_video` — the per-video loop that ties them
  together (reference tools/dataset/cityscapes_vps.py:44-138).
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from slotvps_tpu_torch.eval.color import IdGenerator, rgb2id


def unify_pan_result(
    segs: Sequence[np.ndarray],
    pans: Sequence[np.ndarray],
    cls_inds: Sequence[np.ndarray],
    obj_ids: Optional[Sequence[np.ndarray]] = None,
    stuff_area_limit: int = 4 * 64 * 64,
    id_last_stuff: int = 10,
    use_native: bool = True,
) -> List[np.ndarray]:
    """Reconcile per-frame semantic + instance outputs into 3-channel maps.

    Per frame:
      * ``seg``  — [H, W] semantic argmax (0..num_seg_classes-1),
      * ``pan``  — [H, W] panoptic map: values <= id_last_stuff are stuff
        classes, values > id_last_stuff are instance slots numbered
        ``id_last_stuff + 1 + k`` for the k-th kept thing,
      * ``cls_inds`` — [n_things] thing class (1-based, in 1..8 for
        Cityscapes) per instance slot in order,
      * ``obj_ids``  — [n_things] track id per instance slot (optional).

    Returns a list of [H, W, 3] uint8 arrays [pan_seg, pan_ins, pan_obj].
    """
    if obj_ids is None:
        obj_ids = [None] * len(cls_inds)
    out: List[np.ndarray] = []
    max_oid = 100  # cap for de-duplicated track ids (reference :220)

    for seg, pan, cls_ind, obj_id in zip(segs, pans, cls_inds, obj_ids):
        seg = np.asarray(seg)
        pan = np.asarray(pan).copy()
        cls_ind = np.asarray(cls_ind)

        # de-duplicate repeated obj ids: later occurrences get fresh ids
        # (reference :232-244 — the [::-1] round trip keeps the FIRST
        # occurrence and renames the rest)
        if obj_id is not None:
            obj_id = np.asarray(obj_id).copy()
            oid_unique, oid_cnt = np.unique(obj_id, return_counts=True)
            if np.any(oid_cnt > 1):
                obj_id_rev = obj_id[::-1].copy()
                for red in oid_unique[oid_cnt > 1]:
                    part = obj_id[obj_id == red].copy()
                    for i in range(1, len(part)):
                        part[i] = max_oid
                        max_oid += 1
                    obj_id_rev[obj_id_rev == red] = part
                obj_id = obj_id_rev[::-1]

        pan_seg = pan.copy()
        if len(cls_ind) == 0:
            # no instances: blank out anything claiming to be one.
            # DELIBERATE divergence from the reference (:249-252): it
            # copies pan_seg BEFORE the blank, leaving the dropped
            # instances' raw ids behind as bogus semantic labels; we blank
            # both channels so those pixels read void (255).  Regression:
            # tests/test_eval_fusion.py::test_empty_instance_frame_blanks
            pan[pan > id_last_stuff] = 255
            pan_seg = pan.copy()

        if use_native and len(cls_ind) > 0:
            from slotvps_tpu_torch import native

            res = native.unify_frame_native(
                seg, pan, cls_ind, obj_id, stuff_area_limit, id_last_stuff)
            if res is not None:
                out.append(res)
                continue
        pan_ins = pan.copy()
        pan_obj = pan.copy()
        ids = np.unique(pan)
        ids_ins = ids[ids > id_last_stuff]
        pan_ins[pan_ins <= id_last_stuff] = 0

        for idx, sid in enumerate(ids_ins):
            region = pan_ins == sid
            if sid == 255:
                pan_seg[region] = 255
                pan_ins[region] = 0
                continue
            k = sid - id_last_stuff - 1  # instance slot index
            thing_sem = cls_ind[k] + id_last_stuff
            cls, cnt = np.unique(seg[region], return_counts=True)
            majority = cls[np.argmax(cnt)]
            if majority == thing_sem:
                pan_seg[region] = thing_sem
                pan_ins[region] = idx + 1
                if obj_id is not None:
                    pan_obj[region] = obj_id[idx] + 1
            elif (np.max(cnt) / np.sum(cnt) >= 0.5
                  and majority <= id_last_stuff):
                # semantic head strongly disagrees and says stuff: trust it
                pan_seg[region] = majority
                pan_ins[region] = 0
                pan_obj[region] = 0
            else:
                pan_seg[region] = thing_sem
                pan_ins[region] = idx + 1
                if obj_id is not None:
                    pan_obj[region] = obj_id[idx] + 1

        # small stuff regions -> void (reference :284-290)
        for sem in np.unique(pan_seg):
            if sem <= id_last_stuff:
                area = pan_seg == sem
                if area.sum() < stuff_area_limit:
                    pan_seg[area] = 255

        pan_2ch = np.zeros(pan.shape + (3,), dtype=np.uint8)
        pan_2ch[:, :, 0] = pan_seg
        pan_2ch[:, :, 1] = pan_ins
        pan_2ch[:, :, 2] = pan_obj
        out.append(pan_2ch)
    return out


def convert_2ch_track(
    pan_2ch_set: Sequence[np.ndarray],
    color_generator: IdGenerator,
) -> Tuple[List[dict], List[np.ndarray]]:
    """Assign temporally-consistent colors within one video.

    ``pan_2ch_set`` holds one video's frames of [H, W, 3] uint8
    [sem, ins, obj] maps.  A (sem, obj) pair keeps its color across frames
    via the ``inst2color`` memory — this is what makes pred.json segment ids
    temporally consistent (reference tools/dataset/cityscapes_vps.py:140-213).

    Returns (annotations, colored frames).
    """
    OFFSET_ = 1000
    VOID_ = 255
    annotations: List[dict] = []
    pan_all: List[np.ndarray] = []
    inst2color: Dict[int, tuple] = {}
    seq_ids = [0] * 20

    for pan_2ch in pan_2ch_set:
        pan_2ch = np.uint32(pan_2ch)
        # key = sem * 1000 + obj
        pan = OFFSET_ * pan_2ch[:, :, 0] + pan_2ch[:, :, 2]
        pan_format = np.zeros(pan_2ch.shape[:2] + (3,), dtype=np.uint8)
        segm_info: Dict[int, dict] = {}
        for el in np.unique(pan):
            sem = int(el // OFFSET_)
            obj_idx = int(el % OFFSET_)
            if sem == VOID_ or obj_idx == VOID_:
                continue
            mask = pan == el
            if obj_idx > 0:
                # thing instance: color keyed on (sem, obj) across frames
                if sem >= 21:
                    # reference quirk (:167-168): sems that leaked through
                    # as 19-space + 10 get remapped back
                    sem -= 10
                if el in inst2color:
                    color = inst2color[el]
                else:
                    color = color_generator.get_color(sem, seq_ids[sem])
                    seq_ids[sem] += 1
                    inst2color[el] = color
            else:
                color = color_generator.get_color(sem, -1)

            pan_format[mask] = color
            ys, xs = np.where(mask)
            x, y = int(xs.min()), int(ys.min())
            width, height = int(xs.max() - x), int(ys.max() - y)
            segment_id = int(rgb2id(np.array(color)))
            segm_info[segment_id] = {
                "category_id": sem, "iscrowd": 0, "id": segment_id,
                "bbox": [x, y, width, height], "area": int(mask.sum()),
            }
        pan_all.append(pan_format)

        # recompute areas from the rendered PNG and cross-validate
        # (reference :198-208)
        pan_id = rgb2id(pan_format)
        labels, labels_cnt = np.unique(pan_id, return_counts=True)
        for label, area in zip(labels, labels_cnt):
            if label == 0:
                continue
            if int(label) not in segm_info:
                raise KeyError(f"label {label} not in segm_info keys.")
            segm_info[int(label)]["area"] = int(area)
        annotations.append({"segments_info": list(segm_info.values())})

    return annotations, pan_all


def convert_2ch_single(
    pan_2ch_set: Sequence[np.ndarray],
    color_generator: IdGenerator,
) -> Tuple[List[dict], List[np.ndarray]]:
    """Per-frame (no tube memory) color assignment — the single-frame PQ
    path used for VIPER-style evaluation
    (reference tools/dataset/base_dataset.py:301-351
    ``_converter_2ch_single_core``).  Thing colors restart per frame."""
    annotations, pan_all = [], []
    for pan_2ch in pan_2ch_set:
        anno, pans = convert_2ch_track([pan_2ch], IdGenerator(
            color_generator.categories))
        annotations.extend(anno)
        pan_all.extend(pans)
    return annotations, pan_all


def inference_panoptic_video(
    pred_pans_2ch: Sequence[np.ndarray],
    output_dir: Optional[str],
    categories: Sequence[dict],
    names: Optional[Sequence[str]] = None,
    nframes_per_video: int = 6,
    labeled_fid: int = 20,
    lambda_: int = 5,
    save_pngs: bool = True,
) -> Tuple[List[np.ndarray], dict]:
    """Per-video color/tube-id assignment + artifact writing
    (reference tools/dataset/cityscapes_vps.py:44-138).

    If 1500 frames are passed (full every-frame inference), only the labeled
    frames [labeled_fid/lambda :: lambda] are sampled — reference :52-53.
    """
    pred_pans_2ch = list(pred_pans_2ch)
    if len(pred_pans_2ch) == 1500:
        pred_pans_2ch = pred_pans_2ch[(labeled_fid // lambda_)::lambda_]
    cat_by_id = {el["id"]: el for el in categories}
    color_generator = IdGenerator(cat_by_id)

    annotations: List[dict] = []
    pred_pans: List[np.ndarray] = []
    for start in range(0, len(pred_pans_2ch), nframes_per_video):
        video = pred_pans_2ch[start: start + nframes_per_video]
        anno, pans = convert_2ch_track(video, color_generator)
        annotations.extend(anno)
        pred_pans.extend(pans)

    pred_json = {"annotations": annotations}
    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)
        if save_pngs:
            from PIL import Image

            if names is None:
                names = [f"{i:06d}.png" for i in range(len(pred_pans))]
            names = [
                osp.basename(n).replace("_leftImg8bit", "")
                .replace("_newImg8bit", "").replace("jpg", "png")
                .replace("jpeg", "png")
                for n in names
            ]
            for sub, imgs in (("pan_2ch", pred_pans_2ch), ("pan_pred", pred_pans)):
                d = osp.join(output_dir, sub)
                os.makedirs(d, exist_ok=True)
                for img, name in zip(imgs, names):
                    Image.fromarray(np.asarray(img)).save(osp.join(d, name))
        with open(osp.join(output_dir, "pred.json"), "w") as f:
            json.dump(pred_json, f)
    return pred_pans, pred_json
