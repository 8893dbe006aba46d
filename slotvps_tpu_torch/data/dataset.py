"""Cityscapes-VPS video dataset (COCO-json, test mode).

Reference: mmdet/datasets/cityscapes_vps.py:14-327 ``CityscapesVPSDataset``.
Test-mode behavior reproduced:
  * images sorted by the json order; ``iid = vid * 10000 + fid``
    (reference :57-58; VIPER uses 100000),
  * the reference frame is the previous image within an
    ``nframes_span_test``-frame window; the first frame of each span refs
    itself (reference :258-264),
  * ``is_first`` for video-state reset is ``fid == 1``
    (reference vps_temporal_slots.py:227).

Training annotation parsing (bboxes/labels/RLE masks/track ids) is in
``parse_ann_info`` for the training path.
"""

from __future__ import annotations

import json
import os.path as osp
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from slotvps_tpu_torch.data.pipeline import preprocess


class RefSample(NamedTuple):
    """Sampled training reference frames (reference
    cityscapes_vps.py:102-197)."""

    ref_indices: List[int]
    pseudo_video: bool   # True: refs are same-frame copies to be shifted


# Cityscapes semantic label remap (reference r50_fpn_slotvps.py:128-130)
CITYSCAPES_SEMANTIC2LABEL = {**{i: i for i in range(19)}, -1: 255, 255: 255}


class RepeatDataset:
    """Epoch-lengthening wrapper (reference
    mmdet/datasets/dataset_wrappers.py:28; train config times=8)."""

    def __init__(self, dataset, times: int):
        self.dataset = dataset
        self.times = times

    def __len__(self):
        return self.times * len(self.dataset)

    def __getitem__(self, idx):
        return self.dataset[idx % len(self.dataset)]

    def translate_index(self, idx: int) -> int:
        """Map a repeated index into the base dataset's index space.

        Callers that bypass ``__getitem__`` and talk to base-dataset methods
        directly (``sample_train_refs``/``parse_ann_info``/``load_image``/
        ``img_infos``) must translate first — ``__getattr__`` delegation does
        NOT wrap indices."""
        return int(idx) % len(self.dataset)

    def __getattr__(self, name):
        return getattr(self.dataset, name)


class ConcatDataset:
    """Concatenation wrapper (reference dataset_wrappers.py:8)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._lens = [len(d) for d in self.datasets]

    def __len__(self):
        return sum(self._lens)

    def __getitem__(self, idx):
        for d, n in zip(self.datasets, self._lens):
            if idx < n:
                return d[idx]
            idx -= n
        raise IndexError(idx)


class CityscapesVPSDataset:
    def __init__(
        self,
        ann_file: str,
        img_prefix: str,
        nframes_span_test: int = 30,
        iid_divisor: int = 10000,
        scale: Tuple[int, int] = (2048, 1024),
        uint8_images: bool = False,
    ):
        """``uint8_images`` emits padded uint8 BGR frames and defers
        normalization to the device (4x fewer host->device bytes; the
        inference pipelines detect the dtype — see
        inference._device_normalize)."""
        with open(ann_file) as f:
            data = json.load(f)
        self.img_infos: List[dict] = data["images"]
        self.categories = data.get("categories", [])
        self.anns = data.get("annotations", [])
        self.img_prefix = img_prefix
        self.nframes_span_test = nframes_span_test
        self.iid_divisor = iid_divisor
        self.scale = scale
        self.uint8_images = uint8_images

    def __len__(self):
        return len(self.img_infos)

    def frame_ids(self, idx: int) -> Tuple[int, int]:
        iid = self.img_infos[idx]["id"]
        return iid // self.iid_divisor, iid % self.iid_divisor

    def ref_index(self, idx: int) -> int:
        """Previous frame within the test span; self for span starts
        (reference cityscapes_vps.py:258-264)."""
        return idx - 1 if idx % self.nframes_span_test > 0 else idx

    def load_image(self, idx: int) -> np.ndarray:
        import cv2

        path = osp.join(self.img_prefix, self.img_infos[idx]["file_name"])
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return img

    def __getitem__(self, idx: int) -> Dict:
        img, meta = preprocess(self.load_image(idx), self.scale,
                               keep_uint8=self.uint8_images)
        vid, fid = self.frame_ids(idx)
        meta.update(
            iid=self.img_infos[idx]["id"], vid=vid, fid=fid,
            is_first=(fid == 1),
            filename=self.img_infos[idx]["file_name"],
            ref_index=self.ref_index(idx), index=idx,
        )
        return {"img": img, "meta": meta}

    def __iter__(self) -> Iterator[Dict]:
        for i in range(len(self)):
            yield self[i]

    # ------------------------------------------------------------------
    # training-mode support (reference cityscapes_vps.py:108-251)
    # ------------------------------------------------------------------

    def _ann_by_image(self):
        if not hasattr(self, "_ann_index"):
            idx: Dict[int, list] = {}
            for ann in self.anns:
                idx.setdefault(ann["image_id"], []).append(ann)
            self._ann_index = idx
        return self._ann_index

    def parse_ann_info(self, idx: int) -> Dict:
        """bboxes/labels/masks(raw)/obj_ids for one image
        (reference cityscapes_vps.py:273-327)."""
        info = self.img_infos[idx]
        cat2label = {c["id"]: i + 1 for i, c in enumerate(self.categories)}
        bboxes, labels, obj_ids, masks, ignore = [], [], [], [], []
        for ann in self._ann_by_image().get(info["id"], []):
            if ann.get("ignore", False):
                continue
            x1, y1, w, h = ann["bbox"]
            if ann["area"] <= 0 or w < 1 or h < 1:
                continue
            bbox = [x1, y1, x1 + w - 1, y1 + h - 1]
            if ann.get("iscrowd", False):
                ignore.append(bbox)
                continue
            bboxes.append(bbox)
            labels.append(cat2label.get(ann["category_id"],
                                        ann["category_id"]))
            masks.append(ann.get("segmentation"))
            obj_ids.append(ann.get("inst_id", -1))
        return dict(
            bboxes=np.asarray(bboxes, np.float32).reshape(-1, 4),
            labels=np.asarray(labels, np.int64),
            obj_ids=np.asarray(obj_ids, np.int64),
            bboxes_ignore=np.asarray(ignore, np.float32).reshape(-1, 4),
            masks=masks,
        )

    def _video_index(self):
        """vid -> sorted list of dataset indices of that video."""
        if not hasattr(self, "_vid_idx"):
            vids: Dict[int, list] = {}
            for i in range(len(self)):
                vids.setdefault(self.frame_ids(i)[0], []).append(i)
            for v in vids:
                vids[v].sort(key=lambda i: self.img_infos[i]["id"])
            self._vid_idx = vids
        return self._vid_idx

    def sample_train_refs(self, idx: int, offsets, rng,
                          offsets_change_prob: float = 0.5
                          ) -> Optional[RefSample]:
        """Training reference-frame sampling grammar (reference
        cityscapes_vps.py:102-197 ``prepare_train_img``):

          * ``'0'``: ref = the same frame, turned into a pseudo-video by
            FixedImageRandomShift,
          * ``'0_shift_N'``: N shifted copies of the same frame,
          * ``'0_or_ref1'``: with prob ``offsets_change_prob`` the '0'
            (shifted) behavior, else a real [-1, +1] neighbour (no shift),
          * a list (e.g. ``[-1, 1]``): one random real frame at those iid
            offsets (retry until one exists),
          * ``'all'``: all previous frames of the video,
          * ``'full_all'``: every other frame of the video,
          * ``'-2' / '-3' / '-4'``: up to k previous frames,
          * ``'+-3'``: previous frames, topped up with following frames to
            exactly 3.

        Returns None when no candidate exists (caller resamples another
        index — reference datasets/custom.py:138-146)."""
        vid, fid = self.frame_ids(idx)
        iid = self.img_infos[idx]["id"]
        all_idxs = self._video_index()[vid]
        pos = all_idxs.index(idx)
        iid_of = lambda i: self.img_infos[i]["id"]  # noqa: E731

        if offsets == "0" or (offsets == "0_or_ref1"
                              and rng.random() < offsets_change_prob):
            return RefSample([idx], pseudo_video=True)
        if isinstance(offsets, str) and offsets.startswith("0_shift"):
            n = int(offsets.split("_")[-1])
            return RefSample([idx] * n, pseudo_video=True)
        if isinstance(offsets, (list, tuple)) or offsets == "0_or_ref1":
            cands = list(offsets) if isinstance(offsets, (list, tuple)) \
                else [-1, 1]
            by_iid = {iid_of(i): i for i in all_idxs}
            while cands:
                m = int(cands[rng.integers(0, len(cands))])
                if iid + m in by_iid:
                    return RefSample([by_iid[iid + m]], pseudo_video=False)
                cands.remove(m)
            return None
        if offsets in ("all", "full_all"):
            start = 0
        elif offsets == "-2":
            start = max(0, pos - 2)
        elif offsets in ("-3", "+-3"):
            start = max(0, pos - 3)
        elif offsets == "-4":
            start = max(0, pos - 4)
        else:
            raise ValueError(f"unknown offsets grammar: {offsets!r}")
        used = list(all_idxs[start:pos])
        if offsets == "full_all":
            used += all_idxs[pos + 1:]
        elif offsets.startswith("+-"):
            n = int(offsets[-1])
            used += all_idxs[pos + 1:pos + 1 + (n - len(used))]
            if len(used) != n:
                return None
        if not used:
            return None
        return RefSample(used, pseudo_video=False)

    def seg_filename(self, idx: int, seg_prefix: str) -> str:
        """Semantic label-map path for a frame (reference
        cityscapes_vps.py:210-217: seg_map with leftImg8bit->gtFine_color,
        newImg8bit->final_mask)."""
        info = self.img_infos[idx]
        seg_map = info.get("seg_map", info["file_name"])
        name = seg_map.replace("leftImg8bit", "gtFine_color").replace(
            "newImg8bit", "final_mask")
        return osp.join(seg_prefix, name)

    def load_semantic(self, idx: int, seg_prefix: str,
                      semantic2label: Optional[Dict[int, int]] = None
                      ) -> np.ndarray:
        """Load + remap the semantic label map (reference
        pipelines/loading.py:270-283 ``_load_semantic_seg``)."""
        import cv2

        path = self.seg_filename(idx, seg_prefix)
        seg = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if seg is None:
            raise FileNotFoundError(path)
        seg = seg.squeeze()
        if seg.ndim == 3:  # color PNG: cityscapes labelmaps are single-ch
            seg = seg[..., 0]
        if semantic2label is not None:
            out = seg.copy()
            for k in np.unique(seg):
                out[seg == k] = semantic2label.get(int(k), int(k))
            seg = out
        return seg

    @staticmethod
    def gt_pids(gt_obj_ids: np.ndarray, ref_obj_ids: np.ndarray
                ) -> np.ndarray:
        """Track-id labels: 1-based index into the reference frame's
        instances, 0 = new object (reference cityscapes_vps.py:233-251)."""
        ref = list(ref_obj_ids)
        return np.asarray(
            [ref.index(i) + 1 if i in ref else 0 for i in gt_obj_ids],
            np.int64)
