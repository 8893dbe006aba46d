"""Train-time evaluation hook (counterpart of ``slotvps_tpu/eval/hooks.py``):
run the full inference -> fusion -> VPQ stack on a validation set with the
model being trained.

Native analog of the reference's ``DistEvalHook`` family (reference
mmdet/core/evaluation/eval_hooks.py:20-83: periodic val inference, then
``dataset.evaluate``): the trainer (``cli/train.py --eval_every``) calls
:func:`run_val_eval` every N epochs and logs the VPQ summary.  The model's
outputs go through the real artifact path: ``InferencePipeline`` ->
``unify_pan_result`` -> ``inference_panoptic_video`` (pred.json + pan_pred
PNGs) -> ``final_eval`` (vpq-{k}.txt), as the eval CLI runs it.  The model
runs on its own device (the card unless it was built on the CPU) with the
config's kernel routes.
"""

from __future__ import annotations

import json
import os.path as osp
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from slotvps_tpu_torch.config import Config
from slotvps_tpu_torch.models.detector import Detector


def predict_panoptic(model: Detector, cfg: Config, dataset,
                     pipeline_cls=None) -> Tuple[List[np.ndarray],
                                                 List[str]]:
    """Streaming inference over ``dataset`` -> fused 3-channel panoptic
    maps, sorted by file name (the reference's artifact order,
    tools/test_vpq.py:146-151).

    Returns (pred_pans_2ch, names)."""
    from slotvps_tpu_torch.eval.fusion import unify_pan_result
    from slotvps_tpu_torch.inference import InferencePipeline

    pipeline_cls = pipeline_cls or InferencePipeline
    pipeline = None
    ssegs, panos, cls_inds, obj_ids, names = [], [], [], [], []
    for item in dataset:
        meta = item["meta"]
        if pipeline is None:
            pipeline = pipeline_cls(
                model, cfg, image_size=tuple(meta["ori_shape"]),
                valid_hw=tuple(meta["img_shape"]))
        res = pipeline.process_frame(item["img"], meta["is_first"])
        ssegs.append(res.sseg)
        panos.append(res.panoptic)
        cls_inds.append(res.cls_inds)
        obj_ids.append(res.obj_ids)
        names.append(osp.basename(meta["filename"]))
    pans_2ch = unify_pan_result(
        ssegs, panos, cls_inds, obj_ids,
        stuff_area_limit=cfg.eval.panoptic_stuff_area_limit,
        id_last_stuff=cfg.eval.id_last_stuff)
    order = np.argsort(names)
    return [pans_2ch[i] for i in order], [names[i] for i in order]


def evaluate_panoptic(pred_pans_2ch: Sequence[np.ndarray],
                      names: Sequence[str], cfg: Config, categories,
                      gt_annos: Sequence[dict],
                      gt_pans: Sequence[np.ndarray],
                      output_dir: Optional[str] = None,
                      verbose: bool = False) -> Dict:
    """Fused maps -> pred.json / PNGs -> VPQ summary (the artifact path
    the eval CLI runs)."""
    from slotvps_tpu_torch.eval import vpq
    from slotvps_tpu_torch.eval.fusion import inference_panoptic_video

    pred_pans, pred_json = inference_panoptic_video(
        pred_pans_2ch, output_dir, list(categories), list(names),
        nframes_per_video=cfg.eval.nframes_per_video,
        labeled_fid=cfg.eval.labeled_fid, lambda_=cfg.eval.lambda_,
        save_pngs=output_dir is not None)
    cats = {el["id"]: el for el in categories}
    return vpq.final_eval(
        pred_json["annotations"], list(gt_annos), list(gt_pans),
        pred_pans, cats, output_dir=output_dir,
        nframes_per_video=cfg.eval.nframes_per_video, verbose=verbose)


def run_val_eval(model: Detector, cfg: Config, ann_file: str,
                 img_prefix: str, truth_dir: str, pan_gt_json_file: str,
                 output_dir: Optional[str] = None,
                 max_videos: Optional[int] = None,
                 verbose: bool = False) -> Dict:
    """File-based validation eval (the ``--eval_every`` entry point): the
    dataset read with uint8 frames, predicted, fused and scored against
    the ground-truth PNGs in ``truth_dir`` (``*_newImg8bit.png`` ->
    ``*_final_mask.png``, ``*_leftImg8bit.png`` -> ``*_gtFine_color.png``;
    a missing one raises ``FileNotFoundError``).

    ``max_videos`` limits the val slice (the reference hook evaluates the
    full set every ``interval`` epochs; a slice keeps the train loop's
    stall bounded)."""
    from PIL import Image

    from slotvps_tpu_torch.data.dataset import CityscapesVPSDataset

    dataset = CityscapesVPSDataset(
        ann_file, img_prefix,
        nframes_span_test=cfg.data.nframes_span_test,
        iid_divisor=cfg.data.iid_divisor, scale=cfg.data.img_scale,
        uint8_images=True)
    n_frames = (max_videos * cfg.eval.nframes_per_video
                if max_videos else None)

    items = []
    for i in range(len(dataset)):
        if n_frames is not None and len(items) >= n_frames:
            break
        items.append(dataset[i])
    pred_pans_2ch, names = predict_panoptic(model, cfg, iter(items))

    with open(pan_gt_json_file) as f:
        gt_jsons = json.load(f)
    n = len(pred_pans_2ch)
    gt_images = gt_jsons["images"][:n]
    gt_annos = gt_jsons["annotations"][:n]
    files = sorted(i["file_name"]
                   .replace("_newImg8bit.png", "_final_mask.png")
                   .replace("_leftImg8bit.png", "_gtFine_color.png")
                   for i in gt_images)
    gt_pans = [np.array(Image.open(osp.join(truth_dir, f)))
               for f in files]
    return evaluate_panoptic(pred_pans_2ch, names, cfg,
                             gt_jsons["categories"], gt_annos, gt_pans,
                             output_dir=output_dir, verbose=verbose)
