"""End-to-end streaming inference + VPQ evaluation CLI for the port.

Counterpart of ``slotvps_tpu/cli/test_eval_vpq.py`` (streaming branch):
build the model -> stream frames through the port's
``InferencePipeline`` -> fuse panoptic outputs -> write pred.json +
pan_pred/*.png -> compute VPQ at window sizes 0, 5, 10, 15.  Dataset,
fusion and VPQ are the port's own copies (``slotvps_tpu_torch/data``,
``slotvps_tpu_torch/eval``).

Weights come from the port's seeded init: loading a published ``.pth`` is
not ported yet.

Usage:
  python -m slotvps_tpu_torch.cli.test_eval_vpq --tuned \
      --ann_file data/cityscapes_vps/im_all_info_val_city_vps.json \
      --img_prefix data/cityscapes_vps/val/img_all \
      --out work_dirs/out.pkl \
      --truth_dir data/cityscapes_vps/val/panoptic_video \
      --pan_gt_json_file data/cityscapes_vps/panoptic_gt_val_city_vps.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import os.path as osp
import pickle
import time

import numpy as np
import torch

from slotvps_tpu_torch.config import named_config
from slotvps_tpu_torch.data.dataset import CityscapesVPSDataset
from slotvps_tpu_torch.data.loader import PrefetchLoader
from slotvps_tpu_torch.eval import vpq as vpq_mod
from slotvps_tpu_torch.eval.fusion import inference_panoptic_video, unify_pan_result
from slotvps_tpu_torch.inference import InferencePipeline
from slotvps_tpu_torch.models.detector import init_model
from slotvps_tpu_torch.utils.precision import setup_precision


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="slotvps_tpu_torch test + VPQ "
                                            "eval (streaming)")
    p.add_argument("--config", default="r50_fpn_slotvps")
    p.add_argument("--ann_file", required=True)
    p.add_argument("--img_prefix", required=True)
    p.add_argument("--out", default="work_dirs/slotvps_tpu_torch/out.pkl")
    p.add_argument("--load", action="store_true",
                   help="resume from the cached *_pred_pans_2ch.pkl")
    p.add_argument("--truth_dir", default=None)
    p.add_argument("--pan_gt_json_file", default=None)
    p.add_argument("--pan_im_json_file", default=None)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the torch.Generator for the random init")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (the default) raises when "
                        "CUDA is absent")
    p.add_argument("--tuned", action="store_true",
                   help="the tuned stack of the JAX package's --tuned: "
                        "bf16 activations (parameters, norm statistics and "
                        "logits in f32), the bf16 Hopper DCN kernel "
                        "(dcn_impl='pallas') at per-level halos (2,3,4,6), "
                        "the semantic map from quarter-res logits on the "
                        "fused upsample+argmax kernel (fused_sseg), and the "
                        "fused postprocess on the Hopper theta, claim, "
                        "argmax and repair kernels (impl='fused', "
                        "detect_capacity kept at the config's value, 64 by "
                        "default); the Retriever stays plain "
                        "(retriever_impl='jax')")
    return p.parse_args(argv)


def tune_config(cfg):
    """The JAX package's ``tune_config``, field for field."""
    m = cfg.model
    m = dataclasses.replace(
        m, compute_dtype="bfloat16",
        semantic_head=dataclasses.replace(
            m.semantic_head, dcn_impl="pallas", fused_sseg=True,
            dcn_halo=(2, 3, 4, 6)[:m.semantic_head.num_levels]),
        postprocess=dataclasses.replace(m.postprocess, impl="fused"))
    return dataclasses.replace(cfg, model=m)


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available")
    return device


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    setup_precision()
    cfg = named_config(args.config)
    if args.tuned:
        cfg = tune_config(cfg)
    os.makedirs(osp.dirname(args.out) or ".", exist_ok=True)
    output_dir = args.out.replace(".pkl", "_pans_unified/")
    cache = args.out.replace(".pkl", "_pred_pans_2ch.pkl")

    dataset = CityscapesVPSDataset(
        args.ann_file, args.img_prefix,
        nframes_span_test=cfg.data.nframes_span_test,
        iid_divisor=cfg.data.iid_divisor,
        scale=cfg.data.img_scale,
        uint8_images=True)
    print(f"dataset: {len(dataset)} frames")

    if args.load and osp.exists(cache):
        with open(cache, "rb") as f:
            pred_pans_2ch = pickle.load(f)
        names = sorted(i["file_name"] for i in dataset.img_infos)
    else:
        print("WARNING: no checkpoint loading yet — using random init")
        model = init_model(torch.Generator().manual_seed(args.seed),
                           cfg.model, device=device)
        n_params = sum(p.numel() for p in model.parameters())
        print(f"Model Params : {n_params / 1e6:.2f} M on {device}")

        pipeline = None
        ssegs, panos, cls_inds, obj_ids, names = [], [], [], [], []
        t0 = time.time()
        for item in PrefetchLoader(dataset):
            meta = item["meta"]
            if pipeline is None:
                # emit at ori_shape: crops the /32 padding and resizes when
                # the processed size differs
                pipeline = InferencePipeline(
                    model, cfg, image_size=tuple(meta["ori_shape"][:2]),
                    valid_hw=tuple(meta["img_shape"][:2]))
            res = pipeline.process_frame(item["img"], meta["is_first"])
            ssegs.append(res.sseg)
            panos.append(res.panoptic)
            cls_inds.append(res.cls_inds)
            obj_ids.append(res.obj_ids)
            names.append(osp.basename(meta["filename"]))
            if len(names) % 50 == 0:
                dt = time.time() - t0
                print(f"[{len(names)}/{len(dataset)}] "
                      f"{len(names) / dt:.2f} frames/s")

        pans_2ch = unify_pan_result(
            ssegs, panos, cls_inds, obj_ids,
            stuff_area_limit=cfg.eval.panoptic_stuff_area_limit,
            id_last_stuff=cfg.eval.id_last_stuff)
        order = np.argsort(names)
        pred_pans_2ch = [pans_2ch[i] for i in order]
        names = [names[i] for i in order]
        with open(cache, "wb") as f:
            pickle.dump(pred_pans_2ch, f, protocol=2)

    if args.pan_im_json_file:
        with open(args.pan_im_json_file) as f:
            im_jsons = json.load(f)
        categories = im_jsons["categories"]
        names = sorted(x["file_name"] for x in im_jsons["images"])
    else:
        from slotvps_tpu_torch.eval.color import CITYSCAPES_CATEGORIES
        categories = list(CITYSCAPES_CATEGORIES)

    pred_pans, pred_json = inference_panoptic_video(
        pred_pans_2ch, output_dir, categories, names,
        nframes_per_video=cfg.eval.nframes_per_video,
        labeled_fid=cfg.eval.labeled_fid, lambda_=cfg.eval.lambda_)
    print(f"==> wrote {output_dir}pred.json "
          f"({len(pred_json['annotations'])} annotations)")

    summary = None
    if args.pan_gt_json_file and args.truth_dir:
        from PIL import Image

        with open(args.pan_gt_json_file) as f:
            gt_jsons = json.load(f)
        n = len(pred_json["annotations"])
        gt_images = gt_jsons["images"][:n]
        gt_annos = gt_jsons["annotations"][:n]
        cats = {el["id"]: el for el in gt_jsons["categories"]}
        files = sorted(i["file_name"]
                       .replace("_newImg8bit.png", "_final_mask.png")
                       .replace("_leftImg8bit.png", "_gtFine_color.png")
                       for i in gt_images)
        gt_pans = [np.array(Image.open(osp.join(args.truth_dir, f)))
                   for f in files]
        summary = vpq_mod.final_eval(
            pred_json["annotations"], gt_annos, gt_pans, pred_pans, cats,
            output_dir=output_dir,
            nframes_per_video=cfg.eval.nframes_per_video)
        for key in ("vpq_all", "vpq_thing", "vpq_stuff", "vpq_errp"):
            print(f"{key}:{summary[key]:.4f}")
    return summary


if __name__ == "__main__":
    main()
