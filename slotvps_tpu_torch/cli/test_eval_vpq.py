"""End-to-end inference + VPQ evaluation CLI for the port.

Counterpart of ``slotvps_tpu/cli/test_eval_vpq.py``: build the model ->
run the frames through the port's ``InferencePipeline`` (streaming, the
default), ``VideoScanner`` (``--scan``) or ``BatchedVideoPipeline``
(``--batch_videos N``) -> fuse panoptic outputs -> write pred.json +
pan_pred/*.png -> compute VPQ at window sizes 0, 5, 10, 15.  Dataset,
fusion and VPQ are the port's own copies (``slotvps_tpu_torch/data``,
``slotvps_tpu_torch/eval``).

Weights come from ``--checkpoint``: a reference ``.pth`` (converted on
load, ``utils/checkpoint.load_torch_checkpoint``) or a file of the port's
``save_checkpoint``; without one, from the seeded init.  With a checkpoint
the DCN halos are checked on three frames of the dataset
(``utils/diagnostics.check_dcn_halo``) and raised where the offsets would
clamp.

Usage:
  python -m slotvps_tpu_torch.cli.test_eval_vpq --tuned \
      --ann_file data/cityscapes_vps/im_all_info_val_city_vps.json \
      --img_prefix data/cityscapes_vps/val/img_all \
      --checkpoint weights.pth --out work_dirs/out.pkl \
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
from slotvps_tpu_torch.inference import (BatchedVideoPipeline,
                                         InferencePipeline, VideoScanner,
                                         _device_normalize)
from slotvps_tpu_torch.models.detector import init_model
from slotvps_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                load_torch_checkpoint)
from slotvps_tpu_torch.utils.diagnostics import check_dcn_halo
from slotvps_tpu_torch.utils.precision import setup_precision


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="slotvps_tpu_torch test + VPQ "
                                            "eval (streaming)")
    p.add_argument("--config", default="r50_fpn_slotvps")
    p.add_argument("--checkpoint", default=None,
                   help=".pth (reference format, converted on load), a "
                        "state dict of the port's save_checkpoint, or empty "
                        "for the seeded init")
    p.add_argument("--ann_file", required=True)
    p.add_argument("--img_prefix", required=True)
    p.add_argument("--out", default="work_dirs/slotvps_tpu_torch/out.pkl")
    p.add_argument("--load", action="store_true",
                   help="resume from the cached *_pred_pans_2ch.pkl")
    p.add_argument("--n_video", type=int, default=50,
                   help="accepted as the JAX CLI accepts it; not read")
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
    p.add_argument("--scan", action="store_true",
                   help="whole-clip inference with VideoScanner: track ids "
                        "assigned on the device and one readback of a "
                        "clip's outputs; needs videos that align with the "
                        "nframes_span_test chunks (raises otherwise); gives "
                        "the streaming results")
    p.add_argument("--batch_videos", type=int, default=0,
                   help="run frame t of N videos in lockstep with "
                        "BatchedVideoPipeline over every visible card (the "
                        "largest divisor of N that fits: a replica of the "
                        "model a card, N / cards videos each); the last "
                        "group is padded with copies of its "
                        "last video whose results are dropped; needs the "
                        "same chunk alignment as --scan; gives the "
                        "streaming results wherever batch N gives the "
                        "floats of batch 1")
    p.add_argument("--save_diff_fig", action="store_true",
                   help="write pan_diff/*.png error maps (pred - gt, "
                        "zeroed where gt == 0; reference eval_vpq.py:463-470)")
    p.add_argument("--debug_postproc", action="store_true",
                   help="per-frame postprocess diagnostics: kept thing "
                        "classes and scores, track ids and per-id pixel "
                        "areas")
    p.add_argument("--draw_line_charts", action="store_true",
                   help="per-video / per-category VPQ figures (reference "
                        "--draw_line_charts)")
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


def build_model(args, cfg, device):
    """The model of ``cfg.model`` on ``device``, its weights from
    ``args.checkpoint`` (the JAX CLI's ``build_params``)."""
    model = init_model(torch.Generator().manual_seed(args.seed), cfg.model,
                       device=device)
    if args.checkpoint and args.checkpoint.endswith(".pth"):
        model.load_state_dict(load_torch_checkpoint(args.checkpoint,
                                                    cfg.model), strict=True)
    elif args.checkpoint:
        load_checkpoint(args.checkpoint, model)
    else:
        print("WARNING: no checkpoint given — using random init")
    return model


def calibrate_halos(model, cfg, dataset, device):
    """A checkpoint's offsets against the DCN halos, measured on frames 0,
    n/2 and n-1 of ``dataset`` ([1, H, W, 3] uint8 each) as the device
    normalizes them; returns ``cfg`` with ``semantic_head.dcn_halo`` raised
    where they would clamp."""
    frames = []
    for i in sorted({0, len(dataset) // 2, len(dataset) - 1}):
        item = dataset[i]
        frames.append(_device_normalize(
            torch.from_numpy(item["img"]).to(device), cfg.data,
            valid_hw=item["meta"]["img_shape"][:2]))
    mx, eff, rec = check_dcn_halo(model, cfg.model, warn=False,
                                  images=frames)
    print(f"DCN offsets: checkpoint emits up to {mx:.2f} px (per-level "
          f"halos in effect: {eff} px)")
    if rec == eff:
        return cfg
    print(f"WARNING: raising dcn_halo {eff} -> {rec} so no sample clamps")
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, semantic_head=dataclasses.replace(m.semantic_head,
                                             dcn_halo=rec)))


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available")
    return device


def video_chunks(dataset, cfg, batch_videos=0):
    """Per-video item lists of ``nframes_span_test`` frames; raises unless
    every chunk starts a video and holds no other start (the track pool and
    the carried reference features must not bleed across videos)."""
    span = cfg.data.nframes_span_test
    # decode about half a group ahead, so the host's decoding overlaps the
    # card's steps (~6 MB per decoded uint8 1024x2048 frame)
    depth = max(2, (span * batch_videos + 1) // 2) if batch_videos else 2
    items, done = [], 0
    for item in PrefetchLoader(dataset, prefetch=depth):
        items.append(item)
        if len(items) == span or done + len(items) == len(dataset):
            firsts = [i for i, it in enumerate(items)
                      if it["meta"].get("is_first")]
            if firsts != [0]:
                raise RuntimeError(
                    f"--scan/--batch_videos need videos aligned with "
                    f"nframes_span_test={span} chunks, but the chunk "
                    f"starting at frame {done} has is_first flags at "
                    f"positions {firsts} (expected [0]); run without them "
                    "(streaming)")
            done += len(items)
            yield items
            items = []


def visible_devices(model) -> list:
    """Every visible card when the model lies on one (the JAX CLI's
    ``jax.devices()``), the model's device first; else the model's
    device."""
    dev = next(model.parameters()).device
    if dev.type != "cuda":
        return [dev]
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev] + [c for c in cards if c != dev]


def run_batched(model, cfg, bsz, chunks, sizes, emit):
    """Groups of ``bsz`` videos through :class:`BatchedVideoPipeline`; the
    tail group is padded with copies of its last video, whose results are
    dropped.  Prints each group's frames/s."""
    pipeline = None
    videos, metas = [], []

    def flush():
        nonlocal pipeline
        nvid = len(videos)
        while len(videos) < bsz:
            videos.append(videos[-1])
            metas.append(metas[-1])
        if pipeline is None:
            pipeline = BatchedVideoPipeline(model, cfg, bsz,
                                            devices=visible_devices(model),
                                            **sizes(metas[0][0]))
            print(f"batched inference: {bsz} videos a step, "
                  f"n_devices {pipeline.n_devices}")
        tg = time.time()
        res = pipeline.run_videos(videos)
        dt = time.time() - tg
        n_len = len(videos[0])
        print(f"group of {nvid} videos: {nvid * n_len} frames in {dt:.2f} s "
              f"= {bsz * n_len / dt:.2f} frames/s (the card's steps and the "
              "readback; the first group includes the kernels' build)")
        for v in range(nvid):
            for t, meta in enumerate(metas[v]):
                emit(res[v][t], meta)
        videos.clear()
        metas.clear()

    for items in chunks:
        videos.append([i["img"] for i in items])
        metas.append([i["meta"] for i in items])
        if len(videos) == bsz:
            flush()
    if videos:
        flush()


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
        model = build_model(args, cfg, device)
        n_params = sum(p.numel() for p in model.parameters())
        print(f"Model Params : {n_params / 1e6:.2f} M on {device}")
        if args.checkpoint:
            cfg = calibrate_halos(model, cfg, dataset, device)

        ssegs, panos, cls_inds, obj_ids, names = [], [], [], [], []
        t0 = time.time()

        def emit(res, meta):
            ssegs.append(res.sseg)
            panos.append(res.panoptic)
            cls_inds.append(res.cls_inds)
            obj_ids.append(res.obj_ids)
            names.append(osp.basename(meta["filename"]))
            if args.debug_postproc:
                ids, areas = np.unique(res.panoptic, return_counts=True)
                area_of = dict(zip(ids.tolist(), areas.tolist()))
                thing_areas = [area_of.get(cfg.model.stuff_num + r, 0)
                               for r in range(len(res.cls_inds))]
                print(f"[postproc] {names[-1]}: {len(res.cls_inds)} things "
                      f"kept cls={res.cls_inds.tolist()} "
                      f"prob={[round(float(p), 3) for p in res.cls_prob]} "
                      f"obj_ids={res.obj_ids.tolist()} areas={thing_areas} "
                      f"void={area_of.get(255, 0)}")
            if len(names) % 50 == 0:
                dt = time.time() - t0
                print(f"[{len(names)}/{len(dataset)}] "
                      f"{len(names) / dt:.2f} frames/s")

        # emit at ori_shape: crops the /32 padding and resizes when the
        # processed size differs
        def sizes(meta):
            return dict(image_size=tuple(meta["ori_shape"][:2]),
                        valid_hw=tuple(meta["img_shape"][:2]))

        if args.scan:
            scanner = None
            for items in video_chunks(dataset, cfg):
                if scanner is None:
                    scanner = VideoScanner(model, cfg,
                                           **sizes(items[0]["meta"]))
                for res, it in zip(scanner.run_video(
                        [i["img"] for i in items]), items):
                    emit(res, it["meta"])
        elif args.batch_videos:
            run_batched(model, cfg, args.batch_videos,
                        video_chunks(dataset, cfg, args.batch_videos),
                        sizes, emit)
        else:
            pipeline = None
            for item in PrefetchLoader(dataset):
                meta = item["meta"]
                if pipeline is None:
                    pipeline = InferencePipeline(model, cfg, **sizes(meta))
                emit(pipeline.process_frame(item["img"], meta["is_first"]),
                     meta)

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
        if args.save_diff_fig:
            vpq_mod.save_diff_figs(pred_pans, gt_pans,
                                   [str(i["id"]) + ".png" for i in gt_images],
                                   output_dir)
        summary = vpq_mod.final_eval(
            pred_json["annotations"], gt_annos, gt_pans, pred_pans, cats,
            output_dir=output_dir,
            nframes_per_video=cfg.eval.nframes_per_video,
            draw_charts=args.draw_line_charts)
        for key in ("vpq_all", "vpq_thing", "vpq_stuff", "vpq_errp"):
            print(f"{key}:{summary[key]:.4f}")
    return summary


if __name__ == "__main__":
    main()
