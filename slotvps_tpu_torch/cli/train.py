"""Training CLI of the port (counterpart of ``slotvps_tpu/cli/train.py``),
on one device.

The data recipe is the reference's released train pipeline (the port's
``data/transforms.py``: multiscale resize, flip, normalize, random crop
800x1600, pad, semantic map at 1/4, the pseudo-video shift) over
reference-frame sampling with the offsets grammar; the losses are
``training/losses.py``; the optimizer is AdamW lr 1e-4 wd 1e-4 clip 1.0
with 500 warm-up iterations at ratio 1/3 and steps at epochs 8 and 11 of
12 (reference r50_fpn_slotvps.py:195-208), over RepeatDataset(times=8)
epochs.  The train state (the model's ``state_dict``, the optimizer's state
and the step) is saved with ``torch.save`` each epoch and resumed with
``--resume_from``.  With ``--eval_every N`` and the ``--val_*`` files, the
val VPQ of the model being trained is taken every N epochs
(``eval/hooks.run_val_eval``, the reference's DistEvalHook) and written
under ``<work_dir>/val_epoch_<e>``.  The image pipeline needs ``cv2``.
Training runs with ``compute_dtype="float32"``, with either backbone
(``--config swinl_fpn_slotvps`` trains Swin-L).

Data parallel under a launcher (torchrun, SLURM, Open MPI;
``parallel/env.init_distributed``): one process a card, a step's batch is
``--batch_per_device`` times the processes, as the JAX package's mesh over
every device.  Each process builds the step's whole batch, as one process
would, and keeps its rows (``parallel/mesh.batch_rows``), so the crops a
step trains on do not depend on the number of processes; the gradients are
averaged over the processes (``training/step.train_step`` with the
group).  Process 0 alone logs, writes the train state and runs the eval
hook; the others wait at a barrier.

Usage:
  python -m slotvps_tpu_torch.cli.train --ann_file ... --img_prefix ... \\
      --seg_prefix ... --work_dir work_dirs/run1 [--device cuda]
  torchrun --nproc_per_node N -m slotvps_tpu_torch.cli.train ...
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from slotvps_tpu_torch.cli.test_eval_vpq import resolve_device
from slotvps_tpu_torch.config import named_config


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="slotvps_tpu_torch train")
    p.add_argument("--config", default="r50_fpn_slotvps")
    p.add_argument("--ann_file", required=True)
    p.add_argument("--img_prefix", required=True)
    p.add_argument("--seg_prefix", default=None,
                   help="semantic labelmap dir (train/labelmap); without "
                        "it loss_sem has nothing to supervise")
    p.add_argument("--work_dir", default="work_dirs/slotvps_tpu_torch")
    p.add_argument("--resume_from", default=None)
    p.add_argument("--total_epochs", type=int, default=12)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--batch_per_device", type=int, default=1,
                   help="samples a process; a step's batch is this times "
                        "the processes")
    p.add_argument("--crop", type=int, nargs=2, default=(800, 1600))
    p.add_argument("--gt_capacity", type=int, default=64)
    p.add_argument("--offsets", default="0_shift_3")
    p.add_argument("--repeat_times", type=int, default=8)
    p.add_argument("--log_interval", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dcn_impl", default=None,
                   choices=["jax", "pallas", "pallas_f32"],
                   help="semantic-tower DCN (default: the config's): "
                        "'jax' the plain PyTorch DCN, 'pallas_f32' / "
                        "'pallas' the Hopper kernels in f32 / bf16, "
                        "forward and backward")
    p.add_argument("--data_workers", type=int, default=2,
                   help="batch-assembly worker threads")
    p.add_argument("--prefetch_batches", type=int, default=2,
                   help="per-worker look-ahead of assembled batches")
    # train-time periodic eval (reference DistEvalHook,
    # mmdet/core/evaluation/eval_hooks.py:20-83)
    p.add_argument("--eval_every", type=int, default=0,
                   help="run val VPQ every N epochs (0 = off)")
    p.add_argument("--val_ann_file", default=None)
    p.add_argument("--val_img_prefix", default=None)
    p.add_argument("--val_truth_dir", default=None)
    p.add_argument("--val_pan_gt_json_file", default=None)
    p.add_argument("--val_max_videos", type=int, default=10,
                   help="bound the val slice evaluated per hook firing")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (the default) raises when "
                        "CUDA is not available")
    return p.parse_args(argv)


def lr_schedule(base_lr, steps_per_epoch, total_epochs=12,
                warmup_iters=500, warmup_ratio=1.0 / 3,
                decay_epochs=(8, 11)):
    """Step schedule with linear warmup (reference r50_fpn_slotvps.py:
    198-208): ``schedule(count)`` is the lr of update ``count`` (from 0),
    scaled by 0.1 from each decay boundary on, as optax's
    ``piecewise_constant_schedule``."""
    boundaries = {e * steps_per_epoch: 0.1 for e in decay_epochs}

    def schedule(count):
        if count < warmup_iters:
            return base_lr * (warmup_ratio
                              + (1 - warmup_ratio) * count / warmup_iters)
        lr = base_lr
        for boundary, scale in boundaries.items():
            if count >= boundary:
                lr *= scale
        return lr

    return schedule


def _frame_gt(dataset, idx, seg_prefix, semantic2label):
    """Decode one frame's GT into a transforms.FrameGT."""
    from slotvps_tpu_torch.data.mask import decode_mask
    from slotvps_tpu_torch.data.transforms import FrameGT

    ann = dataset.parse_ann_info(idx)
    h = dataset.img_infos[idx].get("height")
    w = dataset.img_infos[idx].get("width")
    masks = []
    for m in ann["masks"]:
        if m is None:
            masks.append(np.zeros((h, w), np.uint8))
        else:
            masks.append(decode_mask(m, h, w).astype(np.uint8))
    semantic = None
    if seg_prefix is not None:
        semantic = dataset.load_semantic(idx, seg_prefix, semantic2label)
    return FrameGT(bboxes=ann["bboxes"], labels=ann["labels"],
                   obj_ids=ann["obj_ids"], masks=masks, semantic=semantic)


def make_sample(dataset, idx, args, cfg, rng, aug):
    """One training sample through the full reference pipeline; returns
    None when the sample has no usable GT (caller resamples)."""
    from slotvps_tpu_torch.data.dataset import CITYSCAPES_SEMANTIC2LABEL
    from slotvps_tpu_torch.data.transforms import apply_train_pipeline

    # RepeatDataset indices run to times*N-1; base-dataset methods need the
    # base-space index
    if hasattr(dataset, "translate_index"):
        idx = dataset.translate_index(idx)
    ref = dataset.sample_train_refs(idx, args.offsets, rng)
    if ref is None:
        return None
    gt = _frame_gt(dataset, idx, args.seg_prefix,
                   CITYSCAPES_SEMANTIC2LABEL)
    if len(gt.labels) == 0:
        return None
    ref_idx = ref.ref_indices[int(rng.integers(0, len(ref.ref_indices)))]
    img = dataset.load_image(idx)
    if ref.pseudo_video:
        ref_img, ref_gt = None, None
    else:
        ref_img = dataset.load_image(ref_idx)
        ref_gt = _frame_gt(dataset, ref_idx, args.seg_prefix,
                           CITYSCAPES_SEMANTIC2LABEL)
        if len(ref_gt.labels) == 0:
            return None
    return apply_train_pipeline(img, gt, ref_img, ref_gt, aug, rng,
                                pseudo_video=ref.pseudo_video)


def _pad_gt(gt, gt_pids, capacity, quarter_shape, stuff_offset,
            semantic_nx=None, num_stuff=11):
    """Pad variable-length FrameGT to the fixed capacity at 1/4 res; with
    ``semantic_nx`` (quarter-res semantic map, 255 = ignore) one STUFF slot
    is appended per present stuff class (ids < num_stuff), as MaX-DeepLab
    style slot training supervises stuff regions."""
    import cv2

    g = capacity
    qh, qw = quarter_shape
    labels = np.zeros((g,), np.int32)
    masks = np.zeros((g, qh, qw), np.float32)
    valid = np.zeros((g,), bool)
    pids = np.zeros((g,), np.int32)
    n = min(len(gt.labels), g)
    for i in range(n):
        labels[i] = gt.labels[i] + stuff_offset  # things in 19-class space
        masks[i] = cv2.resize(gt.masks[i].astype(np.uint8), (qw, qh),
                              interpolation=cv2.INTER_NEAREST)
        valid[i] = True
        if gt_pids is not None:
            pid = int(gt_pids[i])
            pids[i] = pid if pid <= g else 0
    if semantic_nx is not None:
        for cls in [c for c in np.unique(semantic_nx) if c < num_stuff]:
            if n >= g:
                break
            labels[n] = int(cls)
            masks[n] = (semantic_nx == cls).astype(np.float32)
            valid[n] = True
            n += 1
    return labels, masks, valid, pids


def make_batch(dataset, indices, args, cfg, rng, aug):
    """Host-side batch assembly through the real train pipeline; a
    TrainBatch of CPU tensors."""
    from slotvps_tpu_torch.training.step import TrainBatch

    stuff_offset = cfg.model.stuff_num - 1
    ch, cw = args.crop
    qh, qw = ch // 4, cw // 4
    cols = {f: [] for f in TrainBatch._fields}
    for idx in indices:
        out = None
        for _ in range(20):  # resample on degenerate crops/shifts
            out = make_sample(dataset, int(idx), args, cfg, rng, aug)
            if out is not None:
                break
            idx = int(rng.integers(0, len(dataset)))
        if out is None:
            raise RuntimeError("could not sample a valid training clip")
        sem = out["gt_semantic_seg_nx"]
        if sem is None:
            sem = np.full((qh, qw), 255, np.int32)
        n_stuff = cfg.model.stuff_num - 1  # 11 stuff classes (0..10)
        labels, masks, valid, pids = _pad_gt(
            out["gt"], out["gt_pids"], args.gt_capacity, (qh, qw),
            stuff_offset, semantic_nx=sem, num_stuff=n_stuff)
        ref_sem = out.get("ref_semantic_seg")
        rlabels, rmasks, rvalid, _ = _pad_gt(
            out["ref_gt"], None, args.gt_capacity, (qh, qw), stuff_offset,
            # nearest-subsample to the mask grid (seg_nx equivalent)
            semantic_nx=None if ref_sem is None else ref_sem[::4, ::4],
            num_stuff=n_stuff)
        cols["img"].append(out["img"])
        cols["ref_img"].append(out["ref_img"])
        cols["gt_labels"].append(labels)
        cols["gt_masks"].append(masks)
        cols["gt_valid"].append(valid)
        cols["gt_semantic"].append(sem.astype(np.int32))
        cols["ref_gt_labels"].append(rlabels)
        cols["ref_gt_masks"].append(rmasks)
        cols["ref_gt_valid"].append(rvalid)
        cols["gt_pids"].append(pids)
    return TrainBatch(**{k: torch.from_numpy(np.stack(v))
                         for k, v in cols.items()})


def save_train_state(path, model, optimizer, step):
    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict(), "step": int(step)},
               path)


def load_train_state(path, model, optimizer, device):
    """Loads into ``model`` and ``optimizer`` in place; returns the step."""
    state = torch.load(path, map_location=device)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])


def main(argv=None):
    from slotvps_tpu_torch.parallel.env import init_distributed

    args = parse_args(argv)
    device = init_distributed(device=args.device)
    try:
        _train(args, device)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _train(args, device):
    """The training loop; ``device`` is the process's card under a
    launcher, None in one process."""
    from slotvps_tpu_torch.data.dataset import (CityscapesVPSDataset,
                                                RepeatDataset)
    from slotvps_tpu_torch.data.loader import prefetch_ordered
    from slotvps_tpu_torch.data.sampler import (aspect_ratio_flags,
                                                group_shuffled_indices)
    from slotvps_tpu_torch.data.transforms import TrainAugConfig
    from slotvps_tpu_torch.models.detector import init_model
    from slotvps_tpu_torch.parallel.env import (broadcast_state,
                                                process_count,
                                                process_index)
    from slotvps_tpu_torch.parallel.mesh import batch_rows, make_mesh
    from slotvps_tpu_torch.training.step import (TrainBatch,
                                                 check_trainable,
                                                 make_optimizer, train_step)
    from slotvps_tpu_torch.utils.precision import setup_precision
    from slotvps_tpu_torch.utils.profiler import (count_params,
                                                  params_to_string)

    dist = torch.distributed
    group, mesh = None, None
    if device is None:
        device = resolve_device(args.device)
    else:
        group, mesh = dist.group.WORLD, make_mesh()
    lead = process_index() == 0

    def barrier():
        if group is not None:
            dist.barrier()

    def say(msg):
        if lead:
            print(msg, flush=True)

    setup_precision()
    cfg = named_config(args.config)
    if args.dcn_impl:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, semantic_head=dataclasses.replace(
                cfg.model.semantic_head, dcn_impl=args.dcn_impl)))
    check_trainable(cfg.model)
    if lead:
        os.makedirs(args.work_dir, exist_ok=True)

    dataset = RepeatDataset(
        CityscapesVPSDataset(args.ann_file, args.img_prefix),
        args.repeat_times)
    aug = TrainAugConfig(crop_size=tuple(args.crop))
    batch = args.batch_per_device * process_count()
    rows = batch_rows(batch, mesh)
    # aspect-ratio group sampling: each batch draws from one orientation
    # group; steps/epoch comes from the sampled order
    flags = np.tile(aspect_ratio_flags(dataset.img_infos),
                    args.repeat_times)
    steps_per_epoch = max(
        len(group_shuffled_indices(flags, batch,
                                   np.random.default_rng(0))) // batch, 1)
    say(f"dataset: {len(dataset)} frames (x{args.repeat_times} repeat), "
        f"{process_count()} process(es) on {device.type}, batch {batch}, "
        f"{steps_per_epoch} steps/epoch")

    model = init_model(torch.Generator().manual_seed(args.seed), cfg.model,
                       device=device)
    say(f"Model Params : {params_to_string(count_params(model))}")
    optimizer = make_optimizer(model, lr=lr_schedule(
        args.lr, steps_per_epoch, args.total_epochs))
    start_it = 0
    if args.resume_from:
        start_it = load_train_state(args.resume_from, model, optimizer,
                                    device)
        say(f"resumed from {args.resume_from} at iter {start_it}")
    broadcast_state(model)

    it = start_it
    t0 = time.time()
    host_wait = 0.0
    for epoch in range(start_it // steps_per_epoch, args.total_epochs):
        # per-epoch / per-step rngs: deterministic under resume and under
        # parallel batch assembly
        order = group_shuffled_indices(
            flags, batch, np.random.default_rng((args.seed, epoch)))

        def build(s):
            srng = np.random.default_rng((args.seed, epoch, int(s)))
            idxs = order[s * batch:(s + 1) * batch]
            return make_batch(dataset, idxs, args, cfg, srng, aug)

        s0 = it % steps_per_epoch
        # batch assembly overlaps the device step
        stream = prefetch_ordered(build, range(s0, steps_per_epoch),
                                  prefetch=args.prefetch_batches,
                                  num_threads=args.data_workers)
        for _ in range(s0, steps_per_epoch):
            tw = time.perf_counter()
            hb = TrainBatch(*(a[rows] for a in next(stream)))
            host_wait += time.perf_counter() - tw
            metrics = train_step(model, optimizer, hb.to(device), cfg.model,
                                 group=group)
            it += 1
            if it % args.log_interval == 0:
                n_it = max(it - start_it, 1)
                dt = (time.time() - t0) / n_it
                say(f"epoch {epoch} iter {it}: "
                    + " ".join(f"{k}={float(v):.4f}"
                               for k, v in metrics.items())
                    + f" ({dt:.2f}s/iter, host wait "
                    + f"{host_wait / n_it:.2f}s/iter)")
        if lead:
            save_train_state(os.path.join(args.work_dir,
                                          f"epoch_{epoch + 1}.pt"),
                             model, optimizer, it)
        if (lead and args.eval_every and (epoch + 1) % args.eval_every == 0
                and args.val_ann_file):
            # periodic val VPQ with the live model (reference
            # DistEvalHook, eval_hooks.py:20-83)
            from slotvps_tpu_torch.eval.hooks import run_val_eval

            te = time.time()
            summary = run_val_eval(
                model, cfg, args.val_ann_file, args.val_img_prefix,
                args.val_truth_dir, args.val_pan_gt_json_file,
                output_dir=os.path.join(args.work_dir,
                                        f"val_epoch_{epoch + 1}"),
                max_videos=args.val_max_videos)
            print(f"[eval] epoch {epoch + 1}: "
                  f"vpq_all={summary['vpq_all']:.2f} "
                  f"vpq_thing={summary['vpq_thing']:.2f} "
                  f"vpq_stuff={summary['vpq_stuff']:.2f} "
                  f"({time.time() - te:.0f}s)")
        # the other processes wait for process 0's state and hook
        barrier()
    say("done")


if __name__ == "__main__":
    main()
