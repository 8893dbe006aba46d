#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (slotvps_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises, exit code != 0):
  1. device   — card name and power limit, torch/CUDA versions; the port's
     precision setup (no TF32, bf16 products reduced in f32).
  2. build    — compile the four kernel libraries from
     slotvps_tpu_torch/csrc/ (one nvcc each, started together); one line
     per wgmma kernel (the DCN forward and the DCN backward's data and dW
     passes in bf16 and in f32, slot attention's pass 1) and per instance
     of the f32 slot-attention kernel (slot_attn_f32_kernel, 64, 104 and
     128 slots) with its registers, dynamic shared memory and spills from
     ptxas; each DCN
     kernel's shared memory as the wrapper states it against the
     library's; the same lines for the two persistent claim kernels
     (claim_scan_kernel, claim_kernel; one instance per bit-word width)
     and their shared memory as claim_geometry states it against the
     libraries'.
  3. kernels  — each kernel against its plain PyTorch version on the card,
     with CUDA-event times of both and the bound: the DCN kernel in f32 and
     in bf16 at the 12 (tower block, FPN level) shapes of a 1024x2048
     frame, each at its level's halo; theta, claim, argmax and repair at
     K = 64 and K = 100 slots of 256x512 low-res masks, with small segments
     so that repair has dirty tiles; sseg on [256, 512, 19] quarter-res
     logits with ties; slot attention at the decoder's four pixel counts,
     in bf16 and in f32 (the f32 kernel also at L = 1, 64, 65, 104, 105,
     128 and P = 1, 64, 777, 4133); argmax with its runner-up map (top2)
     and hist at K = 64; hist's edge cases (HIST_CASES: one id
     everywhere, random ids, runs, ids outside [0, K), K = 1 and 4096, n
     not a multiple of 4, 37 ids) at 16 x 256 x 512 ids, bit for bit.
     The claim loops' edge cases (claim_cases): more than 32 valid things,
     K = 127, all-0 and all-1 planes, B = 2 with different numbers of
     valid things, and batches past the shared-memory geometry (the owner
     tile, then the bit words in device memory): the claim scan on
     contiguous and K-minor planes, the theta claim on slot-major and
     K-minor masks, each bit-identical to its plain version, equal in two
     runs, one launch a call.
     Batch invariance: the bf16 and the f32 DCN at a P3 shape with B = 2
     against each image alone, slot attention in bf16 and in f32 with
     B = 2 at P = 32768 against each batch element alone, bit for bit, and
     two runs equal.
     At the 12 shapes of the 800x1600 training crop (B=2: the reference
     and the current frame), each level at its halo, with offsets that
     clamp some taps: the DCN forward kernel on the f32 model's bf16 route
     (f32 x and offsets, bf16 compute, f32 output) and the f32 DCN
     forward (the pallas_f32 step's), and the DCN backward kernel in f32
     and in bf16 against the plain backward (dx, doff and dW each equal in
     two runs), with the profiler's device time of each of its passes
     (data, dx, dW, reduction, the weight image, f32 g's transposed
     split, the wrapper's casts) and the host's time to enqueue a call,
     summed over the 12 shapes.
  4. slice    — r50_fpn_slotvps at full width and 1024x2048, the JAX
     package's tuned stack with the slot-attention kernel (bf16, bf16 DCN
     kernel, fused_sseg, fused postprocess, retriever_impl="pallas"),
     seeded random weights doctored and calibrated so ~48 slots clear the
     0.85 keep threshold; a 6-frame synthetic uint8 clip through
     InferencePipeline (run_video and process_frame); counts every
     kernel's launches on that path and checks the outputs.  Then the f32
     path of the earlier slices (f32 DCN kernel, full-res semantic logits,
     fused postprocess) on the first 3 frames with the same weights, with
     its own launch counts.
  4b. checkpoint — the path a user takes to evaluate published weights, on
     the f32 Pallas-Retriever path (the f32 path with
     retriever_impl="pallas": the f32 slot-attention kernel): the same
     weights written as a reference-format .pth (reference_state_dict),
     loaded by utils/checkpoint.load_torch_checkpoint (state_dict equal bit
     for bit), check_dcn_halo on the clip's first 3 frames (per-level
     maxima, recommendation taken), those frames through InferencePipeline
     with the launch counts (14 f32 slot-attention launches a frame),
     steady ms a frame and peak memory, and the integer outputs against the
     plain-Retriever route with the same weights.
  4c. cli     — the eval CLI's main with --checkpoint <that .pth>
     --save_diff_fig on a synthetic 2-video x 2-frame 1024x2048 dataset on
     disk, on the same path: a VPQ summary, the halo line, pred.json and
     the diff figures.
  5. postproc — on two clip frames, the bf16 path's decoder outputs go
     through postprocess_frame with impl="fused" (the kernels, sseg on the
     quarter-res logits) and impl="jax" (the reference path): equal sseg,
     panoptic >= 99.99 %.
  5b. fused   — the counterparts of postproc_fused.py's three TPU kernels
     (theta, claim, argmax-areas on K-minor [h, w, K] masks) as a chain on
     two inputs: 256x512x100 random-normal masks (the JAX package's
     profiling shape) and the bf16 path's first clip frame; launches
     counted; each kernel against its plain version; on the real frame the
     chain against the v3 kernels' chain on the same masks (bit-identical
     given the same theta); kernel and plain times.
  6. stages   — per-stage times of the frame (device synchronize between
     stages) for the bf16 and the f32 path, the postprocess with each impl,
     and a torch.profiler pass each: device time by kernel and busy share.
  7. plain    — the first frames again, fully plain in bf16
     (dcn_impl="jax", retriever_impl="jax", postprocess impl="jax") on the
     card: no kernel launches; pixel agreement with the kernel path; and
     the bf16 path's agreement with the f32 path, printed.
  8. serving  — with the same weights: the claim-scan kernel against its
     plain version on the binarized planes of two real 1024x2048 frames of
     the f32 path (K = 100; B = 1 and B = 2; and the K-minor layout against
     the contiguous copy); BatchedVideoPipeline with B = 2 videos of 2
     frames on the f32 path with postprocess impl="pallas" against the same
     run with impl="jax" and against each video's streaming run (both
     bit-identical) and both postprocess stages' times;
     BatchedVideoPipeline with B = 2 videos of 3 frames on the bf16 path
     against each video's streaming run (bit-identical), every DCN and
     slot-attention call of the run against its plain version (slot
     attention's in float64) on the inputs the batched path gives it, ms
     per lockstep step, frames/s and peak memory;
     VideoScanner on the bf16 path over the clip's first 3 frames against
     their streaming results (bit-identical).  Each run's launch counts
     are set to 0 just before it and read just after.
  9. train    — r50_fpn_slotvps at full width, the JAX package's training
     configuration (f32, the bf16 DCN kernels forward and backward, halos
     (2, 3, 4, 6), full-res semantic logits, the plain Retriever), seeded
     random weights, one 800x1600 synthetic scene (batch 1, 64 GT slots):
     5 AdamW steps through training/step.train_step with their launch
     counts, losses, ms/step and peak memory; a step split into forward /
     backward / optimizer and a profiler pass over one more; then, with
     fixed_match, the loss terms and every gradient of one step with
     dcn_impl="pallas_f32" against one with the plain DCN, each step's ms
     and, in one more pallas_f32 step under the profiler, its DCN
     kernels' device ms.
  9b. train_eval — the rest of training at full width, the same
     configuration: utils/synthetic.overfit for 20 steps on the 800x1600
     synthetic scene (BN calibration with its replay check, norm caps, FPN
     gain fix, two optimizer groups; its probe fires once), with its
     launch counts, ms a step, peak memory and the probe's confident
     slots; then eval/hooks.run_val_eval with the trained model on a
     2-frame 1024x2048 video of the scene written to disk, on the fused
     postprocess: launch counts, kept things a frame, wall time and the
     VPQ summary.
  9c. train_cli — cli/train.py's main with --dcn_impl pallas --eval_every
     1: one epoch of one step on a one-frame training set on disk, then
     the hook on a 2-frame val set: the epoch's state, pred.json and
     vpq-final.txt, and the launch counts.
  8b. swin    — swinl_fpn_slotvps (Swin-L) at 1024x2048 with seeded
     weights doctored and calibrated (~48 slots on a probe frame): the
     bf16 --tuned stack with the slot-attention kernel on 3 frames
     through InferencePipeline with its launch counts (DCN 12, slot
     attention 14, sseg / theta / claim / argmax 1 a frame, repair
     n_loop), its stage times and a profiler pass, the fully plain bf16
     path (the rule of phase 7); the f32 path with the f32 DCN and
     slot-attention kernels on 2 frames with its launch counts, against
     the plain Retriever (the checkpoint phase's rule) and against both
     plain routes (the semantic map may differ only at ties within
     SSEG_TIE of the plain logits); the weights as a reference-format Swin .pth
     (~0.9 GB, deleted after), loaded bit for bit, check_dcn_halo; the
     eval CLI with --config swinl_fpn_slotvps --tuned --checkpoint on 1
     video x 2 frames.  Extract ms, steady ms a frame, peak memory and
     launches beside the card's name and power limit.
  8c. plugins — r50_fpn_slotvps with the R52 stem and the DCN and GCNet
     plugins on stages 2-4: one f32 1024x2048 frame after
     calibrate_bn_stats, outputs finite, the semantic head's 12 f32 DCN
     launches and the fused postprocess kernels counted.
  8d. multi   — BatchedVideoPipeline at B = 2 over every visible card (a
     replica of the model and one video a card; with one card two
     replicas on cuda:0, each on its own stream, and a line saying that
     the cross-card path was not run), in the bf16 tuned stack and in f32:
     each video equal to its streaming run bit for bit, the launches of a
     decoder call a replica and step, ms per lockstep step beside the
     one-card batched step.
  8e. tuned_vs_exact — utils/parity.tuned_vs_exact, the bf16 tuned stack
     (the bf16 DCN, sseg and fused postprocess kernels) against the f32
     plain stack (plain DCN, reference postprocess) on the same weights
     and frames: the calibrated regime (doctored, 48 slots packed at the
     keep rule) at 1024x2048 and the trained one (150 overfit steps with
     the DCN kernels and parity's TRAINED_OVERFIT, 6 things) at 256x512,
     2 frames each; each streaming step of the two routes with its
     launches (none on the exact route; 12 bf16 DCN and the fused
     postprocess kernels a tuned frame), the kept and thing counts, the
     aggregates
     held to TVE_BOUNDS (the JAX package's floors), the halo assertion
     inside; wall seconds and peak memory.
  9d. ddp     — a world-1 process group (init_distributed on localhost,
     NCCL): one data-parallel train step (train_step with the group) of
     the R50 training model against the plain step from the same state
     and batch: loss terms, all-reduced gradients and the parameters after
     the update (DDP_* tolerances; a second plain step shows what the
     card's own reductions move), then a few steps of each in turns for
     their ms.  The group is destroyed after.
  9e. swin_train — swinl_fpn_slotvps at full width in the training
     configuration at 800x1600, batch 1: 3 train_steps (exactly 12
     forward and 12 backward bf16 DCN launches a step, nothing else),
     finite losses and gradients, ms a step, peak memory, the DCN kernels'
     device ms under the profiler; then 3 steps of utils/synthetic.overfit
     with Swin-L at 512x1024, finite losses.
  10. report  — the card line, the kernels' JSON line, and last the result
     line {"ok": true, "device": {...}}.

The script imports nothing of JAX.  It exits non-zero, printing no result,
without CUDA or outside a checkout of the repository.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import inspect
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

H, W = 1024, 2048
N_FRAMES = 6
N_SERVE = 3              # frames of each batched bf16 video and the scan
# (H, W, halo) of the FPN levels P2..P5 of a 1024x2048 frame
DCN_LEVELS = ((256, 512, 2), (128, 256, 3), (64, 128, 4), (32, 64, 6))
# (Cin, Cout) of the three semantic-tower blocks
DCN_BLOCKS = ((256, 256), (256, 128), (128, 128))
# kernel vs plain: f32 sums taken in another order (per-tap reduction over
# 9*Cin terms, FMA contraction) differ by a few ulp of the largest partial
# sums; 1e-4 of the output scale leaves two orders of magnitude of margin.
# In bf16 both round at the same three points, and a sum in another order
# moves a rounded value by one bf16 ulp (2**-8 relative) now and then.
DCN_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# an f32 model's bf16 route (f32 x and offsets, bf16 compute, f32 output)
# against its plain version: the same rounding points and no rounding of the
# output, so what differs is the order of f32 sums, and now and then a
# sample whose f32 sum lies within an ulp of a bf16 rounding boundary
# (one bf16 ulp, 2**-8 of one of the 9*Cin terms of an output, ~3e-5 of
# max|ref| at Cin=128)
DCN_F32_OUT_RTOL = 1e-3
# slot attention (f32 out): f32 sums over 256 channels and over the pixels
# in another order
SA_RTOL = 1e-4
# the f32 kernel: each product as three TF32 products (~2**-21 of a
# product), the tensor cores' truncating sums restarted every 64 channels
# and every 4 tiles, the sums in another order than the plain version's;
# the plain version lies ~2e-6 of max|ref| from float64 at L = 100, P <=
# 131072 (measured on the H100), the kernel's CPU emulation ~3e-6 from the
# plain version (tests/test_torch_sa_f32_split.py)
SA_F32_RTOL = 1e-5
# (L, P) edge cases of the f32 kernel: one slot, a full 128 slots, the
# largest L of the 64- and 104-slot instances and the smallest of the
# 104- and 128-slot ones, one pixel, pixel counts that end inside a
# 64-pixel tile
SA_EDGE_CASES = ((1, 4133), (128, 4133), (64, 777), (65, 64), (100, 1),
                 (104, 777), (105, 4133))
# (pixels, calls per frame) of the slot-attention kernel: stage 0 on the
# 32x64 level, two stages on each finer level, both frames of the pair
SA_PIXELS = ((2048, 2), (8192, 4), (32768, 4), (131072, 4))
SA_SLOTS = 100
# (h, w, C) of the quarter-res semantic logits of a 1024x2048 frame
SSEG_SHAPE = (256, 512, 19)
# theta: the sum of exp over slots is taken in another order; a few ulp
THETA_RTOL = 1e-5
# (K, h, w) of the postprocess kernels: the ladder's 64-slot prefix and
# all 100 slots, at the 256x512 low-res masks of a 1024x2048 frame
PP_SHAPES = ((64, 256, 512), (100, 256, 512))
PP_VALID = 40            # valid slots of the kernel-phase cases
# a ragged case of the postprocess kernels (untimed): odd h (row tiles of
# one row, blocks of one row) and w not a multiple of 32
PP_RAGGED = (48, 45, 70)
SSEG_RAGGED = (45, 70, 19)
# fused vs reference postprocess: the fused theta sums in another order,
# which may move a pixel that sits within an ulp of the threshold
PAN_AGREE = 0.9999
# bf16 kernel path vs the fully plain bf16 path: the two are different bf16
# functions (the plain DCN computes in f32, the plain Retriever keeps a bf16
# attention tensor), so they differ as the JAX package's bf16 tuned stack
# differs from its exact path in this calibrated regime; these are that
# package's own floors for it (tests/test_tuned_vs_exact.py ADV_MIN_SSEG,
# ADV_MIN_PAN_MATCHED), with panoptic ids matched by overlap
PLAIN_BF16_SSEG = 0.97
PLAIN_BF16_PAN = 0.30
# (h, w, K) of the K-minor postprocess chain's first input: the shape that
# slotvps_tpu's profiling script (_prof.py, section "kern") gives
# postproc_fused.py, random-normal masks of a 1024x2048 frame, every slot
# valid, labels 0..18, things > 10
FUSED_SHAPE = (256, 512, 100)
# tuned_vs_exact: utils/parity.tuned_vs_exact's calibrated regime at
# 1024x2048, its trained regime at a reduced size (TVE_TRAIN_*: 150 overfit
# steps at 256x512 on a 6-thing scene, the DCN kernels in training, the
# regime's overfit options utils/parity.TRAINED_OVERFIT), each on
# TVE_FRAMES frames; held to the JAX package's bounds for the same runs
# (tests/test_tuned_vs_exact.py: the adversarial floors ADV_* :47-62, the
# reduced-size trained run :112-117): min matched panoptic agreement, min
# sseg agreement, max score drift, max share of kept segments unmatched
# (None: not bounded) and kept segments a frame at least
TVE_FRAMES = 2
TVE_TRAIN_SIZE = (256, 512)
TVE_TRAIN_STEPS = 150
TVE_TRAIN_THINGS = 6
TVE_BOUNDS = {
    "calibrated": dict(pan_matched_min=0.30, sseg_min=0.97,
                       score_drift_max=0.15, unmatched_frac_max=0.60,
                       kept_per_frame=4),
    "trained": dict(pan_matched_min=0.90, sseg_min=0.97,
                    score_drift_max=0.10, unmatched_frac_max=None,
                    kept_per_frame=4)}
# published H100 SXM peaks at 700 W: f32 outside the tensor cores, dense
# bf16 and TF32 on the tensor cores, HBM
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
TF32_FLOPS = 494.7e12
HBM_BYTES = 3.35e12
# the f32 DCN kernels run each f32 product as three TF32 products (the
# split-TF32 product of csrc/deform_conv.cu)
TF32_PASSES = 3
# the training crop (cli/train.py --crop): (H, W, halo) of its FPN levels
# P2..P5, and the batch the semantic tower sees (reference + current frame)
TRAIN_H, TRAIN_W = 800, 1600
TRAIN_LEVELS = ((200, 400, 2), (100, 200, 3), (50, 100, 4), (25, 50, 6))
TRAIN_B = 2
TRAIN_STEPS = 5
GT_CAPACITY = 64
# the overfit of the train_eval phase: 20 steps, so that its probe (every
# 20 steps from min(100, steps) on) fires once
OVERFIT_STEPS = 20
# one step with the f32 DCN kernel vs one with the plain DCN, same weights
# and batch, fixed_match: both f32, the DCN's sums in another order; each
# gradient tensor against its own max|g|, floored at 1e-6 of the largest
# tensor's (a few f32 ulps of it): a gradient that is 0 in exact
# arithmetic (the q LayerNorm bias under the slot softmax) is f32 noise on
# both sides
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
TRAIN_GRAD_FLOOR = 1e-6
# swin_train: Swin-L's train steps at the training crop, then its overfit
# for a few steps at a smaller crop
SWIN_TRAIN_STEPS = 3
SWIN_OVERFIT_STEPS = 3
SWIN_OVERFIT_SIZE = (512, 1024)
# ddp: the data-parallel step in a world of one against the plain step from
# the same state; the same kernels on the same inputs and an all-reduce
# over one rank, so equal up to what two plain steps differ by (the
# card's nondeterministic reductions, printed): each gradient tensor within
# DDP_GRAD_RTOL of its own max|g| (floored at TRAIN_GRAD_FLOOR of the
# largest), each loss term within DDP_LOSS_RTOL, and each parameter after
# the update within 2 * lr (Adam's first update is lr * g / (|g| + eps): a
# gradient entry near 0 whose sign differs moves its parameter by up to
# 2 * lr)
DDP_GRAD_RTOL = 1e-5
DDP_LOSS_RTOL = 1e-6
DDP_LR = 1e-4
DDP_STEPS = 3
SRC = "slotvps_tpu_torch/csrc/"
PV3 = "slotvps_tpu/ops/pallas/postproc_v3.py"
PFU = "slotvps_tpu/ops/pallas/postproc_fused.py"
DCN_TPU = "slotvps_tpu/ops/pallas/deform_conv.py:44"
DCN_BWD_TPU = "slotvps_tpu/ops/pallas/deform_conv.py:301"
# kernel -> (source, the TPU kernel it replaces, the path it belongs to)
KERNELS = {
    "deform_conv2d_hopper": (SRC + "deform_conv.cu", DCN_TPU, "f32"),
    "deform_conv2d_hopper_bf16": (SRC + "deform_conv.cu", DCN_TPU, "bf16"),
    "deform_conv2d_hopper_bf16_f32": (SRC + "deform_conv.cu", DCN_TPU,
                                      "train"),
    "dcn_backward_hopper": (SRC + "deform_conv.cu", DCN_BWD_TPU,
                            "train_f32"),
    "dcn_backward_hopper_bf16": (SRC + "deform_conv.cu", DCN_BWD_TPU,
                                 "train"),
    "theta_hopper": (SRC + "postproc_v3.cu", PV3 + ":151", "bf16"),
    "claim_hopper": (SRC + "postproc_v3.cu", PV3 + ":252", "bf16"),
    "argmax_hopper": (SRC + "postproc_v3.cu", PV3 + ":351", "bf16"),
    "repair_hopper": (SRC + "postproc_v3.cu", PV3 + ":462", "bf16"),
    "sseg_hopper": (SRC + "postproc_v3.cu", PV3 + ":551", "bf16"),
    "slot_attention_hopper": (SRC + "slot_attention.cu",
                              "slotvps_tpu/ops/pallas/slot_attention.py:35",
                              "bf16"),
    # the f32 instance of the same TPU kernel, on the f32 Pallas-Retriever
    # path that the checkpoint phase drives
    "slot_attention_hopper_f32": (SRC + "slot_attention.cu",
                                  "slotvps_tpu/ops/pallas/slot_attention.py"
                                  ":35", "checkpoint"),
    "claim_scan_hopper": (SRC + "claim_scan.cu",
                          "slotvps_tpu/ops/pallas/claim_scan.py:29",
                          "batched_pallas"),
    "theta_fused_hopper": (SRC + "postproc_v3.cu", PFU + ":104",
                           "fused_chain"),
    "claim_scan_fused_hopper": (SRC + "postproc_v3.cu", PFU + ":210",
                                "fused_chain"),
    "argmax_areas_hopper": (SRC + "postproc_v3.cu", PFU + ":275",
                            "fused_chain"),
    # reachable from no entry point: their launches are read on the
    # batched claim-scan path's run (0)
    "argmax_hopper_top2": (SRC + "postproc_v3.cu", PV3 + ":351", "tests"),
    "hist_hopper": (SRC + "postproc_v3.cu", PV3 + ":603", "tests"),
}


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def wrappers():
    """name -> kernel wrapper with an integer ``launches`` count (the DCN
    wrapper counts per dtype: see :func:`launch_counts`)."""
    from slotvps_tpu_torch.ops.cuda import postproc_fused as pfu
    from slotvps_tpu_torch.ops.cuda import postproc_v3 as pv3
    from slotvps_tpu_torch.ops.cuda.claim_scan import claim_scan_hopper
    from slotvps_tpu_torch.ops.cuda.slot_attention import (
        slot_attention_hopper)

    return {"theta_hopper": pv3.theta_hopper,
            "claim_hopper": pv3.claim_hopper,
            "argmax_hopper": pv3.argmax_hopper,
            "repair_hopper": pv3.repair_hopper,
            "sseg_hopper": pv3.sseg_hopper,
            "slot_attention_hopper": slot_attention_hopper,
            "claim_scan_hopper": claim_scan_hopper,
            "hist_hopper": pv3.hist_hopper,
            "theta_fused_hopper": pfu.theta_fused_hopper,
            "claim_scan_fused_hopper": pfu.claim_scan_fused_hopper,
            "argmax_areas_hopper": pfu.argmax_areas_hopper}


def launch_counts():
    from slotvps_tpu_torch.ops.cuda.deform_conv import (dcn_backward_hopper,
                                                        deform_conv2d_hopper)

    dcn = deform_conv2d_hopper.launches
    bwd = dcn_backward_hopper.launches
    counts = {"deform_conv2d_hopper": dcn["float32"],
              "deform_conv2d_hopper_bf16": dcn["bfloat16"],
              "deform_conv2d_hopper_bf16_f32": dcn["bfloat16_f32"],
              "dcn_backward_hopper": bwd["float32"],
              "dcn_backward_hopper_bf16": bwd["bfloat16"]}
    counts.update({name: fn.launches for name, fn in wrappers().items()})
    counts["argmax_hopper_top2"] = wrappers()["argmax_hopper"].top2_launches
    counts["slot_attention_hopper_f32"] = \
        wrappers()["slot_attention_hopper"].f32_launches
    return counts


def reset_counts():
    from slotvps_tpu_torch.ops.cuda.deform_conv import (dcn_backward_hopper,
                                                        deform_conv2d_hopper)

    for counts in (deform_conv2d_hopper.launches,
                   dcn_backward_hopper.launches):
        for key in counts:
            counts[key] = 0
    for fn in wrappers().values():
        fn.launches = 0
    wrappers()["argmax_hopper"].top2_launches = 0
    wrappers()["slot_attention_hopper"].f32_launches = 0


def bound_parts(n_bytes, n_ops, peak_ops=F32_FLOPS, n_ops_bf16=0,
                n_ops_tf32=0):
    """The least times in ms on the published peaks: the bytes at the
    memory rate, ``n_ops`` at ``peak_ops``, ``n_ops_bf16`` (bf16 products,
    f32 sums) and ``n_ops_tf32`` (TF32 products) at the tensor cores'
    rates."""
    return dict(bytes=n_bytes / HBM_BYTES * 1e3,
                ops=n_ops / peak_ops * 1e3,
                ops_bf16=n_ops_bf16 / BF16_FLOPS * 1e3,
                ops_tf32=n_ops_tf32 / TF32_FLOPS * 1e3)


def bound(n_bytes, n_ops, peak_ops=F32_FLOPS, n_ops_bf16=0, n_ops_tf32=0):
    """(bound ms, what bounds it): the largest of :func:`bound_parts`.  The
    memory, the tensor cores and the other pipes work at the same time, so
    the least time of work of mixed kinds is the longest of them, not
    their sum."""
    parts = bound_parts(n_bytes, n_ops, peak_ops, n_ops_bf16, n_ops_tf32)
    t_ops = max(parts["ops"], parts["ops_bf16"], parts["ops_tf32"])
    return ((parts["bytes"], "bytes") if parts["bytes"] >= t_ops
            else (t_ops, "operations"))


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    log("device", f"{card} | torch {torch.__version__} | CUDA "
                  f"{torch.version.cuda} | {torch.cuda.device_count()} "
                  "device(s)")
    from slotvps_tpu_torch.utils.precision import setup_precision

    setup_precision()
    return torch.device("cuda", 0), card


def phase_build():
    """The libraries from the checkout's sources, one nvcc each, started
    together.  Returns library name -> seconds."""
    from slotvps_tpu_torch.ops.cuda import (claim_scan, deform_conv,
                                            postproc_v3, slot_attention)

    libs = (deform_conv.LIBRARY, postproc_v3.LIBRARY, slot_attention.LIBRARY,
            claim_scan.LIBRARY)
    for lib in libs:
        path = lib.library_path()
        if path.exists():
            path.unlink()   # always build from the checkout's sources
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        futs = {lib.name: pool.submit(lib.build, True) for lib in libs}
        built = {name: f.result() for name, f in futs.items()}
    for name, (path, secs) in built.items():
        log("build", f"nvcc built {path.name} in {secs:.2f} s")
    for row in wgmma_kernel_resources(deform_conv.LIBRARY,
                                      slot_attention.LIBRARY):
        log("build", json.dumps(row))
    for row in sa_f32_kernel_resources():
        log("build", json.dumps(row))
    check_dcn_smem()
    for row in claim_kernel_resources(claim_scan.LIBRARY,
                                      postproc_v3.LIBRARY):
        log("build", json.dumps(row))
    check_claim_smem()
    for row in tiled_kernel_resources():
        log("build", json.dumps(row))
    check_tiled_geometry()
    return {name: secs for name, (_, secs) in built.items()}


# (kernel in ptxas' mangled names, its dynamic shared memory at a template
# width from the library's C entry: the backward's data passes at their
# largest Cout, 256)
WGMMA_KERNELS = (
    ("dcn_fwd_bf16_kernel", lambda lib, n: lib.dcn_forward_bf16_smem(n)),
    ("dcn_bwd_data_bf16_kernel",
     lambda lib, n: lib.dcn_bwd_data_bf16_smem(n, 256)),
    ("dcn_bwd_dw_bf16_kernel", lambda lib, n: lib.dcn_bwd_dw_bf16_smem(n)),
    ("dcn_fwd_f32_kernel", lambda lib, n: lib.dcn_forward_f32_smem(n)),
    ("dcn_bwd_data_f32_kernel",
     lambda lib, n: lib.dcn_bwd_data_f32_smem(n, 256)),
    ("dcn_bwd_dw_f32_kernel", lambda lib, n: lib.dcn_bwd_dw_f32_smem(n)),
    ("slot_attn_partial_kernel", lambda lib, n: lib.sa_smem_bytes(n)))


def ptxas_entries(lib):
    """(mangled name, registers, stack bytes, spill stores, spill loads) of
    each kernel entry in a library's ptxas report."""
    entries, name, props = [], None, (0, 0, 0)
    for line in lib.ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                      r"stores, (\d+) bytes spill loads", line)
        if m and name:
            props = tuple(map(int, m.groups()))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            entries.append((name, int(m.group(1)), *props))
            name = None
    return entries


def wgmma_kernel_resources(*libs):
    """Registers, spills and dynamic shared memory of every instance of the
    wgmma kernels, from their libraries' ptxas reports."""
    rows = []
    for lib in libs:
        handle = lib.load()
        for name, regs, stack, st, ld in ptxas_entries(lib):
            kern = next((k for k in WGMMA_KERNELS if k[0] in name), None)
            if kern is None:
                continue
            tmpl = re.search(kern[0] + r"ILi(\d+)E(\w*?)E", name)
            width = int(tmpl.group(1))
            out = ("bf16" if "bfloat16" in tmpl.group(2) else "f32"
                   if tmpl.group(2) == "f" else "")
            rows.append(dict(
                kernel=f"{kern[0]}<{width}{', ' + out if out else ''}>",
                registers=regs, spill_stores=st, spill_loads=ld,
                stack_bytes=stack,
                dynamic_smem_bytes=kern[1](handle, width)))
    if len(rows) != 23:
        raise AssertionError(
            f"ptxas reported {len(rows)} wgmma kernel instances, not 23 (6 "
            "bf16 and 3 f32 DCN forward, 3 + 3 bf16 and 3 + 3 f32 DCN "
            "backward, 2 slot attention)")
    return rows


def sa_f32_kernel_resources():
    """Registers, spills and dynamic shared memory of the three instances of
    the f32 slot-attention kernel (64, 104 and 128 padded slots), from
    ptxas; the wrapper's statement of their shared memory (f32_smem, tested
    on the CPU) against the library's."""
    from slotvps_tpu_torch.ops.cuda import slot_attention as sa

    lib = sa.LIBRARY.load()
    rows = []
    for name, regs, stack, st, ld in ptxas_entries(sa.LIBRARY):
        m = re.search(r"slot_attn_f32_kernelILi(\d+)E", name)
        if m:
            nq = int(m.group(1))
            rows.append(dict(
                kernel=f"slot_attn_f32_kernel<{nq}>", registers=regs,
                spill_stores=st, spill_loads=ld, stack_bytes=stack,
                dynamic_smem_bytes=lib.sa_f32_smem_bytes(nq)))
            if rows[-1]["dynamic_smem_bytes"] != sa.f32_smem(nq):
                raise AssertionError(f"f32 slot attention's shared memory at "
                                     f"{nq} slots: library "
                                     f"{rows[-1]['dynamic_smem_bytes']}, "
                                     f"wrapper {sa.f32_smem(nq)}")
    if len(rows) != 3:
        raise AssertionError(f"ptxas reported {len(rows)} f32 slot-attention "
                             "kernel instances, not 3 (64, 104 and 128 "
                             "slots)")
    return rows


def check_dcn_smem():
    """The wrapper's statement of the DCN kernels' shared memory (its
    geometry helpers, tested on the CPU) equals the library's: the bf16
    backward's passes, the f32 forward and the f32 backward's passes."""
    from slotvps_tpu_torch.ops.cuda import deform_conv as dc

    lib = dc.LIBRARY.load()
    for n in (64, 128, 256):
        got = (lib.dcn_forward_f32_smem(n), lib.dcn_bwd_dw_bf16_smem(n),
               lib.dcn_bwd_dw_f32_smem(n))
        want = (dc.fwd_f32_smem(n), dc.bwd_dw_smem(n), dc.bwd_dw_f32_smem(n))
        for c_out in (20, 24, 128, 256):
            got += (lib.dcn_bwd_data_bf16_smem(n, c_out),
                    lib.dcn_bwd_data_f32_smem(n, c_out))
            want += (dc.bwd_data_smem(n, c_out),
                     dc.bwd_data_f32_smem(n, c_out))
        if got != want:
            raise AssertionError(f"DCN shared memory at width {n} (f32 "
                                 "forward, dW bf16 / f32, data bf16 / f32 at "
                                 f"Cout 20, 24, 128, 256): library {got}, "
                                 f"wrapper {want}")


# the persistent claim kernels: one instance per bit word (uint8, uint16,
# uint32 for chunks of <= 8, 16, 32 valid things)
CLAIM_WORDS = {"h": "uint8_t", "t": "uint16_t", "j": "uint32_t"}


def claim_kernel_resources(*libs):
    """Registers, spills and stack of each instance of the two claim
    kernels, from their libraries' ptxas reports (their shared memory is
    dynamic: claim_geometry's)."""
    rows = []
    for lib in libs:
        lib.load()
        for name, regs, stack, st, ld in ptxas_entries(lib):
            kern = re.search(r"\d+(claim_scan_kernel|claim_kernel)I([htj])E",
                             name)
            if kern:
                rows.append(dict(
                    kernel=f"{kern.group(1)}<{CLAIM_WORDS[kern.group(2)]}>",
                    registers=regs, spill_stores=st, spill_loads=ld,
                    stack_bytes=stack))
    if len(rows) != 6:
        raise AssertionError(f"ptxas reported {len(rows)} claim kernel "
                             "instances, not 6 (two kernels x three word "
                             "widths)")
    return rows


ARGMAX_MODES = {"0": "argmax", "1": "top2", "2": "repair"}


def tiled_kernel_resources():
    """Registers, spills and static shared memory of theta, of each
    instance of argmax (one or two rows a block; argmax, top2, repair), of
    sseg (one or two rows a block) and of hist, from ptxas: no call sets a
    dynamic shared-memory size (hist's, at most 16 KB, needs none)."""
    from slotvps_tpu_torch.ops.cuda import postproc_v3 as pv3

    smem, name = {}, None
    for line in pv3.LIBRARY.ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used \d+ registers.*?(\d+) bytes smem", line)
        if m and name:
            smem[name] = int(m.group(1))
    rows = []
    for name, regs, stack, st, ld in ptxas_entries(pv3.LIBRARY):
        am = re.search(r"argmax_kernelILi(\d)ELi(\d)E", name)
        sg = re.search(r"sseg_kernelILi(\d)E", name)
        if am:
            kern = f"argmax_kernel<{am.group(1)}, " \
                   f"{ARGMAX_MODES[am.group(2)]}>"
        elif sg:
            kern = f"sseg_kernel<{sg.group(1)}>"
        elif "theta_kernel" in name:
            kern = "theta_kernel"
        elif "hist_kernel" in name:
            kern = "hist_kernel"
        else:
            continue
        rows.append(dict(kernel=kern, registers=regs, spill_stores=st,
                         spill_loads=ld, stack_bytes=stack,
                         static_smem_bytes=smem.get(name)))
    if len(rows) != 10:
        raise AssertionError(f"ptxas reported {len(rows)} tiled postprocess "
                             "and hist kernel instances, not 10 (theta, "
                             "argmax x 2 row counts x 3 modes, sseg x 2, "
                             "hist)")
    return rows


def check_tiled_geometry():
    """tiled_geometry (tested on the CPU) against the library's
    pp_tiled_geometry: rows a block and grid of the argmax / repair and
    sseg kernels."""
    import ctypes

    from slotvps_tpu_torch.ops.cuda import postproc_v3 as pv3

    lib = pv3.LIBRARY.load()
    out = (ctypes.c_int * 3)()
    for h, w in ((256, 512), (45, 70), (6, 33), (12, 20), (1, 1)):
        for hb in sorted({pv3.plain.tile_rows(h), h}):
            lib.pp_tiled_geometry(h, w, hb, out)
            rb, grid = pv3.tiled_geometry(h, w, hb)
            if tuple(out) != (rb, *grid):
                raise AssertionError(f"tiled geometry at h, w, hb = {h}, "
                                     f"{w}, {hb}: library {tuple(out)}, "
                                     f"wrapper {(rb, *grid)}")


def check_claim_smem():
    """claim_geometry's statement of a claim kernel's shared memory
    (claim_smem, tested on the CPU) equals the libraries' at each plan."""
    from slotvps_tpu_torch.ops.cuda import claim_scan as cs
    from slotvps_tpu_torch.ops.cuda import postproc_v3 as pv3

    scan, v3 = cs.LIBRARY.load(), pv3.LIBRARY.load()
    got, want = [], []
    for b, k, run in ((1, 100, 15888), (4, 127, 15888), (8, 3, 15888),
                      (220, 127, 1024)):
        for chunk, own, bits in cs.CLAIM_PLANS:
            got += [scan.cs_claim_smem(b, k, run, chunk, own, bits),
                    v3.pp_claim_smem(k, run, chunk, own, bits)]
            want += [cs.claim_smem(b, k, run, chunk, own, bits),
                     cs.claim_smem(1, k, run, chunk, own, bits,
                                   pv3.CLAIM_STAGE)]
    if got != want:
        raise AssertionError(f"claim kernels' shared memory: libraries "
                             f"{got}, wrappers {want}")


def _cuda_ms(fn, n=10, warmup=2):
    """Median of ``n`` CUDA-event timed calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _alone_ms(fn, n=10):
    """The device ms a call of the port's own kernels (the
    ``csrc/`` entries, in an anonymous namespace) takes, from the profiler
    over ``n`` calls: the kernel alone, without the wrapper's host
    prologue or torch's allocations and copies."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(ms for name, (ms, _) in _device_time_by_kernel(prof).items()
               if "anonymous namespace" in name) / n


def dcn_case(dev, h, w, cin, cout, halo, seed, b=1):
    """Seeded DCN inputs: offsets mostly inside the halo, ~5% of them
    beyond it (clamped), and border pixels whose samples leave the image."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, h, w, cin), generator=g, device=dev)
    off = torch.randn((b, h, w, 18), generator=g, device=dev) * (0.75 * halo)
    far = torch.rand((b, h, w, 18), generator=g, device=dev) < 0.05
    off = torch.where(far, torch.sign(off) * (halo + 1.5), off)
    wt = torch.randn((3, 3, cin, cout), generator=g, device=dev) \
        / (9 * cin) ** 0.5
    return x, off, wt


def phase_kernels(dev, levels=DCN_LEVELS, blocks=DCN_BLOCKS, timed=True,
                  dtype=torch.float32, b=1, io_dtype=None):
    """DCN kernel vs plain at every (level, block) shape and batch ``b``,
    computing in ``dtype`` with inputs and output in ``io_dtype`` (default
    ``dtype``; float32 with a bf16 ``dtype`` is an f32 model's bf16 route);
    the plain version at compute_dtype=dtype on the same inputs."""
    from slotvps_tpu_torch.ops.cuda.deform_conv import deform_conv2d_hopper
    from slotvps_tpu_torch.ops.deform_conv import deform_conv2d

    io_dtype = io_dtype or dtype
    rtol = DCN_RTOL[dtype] if io_dtype == dtype else DCN_F32_OUT_RTOL
    size = torch.finfo(io_dtype).bits // 8
    rows = []
    for li, (h, w, halo) in enumerate(levels):
        for bi, (cin, cout) in enumerate(blocks):
            x, off, wt = (t.to(io_dtype) for t in dcn_case(
                dev, h, w, cin, cout, halo, seed=10 * li + bi, b=b))

            def plain():
                return deform_conv2d(x, off, wt, padding=1,
                                     max_displacement=halo,
                                     compute_dtype=dtype)

            def kern():
                return deform_conv2d_hopper(x, off, wt, halo,
                                            compute_dtype=dtype)

            with torch.no_grad():
                ref = plain()
                out = kern()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            ok = (bool(torch.isfinite(out).all()) and out.dtype == io_dtype
                  and err <= rtol * scale)
            # each input read once, the output written once; one FMA = 2
            n_bytes = size * (b * h * w * (cin + 18 + cout) + 9 * cin * cout)
            row = dict(shape=f"P{li + 2} {b}x{h}x{w} {cin}->{cout} halo "
                             f"{halo}", dtype=str(dtype),
                       io_dtype=str(io_dtype), max_abs_err=err,
                       max_abs_ref=scale, rel_err=err / scale, bytes=n_bytes,
                       ops=2 * 9 * cin * cout * b * h * w)
            row["bound_ms"], row["bound_by"] = _fwd_bound([row], dtype)
            if dtype == torch.float32:
                row["bound_fma_ms"] = _fma_bound([row])
            if timed:
                with torch.no_grad():
                    row["ms"] = _cuda_ms(kern)
                    row["plain_ms"] = _cuda_ms(plain)
            log("kernels", json.dumps(row))
            if not ok:
                raise AssertionError(
                    f"{dtype} DCN kernel ({io_dtype} in and out) disagrees "
                    f"at {row['shape']}: max|d| {err:.3e} > {rtol} * "
                    f"max|ref| {scale:.3e}, or output dtype {out.dtype}")
            rows.append(row)
    return rows


def _fwd_bound(rows, dtype):
    """Bound of the forward rows' work: bf16 products on the tensor cores;
    f32 products as the kernel runs them, three TF32 products each (the
    f32 FMA bound beside it: :func:`_fma_bound`)."""
    n_bytes = sum(r["bytes"] for r in rows)
    ops = sum(r["ops"] for r in rows)
    if dtype == torch.float32:
        return bound(n_bytes, 0, n_ops_tf32=TF32_PASSES * ops)
    return bound(n_bytes, 0, n_ops_bf16=ops)


def _fma_bound(rows, ops_keys=("ops",)):
    """The f32 rows' work all on the f32 pipes (67 TFLOP/s), as f32 FMA
    kernels run it: ms."""
    return bound(sum(r["bytes"] for r in rows),
                 sum(r[k] for r in rows for k in ops_keys))[0]


def phase_backward_kernels(dev, levels=TRAIN_LEVELS, blocks=DCN_BLOCKS,
                           b=TRAIN_B, timed=True, dtype=torch.float32):
    """DCN backward kernel vs the plain backward at every (level, block)
    shape of the training step, computing in ``dtype`` (f32 inputs, as the
    f32 model gives them): dx, doff and dW each within DCN_RTOL of the
    plain version's max, and each equal in two runs."""
    from slotvps_tpu_torch.ops.cuda.deform_conv import dcn_backward_hopper
    from slotvps_tpu_torch.ops.deform_conv import deform_conv2d_backward

    rtol = DCN_RTOL[dtype]
    size = torch.finfo(dtype).bits // 8
    rows = []
    passes = {}
    for li, (h, w, halo) in enumerate(levels):
        for bi, (cin, cout) in enumerate(blocks):
            x, off, wt = dcn_case(dev, h, w, cin, cout, halo,
                                  seed=100 + 10 * li + bi, b=b)
            g = torch.randn((b, h, w, cout), device=dev,
                            generator=torch.Generator(dev).manual_seed(li))

            def kern():
                return dcn_backward_hopper(x, off, wt, g, halo, dtype)

            def plain():
                return deform_conv2d_backward(x, off, wt, g, halo, dtype)

            out, again, ref = kern(), kern(), plain()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            errs = {n: float((a - r).abs().max())
                    for n, a, r in zip(("dx", "doff", "dW"), out, ref)}
            scales = {n: float(r.abs().max())
                      for n, r in zip(("dx", "doff", "dW"), ref)}
            ok = (all(bool(torch.isfinite(a).all()) for a in out)
                  and all(errs[n] <= rtol * scales[n] for n in errs)
                  and all(torch.equal(a, b) for a, b in zip(out, again)))
            p = b * h * w
            # inputs (x and W in the compute dtype, f32 offsets, g) read
            # once, dx, doff and dW written once in f32; dsample and dW are
            # each 2*9*Cin*Cout flops a pixel in the compute dtype; the dx
            # sums, the sample recompute and the offset sums 24 f32 flops
            # per (pixel, tap, input channel)
            n_bytes = (size * (p * (cin + cout) + 9 * cin * cout)
                       + 4 * (p * (cin + 36) + 9 * cin * cout))
            row = dict(shape=f"P{li + 2} {b}x{h}x{w} {cin}->{cout} halo "
                             f"{halo}", dtype=str(dtype),
                       max_abs_err=max(errs.values()),
                       rel_err=max(errs[n] / scales[n] for n in errs),
                       errs=errs, bytes=n_bytes,
                       ops_main=4 * 9 * cin * cout * p,
                       ops_f32=24 * 9 * cin * p)
            row["bound_ms"], row["bound_by"] = _bwd_bound([row], dtype)
            row["bound_parts_ms"] = _bwd_bound([row], dtype, parts=True)
            if dtype == torch.float32:
                row["bound_fma_ms"] = _fma_bound([row],
                                                 ("ops_main", "ops_f32"))
            if timed:
                row["ms"] = _cuda_ms(kern)
                row["plain_ms"] = _cuda_ms(plain, n=3, warmup=1)
                row["pass_ms"] = _bwd_pass_ms(kern)
                row["host_ms"] = _host_ms(kern)
                for name, ms in row["pass_ms"].items():
                    passes[name] = passes.get(name, 0.0) + ms
                passes["host_enqueue"] = (passes.get("host_enqueue", 0.0)
                                          + row["host_ms"])
            log("kernels", json.dumps(row))
            if not ok:
                raise AssertionError(
                    f"{dtype} DCN backward disagrees at {row['shape']}: "
                    f"errors {errs} vs {rtol} x {scales}, or dx, doff or dW "
                    "differs from run to run")
            rows.append(row)
    if passes:
        host = passes.pop("host_enqueue")
        log("kernels", json.dumps({
            "dcn_backward_passes": str(dtype), "shapes": len(rows),
            "profiler_device_ms": passes,
            "total_ms": sum(passes.values()),
            "cuda_event_ms": sum(r["ms"] for r in rows),
            "host_enqueue_ms": host}))
    return rows


def _host_ms(fn, n=5):
    """Host ms to enqueue one call of ``fn`` (the mean of ``n`` calls, the
    card left to run behind): where it comes near the CUDA-event time, the
    call is bound by the host."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / n


# the backward's kernels by pass (substrings of their names; both dtypes:
# dcn_bwd_data_{bf16,f32}_kernel, dcn_bwd_dx_kernel<CPL, T>,
# dcn_bwd_dw_{bf16,f32}_kernel, dcn_wimg{,_f32}_kernel)
BWD_PASSES = (("dcn_bwd_data", "data"), ("dcn_bwd_dx", "dx"),
              ("dcn_bwd_dw_", "dW"), ("dcn_bwd_reduce_kernel", "reduction"),
              ("dcn_wimg", "weight_image"), ("dcn_gsplit_kernel", "g_split"))


def _bwd_pass_ms(fn):
    """Device ms of one call of ``fn`` (the backward wrapper) by pass,
    from torch.profiler; "other" is every other kernel of the call: the
    wrapper's casts and copies of x, g and W."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for name, (ms, _) in _device_time_by_kernel(prof).items():
        part = next((p for key, p in BWD_PASSES if key in name), "other")
        out[part] = out.get(part, 0.0) + ms
    return out


def _bwd_bound(rows, dtype, parts=False):
    """Bound of the backward rows' work: the products on the tensor cores
    (bf16; in f32 three TF32 products each, as the kernels run them), the
    f32 elementwise work at the f32 peak (the two run on different pipes
    at the same time: the longer one bounds).  With ``parts``, the times
    (bytes, f32 work, tensor-core work)."""
    n_bytes = sum(r["bytes"] for r in rows)
    ops = sum(r["ops_main"] for r in rows)
    ops_f32 = sum(r["ops_f32"] for r in rows)
    args = ((n_bytes, ops_f32, F32_FLOPS, 0, TF32_PASSES * ops)
            if dtype == torch.float32
            else (n_bytes, ops_f32, F32_FLOPS, ops))
    return bound_parts(*args) if parts else bound(*args)


def postproc_case(dev, k, h, w, seed=0, n_valid=PP_VALID):
    """Seeded low-res mask logits [K, h, w] in the slot order of the path:
    valid stuff (a quarter of the valid slots), valid things, invalid.
    Smooth regions plus noise; two thing slots of one class that overlap
    (the claim loop rejects one); two stuff slots that are one bright
    low-res pixel each, small segments a small-area iteration removes."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(seed)
    coarse = torch.randn((1, k, max(h // 16, 1), max(w // 16, 1)),
                         generator=g, device=dev) * 4
    m = F.interpolate(coarse, size=(h, w), mode="bilinear",
                      align_corners=False)[0]
    m = m + torch.randn((k, h, w), generator=g, device=dev) * 0.5
    n_stuff = n_valid // 4
    labels = torch.randint(11, 19, (k,), generator=g, device=dev)
    labels[:n_stuff] = torch.randint(0, 11, (n_stuff,), generator=g,
                                     device=dev)
    valid = torch.arange(k, device=dev) < n_valid
    a, b = n_stuff, n_stuff + 1
    labels[b] = labels[a]
    m[b] = m[a] + 0.01
    small = (0, 1)
    for s, (y, x) in zip(small, ((h // 3, w // 5), (2 * h // 3, w // 2))):
        m[s] = -30.0
        m[s, y, x] = 30.0
    return (m.contiguous(), labels, valid, labels > 10, (n_stuff, n_valid),
            small)


def _blob_owner(rng, h, w, choices):
    """A [4h, 4w] int8 owner map: coherent 2x2-cell regions, each owned by
    one of ``choices`` (-1 = unowned)."""
    cells = rng.choice(np.asarray(choices), size=(-(-h // 2), -(-w // 2)))
    full = np.repeat(np.repeat(cells, 8, 0), 8, 1)[:4 * h, :4 * w]
    return torch.from_numpy(full.astype(np.int8))


# the argmax kernel's edge cases, name -> (K, h, w): seeded masks, a kept
# set, thing flags and an owner map that stress one part of its tie rule
# (no slot kept, only unowned things kept, every stuff value negative,
# exact ties, things before stuff, owners that are removed or stuff slots,
# values below -1e30), K = 1 and 127, row tiles of 1, 2, 4 and 8 rows;
# widths not a multiple of 32.  tests/test_torch_argmax_tiled.py holds a
# torch model of the kernel's schedule to the plain versions on them
ARGMAX_CASES = {
    "no_slot_kept": (12, 8, 40),
    "only_unowned_things_kept": (12, 8, 40),
    "stuff_all_negative": (12, 6, 33),
    "exact_ties": (10, 4, 20),
    "things_before_stuff": (16, 8, 40),
    "owner_is_a_removed_slot": (16, 12, 36),
    "owner_is_stuff": (12, 8, 24),
    "values_below_neg": (10, 5, 17),
    "k1": (1, 8, 40),
    "k127": (127, 4, 12),
    "hb1": (20, 5, 33),
    "hb2": (20, 6, 35),
    "hb4": (20, 12, 31),
    "hb8": (20, 16, 64),
}


def argmax_case(name, seed=0):
    """CPU tensors (m [K, h, w] f32, owner [4h, 4w] int8, kept, is_thing)
    of edge case ``name`` of ARGMAX_CASES, made with numpy from ``seed``."""
    k, h, w = ARGMAX_CASES[name]
    rng = np.random.default_rng(seed + len(name))
    m = rng.standard_normal((k, h, w)).astype(np.float32) * 2
    for i in range(0, k, 3):
        y, x = rng.integers(0, max(h - 3, 1)), rng.integers(0, max(w - 4, 1))
        m[i, y:y + 3, x:x + 4] += 5.0
    is_thing = rng.random(k) < 0.5
    kept = rng.random(k) < 0.7
    things = np.nonzero(is_thing)[0].tolist()
    owner_from = [-1] + [t for t in things if kept[t]]
    if name == "no_slot_kept":
        kept[:] = False
    elif name == "only_unowned_things_kept":
        kept = is_thing.copy()
        kept[0] = is_thing[0] = True
        owner_from = [-1]
    elif name == "stuff_all_negative":
        m[~is_thing] = -np.abs(m[~is_thing]) - 0.5
        kept[:] = True
        owner_from = [-1] + things[:1]
    elif name == "exact_ties":
        is_thing[:] = False
        kept[:] = True
        m[3] = m[1]
        m[7] = m[1]
        m[5, :, : w // 2] = m[2, :, : w // 2]
    elif name == "things_before_stuff":
        is_thing[:] = np.arange(k) < k // 2
        kept[:] = True
        kept[1] = False
        owner_from = [-1] + list(range(k // 2))
    elif name == "owner_is_a_removed_slot":
        is_thing[:] = np.arange(k) >= 4
        kept[:] = True
        kept[[5, 9]] = False      # removed by a small-area iteration
        owner_from = [-1, 5, 6, 9, 10]
    elif name == "owner_is_stuff":
        is_thing[:] = np.arange(k) % 2 == 1
        kept[:] = True
        owner_from = [-1, 0, 1, 2, 3]
    elif name == "values_below_neg":
        kept[:] = True
        kept[[2, 6]] = False
        is_thing[:] = False
        m[0] = -float("inf")
        m[1, : h // 2] = -3e30
        m[3:, : h // 2] = -2e30
        m[4, h // 2:] = -1e30
    elif name == "k1":
        kept[:] = True
        owner_from = [-1, 0]
    owner = _blob_owner(rng, h, w, owner_from)
    return (torch.from_numpy(m), owner, torch.from_numpy(kept),
            torch.from_numpy(is_thing))


# sseg's edge cases, (h, w, C): ties (a copied channel, a block of equal
# logits) and -inf logits at one channel, more channels than one staged
# chunk (20), odd h and w not a multiple of 32
SSEG_CASES = ((6, 33, 19), (5, 8, 1), (4, 12, 21), (45, 70, 19))


def sseg_case(h, w, c):
    """Seeded [h, w, C] f32 logits (CPU) with ties and a -inf entry."""
    g = torch.Generator().manual_seed(h * w + c)
    x = torch.randn((h, w, c), generator=g) * 3
    x[..., c - 1] = x[..., c // 2]
    x[: h // 2, : w // 3, :] = 0.25
    x[-1, -1, 0] = -float("inf")
    return x


# hist's edge cases beside the real argmax map (phase_top2_hist's own):
# one id everywhere (every warp on the one-atomic path), random ids (16
# runs a thread), runs of 1-40 equal ids (warps that mix the paths), ids
# outside [0, K) in runs, K = 1 and K = 4096, n not a multiple of 4 (nor of
# 16), and 37 ids (one partial thread, one block)
HIST_CASES = ("uniform", "random_ids", "runs", "out_of_range", "k1",
              "k4096", "ragged", "tiny")


def _id_runs(rng, n, lo, hi):
    """n ids in runs of 1-40 equal ids drawn from [lo, hi)."""
    lens = rng.integers(1, 41, n // 10 + 2)
    return np.repeat(rng.integers(lo, hi, len(lens)), lens)[:n]


def hist_case(name, n=H * W, seed=0):
    """(flat int32 id map on the CPU, K) of hist edge case ``name`` at
    ``n`` ids, made with numpy from ``seed``."""
    rng = np.random.default_rng(seed + len(name))
    k = {"k1": 1, "k4096": 4096}.get(name, 64)
    if name == "uniform":
        ids = np.full(n, 7)
    elif name == "random_ids":
        ids = rng.integers(0, k, n)
    elif name == "out_of_range":
        ids = _id_runs(rng, n, -3, k + 3)
    elif name == "k1":
        ids = _id_runs(rng, n, -1, 2)
    elif name == "k4096":
        ids = np.where(rng.random(n) < 0.5, rng.integers(0, k, n),
                       _id_runs(rng, n, 0, k))
    elif name == "ragged":
        ids = _id_runs(rng, n - 3, 0, k)
    elif name == "tiny":
        ids = rng.integers(0, k, 37)
    else:
        ids = _id_runs(rng, n, 0, k)
    return torch.from_numpy(ids.astype(np.int32)), k


def hold_hist_edge(dev, name, n=H * W):
    """hist on edge case ``name`` of HIST_CASES at ``n`` ids against its
    plain version, bit for bit, one launch on the card.  Returns the
    case's row."""
    from slotvps_tpu_torch.ops import postproc_v3 as plain
    from slotvps_tpu_torch.ops.cuda import postproc_v3 as hv3

    ids, k = hist_case(name, n)
    ids = ids.to(dev)
    _held_once(dev, "hist_hopper", f"hist {name}",
               lambda: hv3.hist_hopper(ids, k), lambda: plain.hist(ids, k))
    return dict(case=name, K=k, n=ids.numel())


def hold_hist_edges(dev, n=H * W):
    """Every case of HIST_CASES (hold_hist_edge).  Returns their rows."""
    return [hold_hist_edge(dev, name, n) for name in HIST_CASES]


def _removal(areas, kept):
    """The kept slot touching the fewest row tiles removed: (kept after,
    dirty tiles); nothing removed when no kept slot has pixels."""
    n_tiles = (areas > 0).sum(0)
    cand = torch.nonzero(kept & (n_tiles > 0)).flatten()
    removed = torch.zeros_like(kept)
    if len(cand):
        removed[cand[n_tiles[cand].argmin()]] = True
    return kept & ~removed, ((areas > 0) & removed[None]).any(-1)


def _held_once(dev, kern, label, fn, ref):
    """``fn()`` (one launch of wrapper ``kern`` on the card, none on the
    CPU) equals ``ref()`` bit for bit."""
    before = launch_counts()[kern]
    got, want = fn(), ref()
    _sync(dev)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    diff = sum(int((a != b).sum()) for a, b in zip(got, want))
    launched = launch_counts()[kern] - before
    if diff or launched != (1 if dev.type == "cuda" else 0):
        raise AssertionError(f"{kern} on edge case {label}: {diff} entries "
                             f"differ, {launched} launches")


def hold_argmax_edge(dev, case):
    """argmax, its runner-up map (top2), one repair (the kept slot
    touching the fewest row tiles removed) and the K-minor argmax-areas on
    edge case ``case`` of ARGMAX_CASES, each against its plain version.
    Returns the case's row."""
    from slotvps_tpu_torch.ops import postproc_fused as plain_fused
    from slotvps_tpu_torch.ops import postproc_v3 as plain
    from slotvps_tpu_torch.ops.cuda import postproc_fused as pfu
    from slotvps_tpu_torch.ops.cuda import postproc_v3 as hv3

    m, owner, kept, is_thing = (t.to(dev) for t in argmax_case(case))
    m1, areas = plain.argmax(m, owner, kept, is_thing)
    kept_n, dirty = _removal(areas, kept)
    m_hwk = m.permute(1, 2, 0).contiguous()
    _held_once(dev, "argmax_hopper", case,
               lambda: hv3.argmax_hopper(m, owner, kept, is_thing),
               lambda: plain.argmax(m, owner, kept, is_thing))
    _held_once(dev, "argmax_hopper_top2", case,
               lambda: hv3.argmax_hopper(m, owner, kept, is_thing, top2=True),
               lambda: plain.argmax(m, owner, kept, is_thing, top2=True))
    _held_once(dev, "repair_hopper", case,
               lambda: hv3.repair_hopper(m, owner, m1, kept_n, is_thing,
                                         dirty, areas),
               lambda: plain.repair(m, owner, m1, kept_n, is_thing, dirty,
                                    areas))
    _held_once(dev, "argmax_areas_hopper", case,
               lambda: pfu.argmax_areas_hopper(m_hwk, owner, kept, is_thing),
               lambda: plain_fused.argmax_areas(m_hwk, owner, kept,
                                                is_thing))
    return dict(case=case, shape=list(m.shape), kept=int(kept.sum()),
                dirty_tiles=f"{int(dirty.sum())}/{dirty.numel()}")


def hold_sseg_edge(dev, shape):
    """sseg on the logits of sseg_case(*shape) against its plain
    version."""
    from slotvps_tpu_torch.ops import postproc_v3 as plain
    from slotvps_tpu_torch.ops.cuda import postproc_v3 as hv3

    x = sseg_case(*shape).to(dev)
    _held_once(dev, "sseg_hopper", f"sseg {shape}",
               lambda: hv3.sseg_hopper(x), lambda: plain.sseg(x))
    return dict(case="sseg", shape=list(shape))


def phase_argmax_edges(dev):
    """Every edge case of ARGMAX_CASES (hold_argmax_edge) and of SSEG_CASES
    (hold_sseg_edge): each kernel bit-identical to its plain version, one
    launch a call on the card.  Returns the cases' rows."""
    rows = [hold_argmax_edge(dev, case) for case in ARGMAX_CASES]
    rows += [hold_sseg_edge(dev, shape) for shape in SSEG_CASES]
    log("kernels", f"argmax / top2 / repair / K-minor argmax / sseg edge "
                   f"cases, each bit-identical to its plain version: "
                   f"{json.dumps(rows)}")
    return rows


def _owned_px(owner, kept, is_thing):
    """The full-res pixels whose owner is a kept thing slot."""
    own = owner.long()
    lut = torch.cat([kept & is_thing, kept.new_zeros(1)])
    return int(lut[torch.where(own >= 0, own, len(kept))].sum())


def _pp_bounds(k, h, w, n_valid, n_things, n_kept, n_kept_things,
               dirty_frac, t, owned=0):
    """(bytes, operations) of the four functions on this run's data.  Each
    counts only the slots its output depends on (theta the valid slots,
    claim the valid things, argmax and repair the kept stuff slots and,
    where a kept thing owns a pixel (``owned`` full-res pixels), that
    thing), each input read once and each output written once.  One slot's
    x4 upsample is separable: 3 flops per row-phase value and 3 per
    column-phase value; a compare, exp or log is one operation."""
    hw, full = h * w, 16 * h * w
    up = 3 * 4 * hw + 3 * full                   # one slot, rows + columns
    # per valid slot: max, subtract, exp, add; per pixel: log and two adds
    theta = (4 * n_valid * hw + k + 4 * full,
             n_valid * (up + 4 * full) + 3 * full)
    # per thing: compare with theta, count, owner and class test; per kept
    # thing: the claim
    claim = (4 * n_things * hw + 4 * full + full + 5 * k,
             n_things * (up + 5 * full) + n_kept_things * 2 * full)
    # per kept stuff slot: compare, select; a kept thing counts 0.0 off
    # the pixels it owns, so its mask is needed under those (owned / 16
    # low-res values) with one upsample (~6 flops a pixel), a compare and
    # a select; per pixel: the owner test, the 0.0 and -1e30 candidates,
    # its count
    n_stuff = n_kept - n_kept_things
    argmax = (4 * n_stuff * hw + owned // 4 + full + 4 * full + 4 * t * k
              + 2 * k,
              n_stuff * (up + 2 * full) + 9 * owned + 4 * full)
    # the argmax on the dirty tiles; the clean tiles copied through
    repair = (dirty_frac * (4 * n_stuff * hw + owned // 4 + full)
              + (1 - dirty_frac) * 4 * full + 4 * full + 8 * t * k + t
              + 2 * k,
              dirty_frac * argmax[1])
    return {"theta_hopper": theta, "claim_hopper": claim,
            "argmax_hopper": argmax, "repair_hopper": repair}


def phase_postproc_kernels(dev, shapes=PP_SHAPES, n_valid=PP_VALID,
                           timed=True, ragged=PP_RAGGED):
    """The four postprocess kernels against their plain versions at each
    of ``shapes`` and, untimed, at the ragged shape.  Integer outputs must
    be bit-identical given identical inputs; theta within THETA_RTOL *
    max(1, |theta|).  Timed rows give the wrapper's CUDA-event ms (``ms``)
    and the kernel's device ms alone (``alone_ms``, profiler).  Returns
    {K: {kernel: row}} of ``shapes``."""
    from slotvps_tpu_torch.ops import postproc_v3 as plain
    from slotvps_tpu_torch.ops.cuda import postproc_v3 as hv3

    out = {}
    for k, h, w in tuple(shapes) + ((ragged,) if ragged else ()):
        timed_here = timed and (k, h, w) != ragged
        m, labels, valid, is_thing, slots, small = postproc_case(
            dev, k, h, w, seed=k, n_valid=n_valid)
        th = hv3.theta_hopper(m, valid, 0.4)
        th_ref = plain.theta(m, valid, 0.4)
        keep, owner = hv3.claim_hopper(m, th_ref, labels, is_thing, valid,
                                       0.03, slots=slots)
        keep_ref, owner_ref = plain.claim(m, th_ref, labels, is_thing, valid,
                                          0.03)
        kept = torch.where(is_thing, keep_ref, valid)
        m1, areas = hv3.argmax_hopper(m, owner_ref, kept, is_thing)
        m1_ref, areas_ref = plain.argmax(m, owner_ref, kept, is_thing)
        removed = torch.zeros_like(kept)
        removed[list(small)] = True
        kept_n = kept & ~removed
        dirty = ((areas_ref > 0) & removed[None]).any(-1)
        m2, a2 = hv3.repair_hopper(m, owner_ref, m1_ref, kept_n, is_thing,
                                   dirty, areas_ref)
        m2_ref, a2_ref = plain.repair(m, owner_ref, m1_ref, kept_n, is_thing,
                                      dirty, areas_ref)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        theta_rel = float(((th - th_ref).abs()
                           / th_ref.abs().clamp_min(1.0)).max())
        # integer outputs: the number of differing entries (must be 0)
        errs = {"theta_hopper": float((th - th_ref).abs().max()),
                "claim_hopper": max(int((keep != keep_ref).sum()),
                                    int((owner != owner_ref).sum())),
                "argmax_hopper": max(int((m1 != m1_ref).sum()),
                                     int((areas != areas_ref).sum())),
                "repair_hopper": max(int((m2 != m2_ref).sum()),
                                     int((a2 != a2_ref).sum()))}
        n_dirty = int(dirty.sum())
        n_things = slots[1] - slots[0]
        regime = dict(K=k, valid=int(valid.sum()), things=n_things,
                      kept_things=int((keep_ref & is_thing).sum()),
                      dirty_tiles=f"{n_dirty}/{dirty.numel()}",
                      segments=len(torch.unique(m1_ref)))
        log("kernels", f"postproc case {json.dumps(regime)}")
        if theta_rel > THETA_RTOL or any(
                v for n, v in errs.items() if n != "theta_hopper"):
            raise AssertionError(f"postproc kernels disagree at K={k}: "
                                 f"theta rel {theta_rel:.3e}, mismatches "
                                 f"{errs}")
        if not 0 < n_dirty < dirty.numel() \
                or not 0 < regime["kept_things"] < n_things:
            raise AssertionError(f"postproc case lost its regime: {regime}")
        bounds = _pp_bounds(k, h, w, int(valid.sum()), n_things,
                            int(kept.sum()), regime["kept_things"],
                            n_dirty / dirty.numel(), dirty.numel(),
                            _owned_px(owner_ref, kept, is_thing))
        calls = {
            "theta_hopper": (lambda: hv3.theta_hopper(m, valid, 0.4),
                             lambda: plain.theta(m, valid, 0.4)),
            "claim_hopper": (
                lambda: hv3.claim_hopper(m, th_ref, labels, is_thing, valid,
                                         0.03, slots=slots),
                lambda: plain.claim(m, th_ref, labels, is_thing, valid,
                                    0.03)),
            "argmax_hopper": (
                lambda: hv3.argmax_hopper(m, owner_ref, kept, is_thing),
                lambda: plain.argmax(m, owner_ref, kept, is_thing)),
            "repair_hopper": (
                lambda: hv3.repair_hopper(m, owner_ref, m1_ref, kept_n,
                                          is_thing, dirty, areas_ref),
                lambda: plain.repair(m, owner_ref, m1_ref, kept_n, is_thing,
                                     dirty, areas_ref)),
        }
        rows = {}
        for name, (kern, ref) in calls.items():
            b_ms, b_by = bound(*bounds[name])
            row = dict(kernel=name, K=k, shape=[k, h, w],
                       max_abs_err=errs[name], bound_ms=b_ms, bound_by=b_by)
            if timed_here:
                row["ms"] = _cuda_ms(kern)
                row["alone_ms"] = _alone_ms(kern)
                row["plain_ms"] = _cuda_ms(ref, n=5, warmup=1)
            log("kernels", json.dumps(row))
            rows[name] = row
        if (k, h, w) != ragged:
            out[k] = rows
    return out


def phase_sseg_kernel(dev, shape=SSEG_SHAPE, timed=True,
                      ragged=SSEG_RAGGED):
    """sseg kernel vs plain on seeded quarter-res logits [h, w, C] with
    ties (a channel copied, a block where all channels are equal), at
    ``shape`` and at the ragged shape: the maps must be equal.  The row is
    ``shape``'s: the wrapper's CUDA-event ms (``ms``) and the kernel's
    device ms alone (``alone_ms``, profiler)."""
    from slotvps_tpu_torch.ops import postproc_v3 as plain
    from slotvps_tpu_torch.ops.cuda import postproc_v3 as hv3

    n_diff = 0
    for h, w, c in (ragged, shape) if ragged else (shape,):
        g = torch.Generator(device=dev).manual_seed(7)
        x = torch.randn((h, w, c), generator=g, device=dev) * 3
        x[..., c - 1] = x[..., 2]
        x[: h // 8, : w // 8, :] = 0.5
        out = hv3.sseg_hopper(x)
        ref = plain.sseg(x)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        n_diff += int((out != ref).sum())
    full = 16 * h * w
    # read the logits once, write the int64 map; per full-res pixel and
    # channel a column phase (3 flops) and a compare, per quarter-res
    # value four row phases (3 flops each)
    b_ms, b_by = bound(4 * c * h * w + 8 * full,
                       4 * c * full + 12 * c * h * w)
    row = dict(kernel="sseg_hopper", shape=list(shape), max_abs_err=n_diff,
               bound_ms=b_ms, bound_by=b_by)
    if timed:
        row["ms"] = _cuda_ms(lambda: hv3.sseg_hopper(x))
        row["alone_ms"] = _alone_ms(lambda: hv3.sseg_hopper(x))
        row["plain_ms"] = _cuda_ms(lambda: plain.sseg(x), n=5, warmup=1)
    log("kernels", json.dumps(row))
    if n_diff:
        raise AssertionError(f"sseg kernel differs from plain at {n_diff} "
                             "pixels")
    return row


def phase_slot_attention(dev, pixels=SA_PIXELS, n_slots=SA_SLOTS,
                         timed=True, dtype=torch.bfloat16,
                         edge_cases=SA_EDGE_CASES):
    """Slot-attention kernel vs plain at the decoder's pixel counts, q [1, L,
    256], k and v [1, P, 256] in ``dtype`` (bf16: the bf16 tensor-core
    kernel, f32: the split-TF32 one), then (untimed) ``edge_cases`` (L, P)
    in f32.
    Returns the per-frame row (each shape weighted by its calls per
    frame)."""
    from slotvps_tpu_torch.ops.cuda.slot_attention import (
        slot_attention_hopper)
    from slotvps_tpu_torch.ops.slot_attention import slot_attention

    f32 = dtype == torch.float32
    rtol = SA_F32_RTOL if f32 else SA_RTOL
    name = "slot_attention_hopper" + ("_f32" if f32 else "")
    total = dict(kernel=name, max_abs_err=0.0, bytes=0, ops=0, ops_bf16=0,
                 ops_tf32=0, ms=0.0, plain_ms=0.0)
    cases = [(n_slots, n_pix, calls) for n_pix, calls in pixels]
    if f32:
        cases += [(slots, n_pix, 0) for slots, n_pix in edge_cases]
    for i, (slots, n_pix, calls) in enumerate(cases):
        g = torch.Generator(device=dev).manual_seed(20 + i)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for shape in ((1, slots, 256), (1, n_pix, 256),
                                 (1, n_pix, 256)))
        out = slot_attention_hopper(q, k, v)
        ref = slot_attention(q, k, v)
        again = slot_attention_hopper(q, k, v)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        esz = 4 if f32 else 2
        # q, k, v read once, out written once; 2 flops per (slot, pixel,
        # channel) in each product, on the tensor cores as the kernel runs
        # them (csrc/slot_attention.cu): bf16, q.k and p.v as three exact
        # bf16 parts of the f32 p (bf16 in, f32 sums); f32, q.k and p.v as
        # TF32_PASSES TF32 products each (the split-TF32 product; the f32
        # FMA bound beside it); the softmax ~5 f32 per (slot, pixel)
        n_bytes = esz * (slots + 2 * n_pix) * 256 + 4 * slots * 256
        n_ops_bf16 = 0 if f32 else 4 * 2 * slots * 256 * n_pix
        n_ops_tf32 = TF32_PASSES * 4 * slots * 256 * n_pix if f32 else 0
        n_ops = 5 * slots * n_pix
        row = dict(L=slots, P=n_pix, dtype=str(dtype).split(".")[-1],
                   calls_per_frame=calls, max_abs_err=err,
                   max_abs_ref=scale, bytes=n_bytes, ops=n_ops,
                   ops_bf16=n_ops_bf16, ops_tf32=n_ops_tf32)
        if timed and calls:
            row["ms"] = _cuda_ms(lambda: slot_attention_hopper(q, k, v))
            row["plain_ms"] = _cuda_ms(lambda: slot_attention(q, k, v))
            total["ms"] += calls * row["ms"]
            total["plain_ms"] += calls * row["plain_ms"]
        log("kernels", json.dumps(row))
        if not (err <= rtol * scale and torch.equal(out, again)):
            raise AssertionError(
                f"{name} disagrees at L={slots}, P={n_pix}: max|d| "
                f"{err:.3e} vs {rtol} * max|ref| {scale:.3e}, or two runs "
                "differ")
        total["max_abs_err"] = max(total["max_abs_err"], err)
        total["max_rel_err"] = max(total.get("max_rel_err", 0.0),
                                   err / scale)
        total["bytes"] += calls * n_bytes
        total["ops"] += calls * n_ops
        total["ops_bf16"] += calls * n_ops_bf16
        total["ops_tf32"] += calls * n_ops_tf32
    work = (total["bytes"], total["ops"], F32_FLOPS, total["ops_bf16"],
            total["ops_tf32"])
    total["bound_ms"], total["bound_by"] = bound(*work)
    total["bound_parts_ms"] = bound_parts(*work)
    if f32:
        total["bound_fma_ms"] = bound(
            total["bytes"], total["ops"] + total["ops_tf32"] // TF32_PASSES)[0]
    log("kernels", json.dumps(total))
    return total


def phase_batch_invariance(dev, dcn_shape=(128, 256, 256, 256, 3),
                           sa_pixels=32768, n_slots=SA_SLOTS):
    """Each image of a batch of 2 against the same image alone, bit for
    bit: the bf16 DCN (bf16 in and out) and the f32 DCN at a P3 shape and
    slot attention in bf16 and in f32 at P = 32768; and each batched call
    equal in two runs.  These launches are not the main path's."""
    from slotvps_tpu_torch.ops.cuda.deform_conv import deform_conv2d_hopper
    from slotvps_tpu_torch.ops.cuda.slot_attention import (
        slot_attention_hopper)

    h, w, cin, cout, halo = dcn_shape
    dcn = {}
    for dtype in (torch.bfloat16, torch.float32):
        x, off, wt = (t.to(dtype) for t in dcn_case(
            dev, h, w, cin, cout, halo, seed=90, b=2))
        with torch.no_grad():
            both = deform_conv2d_hopper(x, off, wt, halo)
            again = deform_conv2d_hopper(x, off, wt, halo)
            alone = [deform_conv2d_hopper(x[i:i + 1].contiguous(),
                                          off[i:i + 1].contiguous(), wt,
                                          halo) for i in range(2)]
        dcn[dtype] = (both, again, alone)
    sa = {}
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device=dev).manual_seed(91)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for shape in ((2, n_slots, 256), (2, sa_pixels, 256),
                                 (2, sa_pixels, 256)))
        sa[dtype] = (slot_attention_hopper(q, k, v),
                     slot_attention_hopper(q, k, v),
                     [slot_attention_hopper(q[i:i + 1].contiguous(),
                                            k[i:i + 1].contiguous(),
                                            v[i:i + 1].contiguous())
                      for i in range(2)])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    row = dict(dcn_shape=f"2x{h}x{w} {cin}->{cout} halo {halo}")
    for dtype, (both, again, alone) in dcn.items():
        name = "dcn" if dtype == torch.bfloat16 else "dcn_f32"
        row[f"{name}_equal_alone"] = [torch.equal(both[i:i + 1], alone[i])
                                      for i in range(2)]
        row[f"{name}_equal_again"] = torch.equal(both, again)
    row["sa_shape"] = f"2x{n_slots}x{sa_pixels}"
    for dtype, (both, again, alone) in sa.items():
        name = "sa" if dtype == torch.bfloat16 else "sa_f32"
        row[f"{name}_equal_alone"] = [torch.equal(both[i:i + 1], alone[i])
                                      for i in range(2)]
        row[f"{name}_equal_again"] = torch.equal(both, again)
    log("kernels", json.dumps({"batch_invariance": row}))
    if not all(all(v) if isinstance(v, list) else v
               for key, v in row.items() if "equal" in key):
        raise AssertionError(f"a kernel's batch of 2 is not its images "
                             f"alone bit for bit, or two runs differ: {row}")
    return row


def make_clip(h, w, n_frames, seed=0):
    """Synthetic uint8 BGR clip [1, h, w, 3] per frame: coloured blocks
    with pixel noise, panning 16 px per frame."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 256, (h // 32, w // 32, 3), dtype=np.uint8)
    base = np.repeat(np.repeat(blocks, 32, axis=0), 32, axis=1)
    frames = []
    for t in range(n_frames):
        noise = rng.integers(-12, 13, (h, w, 3))
        img = np.clip(np.roll(base, 16 * t, axis=1) + noise, 0, 255)
        frames.append(img.astype(np.uint8)[None])
    return frames


def calibrated_model(cfg, dev, probe_frame, target_valid=48):
    """Seeded init -> doctor_params -> calibrate_class_head on one probe."""
    from slotvps_tpu_torch.inference import _device_normalize
    from slotvps_tpu_torch.models.detector import (decode_pair,
                                                   extract_features,
                                                   init_model)
    from slotvps_tpu_torch.utils.calibration import (calibrate_class_head,
                                                     doctor_params)

    model = init_model(torch.Generator().manual_seed(0), cfg.model,
                       device=dev)
    doctor_params(model, torch.Generator().manual_seed(1))
    with torch.inference_mode():
        img = _device_normalize(torch.from_numpy(probe_frame).to(dev),
                                cfg.data)
        f = extract_features(model, cfg.model, img)
        logits = decode_pair(model, cfg.model, f, f).pred_logits[0]
    model, info = calibrate_class_head(
        model, logits, torch.Generator().manual_seed(2),
        target_valid=target_valid, threshold=cfg.model.postprocess.threshold)
    return model, info


def check_results(results, h, w, stuff_num, cfg):
    from slotvps_tpu_torch.eval.fusion import unify_pan_result

    for t, r in enumerate(results):
        if r.sseg.shape != (h, w) or r.panoptic.shape != (h, w):
            raise AssertionError(f"frame {t}: maps {r.sseg.shape} "
                                 f"{r.panoptic.shape} != {(h, w)}")
        if not np.isfinite(r.cls_prob).all():
            raise AssertionError(f"frame {t}: non-finite scores")
        vals = np.unique(r.panoptic)
        things = vals[(vals >= stuff_num) & (vals != 255)].tolist()
        want = list(range(stuff_num, stuff_num + len(r.cls_inds)))
        if things != want:
            raise AssertionError(f"frame {t}: thing ids {things} are not "
                                 f"contiguous from {stuff_num} ({want})")
    n_things = [len(r.cls_inds) for r in results]
    tracked = [sorted(set(a.obj_ids.tolist()) & set(b.obj_ids.tolist()))
               for a, b in zip(results, results[1:])]
    if not any(tracked):
        raise AssertionError(f"no thing tracked across frames "
                             f"(things per frame {n_things})")
    pans = unify_pan_result(
        [r.sseg for r in results], [r.panoptic for r in results],
        [r.cls_inds for r in results], [r.obj_ids for r in results],
        stuff_area_limit=cfg.eval.panoptic_stuff_area_limit,
        id_last_stuff=cfg.eval.id_last_stuff)
    if len(pans) != len(results) or pans[0].shape != (h, w, 3):
        raise AssertionError("unify_pan_result output malformed")
    return n_things, tracked


def expected_launches(cfg, results, steps=None):
    """Each kernel's launches on the path of ``cfg``, from what the frames
    report: the DCN of the path's dtype 3 blocks x levels per frame (the
    batched pipeline, too, runs the backbone one frame at a time), sseg one
    per frame on quarter-res logits, slot attention one per decoder stage
    and frame of the pair per decoder call (one per frame, or per lockstep
    ``steps`` of a batched run), and the postprocess of the path's impl
    per frame: fused, theta, the claim loop and argmax one each, repair
    one per small-area iteration; "pallas", the claim scan one."""
    m = cfg.model
    n = len(results)
    calls = n if steps is None else steps
    dcn = {"pallas": "deform_conv2d_hopper_bf16",
           "pallas_f32": "deform_conv2d_hopper"}[m.semantic_head.dcn_impl]
    want = dict.fromkeys(KERNELS, 0)
    want[dcn] = 3 * m.semantic_head.num_levels * n
    if m.slot_head.retriever_impl == "pallas":
        sa = ("slot_attention_hopper_f32" if m.compute_dtype == "float32"
              else "slot_attention_hopper")
        want[sa] = 2 * sum(m.slot_head.per_dh_num_heads) * calls
    if m.postprocess.impl == "pallas":
        want["claim_scan_hopper"] = n
    elif m.postprocess.impl == "fused":
        if m.semantic_head.fused_sseg:
            want["sseg_hopper"] = n
        want.update(theta_hopper=n, argmax_hopper=n, claim_hopper=n,
                    repair_hopper=sum(r.n_loop for r in results))
    return want


def _run_counted(dev, fn):
    """(result, launches, wall s, peak GiB) of ``fn()`` with every count set
    to 0 just before and read just after."""
    _reset_peak(dev)
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    wall = time.perf_counter() - t0
    return out, launch_counts(), wall, _peak_gib(dev)


def _check_launches(label, launches, want):
    if launches != want:
        raise AssertionError(f"[{label}] kernel launches {launches}, want "
                             f"{want}")
    missing = [name for name, n in want.items()
               if KERNELS[name][2] == label and n == 0]
    if missing:
        raise AssertionError(f"[{label}] kernels never launched on the "
                             f"path: {missing}")


def prepare(dev, cfg, h=H, w=W, n_frames=N_FRAMES, target_valid=48):
    """(calibrated model, synthetic clip) for the slice."""
    frames = make_clip(h, w, n_frames)
    # calibrate on a frame outside the clip: bisecting on a clip frame
    # would leave one of its slots exactly at the keep threshold
    probe = make_clip(h, w, 1, seed=1)[0]
    t0 = time.perf_counter()
    model, info = calibrated_model(cfg, dev, probe, target_valid)
    log("slice", f"init + doctor + calibrate {time.perf_counter() - t0:.1f}"
                 f" s: scale {info['scale']:.3f}, {info['n_valid_probe']} "
                 "slots clear the keep rule on the probe frame (outside "
                 "the clip)")
    return model, frames


def phase_slice(dev, cfg, model, frames, label="bf16"):
    """One path through InferencePipeline: its launch counts (set to 0
    just before, read just after run_video), outputs and steady frame.
    Returns (results, stats)."""
    from slotvps_tpu_torch.inference import InferencePipeline, run_video

    h, w = frames[0].shape[1:3]
    cuda = dev.type == "cuda"
    pipe = InferencePipeline(model, cfg, image_size=(h, w))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    results = run_video(pipe, frames)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    want = expected_launches(cfg, results)
    for t, r in enumerate(results):
        log("slice", f"[{label}] frame {t}: ladder branch {r.capacity} "
                     f"slots, claim over {r.n_claim} valid things, n_loop "
                     f"{r.n_loop}, {len(r.cls_inds)} things kept")
    _check_launches(label, launches, want)
    n_things, tracked = check_results(results, h, w, cfg.model.stuff_num,
                                      cfg)

    # steady per-frame latency through process_frame (host clock; each
    # call ends in a device->host copy of its maps)
    times = []
    for t, fr in enumerate(frames):
        t1 = time.perf_counter()
        pipe.process_frame(fr, is_first=(t == 0))
        if cuda:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    stats = dict(path=label, launches=launches, run_video_s=wall,
                 steady_ms_per_frame=statistics.median(times[1:]),
                 first_frame_ms=times[0], peak_mem_gib=peak / 2 ** 30,
                 things_per_frame=n_things,
                 tracked_ids=[len(x) for x in tracked],
                 obj_ids=[r.obj_ids.tolist() for r in results])
    log("slice", json.dumps(stats))
    return results, stats


def phase_slice_results(model, cfg, frames):
    """The streaming results of ``frames`` (no counts, no timing)."""
    from slotvps_tpu_torch.inference import InferencePipeline, run_video

    return run_video(InferencePipeline(model, cfg,
                                       image_size=frames[0].shape[1:3]),
                     frames)


def _decoder_outputs(model, cfg, frames, dev):
    """Decoder outputs of the clip's first frames on the card, each frame
    decoded against the previous one's features as the pipeline does."""
    from slotvps_tpu_torch.inference import _device_normalize
    from slotvps_tpu_torch.models.detector import (decode_pair,
                                                   extract_features)

    outs, prev = [], None
    with torch.inference_mode():
        for fr in frames:
            img = _device_normalize(torch.from_numpy(fr).to(dev), cfg.data)
            f = extract_features(model, cfg.model, img)
            outs.append(decode_pair(model, cfg.model, prev or f, f))
            prev = f
    return outs


def _post(outs, pcfg, size):
    from slotvps_tpu_torch.models.postprocess import postprocess_frame

    with torch.inference_mode():
        return postprocess_frame(outs.pred_logits[0], outs.pred_masks[0],
                                 outs.embeddings[0], outs.fcn_output[0],
                                 tuple(size), pcfg)


def phase_postproc(model, cfg, frames, dev, n_frames=2):
    """Fused path vs reference path on the same decoder outputs."""
    pcfg = cfg.model.postprocess
    ref_cfg = dataclasses.replace(pcfg, impl="jax")
    size = frames[0].shape[1:3]
    for t, outs in enumerate(_decoder_outputs(model, cfg,
                                              frames[:n_frames], dev)):
        fused = _post(outs, pcfg, size)
        ref = _post(outs, ref_cfg, size)
        sseg_diff = int((fused.sseg != ref.sseg).sum())
        pan_diff = int((fused.panoptic != ref.panoptic).sum())
        agree = 1.0 - pan_diff / fused.panoptic.numel()
        kept_f = torch.nonzero(fused.kept).flatten().tolist()
        kept_r = torch.nonzero(ref.kept).flatten().tolist()
        log("postproc", f"frame {t}: branch {fused.capacity}, n_loop "
                        f"{fused.n_loop}/{ref.n_loop}, kept {len(kept_f)}/"
                        f"{len(kept_r)}, sseg pixels differing {sseg_diff}, "
                        f"panoptic pixels differing {pan_diff} "
                        f"(agreement {agree:.6f})")
        if kept_f != kept_r:
            log("postproc", f"frame {t}: kept sets differ: fused only "
                            f"{sorted(set(kept_f) - set(kept_r))}, "
                            f"reference only "
                            f"{sorted(set(kept_r) - set(kept_f))}")
        if sseg_diff or agree < PAN_AGREE:
            raise AssertionError(f"frame {t}: fused and reference "
                                 f"postprocess disagree (sseg {sseg_diff} "
                                 f"px, panoptic {agree})")


def _timed(fn):
    """(result, host ms) of ``fn`` between two device synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_stages(model, cfg, frames, label="bf16"):
    """Per-stage ms of the streaming frame (a synchronize between stages,
    median over frames 1..), the postprocess with each impl, then
    torch.profiler over three frames: device ms by kernel, busy share."""
    from torch.profiler import ProfilerActivity, profile

    from slotvps_tpu_torch.inference import (InferencePipeline,
                                             _compact_post, finish_frame)
    from slotvps_tpu_torch.models.detector import decode_pair

    size = frames[0].shape[1:3]
    pipe = InferencePipeline(model, cfg, image_size=size)
    ref_cfg = dataclasses.replace(cfg.model.postprocess, impl="jax")
    rows = []
    with torch.inference_mode():
        for t, fr in enumerate(frames):
            if t == 0:
                pipe.reset_video()
            f, t_ext = _timed(lambda: pipe._extract(fr))
            ref = pipe._prev_feats or f
            outs, t_dec = _timed(lambda: decode_pair(model, cfg.model, ref,
                                                     f))
            post, t_post = _timed(lambda: _compact_post(
                _post(outs, cfg.model.postprocess, size)))
            _, t_ref = _timed(lambda: _post(outs, ref_cfg, size))
            pipe._prev_feats = f
            _, t_fin = _timed(lambda: finish_frame(
                post, t == 0, pipe._track, pipe._match, pipe.stuff_num))
            rows.append(dict(extract=t_ext, decode=t_dec, post_fused=t_post,
                             post_reference=t_ref, finish=t_fin))
    med = {k: statistics.median(r[k] for r in rows[1:]) for k in rows[0]}
    med["total_fused"] = sum(med[k] for k in ("extract", "decode",
                                              "post_fused", "finish"))
    log("stages", f"[{label}] median ms/frame over frames 1..: "
                  + json.dumps(med))

    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t, fr in enumerate(frames[:3]):
            pipe.process_frame(fr, is_first=(t == 0))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = _device_time_by_kernel(prof)
    busy = sum(ms for ms, _ in by_name.values())
    if busy == 0:
        log("stages", f"[{label}] torch.profiler saw no device time")
        return med
    log("stages", f"[{label}] profiler, 3 frames: device {busy:.1f} ms in "
                  f"{wall:.1f} ms wall, busy share {busy / wall:.3f} "
                  "(profiler on)")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :14]:
        log("stages", f"  {ms:9.3f} ms {n:5d} x {name[:90]}")
    for kern in ("dcn_fwd_f32_kernel", "dcn_fwd_bf16_kernel",
                 "slot_attn_partial_kernel", "slot_attn_reduce_kernel",
                 "sseg_kernel", "theta_kernel", "claim_kernel",
                 "claim_scan_kernel", "argmax_kernel"):
        hits = [(ms, n) for name, (ms, n) in by_name.items() if kern in name]
        if hits:
            ms, n = map(sum, zip(*hits))
            log("stages", f"  {kern}: {ms:.3f} ms in {n} launches over 3 "
                          "frames")
    # argmax and repair are instances of one kernel: <rows, mode>, mode 0
    # argmax, 2 repair
    for name, (ms, n) in by_name.items():
        inst = re.search(r"argmax_kernel<\d, \d>", name)
        if inst:
            log("stages", f"  {inst.group(0)}: {ms:.3f} ms in {n} launches "
                          "over 3 frames")
    return med


def _agreement(a, b):
    """(sseg, panoptic, panoptic with ids matched by overlap) pixel
    agreement."""
    from slotvps_tpu_torch.utils.parity import _match_relabel

    return (float((a.sseg == b.sseg).mean()),
            float((a.panoptic == b.panoptic).mean()),
            float((a.panoptic == _match_relabel(a.panoptic,
                                                b.panoptic)).mean()))


def phase_plain(model, cfg, frames, results, results_f32, n_frames=2):
    """The first frames again, same weights, fully plain in bf16 on the
    same device: the plain DCN, the plain Retriever and the reference
    postprocess; no kernel may launch.  Also prints, without asserting,
    how far the bf16 path lies from the f32 path."""
    from slotvps_tpu_torch.inference import InferencePipeline

    m = cfg.model
    plain_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        m, semantic_head=dataclasses.replace(m.semantic_head,
                                             dcn_impl="jax"),
        slot_head=dataclasses.replace(m.slot_head, retriever_impl="jax"),
        postprocess=dataclasses.replace(m.postprocess, impl="jax")))
    pipe = InferencePipeline(model, plain_cfg,
                             image_size=results[0].panoptic.shape)
    before = launch_counts()
    for t, fr in enumerate(frames[:n_frames]):
        r = pipe.process_frame(fr, is_first=(t == 0))
        k = results[t]
        sseg, pan, pan_m = _agreement(k, r)
        log("plain", f"frame {t}: sseg agreement {sseg:.6f}, panoptic "
                     f"agreement {pan:.6f} ({pan_m:.6f} with ids matched)")
        if r.cls_inds.tolist() != k.cls_inds.tolist() \
                or r.obj_ids.tolist() != k.obj_ids.tolist():
            log("plain", f"frame {t}: kept things differ: kernel "
                         f"cls {k.cls_inds.tolist()} ids "
                         f"{k.obj_ids.tolist()} / plain cls "
                         f"{r.cls_inds.tolist()} ids {r.obj_ids.tolist()}")
        if sseg < PLAIN_BF16_SSEG or pan_m < PLAIN_BF16_PAN:
            raise AssertionError(f"frame {t}: kernel path and plain path "
                                 f"disagree (sseg {sseg}, matched "
                                 f"panoptic {pan_m})")
    if launch_counts() != before:
        raise AssertionError(f"the plain path launched kernels: "
                             f"{before} -> {launch_counts()}")
    for t, (a, b) in enumerate(zip(results_f32, results)):
        sseg, pan, pan_m = _agreement(a, b)
        log("plain", f"frame {t}: bf16 path vs f32 path (same weights): "
                     f"sseg agreement {sseg:.6f}, panoptic {pan:.6f} "
                     f"({pan_m:.6f} with ids matched), things "
                     f"{b.cls_inds.tolist()} / {a.cls_inds.tolist()}")


def slice_config():
    """The JAX package's tuned stack (the port's --tuned) with the
    slot-attention kernel, as bench.py runs it with BENCH_RETRIEVER=pallas."""
    from slotvps_tpu_torch.cli.test_eval_vpq import tune_config
    from slotvps_tpu_torch.config import named_config

    return _with_retriever(tune_config(named_config("r50_fpn_slotvps")),
                           "pallas")


def f32_config():
    """The path of the port's first two slices: f32 compute, the f32 DCN
    kernel, full-res semantic logits, the fused postprocess."""
    return _with_retriever(checkpoint_config(), "jax")


def checkpoint_config():
    """The f32 Pallas-Retriever path: the f32 path of the earlier slices
    with the Retriever on the f32 slot-attention kernel."""
    return _f32_kernel_path(slice_config())


def _with_retriever(cfg, impl):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, slot_head=dataclasses.replace(cfg.model.slot_head,
                                                 retriever_impl=impl)))


def _plain_routes(cfg):
    """``cfg`` with the plain DCN and the plain Retriever."""
    m = _with_retriever(cfg, "jax").model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, semantic_head=dataclasses.replace(m.semantic_head,
                                             dcn_impl="jax")))


def _f32_kernel_path(cfg):
    """``cfg``'s model on the f32 path with both f32 kernels: the f32 DCN
    and the f32 slot attention (full-res semantic logits, the fused
    postprocess)."""
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, compute_dtype="float32",
        semantic_head=dataclasses.replace(m.semantic_head,
                                          dcn_impl="pallas_f32",
                                          fused_sseg=False),
        slot_head=dataclasses.replace(m.slot_head, retriever_impl="pallas")))


def reference_state_dict(model, mcfg):
    """The port model's state dict in the reference checkpoint's key names
    (VPS_Temporal_Slots: image_model.{backbone, neck, panopticFPN,
    dynamic_mask_head, ...}, temporal_track_head), the inverse of the key
    map of utils/checkpoint.py, for writing a reference-format .pth."""
    im = "image_model"
    stages = [f"head_series_{lvl}.{j}"
              for lvl, n in enumerate(mcfg.slot_head.per_dh_num_heads)
              for j in range(n)]
    out = {}
    for key, val in model.state_dict().items():
        top, *rest = key.split(".")
        if top == "backbone" and mcfg.backbone == "swin":
            name = f"{im}.backbone." + _swin_reference_key(rest)
        elif top == "backbone":
            name = f"{im}.backbone." + ".".join(rest).replace(
                "downsample.conv.", "downsample.0.").replace(
                "downsample.bn.", "downsample.1.")
        elif top == "fpn":
            kind = {"lateral": "lateral_convs", "fpn": "fpn_convs"}[rest[0]]
            name = f"{im}.neck.{kind}.{rest[1]}.conv.{rest[2]}"
        elif top == "semantic_head" and rest[0] == "conv_pred":
            name = f"{im}.panopticFPN.conv_pred.conv.{rest[1]}"
        elif top == "semantic_head":      # tower.{j}.{offset,conv,gn}.leaf
            j, mod, leaf = int(rest[1]), rest[2], rest[3]
            idx = 3 * j + (mod == "gn")
            sub = {"offset": "conv_offset.", "conv": "conv.", "gn": ""}[mod]
            name = f"{im}.panopticFPN.deform_convs.0.{idx}.{sub}{leaf}"
        elif top == "slot_head" and rest[0] == "conv_trans":
            name = f"{im}.dynamic_mask_head.conv_trans.conv.{rest[1]}"
        elif top == "slot_head":          # stages.{flat}.<module path>
            path = rest[2:]
            if path[0] in ("cls_module", "reg_module"):
                path = [path[0], str(3 * int(path[1]) + (path[2] == "ln")),
                        *path[3:]]
            elif path[0] == "temporal":
                path = ["temporal_query_head", *path[1:]]
            name = (f"{im}.dynamic_mask_head.{stages[int(rest[1])]}."
                    + ".".join(path))
        elif top == "track_head":
            name = f"temporal_track_head.fcs_query.{rest[1]}.{rest[2]}"
        elif top == "init_mask_query":
            name = f"{im}.init_mask_query.weight"
        elif top == "conv_trans":
            name = f"{im}.conv_trans.conv.{rest[0]}"
        else:                             # fg_bn, feat_bn
            name = f"{im}.{key}"
        out[name] = val.detach().cpu().clone()
    if mcfg.backbone == "swin":
        # the derived buffer a reference Swin checkpoint holds (the port
        # recomputes it and must not read it)
        from slotvps_tpu_torch.models.swin import rel_pos_index

        index = rel_pos_index(mcfg.swin.window_size)
        for si, depth in enumerate(mcfg.swin.depths):
            for bi in range(depth):
                out[f"{im}.backbone.layers.{si}.blocks.{bi}.attn."
                    "relative_position_index"] = index.clone()
    return out


# port Swin module names -> the reference's (swin_transformer.py)
_SWIN_KEYS = {"qkv": "attn.qkv", "proj": "attn.proj",
              "rel_pos_bias": "attn.relative_position_bias_table",
              "fc1": "mlp.fc1", "fc2": "mlp.fc2"}


def _swin_reference_key(parts):
    """A port Swin backbone key (split at the dots, without "backbone")
    in the reference's names: stage{s} -> layers.{s}, a block's attention
    and MLP under attn. / mlp., out_norm{i} -> norm{i}."""
    head, *rest = parts
    if head.startswith("out_norm"):
        return ".".join([f"norm{head[len('out_norm'):]}", *rest])
    if head.startswith("stage"):
        head = f"layers.{head[len('stage'):]}"
        if rest[0] == "blocks":
            rest = rest[:2] + _SWIN_KEYS.get(rest[2], rest[2]).split(".") \
                + rest[3:]
    return ".".join([head, *rest])


# the f32 Pallas-Retriever path against the plain-Retriever path, same
# weights: a slot may change sides of the 0.85 keep rule only if its score
# lies this close to it (the two routes' f32 attention outputs differ by
# ~2e-6 of max)
KEEP_MARGIN = 1e-4
# the f32 DCN kernel against the plain DCN: a semantic-map pixel may differ
# only where the plain route's logits of its two classes lie this close
# (relative to the largest |logit|; the kernel is within 4.1e-6 of max)
SSEG_TIE = 1e-4


def _valid_slots(model, cfg, frames, dev, t):
    """(valid slot ids, scores) of frame ``t``'s decoder outputs on
    ``cfg``'s path under the keep rule (class != no-object, score >
    threshold)."""
    pcfg = cfg.model.postprocess
    outs = _decoder_outputs(model, cfg, frames[:t + 1], dev)[t]
    probs = torch.softmax(outs.pred_logits[0].float(), dim=-1)
    scores, classes = probs.amax(-1), probs.argmax(-1)
    valid = (classes != pcfg.num_classes - 1) & (scores > pcfg.threshold)
    return set(torch.nonzero(valid).flatten().tolist()), scores.cpu()


def _sseg_ties(model, cfg_p, frames, dev, t, sseg_k, sseg_p):
    """(pixels, largest gap / max |logit|) where the two routes' semantic
    maps of frame ``t`` differ: the gap between the plain route's logits of
    the two classes at each such pixel, against its largest |logit|."""
    diff = sseg_k != sseg_p
    if not diff.any():
        return 0, 0.0
    logits = _decoder_outputs(model, cfg_p, frames[:t + 1], dev)[t] \
        .fcn_output[0].float().cpu().numpy()
    at = logits[diff]
    rows = np.arange(at.shape[0])
    gap = np.abs(at[rows, sseg_k[diff]] - at[rows, sseg_p[diff]])
    return int(diff.sum()), float(gap.max() / np.abs(logits).max())


def _routes_agree(model, cfg_k, cfg_p, frames, dev, res_k, res_p,
                  label="checkpoint", sseg_tie=None):
    """The kernel route's integer outputs against the plain route's: equal,
    or, where they differ, every slot that the keep rule keeps on one route
    only has its score within KEEP_MARGIN of the threshold on both, and
    with the same slots kept the semantic maps are equal and the panoptic
    maps agree on >= PAN_AGREE of the pixels (a pixel whose mask logits tie
    within the routes' difference).  With ``sseg_tie`` (routes whose
    semantic logits differ: the DCN kernel against the plain DCN) the
    semantic maps may differ only at pixels whose two classes' plain logits
    lie within ``sseg_tie`` of the largest |logit| (:func:`_sseg_ties`).
    Prints what differs."""
    thr = cfg_k.model.postprocess.threshold
    notes = []
    for t, (a, b) in enumerate(zip(res_p, res_k)):
        diff = [name for name in ("sseg", "panoptic", "cls_inds", "obj_ids")
                if not np.array_equal(getattr(a, name), getattr(b, name))]
        if not diff:
            continue
        vk, sk = _valid_slots(model, cfg_k, frames, dev, t)
        vp, sp = _valid_slots(model, cfg_p, frames, dev, t)
        slots = sorted(vk ^ vp)
        near = {s: (float(sk[s]), float(sp[s])) for s in slots}
        pan = float((a.panoptic == b.panoptic).mean())
        notes.append(dict(frame=t, differ_in=diff, slots_kept_on_one_route=
                          near, panoptic_agreement=pan))
        log(label, f"frame {t}: the routes differ in {diff}; slots "
                          f"kept on one route only (kernel score, plain "
                          f"score): {near}; panoptic agreement {pan:.6f}")
        if slots:
            if any(abs(x - thr) > KEEP_MARGIN for sc in near.values()
                   for x in sc):
                raise AssertionError(
                    f"frame {t}: the f32 kernel route keeps other slots "
                    f"than the plain route, not all within {KEEP_MARGIN} "
                    f"of the {thr} rule: {near}")
            continue
        sseg_ok = np.array_equal(a.sseg, b.sseg)
        if not sseg_ok and sseg_tie is not None:
            n_px, gap = _sseg_ties(model, cfg_p, frames, dev, t, b.sseg,
                                   a.sseg)
            notes[-1].update(sseg_pixels=n_px, sseg_gap=gap)
            log(label, f"frame {t}: the semantic maps differ at {n_px} "
                       f"pixels, the plain logits of their two classes "
                       f"within {gap:.3g} of the largest |logit| (allowed "
                       f"{sseg_tie})")
            sseg_ok = gap <= sseg_tie
        if not (sseg_ok and pan >= PAN_AGREE
                and a.cls_inds.tolist() == b.cls_inds.tolist()
                and a.obj_ids.tolist() == b.obj_ids.tolist()):
            raise AssertionError(f"frame {t}: same slots kept, but the "
                                 f"routes' outputs differ in {diff} "
                                 f"(panoptic agreement {pan})")
    return notes


def phase_checkpoint(dev, model, frames, root, cfg=None):
    """The path a user takes to evaluate published weights, on the f32
    Pallas-Retriever path: ``model``'s weights written as a reference-format
    .pth; loaded with load_torch_checkpoint into a new model (state_dict
    equal bit for bit); check_dcn_halo on the clip's frames (per-level
    maxima and the recommendation, taken as the CLI takes it); the frames
    through InferencePipeline (launches counted, the f32 slot-attention
    kernel 14 a frame; steady ms a frame, peak memory); the integer
    outputs against the plain-Retriever route with the same weights
    (:func:`_routes_agree`).  ``cfg``: :func:`checkpoint_config` unless
    given.  Returns (stats, .pth path, the config the frames ran on)."""
    from slotvps_tpu_torch.inference import _device_normalize
    from slotvps_tpu_torch.models.detector import init_model
    from slotvps_tpu_torch.utils.checkpoint import load_torch_checkpoint
    from slotvps_tpu_torch.utils.diagnostics import (check_dcn_halo,
                                                     measure_max_dcn_offset)

    cfg = cfg or checkpoint_config()
    pth = root / "reference.pth"
    torch.save({"state_dict": reference_state_dict(model, cfg.model),
                "meta": {"CLASSES": None, "config": "r50_fpn_slotvps"}}, pth)
    t0 = time.perf_counter()
    loaded = init_model(torch.Generator().manual_seed(5), cfg.model,
                        device=dev)
    loaded.load_state_dict(load_torch_checkpoint(str(pth), cfg.model),
                           strict=True)
    load_s = time.perf_counter() - t0
    want, got = model.state_dict(), loaded.state_dict()
    differ = sorted(k for k in want if not torch.equal(want[k], got[k]))
    if set(want) != set(got) or differ:
        raise AssertionError(f"the loaded checkpoint's state_dict differs "
                             f"from the model's in {differ[:8]}")
    log("checkpoint", f"wrote {pth.stat().st_size / 2 ** 20:.1f} MiB in the "
                      f"reference's key names ({len(want)} entries); "
                      f"load_torch_checkpoint + load_state_dict "
                      f"{load_s:.2f} s: state_dict equal bit for bit")
    images = [_device_normalize(torch.from_numpy(f).to(dev), cfg.data)
              for f in frames]
    per_level = measure_max_dcn_offset(loaded, cfg.model, images=images)
    mx, eff, rec = check_dcn_halo(loaded, cfg.model, warn=False,
                                  images=images)
    log("checkpoint", f"DCN offsets on {len(images)} clip frames: max per "
                      f"level (P2..P5) {[round(float(m), 4) for m in per_level]}"
                      f" px, {mx:.4f} overall; halos in effect {eff}, "
                      f"recommended {rec}")
    if rec != eff:
        m = cfg.model
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            m, semantic_head=dataclasses.replace(m.semantic_head,
                                                 dcn_halo=rec)))
    results, stats = phase_slice(dev, cfg, loaded, frames, "checkpoint")
    # one launch a decoder stage and frame of the pair: 14 a frame at the
    # named configs' 7 stages
    per_frame = 2 * sum(cfg.model.slot_head.per_dh_num_heads)
    n_sa = stats["launches"]["slot_attention_hopper_f32"]
    if n_sa != per_frame * len(frames):
        raise AssertionError(f"{n_sa} f32 slot-attention launches in "
                             f"{len(frames)} frames, not {per_frame} a "
                             "frame")
    cfg_p = _with_retriever(cfg, "jax")
    plain = phase_slice_results(loaded, cfg_p, frames)
    stats["routes_differ"] = _routes_agree(loaded, cfg, cfg_p, frames, dev,
                                           results, plain)
    stats["halos"] = dict(per_level_max=per_level.tolist(), in_effect=eff,
                          recommended=rec)
    log("checkpoint", f"f32 Pallas-Retriever path == plain-Retriever path "
                      f"on {len(frames)} frames (differences above, if "
                      f"any); steady {stats['steady_ms_per_frame']:.2f} ms "
                      f"a frame, peak {stats['peak_mem_gib']:.2f} GiB")
    del loaded
    return stats, pth, cfg


def write_cli_dataset(root, videos):
    """``videos`` (lists of uint8 BGR [1, h, w, 3] frames) as a
    Cityscapes-VPS-style dataset on disk: images, the annotation json, and
    ground-truth panoptic PNGs with their json (a road segment and one car
    per frame), as tests/test_torch_slice.py writes its fixture."""
    import cv2
    from PIL import Image

    from slotvps_tpu_torch.eval.color import CITYSCAPES_CATEGORIES, id2rgb

    img_dir, truth_dir = root / "img", root / "gt"
    img_dir.mkdir(parents=True)
    truth_dir.mkdir()
    h, w = videos[0][0].shape[1:3]
    images, gt_images, gt_annos = [], [], []
    for v, frames in enumerate(videos, start=1):
        for f, img in enumerate(frames, start=1):
            id_map = np.full((h, w), 1, np.uint32)
            id_map[h // 2:h // 2 + h // 8, w // 8 * f:w // 8 * f + w // 6] \
                = 1001
            segs = [{"id": i, "category_id": c, "iscrowd": 0,
                     "area": int((id_map == i).sum())}
                    for i, c in ((1, 0), (1001, 11))]
            name = f"{v:04d}_{f:04d}_city_newImg8bit.png"
            cv2.imwrite(str(img_dir / name), img[0])
            iid = v * 10000 + f
            images.append({"id": iid, "file_name": name, "height": h,
                           "width": w})
            gt_images.append({"id": iid, "file_name": name})
            gt_annos.append({"segments_info": segs})
            Image.fromarray(id2rgb(id_map)).save(
                truth_dir / name.replace("_newImg8bit.png",
                                         "_final_mask.png"))
    ann, gt_json = root / "ann.json", root / "gt_pan.json"
    cats = list(CITYSCAPES_CATEGORIES)
    ann.write_text(json.dumps({"images": images, "annotations": [],
                               "categories": cats}))
    gt_json.write_text(json.dumps({"images": gt_images,
                                   "annotations": gt_annos,
                                   "categories": cats}))
    return ann, img_dir, truth_dir, gt_json


def phase_cli(dev, cfg, pth, videos, root, args=(), label="cli"):
    """The eval CLI's main on the card, as a user runs it with a reference
    checkpoint: ``--checkpoint <pth> --save_diff_fig`` and ``args`` over
    ``videos`` (2 x 2 frames at 1024x2048) on ``cfg``'s path (named_config
    patched to it, nframes_per_video 2; ``--tuned`` in ``args`` tunes it);
    it must return a VPQ summary of finite numbers, print its halo line,
    and write pred.json and pan_diff/*.png."""
    import contextlib
    import io

    from slotvps_tpu_torch.cli import test_eval_vpq as cli

    ann, img_dir, truth_dir, gt_json = write_cli_dataset(root / label,
                                                         videos)
    run_cfg = dataclasses.replace(cfg, eval=dataclasses.replace(
        cfg.eval, nframes_per_video=len(videos[0])))
    named = cli.named_config
    cli.named_config = lambda name: run_cfg
    out = root / label / "out" / "out.pkl"
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            summary = cli.main([
                "--device", str(dev), "--checkpoint", str(pth),
                "--save_diff_fig", *args, "--ann_file", str(ann),
                "--img_prefix", str(img_dir), "--out", str(out),
                "--truth_dir", str(truth_dir), "--pan_gt_json_file",
                str(gt_json)])
    finally:
        cli.named_config = named
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    (root / label / "cli_stdout.txt").write_text(text)
    out_dir = root / label / "out" / "out_pans_unified"
    n_frames = sum(len(v) for v in videos)
    n_diff = len(list((out_dir / "pan_diff").glob("*.png")))
    halo = [x for x in text.splitlines() if x.startswith("DCN offsets")]
    vpq = {k: summary[k] for k in ("vpq_all", "vpq_thing", "vpq_stuff")} \
        if summary else None
    flags = "".join(f" {a}" for a in args)
    log(label, f"main(--checkpoint, --save_diff_fig{flags}) on "
               f"{len(videos)} videos x {len(videos[0])} frames at "
               f"{videos[0][0].shape[1]}x{videos[0][0].shape[2]}: {wall:.1f} "
               f"s (build, halo check, inference, fusion and VPQ); "
               f"{halo}; {n_diff} pan_diff PNGs; VPQ {vpq}")
    if not (summary and halo and n_diff == n_frames
            and (out_dir / "pred.json").exists()
            and all(np.isfinite(v) for v in vpq.values())):
        raise AssertionError("the CLI's run with a checkpoint did not give "
                             "a VPQ summary, its halo line and the diff "
                             "figures")
    return dict(wall_s=wall, vpq=vpq)


def swin_config():
    """swinl_fpn_slotvps in the port's --tuned stack with the slot-attention
    kernel (as :func:`slice_config` for R50)."""
    from slotvps_tpu_torch.cli.test_eval_vpq import tune_config
    from slotvps_tpu_torch.config import named_config

    return _with_retriever(tune_config(named_config("swinl_fpn_slotvps")),
                           "pallas")


def _swin_checkpoint(dev, model, cfg, frames, root):
    """``model``'s weights as a reference-format Swin .pth (the reference's
    Swin key names, with its relative_position_index buffers); loaded by
    load_torch_checkpoint into a new model (state_dict equal bit for bit);
    check_dcn_halo on ``frames``.  Returns (.pth path, stats)."""
    from slotvps_tpu_torch.inference import _device_normalize
    from slotvps_tpu_torch.models.detector import init_model
    from slotvps_tpu_torch.utils.checkpoint import load_torch_checkpoint
    from slotvps_tpu_torch.utils.diagnostics import check_dcn_halo

    pth = root / "swinl_reference.pth"
    t0 = time.perf_counter()
    torch.save({"state_dict": reference_state_dict(model, cfg.model),
                "meta": {"CLASSES": None, "config": "swinl_fpn_slotvps"}},
               pth)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = init_model(torch.Generator().manual_seed(5), cfg.model,
                        device=dev)
    loaded.load_state_dict(load_torch_checkpoint(str(pth), cfg.model),
                           strict=True)
    load_s = time.perf_counter() - t0
    want, got = model.state_dict(), loaded.state_dict()
    differ = sorted(k for k in want if not torch.equal(want[k], got[k]))
    if set(want) != set(got) or differ:
        raise AssertionError(f"the loaded Swin checkpoint's state_dict "
                             f"differs from the model's in {differ[:8]}")
    images = [_device_normalize(torch.from_numpy(f).to(dev), cfg.data)
              for f in frames]
    mx, eff, rec = check_dcn_halo(loaded, cfg.model, warn=False,
                                  images=images)
    stats = dict(pth_mib=pth.stat().st_size / 2 ** 20, entries=len(want),
                 save_s=save_s, init_load_s=load_s, max_offset=mx,
                 halos_in_effect=eff, halos_recommended=rec)
    log("swin", f"reference .pth {stats['pth_mib']:.1f} MiB "
                f"({len(want)} port entries) written in {save_s:.2f} s; "
                f"init_model + load_torch_checkpoint + load_state_dict "
                f"{load_s:.2f} s: state_dict equal bit for bit; DCN offsets "
                f"on {len(images)} frames up to {mx:.4f} px, halos in effect "
                f"{eff}, recommended {rec}")
    del loaded
    return pth, stats


def phase_swin(dev, card, root, h=H, w=W, stages=True):
    """swinl_fpn_slotvps at full width (Swin-L: embed 192, depths
    (2, 2, 18, 2), heads (6, 12, 24, 48), window 7) on the card: seeded
    weights doctored and calibrated (~48 slots on a probe frame); the bf16
    --tuned stack with the slot-attention kernel on 3 clip frames through
    InferencePipeline (launches counted), its stage times (and the f32
    path's), then the same frames fully plain (the rule of :func:`phase_plain`); the f32 path
    with the f32 DCN and f32 slot-attention kernels on 2 frames (launches
    counted) against the plain Retriever (the checkpoint phase's rule,
    :func:`_routes_agree`) and against both plain routes (the same rule,
    a semantic-map pixel free to differ only at a tie within SSEG_TIE of
    the plain DCN's logits); the weights as
    a reference .pth, loaded bit for bit, the halo check; the eval CLI
    with --config swinl_fpn_slotvps --tuned --checkpoint on 1 video x 2
    frames.  The .pth is deleted after.  Returns the stats."""
    from slotvps_tpu_torch.config import named_config

    cfg = swin_config()
    cfg32 = _f32_kernel_path(cfg)
    model, frames = prepare(dev, cfg, h, w, n_frames=3)
    n_params = sum(p.numel() for p in model.backbone.parameters())
    log("swin", f"Swin-L backbone {n_params / 1e6:.1f} M parameters; "
                f"{card}")
    results, stats = phase_slice(dev, cfg, model, frames, "swin_bf16")
    out = dict(bf16=stats)
    if stages:
        out["bf16_stages"] = phase_stages(model, cfg, frames, "swin_bf16")
    results32, stats32 = phase_slice(dev, cfg32, model, frames[:2],
                                     "swin_f32")
    out["f32"] = stats32
    if stages:
        out["f32_stages"] = phase_stages(model, cfg32, frames, "swin_f32")
    # the checkpoint phase's rule against the plain Retriever (same DCN
    # kernel), then against both plain routes, where the plain DCN's f32
    # sums move the semantic logits in their last bits and a tie may flip
    cfg_sa = _with_retriever(cfg32, "jax")
    out["f32_vs_plain_retriever"] = _routes_agree(
        model, cfg32, cfg_sa, frames[:2], dev, results32,
        phase_slice_results(model, cfg_sa, frames[:2]), label="swin")
    out["f32_vs_plain_routes"] = _routes_agree(
        model, cfg32, _plain_routes(cfg32), frames[:2], dev, results32,
        phase_slice_results(model, _plain_routes(cfg32), frames[:2]),
        label="swin", sseg_tie=SSEG_TIE)
    phase_plain(model, cfg, frames, results, results32)
    pth, out["checkpoint"] = _swin_checkpoint(dev, model, cfg, frames[:2],
                                              root)
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    try:
        out["cli"] = phase_cli(dev, named_config("swinl_fpn_slotvps"), pth,
                               [frames[:2]], root,
                               args=("--config", "swinl_fpn_slotvps",
                                     "--tuned"), label="swin_cli")
    finally:
        pth.unlink()
    ext = {k: out.get(f"{k}_stages", {}).get("extract")
           for k in ("bf16", "f32")}
    log("swin", f"{card}: bf16 --tuned with the slot-attention kernel: "
                f"extract {ext['bf16']} ms, steady "
                f"{stats['steady_ms_per_frame']:.2f} ms a frame, peak "
                f"{stats['peak_mem_gib']:.2f} GiB, launches "
                f"{_nonzero(stats['launches'])}; f32 kernel path: extract "
                f"{ext['f32']} ms, steady "
                f"{stats32['steady_ms_per_frame']:.2f} ms a frame, "
                f"peak {stats32['peak_mem_gib']:.2f} GiB, launches "
                f"{_nonzero(stats32['launches'])}")
    return out


def _nonzero(counts):
    return {k: n for k, n in counts.items() if n}


def plugins_config():
    """r50_fpn_slotvps with the R52 stem and the DCN and GCNet plugins on
    stages 2-4, on the f32 path of the earlier slices."""
    cfg = f32_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, resnet=dataclasses.replace(
            cfg.model.resnet, r52_stem=True,
            dcn_stages=(False, True, True, True),
            gcb_stages=(False, True, True, True))))


def phase_plugins(dev, h=H, w=W):
    """One f32 frame of :func:`plugins_config` at full width: seeded
    weights, the backbone's BN statistics calibrated on the frame
    (calibrate_bn_stats with its replay check: random-init BN statistics
    blow the activations up), then the frame through extract_features,
    decode_pair and the fused postprocess with the launches counted (the
    semantic head's 12 f32 DCN launches; the backbone's DCN plugin runs
    the plain DCN); outputs finite."""
    from slotvps_tpu_torch.inference import _device_normalize
    from slotvps_tpu_torch.models.detector import init_model
    from slotvps_tpu_torch.models.resnet import calibrate_bn_stats

    cfg = plugins_config()
    frame = make_clip(h, w, 1, seed=4)[0]
    model = init_model(torch.Generator().manual_seed(0), cfg.model,
                       device=dev)
    with torch.no_grad():
        img = _device_normalize(torch.from_numpy(frame).to(dev), cfg.data)
        t0 = time.perf_counter()
        calibrate_bn_stats(model.backbone, img)
        _sync(dev)
        cal_s = time.perf_counter() - t0

    def run():
        outs = _decoder_outputs(model, cfg, [frame], dev)[0]
        return outs, _post(outs, cfg.model.postprocess, (h, w))

    (outs, post), launches, wall, peak = _run_counted(dev, run)
    want = expected_launches(cfg, [post])
    _check_launches("plugins", launches, want)
    if not _finite([outs.pred_logits, outs.pred_masks, outs.embeddings,
                    outs.fcn_output]):
        raise AssertionError("the plugins model gave non-finite outputs")
    if tuple(post.panoptic.shape) != (h, w):
        raise AssertionError(f"panoptic map {tuple(post.panoptic.shape)}")
    stats = dict(launches=_nonzero(launches), frame_s=wall,
                 bn_calibration_s=cal_s, peak_mem_gib=peak,
                 kept=int(post.kept.sum()))
    log("plugins", "R50 + R52 stem + DCN/GCNet plugins on stages 2-4, "
                   f"one f32 {h}x{w} frame: " + json.dumps(stats))
    return stats


def train_config(name="r50_fpn_slotvps"):
    """The JAX package's training configuration (bench.py _trained_setup)
    of the named model: the --tuned model in f32 with the bf16 DCN route,
    full-res semantic logits and the plain Retriever."""
    from slotvps_tpu_torch.cli.test_eval_vpq import tune_config
    from slotvps_tpu_torch.config import named_config

    cfg = tune_config(named_config(name))
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, compute_dtype="float32",
        semantic_head=dataclasses.replace(m.semantic_head, dcn_impl="pallas",
                                          fused_sseg=False),
        postprocess=dataclasses.replace(m.postprocess, impl="jax")))


def _with_dcn(cfg, impl):
    m = cfg.model
    return dataclasses.replace(m, semantic_head=dataclasses.replace(
        m.semantic_head, dcn_impl=impl))


def train_model(cfg, dev):
    """Seeded init; fractional DCN offsets (doctor_params, fg_bn at its
    reference scale); the Retrievers' q and k LayerNorm scales quartered,
    so that their unscaled slot softmax does not turn f32 rounding into
    large gradient differences between two DCN routes."""
    from slotvps_tpu_torch.models.detector import init_model
    from slotvps_tpu_torch.utils.calibration import doctor_params

    model = init_model(torch.Generator().manual_seed(0), cfg.model,
                       device=dev)
    doctor_params(model, torch.Generator().manual_seed(1), fg_scale=0.1,
                  fg_var=1.0)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if name.endswith(("inst_interact.norm_q",
                              "inst_interact.norm_k")):
                mod.weight.mul_(0.25)
    return model


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _finite(tensors):
    return bool(torch.stack([torch.isfinite(t).all()
                             for t in tensors]).all())


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _reset_peak(dev):
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak_gib(dev):
    return (torch.cuda.max_memory_allocated() / 2 ** 30
            if dev.type == "cuda" else 0.0)


def phase_train(dev, steps=TRAIN_STEPS, size=(TRAIN_H, TRAIN_W)):
    """The training path: ``steps`` train_steps with dcn_impl="pallas" (the
    main path, counts set to 0 just before and read just after), then one
    step split into its parts and one under the profiler.  Returns
    (stats, initial state_dict, batch)."""
    from torch.profiler import ProfilerActivity, profile

    from slotvps_tpu_torch.training.step import (loss_fn, make_optimizer,
                                                 train_step)
    from slotvps_tpu_torch.utils.synthetic import (make_scene,
                                                   scene_train_batch)

    cfg = train_config()
    model = train_model(cfg, dev)
    init_state = {k: v.detach().clone()
                  for k, v in model.state_dict().items()}
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    batch = scene_train_batch(make_scene(*size, n_things=12, seed=0),
                              g_cap=GT_CAPACITY).to(dev)
    opt = make_optimizer(model)
    n_params = sum(p.numel() for p in model.parameters())
    log("train", f"r50_fpn_slotvps f32, dcn_impl 'pallas' (bf16), "
                 f"{size[0]}x{size[1]}, batch 1, {GT_CAPACITY} GT slots "
                 f"({int(batch.gt_valid.sum())} valid), {n_params} "
                 "parameters")
    _reset_peak(dev)
    reset_counts()
    times, losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        metrics = train_step(model, opt, batch, cfg.model)
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        m = {k: float(v) for k, v in metrics.items()}
        losses.append(m)
        finite = _finite([p.grad for p in model.parameters()
                          if p.grad is not None])
        log("train", f"step {i}: {times[-1]:.1f} ms, grads finite "
                     f"{finite}, " + json.dumps(m))
        if not (finite and all(np.isfinite(v) for v in m.values())):
            raise AssertionError(f"step {i}: non-finite loss or gradient")
    launches = launch_counts()
    peak = _peak_gib(dev)
    want = dict.fromkeys(KERNELS, 0)
    want.update(deform_conv2d_hopper_bf16_f32=12 * steps,
                dcn_backward_hopper_bf16=12 * steps)
    if launches != want:
        raise AssertionError(f"train: launches {launches} in {steps} "
                             f"steps, want {want}")
    for k, v in model.named_buffers():
        if not torch.equal(v, buffers[k]):
            raise AssertionError(f"train: BN statistics {k} changed")

    # one step split into its parts, device synchronized between them
    _sync(dev)
    t0 = time.perf_counter()
    opt.zero_grad()
    total, _ = loss_fn(model, cfg.model, batch)
    _sync(dev)
    t1 = time.perf_counter()
    total.backward()
    _sync(dev)
    t2 = time.perf_counter()
    opt.step()
    _sync(dev)
    t3 = time.perf_counter()
    split = dict(forward_ms=(t1 - t0) * 1e3, backward_ms=(t2 - t1) * 1e3,
                 optimizer_ms=(t3 - t2) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _sync(dev)
        t0 = time.perf_counter()
        train_step(model, opt, batch, cfg.model)
        _sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
    by_name = _device_time_by_kernel(prof)
    busy = sum(ms for ms, _ in by_name.values())
    stats = dict(path="train", launches=launches,
                 steady_ms_per_step=statistics.median(times[1:]),
                 first_step_ms=times[0], step_ms=times, **split,
                 peak_mem_gib=peak,
                 loss_total=[m["loss_total"] for m in losses],
                 profiler_device_ms=busy, profiler_wall_ms=wall,
                 busy_share=busy / wall if wall else 0.0)
    log("train", json.dumps(stats))
    for name, (ms, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:14]:
        log("train", f"  {ms:9.3f} ms {n:5d} x {name[:90]}")
    for kern in ("dcn_fwd_bf16_kernel", "dcn_bwd_data_bf16_kernel",
                 "dcn_bwd_dx_kernel", "dcn_bwd_dw_bf16_kernel",
                 "dcn_bwd_reduce_kernel"):
        hits = [(ms, n) for name, (ms, n) in by_name.items() if kern in name]
        if hits:
            ms, n = map(sum, zip(*hits))
            log("train", f"  {kern}: {ms:.3f} ms in {n} launches, one step")
    del model, opt, total
    return stats, init_state, batch


def phase_train_parity(dev, init_state, batch):
    """With fixed_match, the loss terms and every gradient of one step with
    the f32 DCN kernel (forward and backward) against one with the plain
    DCN, from the same weights and batch; each step's ms (host clock
    around loss and backward, ending in a synchronize), then one more
    pallas_f32 step under the profiler: its DCN kernels' device ms.
    Returns the pallas_f32 run's stats (its launch counts)."""
    from torch.profiler import ProfilerActivity, profile

    from slotvps_tpu_torch.training.step import loss_fn

    cfg = train_config()
    runs, step_ms = {}, {}
    for impl in ("pallas_f32", "jax"):
        model = train_model(cfg, dev)
        model.load_state_dict(init_state)
        mcfg = _with_dcn(cfg, impl)
        _reset_peak(dev)
        reset_counts()
        t0 = time.perf_counter()
        total, metrics = loss_fn(model, mcfg, batch, fixed_match=True)
        total.backward()
        _sync(dev)
        step_ms[impl] = (time.perf_counter() - t0) * 1e3
        runs[impl] = ({k: float(v.detach()) for k, v in metrics.items()},
                      _grads(model), launch_counts(), _peak_gib(dev))
        if impl == "pallas_f32" and dev.type == "cuda":
            model.zero_grad()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                total, metrics = loss_fn(model, mcfg, batch,
                                         fixed_match=True)
                total.backward()
                _sync(dev)
            by_name = _device_time_by_kernel(prof)
            dcn = {}
            for name, (ms, n) in by_name.items():
                m = re.search(r"dcn_\w+", name)
                if m:
                    dcn[m.group(0)] = dcn.get(m.group(0), 0.0) + ms
            log("train", json.dumps({
                "pallas_f32_step_profiled": {
                    "device_ms": sum(ms for ms, _ in by_name.values()),
                    "dcn_device_ms": sum(dcn.values()),
                    "dcn_by_kernel_ms": dcn}}))
        del model, total, metrics
    (m_k, g_k, launches, peak_k), (m_p, g_p, plain_launches, peak_p) = (
        runs["pallas_f32"], runs["jax"])
    loss_rel = {k: abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-12)
                for k in m_p}
    g_max = {n: float(g.abs().max()) for n, g in g_p.items()}
    floor = TRAIN_GRAD_FLOOR * max(g_max.values())
    grad_rel = {n: float((g_k[n] - g_p[n]).abs().max())
                / max(g_max[n], floor) for n in g_p}
    worst = [(n, r, g_max[n]) for n, r in sorted(
        grad_rel.items(), key=lambda kv: -kv[1])[:5]]
    log("train", json.dumps({"parity_step_ms": step_ms}))
    log("train", f"pallas_f32 vs plain DCN, fixed_match: loss terms "
                 f"{json.dumps(m_k)}; max rel loss diff "
                 f"{max(loss_rel.values()):.3e}; max rel grad diff "
                 f"{worst[0][1]:.3e} over {len(grad_rel)} tensors, floor "
                 f"{floor:.3e} (worst, with max|g|: {worst}); peak "
                 f"{peak_k:.2f} / {peak_p:.2f} GiB")
    want = dict.fromkeys(KERNELS, 0)
    want.update(deform_conv2d_hopper=12, dcn_backward_hopper=12)
    if launches != want or any(plain_launches.values()):
        raise AssertionError(f"parity steps launched {launches} / "
                             f"{plain_launches}, want {want} / none")
    if set(g_k) != set(g_p) or not _finite(list(g_k.values())):
        raise AssertionError("pallas_f32 step: gradients missing or not "
                             "finite")
    if max(loss_rel.values()) > TRAIN_LOSS_RTOL \
            or worst[0][1] > TRAIN_GRAD_RTOL:
        raise AssertionError(f"pallas_f32 step disagrees with the plain "
                             f"step: losses {loss_rel}, gradients {worst}")
    return dict(path="train_f32", launches=launches, peak_mem_gib=peak_k,
                plain_peak_mem_gib=peak_p, step_ms=step_ms)


def _scene_clip(h, w, n_frames, seed=0, shift=16):
    """uint8 BGR frames [1, h, w, 3] of the synthetic scene
    (utils/synthetic.make_scene, 12 things) translating ``shift`` px a
    frame: the frames the overfit model was trained on, at (h, w)."""
    from slotvps_tpu_torch.utils.synthetic import make_scene

    img = make_scene(h, w, n_things=12, seed=seed).img
    return [np.roll(img, t * shift, axis=1)[None] for t in range(n_frames)]


def _kept_things(kept):
    """A context manager recording each InferencePipeline frame's kept
    thing classes into ``kept`` (the hook's pipeline is internal)."""
    import contextlib

    from slotvps_tpu_torch.inference import InferencePipeline

    @contextlib.contextmanager
    def recording():
        real = InferencePipeline.process_frame

        def process_frame(self, *a, **k):
            res = real(self, *a, **k)
            kept.append(len(res.cls_inds))
            return res
        InferencePipeline.process_frame = process_frame
        try:
            yield
        finally:
            InferencePipeline.process_frame = real
    return recording()


def eval_config(cfg):
    """``cfg`` (the training configuration) for the eval hook: the fused
    postprocess (its kernels; the training configuration's reference
    postprocess launches none) and 2-frame videos."""
    m = cfg.model
    return dataclasses.replace(
        cfg, model=dataclasses.replace(m, postprocess=dataclasses.replace(
            m.postprocess, impl="fused")),
        eval=dataclasses.replace(cfg.eval, nframes_per_video=2))


def phase_train_eval(dev, root, cfg=None, steps=OVERFIT_STEPS,
                     size=(TRAIN_H, TRAIN_W), eval_size=(H, W),
                     g_cap=GT_CAPACITY):
    """The rest of training at full width (``train_config()``: f32, the
    bf16 DCN kernels forward and backward): utils/synthetic.overfit for
    ``steps`` steps on the synthetic scene at ``size`` (BN calibration,
    norm caps, FPN gain fix, two optimizer groups; its probe fires once),
    with its launch counts, ms a step and peak memory (the best state's
    copy included); then eval/hooks.run_val_eval with the trained model on
    a 2-frame video of the same scene at ``eval_size`` written to disk, on
    the fused postprocess: its launch counts, kept things a frame, wall
    time and VPQ summary (``g_cap`` GT slots: fixed matching needs as many
    slots).  Returns the phase's stats."""
    from slotvps_tpu_torch.eval.hooks import run_val_eval
    from slotvps_tpu_torch.utils.synthetic import (make_scene, overfit,
                                                   scene_train_batch)

    cfg = cfg or train_config()
    batch = scene_train_batch(make_scene(*size, n_things=12, seed=0),
                              g_cap=g_cap).to(dev)
    _reset_peak(dev)
    reset_counts()
    t0 = time.perf_counter()
    model = overfit(cfg.model, batch, steps=steps, seed=0, device=dev,
                    log_every=10)
    _sync(dev)
    wall = time.perf_counter() - t0
    train_launches, peak = launch_counts(), _peak_gib(dev)
    # a train step's forward and backward (12 DCN shapes each) and the
    # probe's one forward
    want = dict.fromkeys(KERNELS, 0)
    if dev.type == "cuda":
        want.update(deform_conv2d_hopper_bf16_f32=12 * (steps + 1),
                    dcn_backward_hopper_bf16=12 * steps)
    if train_launches != want:
        raise AssertionError(f"train_eval: overfit launched "
                             f"{train_launches}, want {want}")
    frames = _scene_clip(*eval_size, 2)
    ann, img_dir, truth_dir, gt_json = write_cli_dataset(root / "val",
                                                         [frames])
    kept = []
    reset_counts()
    t0 = time.perf_counter()
    with _kept_things(kept):
        summary = run_val_eval(model, eval_config(cfg), str(ann),
                               str(img_dir), str(truth_dir), str(gt_json),
                               output_dir=str(root / "val" / "out"),
                               max_videos=1)
    _sync(dev)
    eval_wall = time.perf_counter() - t0
    eval_launches = launch_counts()
    vpq = {k: summary[k] for k in ("vpq_all", "vpq_thing", "vpq_stuff")}
    stats = dict(path="train_eval", steps=steps,
                 overfit_s=wall, ms_per_overfit_step=wall * 1e3 / steps,
                 peak_mem_gib=peak, probe=model.probe,
                 launches={k: v for k, v in train_launches.items() if v},
                 eval_wall_s=eval_wall,
                 eval_launches={k: v for k, v in eval_launches.items()
                                if v},
                 n_kept_things=kept, vpq=vpq)
    log("train_eval", json.dumps(stats))
    if dev.type == "cuda" and not (
            eval_launches["deform_conv2d_hopper_bf16_f32"] == 24
            and all(eval_launches[k] > 0 for k in (
                "theta_hopper", "claim_hopper", "argmax_hopper"))
            and eval_launches["dcn_backward_hopper_bf16"] == 0):
        raise AssertionError(f"train_eval: the hook launched "
                             f"{eval_launches}")
    if not ((root / "val" / "out" / "vpq-final.txt").exists()
            and len(kept) == 2
            and all(np.isfinite(v) for v in vpq.values())):
        raise AssertionError("train_eval: the hook gave no VPQ summary of "
                             "2 frames")
    del model
    return stats


def phase_swin_train(dev, card, cfg=None, steps=SWIN_TRAIN_STEPS,
                     size=(TRAIN_H, TRAIN_W), overfit_steps=SWIN_OVERFIT_STEPS,
                     overfit_size=SWIN_OVERFIT_SIZE):
    """swinl_fpn_slotvps trained at full width (Swin-L: embed 192, depths
    (2, 2, 18, 2), heads (6, 12, 24, 48), window 7) in the training
    configuration (f32, the bf16 DCN kernels forward and backward): seeded
    weights (:func:`train_model`), ``steps`` train_steps on the synthetic
    scene at ``size`` (batch 1, GT_CAPACITY GT slots) with their launch
    counts (exactly the train route's 12 forward and 12 backward DCN
    launches a step), ms a step, peak memory, finite losses and gradients,
    and the DCN kernels' device ms in one more step under the profiler;
    then utils/synthetic.overfit with Swin-L (no BN calibration: the
    backbone has no BatchNorm) for ``overfit_steps`` steps at
    ``overfit_size``: finite losses, its launches, each train step's ms
    and the whole call's wall (the model's init included).  Returns the
    phase's stats."""
    from torch.profiler import ProfilerActivity, profile

    from slotvps_tpu_torch.training import step as tstep
    from slotvps_tpu_torch.utils.profiler import (count_params,
                                                  params_to_string)
    from slotvps_tpu_torch.utils.synthetic import (make_scene, overfit,
                                                   scene_train_batch)

    cfg = cfg or train_config("swinl_fpn_slotvps")
    model = train_model(cfg, dev)
    batch = scene_train_batch(make_scene(*size, n_things=12, seed=0),
                              g_cap=GT_CAPACITY).to(dev)
    opt = tstep.make_optimizer(model)
    log("swin_train", f"swinl_fpn_slotvps f32, dcn_impl 'pallas' (bf16), "
                      f"{size[0]}x{size[1]}, batch 1, {GT_CAPACITY} GT "
                      f"slots; Model Params : "
                      f"{params_to_string(count_params(model))}; {card}")

    def dcn_want(n):
        want = dict.fromkeys(KERNELS, 0)
        if dev.type == "cuda":
            want.update(deform_conv2d_hopper_bf16_f32=12 * n,
                        dcn_backward_hopper_bf16=12 * n)
        return want

    _reset_peak(dev)
    reset_counts()
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        metrics = tstep.train_step(model, opt, batch, cfg.model)
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        m = {k: float(v) for k, v in metrics.items()}
        finite = _finite([p.grad for p in model.parameters()
                          if p.grad is not None])
        log("swin_train", f"step {i}: {times[-1]:.1f} ms, grads finite "
                          f"{finite}, " + json.dumps(m))
        if not (finite and all(np.isfinite(v) for v in m.values())):
            raise AssertionError(f"swin_train step {i}: non-finite loss "
                                 "or gradient")
    launches, peak = launch_counts(), _peak_gib(dev)
    if launches != dcn_want(steps):
        raise AssertionError(f"swin_train: launches {launches} in {steps} "
                             f"steps, want {dcn_want(steps)}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _sync(dev)
        t0 = time.perf_counter()
        tstep.train_step(model, opt, batch, cfg.model)
        _sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
    by_name = _device_time_by_kernel(prof)
    busy = sum(ms for ms, _ in by_name.values())
    dcn_ms = {}
    for name, (ms, _) in by_name.items():
        hit = re.search(r"dcn_\w+_kernel", name)
        if hit:
            dcn_ms[hit.group(0)] = dcn_ms.get(hit.group(0), 0.0) + ms
    del model, opt, batch
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    small = scene_train_batch(make_scene(*overfit_size, n_things=12,
                                         seed=0), g_cap=GT_CAPACITY)
    losses, step_ms, real_step = [], [], tstep.train_step

    def recording_step(*args, **kwargs):
        _sync(dev)
        t0 = time.perf_counter()
        out = real_step(*args, **kwargs)
        losses.append(float(out["loss_total"]))
        _sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    tstep.train_step = recording_step
    try:
        _reset_peak(dev)
        reset_counts()
        t0 = time.perf_counter()
        overfit(cfg.model, small, steps=overfit_steps, seed=0, device=dev)
        _sync(dev)
        of_wall = time.perf_counter() - t0
    finally:
        tstep.train_step = real_step
    of_launches, of_peak = launch_counts(), _peak_gib(dev)
    if not (len(losses) == overfit_steps
            and all(np.isfinite(v) for v in losses)):
        raise AssertionError(f"swin_train: overfit losses {losses}")
    if of_launches != dcn_want(overfit_steps):
        raise AssertionError(f"swin_train: overfit launched {of_launches}, "
                             f"want {dcn_want(overfit_steps)}")
    stats = dict(path="swin_train", card=card, steps=steps,
                 step_ms=times,
                 steady_ms_per_step=statistics.median(times[1:] or times),
                 peak_mem_gib=peak, launches=_nonzero(launches),
                 profiler_device_ms=busy, profiler_wall_ms=wall,
                 busy_share=busy / wall if wall else 0.0,
                 dcn_device_ms=dcn_ms,
                 dcn_device_ms_total=sum(dcn_ms.values()),
                 overfit=dict(size=list(overfit_size), steps=overfit_steps,
                              loss_total=losses, step_ms=step_ms,
                              steady_ms_per_step=statistics.median(
                                  step_ms[1:] or step_ms),
                              wall_s=of_wall,
                              peak_mem_gib=of_peak,
                              launches=_nonzero(of_launches)))
    log("swin_train", json.dumps(stats))
    return stats


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _max_diff(a, b):
    return max(float((a[k].double() - b[k].double()).abs().max())
               for k in a)


def phase_ddp(dev, init_state, batch, cfg=None, steps=DDP_STEPS):
    """The data-parallel train step (``train_step`` with a process group:
    the semantic count and the gradients all-reduced in buckets, the
    metrics averaged) in a world of one process (``init_distributed`` on
    localhost, NCCL on the card), against the plain step from the same
    state and batch (``init_state``, ``batch``: the train phase's, R50 at
    800x1600): the loss terms, the all-reduced (and clipped) gradients and
    the parameters after the update (the DDP_* rule), launches equal; a
    second plain step gives what the card's own reductions move, printed
    with a flag per quantity for bit equality.  Then ``steps`` steps of
    each, in turns, for their ms.  The group is destroyed after."""
    import torch.distributed as dist

    from slotvps_tpu_torch.parallel.env import init_distributed
    from slotvps_tpu_torch.training.step import make_optimizer, train_step

    cfg = cfg or train_config()
    model = train_model(cfg, dev)
    init_distributed(f"tcp://localhost:{_free_port()}", num_processes=1,
                     process_id=0, device=dev.type)
    try:
        world = dist.group.WORLD

        def one(group):
            model.load_state_dict(init_state)
            opt = make_optimizer(model, lr=DDP_LR)
            reset_counts()
            m = train_step(model, opt, batch, cfg.model, group=group)
            _sync(dev)
            return (m, _grads(model),
                    {n: p.detach().clone()
                     for n, p in model.named_parameters()}, launch_counts())

        plain, plain2, ddp = one(None), one(None), one(world)
        diffs = {}
        for name, (a, b) in (("plain_vs_plain", (plain, plain2)),
                             ("ddp_vs_plain", (ddp, plain))):
            diffs[name] = dict(
                metrics_max_abs=_max_diff(a[0], b[0]),
                grads_max_abs=_max_diff(a[1], b[1]),
                params_max_abs=_max_diff(a[2], b[2]),
                bit_equal={q: all(torch.equal(x[k], y[k]) for k in x)
                           for q, x, y in (("metrics", a[0], b[0]),
                                           ("grads", a[1], b[1]),
                                           ("params", a[2], b[2]))})
        m_ddp, g_ddp, p_ddp, l_ddp = ddp
        m_ref, g_ref, p_ref, l_ref = plain
        if l_ddp != l_ref or set(g_ddp) != set(g_ref):
            raise AssertionError(f"ddp: launches {_nonzero(l_ddp)} / "
                                 f"{_nonzero(l_ref)} or gradient sets "
                                 "differ")
        for k, v in m_ref.items():
            if not abs(float(m_ddp[k]) - float(v)) <= \
                    DDP_LOSS_RTOL * abs(float(v)):
                raise AssertionError(f"ddp: {k} {float(m_ddp[k])} vs "
                                     f"{float(v)}")
        floor = TRAIN_GRAD_FLOOR * max(float(g.abs().max())
                                       for g in g_ref.values())
        for k, g in g_ref.items():
            err = float((g_ddp[k] - g).abs().max())
            if not err <= DDP_GRAD_RTOL * max(float(g.abs().max()), floor):
                raise AssertionError(f"ddp: gradient {k} off by {err}")
        for k, p in p_ref.items():
            err = float((p_ddp[k] - p).abs().max())
            if not err <= 2 * DDP_LR:
                raise AssertionError(f"ddp: parameter {k} off by {err}")
        # the cost of the group: steps of each in turns, one optimizer
        model.load_state_dict(init_state)
        opt = make_optimizer(model, lr=DDP_LR)
        ms = {"plain": [], "ddp": []}
        for i in range(2 * steps):
            kind = ("plain", "ddp", "ddp", "plain")[i % 4]
            _sync(dev)
            t0 = time.perf_counter()
            train_step(model, opt, batch, cfg.model,
                       group=world if kind == "ddp" else None)
            _sync(dev)
            ms[kind].append((time.perf_counter() - t0) * 1e3)
    finally:
        dist.destroy_process_group()
    stats = dict(path="ddp", world_size=1,
                 backend="nccl" if dev.type == "cuda" else "gloo",
                 launches=_nonzero(l_ddp), step_ms=ms,
                 median_ms={k: statistics.median(v) for k, v in ms.items()},
                 **diffs)
    log("ddp", json.dumps(stats))
    del model
    return stats


def phase_multi(dev, card, model, cfg, cfg32, videos, streams,
                one_card_ms=None):
    """BatchedVideoPipeline at B = 2 over every visible card, a replica of
    the model and one video each; with one card over [cuda:0, cuda:0] (two
    replicas on one card, each on its own stream).  In the bf16 --tuned
    stack (``cfg``: ``videos``, their streaming results ``streams``) and
    in f32 (``cfg32``, the videos' first 2 frames): each video equal to its
    streaming run bit for bit; launches per replica, i.e. the decoder's
    slot-attention launches twice one video's (expected_launches with a
    decoder call a replica and step); ms per lockstep step of a second run
    beside the one-card batched step (``one_card_ms``).  Returns the
    stats."""
    from slotvps_tpu_torch.inference import BatchedVideoPipeline

    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n_cards >= 2:
        devices = [torch.device("cuda", i) for i in range(n_cards)]
    else:
        devices = [dev, dev]
        log("multi", f"{n_cards} card visible: the cross-card path (a "
                     "replica a card) was not run; two replicas on "
                     f"{dev}")
    size = videos[0][0].shape[1:3]
    out = dict(cards=n_cards, card=card, one_card_ms_per_step=one_card_ms)
    for label, c, vids, refs in (
            ("bf16", cfg, videos, streams),
            ("f32", cfg32, [v[:2] for v in videos], None)):
        if refs is None:
            refs = [phase_slice_results(model, c, v) for v in vids]
        t_len = len(vids[0])
        pipe = BatchedVideoPipeline(model, c, len(vids), image_size=size,
                                    devices=devices)
        res, launches, wall, peak = _run_counted(
            dev, lambda: pipe.run_videos(vids))
        _check_launches(f"multi_{label}", launches, expected_launches(
            c, [r for v in res for r in v], steps=t_len * pipe.n_devices))
        for v, (got, ref) in enumerate(zip(res, refs)):
            for t, (a, b) in enumerate(zip(ref, got)):
                diff = _same_results(a, b)
                if diff:
                    raise AssertionError(
                        f"multi {label} video {v} frame {t} differs from "
                        f"streaming in {diff}")
        _, _, wall2, _ = _run_counted(dev, lambda: pipe.run_videos(vids))
        out[label] = dict(n_devices=pipe.n_devices,
                          devices=[str(d) for d in devices[:pipe.n_devices]],
                          launches=_nonzero(launches), first_run_s=wall,
                          ms_per_step=wall2 / t_len * 1e3,
                          frames_per_s=len(vids) * t_len / wall2,
                          peak_mem_gib=peak)
        log("multi", f"[{label}] n_devices {pipe.n_devices}: == streaming "
                     "bit for bit; " + json.dumps(out[label]))
    return out


def write_train_dataset(root, frames):
    """``frames`` (uint8 BGR [1, h, w, 3]) as a one-video training set on
    disk for cli/train.py: the images and an annotation json with one car
    (a box polygon) a frame, as tests/test_training.py writes its own."""
    import cv2

    root.mkdir(parents=True)
    h, w = frames[0].shape[1:3]
    images, anns = [], []
    for fid, img in enumerate(frames, start=1):
        name = f"v1_f{fid}_newImg8bit.png"
        cv2.imwrite(str(root / name), img[0])
        images.append({"id": 10000 + fid, "file_name": name, "height": h,
                       "width": w})
        x1, y1, x2, y2 = w // 4, h // 3, w // 2, 2 * h // 3
        anns.append({"id": fid, "image_id": 10000 + fid, "category_id": 2,
                     "bbox": [x1, y1, x2 - x1, y2 - y1],
                     "area": float((x2 - x1) * (y2 - y1)),
                     "segmentation": [[x1, y1, x2, y1, x2, y2, x1, y2]],
                     "inst_id": 1})
    ann = root / "ann.json"
    ann.write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": 1, "name": "person"},
                       {"id": 2, "name": "car"}]}))
    return ann


def phase_train_cli(dev, root, config=None, size=(256, 512),
                    crop=(TRAIN_H, TRAIN_W), gt_capacity=GT_CAPACITY):
    """cli/train.py's main as a user runs it with the eval hook:
    ``--dcn_impl pallas --eval_every 1`` for one epoch of one step on a
    one-frame training set and a 2-frame val set (``size`` images, which
    the data pipeline rescales to 1024x2048), ``crop`` crops; it must save
    the epoch's state and the hook write pred.json and vpq-final.txt.
    ``config`` (a Config) replaces the named one (CPU rehearsals)."""
    import contextlib
    import io

    from slotvps_tpu_torch.cli import train as cli

    frames = _scene_clip(*size, 2)
    ann = write_train_dataset(root / "train", frames[:1])
    v_ann, v_img, v_truth, v_gt = write_cli_dataset(root / "tval", [frames])
    work = root / "work"
    named = cli.named_config
    if config is not None:
        cli.named_config = lambda name: config
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            cli.main([
                "--ann_file", str(ann), "--img_prefix", str(root / "train"),
                "--work_dir", str(work), "--total_epochs", "1",
                "--repeat_times", "1", "--crop", *map(str, crop),
                "--gt_capacity", str(gt_capacity), "--log_interval", "1",
                "--data_workers", "1",
                "--device", str(dev), "--dcn_impl", "pallas",
                "--eval_every", "1", "--val_ann_file", str(v_ann),
                "--val_img_prefix", str(v_img), "--val_truth_dir",
                str(v_truth), "--val_pan_gt_json_file", str(v_gt),
                "--val_max_videos", "1"])
    finally:
        cli.named_config = named
    wall = time.perf_counter() - t0
    launches = launch_counts()
    text = buf.getvalue()
    lines = [x for x in text.splitlines()
             if x.startswith(("epoch ", "[eval]"))]
    fired = {k: v for k, v in launches.items() if v}
    log("train_cli", f"main(--eval_every 1, --dcn_impl pallas) for one "
                     f"step: {wall:.1f} s (build, step, save, eval); "
                     f"{lines}; launches {json.dumps(fired)}")
    out = work / "val_epoch_1"
    if not ((work / "epoch_1.pt").exists()
            and (out / "vpq-final.txt").exists()
            and (out / "pred.json").exists()
            and any(x.startswith("[eval]") for x in lines)):
        raise AssertionError("the train CLI did not save its epoch or the "
                             f"hook wrote no VPQ: {text[-2000:]}")
    if dev.type == "cuda" and not (
            launches["dcn_backward_hopper_bf16"] == 12
            and launches["deform_conv2d_hopper_bf16_f32"] == 12 + 24):
        raise AssertionError(f"train_cli: launches {launches}, want 12 "
                             "backward and 12 + 2 x 12 forward")
    return dict(wall_s=wall, log=lines)


def phase_top2_hist(dev, shape=PP_SHAPES[0], n_valid=PP_VALID, timed=True,
                    ragged=PP_RAGGED):
    """argmax with its runner-up map and hist (the postproc_v3 entries only
    tests reach) against their plain versions on the K = 64 case of the
    postprocess kernels and (untimed) the ragged case: bit-identical.
    hist also gets torch.bincount's time, and (untimed) its edge cases
    (HIST_CASES, hold_hist_edges) at 16 h w ids.  Returns {name: row} of
    ``shape``."""
    from slotvps_tpu_torch.ops import postproc_v3 as plain
    from slotvps_tpu_torch.ops.cuda import postproc_v3 as hv3

    if ragged:
        phase_top2_hist(dev, ragged, n_valid, False, None)
        edges = hold_hist_edges(dev, 16 * shape[1] * shape[2])
        log("kernels", f"hist edge cases, each bit-identical to its plain "
                       f"version: {json.dumps(edges)}")
    k, h, w = shape
    m, labels, valid, is_thing, slots, _ = postproc_case(
        dev, k, h, w, seed=k, n_valid=n_valid)
    th = plain.theta(m, valid, 0.4)
    keep, owner = plain.claim(m, th, labels, is_thing, valid, 0.03)
    kept = torch.where(is_thing, keep, valid)
    m1, m2, areas = hv3.argmax_hopper(m, owner, kept, is_thing, top2=True)
    r1, r2, r_areas = plain.argmax(m, owner, kept, is_thing, top2=True)
    hist = hv3.hist_hopper(r1, k)
    r_hist = plain.hist(r1, k)
    _sync(dev)
    errs = {"argmax_hopper_top2": max(int((m1 != r1).sum()),
                                      int((m2 != r2).sum()),
                                      int((areas != r_areas).sum())),
            "hist_hopper": int((hist != r_hist).sum())}
    if any(errs.values()) or not (r1 != r2).any():
        raise AssertionError(f"top2 / hist kernels disagree with their "
                             f"plain versions: {errs}")
    full = 16 * h * w
    n_kept = int(kept.sum())
    am_bytes, am_ops = _pp_bounds(k, h, w, int(valid.sum()),
                                  slots[1] - slots[0], n_kept,
                                  int((kept & is_thing).sum()), 0.0,
                                  r_areas.shape[0],
                                  _owned_px(owner, kept, is_thing))[
                                      "argmax_hopper"]
    # the runner-up: one more compare and select per kept slot and pixel,
    # and its map written once; hist: the id map read once, K counts
    bounds = {"argmax_hopper_top2": (am_bytes + 4 * full,
                                     am_ops + 3 * n_kept * full),
              "hist_hopper": (4 * full + 4 * k, 2 * full)}
    calls = {"argmax_hopper_top2": (
        lambda: hv3.argmax_hopper(m, owner, kept, is_thing, top2=True),
        lambda: plain.argmax(m, owner, kept, is_thing, top2=True), None),
        "hist_hopper": (lambda: hv3.hist_hopper(r1, k),
                        lambda: plain.hist(r1, k),
                        lambda: torch.bincount(r1.flatten(), minlength=k))}
    rows = {}
    for name, (kern, ref, lib) in calls.items():
        b_ms, b_by = bound(*bounds[name])
        row = dict(kernel=name, K=k, shape=[k, h, w],
                   max_abs_err=errs[name], bound_ms=b_ms, bound_by=b_by)
        if timed:
            row["ms"] = _cuda_ms(kern)
            row["alone_ms"] = _alone_ms(kern)
            row["plain_ms"] = _cuda_ms(ref, n=5, warmup=1)
            row["library_ms"] = _cuda_ms(lib) if lib else None
        log("kernels", json.dumps(row))
        rows[name] = row
    return rows


def _blobs(g, dev, n, h, w):
    """[n, h, w] f32 smooth seeded noise (blobs of a few cells of 16x16)."""
    import torch.nn.functional as F

    coarse = torch.randn((n, 1, max(h // 16, 2), max(w // 16, 2)),
                         generator=g, device=dev)
    return F.interpolate(coarse, size=(h, w), mode="bilinear",
                         align_corners=False)[:, 0]


def _claim_vectors(dev, k, stuff=(), invalid=()):
    """labels (things of three classes 11-13, ``stuff`` class 4), is_thing
    and valid of ``k`` slots."""
    labels = 11 + torch.arange(k, device=dev) % 3
    labels[list(stuff)] = 4
    valid = torch.ones(k, dtype=torch.bool, device=dev)
    valid[list(invalid)] = False
    return labels, labels > 10, valid


def claim_cases(dev, big=True):
    """Seeded edge cases of the claim loops, as (label, kind, args, slots,
    rejected): kind "planes" takes the claim scan (args: planes [B, K, H,
    W] bool and [B, K] labels, is_thing, valid), "masks" the theta claim
    (args: low-res masks [K, h, w] f32 and [K] vectors; theta = the plain
    theta at 0.4); ``slots`` is a range holding every valid thing;
    ``rejected`` the slots the rule must reject.  More than 32 valid
    things (40 of 48 slots; 100 of 127) with an all-0 thing (slot 3), an
    all-1 thing (slot 5, planes only: in the theta form it leaves every
    other slot without a pixel, so "theta_all1" has it alone) and a copy
    of a thing of its class (slot 9 of 8); B = 2 with 40 and 9 valid
    things.  With ``big``, batches past the shared-memory geometry: B = 8
    at 1024x2048 (the owner tile in device memory), B = 4 at 2048x4096
    (the bit words too), B = 300 of K = 127 (the videos in groups), masks
    of 768x1536 and 1024x2048 low-res."""
    g = torch.Generator(device=dev).manual_seed(5)
    cases = []

    def planes_of(b, k, h, w):
        return (_blobs(g, dev, b * k, h, w) > 0.9).reshape(b, k, h, w)

    def edges(x, lab):
        if x.is_floating_point():             # masks [K, h, w]
            x[3] = -30.0
            x[9] = x[8] + 0.01
        else:                                 # planes [B, K, H, W]
            x[:, 3] = False
            x[:, 5] = True
            x[:, 9] = x[:, 8]
        lab[9] = lab[8]

    planes = planes_of(2, 48, 96, 160)
    lab, thing, val = _claim_vectors(dev, 48, stuff=range(40, 48))
    edges(planes, lab)
    cases.append(("things40", "planes",
                  (planes[:1], lab[None], thing[None], val[None]), (0, 40),
                  [3, 5, 9]))
    val1 = torch.zeros_like(val)
    val1[2:11] = True
    cases.append(("b2_40_and_9", "planes",
                  (planes, lab.expand(2, -1), thing.expand(2, -1),
                   torch.stack([val, val1])), (0, 40), [3, 5, 9]))
    planes = planes_of(1, 127, 64, 96)
    lab, thing, val = _claim_vectors(dev, 127, stuff=range(3),
                                     invalid=range(103, 127))
    edges(planes, lab)
    cases.append(("k127", "planes",
                  (planes, lab[None], thing[None], val[None]), (3, 103),
                  [3, 5, 9]))
    m = _blobs(g, dev, 48, 24, 40) * 4
    lab, thing, val = _claim_vectors(dev, 48, stuff=range(40, 48))
    edges(m, lab)
    cases.append(("theta_things40", "masks", (m, lab, thing, val), (0, 40),
                  [3, 9]))
    m = _blobs(g, dev, 127, 16, 24) * 4
    lab, thing, val = _claim_vectors(dev, 127, stuff=range(3),
                                     invalid=range(103, 127))
    edges(m, lab)
    cases.append(("theta_k127", "masks", (m, lab, thing, val), (3, 103),
                  [3, 9]))
    m = _blobs(g, dev, 8, 16, 24) * 4
    m[5] = 50.0
    lab, thing, val = _claim_vectors(dev, 8, stuff=range(4))
    cases.append(("theta_all1", "masks", (m, lab, thing, val), (4, 8),
                  [4, 5, 6, 7]))
    if big:
        for label, b, k, h, w in (("b8_1024x2048", 8, 3, 1024, 2048),
                                  ("b4_2048x4096", 4, 2, 2048, 4096)):
            lab, thing, val = _claim_vectors(dev, k)
            lab[:] = 11
            cases.append((label, "planes",
                          (planes_of(b, k, h, w), lab.expand(b, -1),
                           thing.expand(b, -1), val.expand(b, -1)), (0, k),
                          []))
        # 300 videos of 127 slots, a few valid things each, other ranges
        b, k = 300, 127
        lab, thing, val = _claim_vectors(dev, k)
        val = torch.rand((b, k), generator=g, device=dev) < 0.05
        val[:, 0] = True
        cases.append(("b300_k127", "planes",
                      (planes_of(b, k, 16, 24), lab.expand(b, -1),
                       thing.expand(b, -1), val), (0, k), []))
        for label, k, h, w in (("theta_768x1536", 3, 768, 1536),
                               ("theta_1024x2048", 2, 1024, 2048)):
            lab, thing, val = _claim_vectors(dev, k)
            lab[:] = 11
            cases.append((label, "masks",
                          (_blobs(g, dev, k, h, w) * 4, lab, thing, val),
                          (0, k), []))
    return cases


def phase_claim_edges(dev, big=True):
    """The claim kernels on claim_cases: the claim scan on the planes and
    on their K-minor copy, the theta claim on slot-major masks and the
    K-minor entry on [h, w, K] masks, each against its plain version (keep
    and owner bit-identical), twice (the same both times), one launch a
    call; the rule rejects each case's ``rejected`` slots and keeps some
    other thing.  Returns one row a case."""
    from slotvps_tpu_torch.ops import postproc_v3 as plain
    from slotvps_tpu_torch.ops.claim_scan import claim_scan
    from slotvps_tpu_torch.ops.cuda import claim_scan as cs
    from slotvps_tpu_torch.ops.cuda import postproc_fused as pfu
    from slotvps_tpu_torch.ops.cuda import postproc_v3 as pv3

    frac = 0.03
    sms = cs.card_sms(dev) if dev.type == "cuda" else 132
    rows = []
    for label, kind, args, slots, rejected in claim_cases(dev, big):
        if kind == "planes":
            planes, lab, thing, val = args
            b, k, h, w = planes.shape
            geo = cs.claim_geometry(b, h, w, k, sms)
            ref = claim_scan(planes, lab, thing, val, frac)
            hwk = planes.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
            calls = [(cs.claim_scan_hopper, (planes, lab, thing, val, frac),
                      dict(slots=slots)),
                     (cs.claim_scan_hopper, (hwk, lab, thing, val, frac),
                      dict(slots=slots))]
        else:
            m, lab, thing, val = args
            k, h, w = m.shape
            geo = cs.claim_geometry(1, 4 * h, 4 * w, k, sms,
                                    stage=pv3.CLAIM_STAGE)
            th = plain.theta(m, val, 0.4)
            ref = plain.claim(m, th, lab, thing, val, frac)
            calls = [(pv3.claim_hopper, (m, th, lab, thing, val, frac),
                      dict(slots=slots)),
                     (pfu.claim_scan_fused_hopper,
                      (m.permute(1, 2, 0).contiguous(), th, lab, thing, val,
                       frac), {})]
        for fn, a, kw in calls:
            before = fn.launches
            first, second = fn(*a, **kw), fn(*a, **kw)
            _sync(dev)
            same = [torch.equal(x, y) for x, y in zip(first, ref)] \
                + [torch.equal(x, y) for x, y in zip(second, first)]
            if not all(same) or (dev.type == "cuda"
                                 and fn.launches != before + 2):
                raise AssertionError(
                    f"{fn.__name__} on claim case {label} (strides "
                    f"{tuple(a[0].stride())}): keep and owner equal to the "
                    f"plain version's and the first run's: {same}; "
                    f"{fn.launches - before} launches for 2 calls")
        keep = ref[0].reshape(-1, k)
        things = (val & thing).reshape(-1, k)
        row = dict(claim_case=label, kind=kind, shape=list(args[0].shape),
                   plan=geo._asdict(), things=things.sum(1).tolist(),
                   kept=(keep & things).sum(1).tolist())
        log("kernels", json.dumps(row))
        others = things.clone()
        others[:, rejected] = False
        if bool(keep[:, rejected].any()) \
                or bool(others.any()) != bool((keep & others).any()):
            raise AssertionError(f"claim case {label} lost its regime: "
                                 f"{row}")
        rows.append(row)
    return rows


def _fused_inputs(dev, model, cfg, frame):
    """The two inputs of the K-minor chain, each (label, m_hwk [h, w, K]
    f32, valid, labels, is_thing): FUSED_SHAPE's random-normal masks (every
    slot valid, labels 0..18, things > 10) and one real frame's low-res
    mask logits of ``cfg``'s path with its own valid, label and thing
    vectors, in the postprocess's slot order (stuff, things, invalid)."""
    from slotvps_tpu_torch.models.postprocess import _slot_order

    h, w, k = FUSED_SHAPE
    g = torch.Generator(device=dev).manual_seed(11)
    labels = torch.randint(0, 19, (k,), generator=g, device=dev)
    prof = ("random", torch.randn((h, w, k), generator=g, device=dev),
            torch.ones(k, dtype=torch.bool, device=dev), labels, labels > 10)
    pcfg = cfg.model.postprocess
    outs = _decoder_outputs(model, cfg, [frame], dev)[0]
    probs = torch.softmax(outs.pred_logits[0], dim=-1)
    scores, classes = probs.amax(dim=-1), probs.argmax(dim=-1)
    perm, valid = _slot_order(scores, classes, pcfg)
    classes = classes[perm]
    masks = outs.pred_masks[0][perm].float()
    real = ("frame", masks.permute(1, 2, 0).contiguous(), valid[perm],
            classes, classes > pcfg.num_stuff - 1)
    return prof, real


def _fused_chain(m, valid, labels, is_thing, thr, frac):
    """theta -> claim -> argmax-areas through the K-minor kernels' wrappers:
    (theta, keep, owner, m_id, areas)."""
    from slotvps_tpu_torch.ops.cuda import postproc_fused as pfu

    th = pfu.theta_fused_hopper(m, valid, thr)
    keep, owner = pfu.claim_scan_fused_hopper(m, th, labels, is_thing, valid,
                                              frac)
    kept = torch.where(is_thing, keep, valid)
    m_id, areas = pfu.argmax_areas_hopper(m, owner, kept, is_thing)
    return th, keep, owner, m_id, areas


def phase_fused_chain(dev, model, cfg, frame, timed=True):
    """The counterparts of postproc_fused.py's three TPU kernels (theta,
    claim, argmax-areas on K-minor [h, w, K] masks) as a chain on two
    inputs (:func:`_fused_inputs`): the chain's launch counts (set to 0
    just before, read just after); each kernel against its plain version on
    the same inputs (theta within THETA_RTOL * max(1, |theta|), integer
    outputs bit-identical); on the real frame, the chain against the v3
    chain on the same masks slot-major (theta_hopper, claim_hopper,
    argmax_hopper): theta within THETA_RTOL, and, given the same theta,
    keep, owner, m_id and areas bit-identical.  Kernel and plain ms of
    both inputs; the kernels line takes the random input's.  Returns
    ({kernel: row}, stats)."""
    from slotvps_tpu_torch.ops import postproc_fused as plain
    from slotvps_tpu_torch.ops.cuda import postproc_fused as pfu
    from slotvps_tpu_torch.ops.cuda import postproc_v3 as hv3

    pcfg = cfg.model.postprocess
    thr, frac = pcfg.pixel_threshold, pcfg.fraction_threshold
    inputs = _fused_inputs(dev, model, cfg, frame)
    chains, launches, _, _ = _run_counted(dev, lambda: [
        _fused_chain(*case[1:], thr, frac) for case in inputs])
    want = dict.fromkeys(KERNELS, 0)
    want.update(theta_fused_hopper=2, claim_scan_fused_hopper=2,
                argmax_areas_hopper=2)
    _check_launches("fused_chain", launches, want)
    rows = {}
    for (label, m, valid, labels, is_thing), chain in zip(inputs, chains):
        th, keep, owner, m_id, areas = chain
        h, w, k = m.shape
        th_ref = plain.theta_fused(m, valid, thr)
        keep_k, owner_k = pfu.claim_scan_fused_hopper(m, th_ref, labels,
                                                      is_thing, valid, frac)
        keep_r, owner_r = plain.claim_scan_fused(m, th_ref, labels, is_thing,
                                                 valid, frac)
        kept_r = torch.where(is_thing, keep_r, valid)
        m_id_k, areas_k = pfu.argmax_areas_hopper(m, owner_r, kept_r,
                                                  is_thing)
        m_id_r, areas_r = plain.argmax_areas(m, owner_r, kept_r, is_thing)
        _sync(dev)
        theta_rel = float(((th - th_ref).abs()
                           / th_ref.abs().clamp_min(1.0)).max())
        errs = {"theta_fused_hopper": float((th - th_ref).abs().max()),
                "claim_scan_fused_hopper": int((keep_k != keep_r).sum())
                + int((owner_k != owner_r).sum()),
                "argmax_areas_hopper": int((m_id_k != m_id_r).sum())
                + int((areas_k != areas_r).sum())}
        n_valid = int(valid.sum())
        n_things = int((valid & is_thing).sum())
        n_kept_things = int((keep_r & valid & is_thing).sum())
        regime = dict(input=label, shape=[h, w, k], valid=n_valid,
                      things=n_things, kept_things=n_kept_things,
                      owned_share=float((owner_r >= 0).float().mean()),
                      segments=len(torch.unique(m_id_r)),
                      theta_rel_err=theta_rel)
        log("fused", json.dumps(regime))
        if theta_rel > THETA_RTOL or errs["claim_scan_fused_hopper"] \
                or errs["argmax_areas_hopper"]:
            raise AssertionError(f"K-minor postprocess kernels disagree "
                                 f"with their plain versions on the "
                                 f"{label} input: theta rel {theta_rel:.3e}, "
                                 f"mismatches {errs}")
        if label == "frame":
            # the v3 chain on the same masks, slot-major, given the fused
            # chain's theta
            m_khw = m.permute(2, 0, 1).contiguous()
            th3 = hv3.theta_hopper(m_khw, valid, thr)
            keep3, owner3 = hv3.claim_hopper(m_khw, th, labels, is_thing,
                                             valid, frac)
            kept3 = torch.where(is_thing, keep3, valid)
            m_id3, areas_t = hv3.argmax_hopper(m_khw, owner3, kept3,
                                               is_thing)
            _sync(dev)
            v3_rel = float(((th - th3).abs() / th3.abs().clamp_min(1.0))
                           .max())
            same = dict(keep=torch.equal(keep, keep3),
                        owner=torch.equal(owner, owner3),
                        m_id=torch.equal(m_id, m_id3),
                        areas=torch.equal(areas, areas_t.sum(0, dtype=
                                                             torch.int32)))
            log("fused", f"[frame] against the v3 chain: theta rel "
                         f"{v3_rel:.3e} (bit-equal {torch.equal(th, th3)}), "
                         f"given the same theta equal: {json.dumps(same)}")
            if v3_rel > THETA_RTOL or not all(same.values()):
                raise AssertionError(f"the K-minor chain differs from the "
                                     f"v3 chain on the real frame: theta "
                                     f"rel {v3_rel:.3e}, equal {same}")
            if not n_kept_things:
                raise AssertionError(f"the real frame lost its regime: "
                                     f"{regime}")
        n_kept = int(kept_r.sum())
        bounds = _pp_bounds(k, h, w, n_valid, n_things, n_kept,
                            n_kept_things, 0.0, 1,
                            _owned_px(owner_r, kept_r, is_thing))
        bounds = {"theta_fused_hopper": bounds["theta_hopper"],
                  "claim_scan_fused_hopper": bounds["claim_hopper"],
                  "argmax_areas_hopper": bounds["argmax_hopper"]}
        calls = {
            "theta_fused_hopper": (
                lambda: pfu.theta_fused_hopper(m, valid, thr),
                lambda: plain.theta_fused(m, valid, thr)),
            "claim_scan_fused_hopper": (
                lambda: pfu.claim_scan_fused_hopper(m, th_ref, labels,
                                                    is_thing, valid, frac),
                lambda: plain.claim_scan_fused(m, th_ref, labels, is_thing,
                                               valid, frac)),
            "argmax_areas_hopper": (
                lambda: pfu.argmax_areas_hopper(m, owner_r, kept_r,
                                                is_thing),
                lambda: plain.argmax_areas(m, owner_r, kept_r, is_thing)),
        }
        for name, (kern, ref) in calls.items():
            b_ms, b_by = bound(*bounds[name])
            row = dict(kernel=name, input=label, K=k,
                       max_abs_err=errs[name], bound_ms=b_ms, bound_by=b_by)
            if timed:
                row["ms"] = _cuda_ms(kern)
                row["alone_ms"] = _alone_ms(kern)
                row["plain_ms"] = _cuda_ms(ref, n=5, warmup=1)
            log("fused", json.dumps(row))
            if label == "random":
                rows[name] = row
    return rows, dict(path="fused_chain", launches=launches)


def _planes_of(model, cfg, frames, dev):
    """The binarized [K, H, W] planes, slot vectors and slot range that
    the impl="pallas" postprocess hands the claim-scan kernel, for each
    frame decoded against itself: recorded at the call."""
    import slotvps_tpu_torch.models.postprocess as pp

    pcfg = dataclasses.replace(cfg.model.postprocess, impl="pallas")
    seen, real = [], pp.claim_scan_hopper

    def record(logit, labels, is_thing, valid, frac, slots=None):
        seen.append((logit, labels, is_thing, valid, slots))
        return real(logit, labels, is_thing, valid, frac, slots=slots)

    pp.claim_scan_hopper = record
    try:
        for fr in frames:
            _post(_decoder_outputs(model, cfg, [fr], dev)[0], pcfg,
                  fr.shape[1:3])
    finally:
        pp.claim_scan_hopper = real
    return seen


def kminor_floor_bytes(planes, slots):
    """Bytes that any kernel reading K-minor planes (slots adjacent bytes)
    in place must move: the 32-byte sectors holding slots [lo, hi) of each
    pixel, each once, and the owner map written once."""
    planes = planes if planes.ndim == 4 else planes[None]
    b, k, h, w = planes.shape
    lo, hi = slots
    if planes.stride(1) != 1 or hi <= lo:
        return b * h * w
    p = torch.arange(h * w, device=planes.device, dtype=torch.int64)
    total = 0
    for v in range(b):
        start = planes.data_ptr() + v * planes.stride(0) \
            + p * planes.stride(3) + lo
        s0, s1 = start // 32, (start + hi - lo - 1) // 32
        prev = torch.cat([s0.new_tensor([-1]),
                          torch.cummax(s1, 0).values[:-1]])
        total += int((s1 - torch.maximum(s0, prev + 1) + 1).clamp_min(0)
                     .sum())
    return 32 * total + b * h * w


def phase_claim_scan_kernel(dev, model, cfg, frames, timed=True):
    """The claim-scan kernel against its plain version on the binarized
    planes of real frames of ``cfg``'s path (K = 100 slots at 1024x2048),
    in the K-minor [H, W, K] layout the postprocess builds and hands the
    kernel: B = 1 (the first frame) and B = 2 (two different frames), keep
    and owner bit-identical; then the first frame's planes as a contiguous
    [K, H, W] copy, the copy timed apart (the layout the postprocess does
    not take).  Returns the B = 1 row."""
    from slotvps_tpu_torch.ops.claim_scan import claim_scan
    from slotvps_tpu_torch.ops.cuda.claim_scan import claim_scan_hopper

    frac = cfg.model.postprocess.fraction_threshold
    seen = _planes_of(model, cfg, frames, dev)
    (p0, *vec0, s0), (p1, *vec1, s1) = seen
    k, h, w = p0.shape
    cases = {
        "B1": ((p0, *vec0), s0),
        "B2": ((torch.stack([p0.permute(1, 2, 0),
                             p1.permute(1, 2, 0)]).permute(0, 3, 1, 2),
                *(torch.stack(pair) for pair in zip(vec0, vec1))),
               (min(s0[0], s1[0]), max(s0[1], s1[1])))}
    rows = {}
    for label, (args, slots) in cases.items():
        keep, owner = claim_scan_hopper(*args, frac, slots=slots)
        keep_r, owner_r = claim_scan(*args, frac)
        _sync(dev)
        n_diff = int((keep != keep_r).sum()) + int((owner != owner_r).sum())
        b = 1 if label == "B1" else 2
        labels, is_thing, valid = args[1:]
        things = int((valid & is_thing).sum())
        kept_things = int((keep_r & valid & is_thing).sum())
        # each valid thing's plane read once, the owner map and keep
        # written once, the slot vectors read once; per valid thing and
        # pixel a test and a count, per kept thing and pixel a claim
        n_bytes = things * h * w + b * h * w + b * k * 10
        n_ops = 3 * things * h * w + kept_things * h * w
        b_ms, b_by = bound(n_bytes, n_ops)
        row = dict(kernel="claim_scan_hopper", case=label, K=k,
                   size=[h, w], strides=list(args[0].stride()),
                   slots=list(slots), valid_things=things,
                   kept_things=kept_things, max_abs_err=n_diff,
                   bound_ms=b_ms, bound_by=b_by,
                   kminor_floor_ms=kminor_floor_bytes(args[0], slots)
                   / HBM_BYTES * 1e3)
        if n_diff or not kept_things:
            log("kernels", json.dumps(row))
            raise AssertionError(f"claim-scan kernel at {label}: {n_diff} "
                                 "entries differ from the plain version, "
                                 "or the planes lost their regime")
        if timed:
            row["ms"] = _cuda_ms(
                lambda: claim_scan_hopper(*args, frac, slots=slots))
            row["plain_ms"] = _cuda_ms(lambda: claim_scan(*args, frac),
                                       n=3, warmup=1)
        log("kernels", json.dumps(row))
        rows[label] = row
    # the other layout: a contiguous [K, H, W] copy of the planes
    khw = p0.contiguous()
    keep, owner = claim_scan_hopper(khw, *vec0, frac, slots=s0)
    keep_r, owner_r = claim_scan(p0, *vec0, frac)
    _sync(dev)
    if not (torch.equal(keep, keep_r) and torch.equal(owner, owner_r)):
        raise AssertionError("claim-scan kernel on the contiguous planes "
                             "differs from the plain version")
    if timed:
        layout = dict(
            k_minor_ms=rows["B1"]["ms"],
            copy_ms=_cuda_ms(lambda: p0.contiguous()),
            contiguous_ms=_cuda_ms(
                lambda: claim_scan_hopper(khw, *vec0, frac, slots=s0)))
        layout["copy_then_contiguous_ms"] = (layout["copy_ms"]
                                             + layout["contiguous_ms"])
        log("kernels", "claim-scan layout, K-minor read vs contiguous copy "
                       "+ kernel: " + json.dumps(layout))
    return rows["B1"]


def _same_results(a, b):
    """Names of the outputs in which two FrameResults differ."""
    diff = [name for name in ("sseg", "panoptic", "cls_inds", "obj_ids",
                              "cls_prob")
            if not np.array_equal(getattr(a, name), getattr(b, name))]
    return diff


def phase_batched_pallas(dev, model, cfg, videos):
    """BatchedVideoPipeline, B = 2 videos of 2 frames, on ``cfg``'s path
    (f32) with postprocess impl="pallas" (the claim-scan kernel), against
    the same run with impl="jax" (the plain claim loop on the card): the
    floats upstream of the claim are the same, so every output must be
    bit-identical.  Each video against its streaming run: bit-identical
    (the backbone runs one frame at a time; maps, classes, scores and ids).
    Then the postprocess stage of both impls on one frame's decoder
    outputs."""
    from slotvps_tpu_torch.inference import BatchedVideoPipeline

    size = videos[0][0].shape[1:3]
    runs = {}
    for impl in ("pallas", "jax"):
        c = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, postprocess=dataclasses.replace(
                cfg.model.postprocess, impl=impl)))
        pipe = BatchedVideoPipeline(model, c, len(videos), image_size=size)
        res, launches, wall, peak = _run_counted(
            dev, lambda: pipe.run_videos(videos))
        flat = [r for v in res for r in v]
        _check_launches("batched_pallas" if impl == "pallas" else impl,
                        launches,
                        expected_launches(c, flat, steps=len(videos[0])))
        runs[impl] = res
        log("batched", f"[f32, impl={impl}] {len(videos)} videos x "
                       f"{len(videos[0])} frames in {wall:.3f} s, peak "
                       f"{peak:.2f} GiB, claim_scan_hopper launches "
                       f"{launches['claim_scan_hopper']}, claims over "
                       f"{[r.n_claim for r in flat]} valid things, things "
                       f"kept {[len(r.cls_inds) for r in flat]}")
        if impl == "pallas":
            pallas_cfg = c
            stats = dict(path="batched_pallas", launches=launches,
                         wall_s=wall, ms_per_step=wall / len(videos[0]) * 1e3,
                         frames_per_s=len(flat) / wall, peak_mem_gib=peak)
    for v, (a_v, b_v) in enumerate(zip(runs["pallas"], runs["jax"])):
        for t, (a, b) in enumerate(zip(a_v, b_v)):
            diff = _same_results(a, b)
            if diff:
                raise AssertionError(f"batched f32 video {v} frame {t}: "
                                     f"impl='pallas' and impl='jax' differ "
                                     f"in {diff}")
    log("batched", "[f32] impl='pallas' == impl='jax' bit for bit: maps, "
                   "classes, scores and track ids of every frame")
    for v, (got, video) in enumerate(zip(runs["pallas"], videos)):
        ref = phase_slice_results(model, pallas_cfg, video)
        for t, (a, b) in enumerate(zip(ref, got)):
            diff = _same_results(a, b)
            if diff:
                sseg, pan, pan_m = _agreement(a, b)
                raise AssertionError(
                    f"batched f32 video {v} frame {t} differs from "
                    f"streaming in {diff}: sseg agreement {sseg}, panoptic "
                    f"{pan} ({pan_m} with ids matched), things "
                    f"{len(b.cls_inds)}/{len(a.cls_inds)}")
    log("batched", "[f32] == streaming bit for bit: maps, classes, scores "
                   "and track ids of every video and frame")
    outs = _decoder_outputs(model, cfg, videos[0], dev)
    post_ms = {}
    for impl in ("pallas", "jax"):
        pcfg = dataclasses.replace(cfg.model.postprocess, impl=impl)
        _post(outs[0], pcfg, size)
        post_ms[impl] = statistics.median(
            _timed(lambda: _post(o, pcfg, size))[1] for o in outs)
    log("batched", f"[f32] postprocess stage ms (median of "
                   f"{len(outs)} frames): " + json.dumps(post_ms))
    stats["post_ms"] = post_ms
    log("batched", "[f32] " + json.dumps(stats))
    return stats


def _held_to_plain(real, ref_fn, rtol, name, rows, plain=None):
    """``real`` (a kernel wrapper) that also holds every output it returns
    against ``ref_fn`` on the same inputs, each batch element on its own:
    max|d| within ``rtol`` of that element's max|ref|.  ``plain`` (if
    given; the plain version where ``ref_fn`` is a more exact one) gets its
    error against ``ref_fn`` recorded beside the kernel's.  One row per
    call into ``rows``; neither reference launches a kernel."""
    def rel_errs(out, ref):
        return [float((o.double() - r.double()).abs().max()
                      / r.double().abs().max().clamp_min(1e-30))
                for o, r in zip(out, ref)]

    def checked(*args, **kwargs):
        out = real(*args, **kwargs)
        ref = ref_fn(*args, **kwargs)
        row = dict(kernel=name, shape=list(out.shape),
                   rel_err=rel_errs(out, ref))
        if plain is not None:
            row["plain_rel_err"] = rel_errs(plain(*args, **kwargs), ref)
        rows.append(row)
        if not (bool(torch.isfinite(out).all())
                and max(row["rel_err"]) <= rtol):
            raise AssertionError(f"{name} disagrees with its reference on "
                                 f"the batched path at {row['shape']}: "
                                 f"max|d| / max|ref| {row['rel_err']} per "
                                 f"batch element > {rtol}")
        return out
    return checked


def _slot_attention_f64(q, k, v):
    """The plain slot attention (ops/slot_attention.py) in float64."""
    scores = q.double() @ k.double().transpose(1, 2)
    return torch.softmax(scores, dim=1) @ v.double()


def _batched_kernels_checked(dev, pipe, videos, first):
    """``pipe.run_videos(videos)`` once more with the DCN and the
    slot-attention kernels' wrappers, at their call sites, holding every
    output, each batch element on its own, to a reference on the inputs
    the batched path gives them: the DCN to its plain version (DCN_RTOL);
    slot attention to its plain version in float64 (SA_RTOL), with the
    plain f32 version's error against it printed beside (its f32 sums over
    up to 131072 pixels reach ~1e-4 of max at batch 2, the kernel's stay
    far below).  The results must equal ``first``'s, the counted run's,
    bit for bit."""
    import slotvps_tpu_torch.models.semantic_head as sh
    import slotvps_tpu_torch.models.slot_head as slh
    from slotvps_tpu_torch.ops.deform_conv import deform_conv2d
    from slotvps_tpu_torch.ops.slot_attention import slot_attention

    def plain_dcn(x, offset, weight, halo, compute_dtype):
        return deform_conv2d(x, offset, weight, padding=1,
                             max_displacement=halo,
                             compute_dtype=compute_dtype)

    rows = []
    real_dcn, real_sa = sh.deform_conv2d_hopper, slh.slot_attention_hopper
    sh.deform_conv2d_hopper = _held_to_plain(
        real_dcn, plain_dcn, DCN_RTOL[torch.bfloat16],
        "deform_conv2d_hopper_bf16", rows)
    slh.slot_attention_hopper = _held_to_plain(
        real_sa, _slot_attention_f64, SA_RTOL, "slot_attention_hopper", rows,
        plain=slot_attention)
    try:
        res = pipe.run_videos(videos)
    finally:
        sh.deform_conv2d_hopper, slh.slot_attention_hopper = real_dcn, real_sa
    for v, (a_v, b_v) in enumerate(zip(first, res)):
        for t, (a, b) in enumerate(zip(a_v, b_v)):
            diff = _same_results(a, b)
            if diff:
                raise AssertionError(f"batched bf16 video {v} frame {t}: "
                                     f"two runs differ in {diff}")
    summary = {}
    for row in rows:
        s = summary.setdefault(row["kernel"], dict(
            calls=0, batch=set(), max_rel_err_per_element=0.0))
        s["calls"] += 1
        s["batch"].add(row["shape"][0])
        s["max_rel_err_per_element"] = max(s["max_rel_err_per_element"],
                                           *row["rel_err"])
        if "plain_rel_err" in row:
            s["plain_f32_max_rel_err_per_element"] = max(
                s.get("plain_f32_max_rel_err_per_element", 0.0),
                *row["plain_rel_err"])
    for s in summary.values():
        s["batch"] = sorted(s["batch"])
    if set(summary) != {"deform_conv2d_hopper_bf16", "slot_attention_hopper"}:
        raise AssertionError(f"the batched path called {sorted(summary)}")
    log("batched", "[bf16] every DCN and slot-attention call of the batched "
                   "run against its reference on the same inputs, each "
                   "batch element on its own: " + json.dumps(summary))
    return summary


def phase_batched_tuned(dev, model, cfg, videos, streams):
    """BatchedVideoPipeline, B = 2 videos of 3 frames, on the bf16 tuned
    path (the JAX package's bench configuration): its launches; each video
    against its streaming run, bit for bit (maps, classes, scores and ids);
    a second run with every DCN and slot-attention call held to a reference
    on the batched inputs (:func:`_batched_kernels_checked`); then a timed
    run (ms per lockstep step, frames/s, peak memory)."""
    from slotvps_tpu_torch.inference import BatchedVideoPipeline

    size = videos[0][0].shape[1:3]
    t_len = len(videos[0])
    pipe = BatchedVideoPipeline(model, cfg, len(videos), image_size=size)
    res, launches, wall, peak = _run_counted(
        dev, lambda: pipe.run_videos(videos))
    _check_launches("batched_bf16", launches,
                    expected_launches(cfg, [r for v in res for r in v],
                                      steps=t_len))
    for v, (got, ref) in enumerate(zip(res, streams)):
        for t, (a, b) in enumerate(zip(ref, got)):
            diff = _same_results(a, b)
            if diff:
                sseg, pan, pan_m = _agreement(a, b)
                raise AssertionError(
                    f"batched bf16 video {v} frame {t} differs from "
                    f"streaming in {diff}: sseg agreement {sseg}, panoptic "
                    f"{pan} ({pan_m} with ids matched), things "
                    f"{len(b.cls_inds)}/{len(a.cls_inds)}")
    log("batched", "[bf16] == streaming bit for bit: maps, classes, scores "
                   "and track ids of every video and frame")
    checked = _batched_kernels_checked(dev, pipe, videos, res)
    _, _, wall2, peak2 = _run_counted(dev, lambda: pipe.run_videos(videos))
    stats = dict(path="batched_bf16", launches=launches,
                 first_run_s=wall, ms_per_step=wall2 / t_len * 1e3,
                 frames_per_s=len(videos) * t_len / wall2,
                 peak_mem_gib=max(peak, peak2), kernels_checked=checked)
    log("batched", "[bf16] " + json.dumps(stats))
    return stats


def phase_scan(dev, model, cfg, frames, streamed):
    """VideoScanner over the clip's first frames on ``cfg``'s path against
    the streaming results of the same frames: same ops at the same batch
    size, only the tracking moved to the device, so maps, classes, scores
    and ids must be bit-identical.  Then a timed run."""
    from slotvps_tpu_torch.inference import VideoScanner

    size = frames[0].shape[1:3]
    scanner = VideoScanner(model, cfg, image_size=size)
    res, launches, wall, peak = _run_counted(
        dev, lambda: scanner.run_video(frames))
    _check_launches("scan", launches, expected_launches(cfg, res))
    for t, (a, b) in enumerate(zip(streamed, res)):
        diff = _same_results(a, b)
        if diff:
            raise AssertionError(
                f"scan frame {t} differs from streaming in {diff}: things "
                f"{a.cls_inds.tolist()} / {b.cls_inds.tolist()}, ids "
                f"{a.obj_ids.tolist()} / {b.obj_ids.tolist()}")
    _, _, wall2, _ = _run_counted(dev, lambda: scanner.run_video(frames))
    stats = dict(path="scan", launches=launches, first_run_s=wall,
                 ms_per_frame=wall2 / len(frames) * 1e3, peak_mem_gib=peak,
                 obj_ids=[r.obj_ids.tolist() for r in res])
    log("scan", "== streaming bit for bit on "
                f"{len(frames)} frames; " + json.dumps(stats))
    return stats


def _tve_counted(parity, frames):
    """Wrap utils/parity.stream_frame, one streaming step of a route, so
    that each call appends (route, launches in the call, its
    PostprocResult) to ``frames``; the route is read from its ``cfg``
    argument.  Returns a function that puts the original back."""
    fn = parity.stream_frame
    sig = inspect.signature(fn)

    def call(*args, **kwargs):
        cfg = sig.bind(*args, **kwargs).arguments["cfg"]
        before = launch_counts()
        out = fn(*args, **kwargs)
        after = launch_counts()
        route = {"float32": "exact", "bfloat16": "tuned"}[cfg.compute_dtype]
        frames.append((route, {k: n - before[k] for k, n in after.items()
                               if n != before[k]}, out[1]))
        return out

    parity.stream_frame = call
    return lambda: setattr(parity, "stream_frame", fn)


def _tve_check_launches(regime, frames, total, n_frames, num_levels):
    """Each exact frame launched nothing; each tuned frame launched the
    bf16 DCN 3 blocks x levels times and the fused postprocess kernels
    once (repair n_loop times), nothing else.  Outside the frames: the
    tuned route's reference extract of frame 0 (the bf16 DCN 3 x levels
    times) and, in the trained regime, the overfit's kernels (the f32
    model's bf16 DCN forward, the bf16 backward) and the offsets
    measure's 3 x levels f32 DCN.  Returns the launches outside the
    frames."""
    dcn = {"deform_conv2d_hopper_bf16": 3 * num_levels}
    inside = dict.fromkeys(total, 0)
    for route, launched, post in frames:
        for k, n in launched.items():
            inside[k] += n
        want = {}
        if route == "tuned":
            want = dict(dcn, sseg_hopper=1, theta_hopper=1, claim_hopper=1,
                        argmax_hopper=1, repair_hopper=post.n_loop)
            want = {k: n for k, n in want.items() if n}
        if launched != want:
            raise AssertionError(f"[tuned_vs_exact] {regime}: {route} "
                                 f"frame launched {launched}, want {want}")
    routes = sorted(route for route, _, _ in frames)
    if routes != ["exact"] * n_frames + ["tuned"] * n_frames:
        raise AssertionError(f"[tuned_vs_exact] {regime}: frames {routes}, "
                             f"want {n_frames} a route")
    outside = {k: n - inside[k] for k, n in total.items() if n != inside[k]}
    want = dict(dcn)
    if regime == "trained":
        train = ("deform_conv2d_hopper_bf16_f32", "dcn_backward_hopper_bf16")
        if not all(outside.get(name) for name in train):
            raise AssertionError(f"[tuned_vs_exact] trained: the overfit "
                                 f"launched no {train}: {outside}")
        want.update({name: outside[name] for name in train},
                    deform_conv2d_hopper=3 * num_levels)
    if outside != want:
        raise AssertionError(f"[tuned_vs_exact] {regime}: launches outside "
                             f"the frames {outside}, want {want}")
    return outside


def _tve_misses(report, bounds):
    """{aggregate: (value, bound)} of the bounds ``report`` misses."""
    agg, n = report["aggregate"], report["n_frames"]
    frac = agg["kept_unmatched_total"] / max(agg["n_kept_exact_total"], 1)
    checks = [
        ("pan_agreement_matched_min", agg["pan_agreement_matched_min"],
         bounds["pan_matched_min"], 1),
        ("sseg_agreement_min", agg["sseg_agreement_min"],
         bounds["sseg_min"], 1),
        ("max_score_drift", agg["max_score_drift"],
         bounds["score_drift_max"], -1),
        ("n_kept_exact_total", agg["n_kept_exact_total"],
         bounds["kept_per_frame"] * n, 1)]
    if bounds["unmatched_frac_max"] is not None:
        checks.append(("kept_unmatched_share", frac,
                       bounds["unmatched_frac_max"], -1))
    # sign 1: a floor, -1: a ceiling
    return {name: (value, bound) for name, value, bound, sign in checks
            if sign * (value - bound) < 0}


def phase_tuned_vs_exact(dev, cal_size=(H, W), n_frames=TVE_FRAMES,
                         train_size=TVE_TRAIN_SIZE,
                         train_steps=TVE_TRAIN_STEPS,
                         n_things=TVE_TRAIN_THINGS):
    """utils/parity.tuned_vs_exact on the card, both regimes: calibrated
    at ``cal_size``, trained at ``train_size`` with the DCN kernels in
    training (its halo assertion inside); each streaming step's launches
    counted by route (:func:`_tve_check_launches`), the aggregates held to
    TVE_BOUNDS.  Returns {regime: stats}."""
    from slotvps_tpu_torch.config import named_config
    from slotvps_tpu_torch.utils import parity

    num_levels = named_config("r50_fpn_slotvps").model.semantic_head \
        .num_levels
    runs = {"calibrated": dict(h=cal_size[0], w=cal_size[1]),
            "trained": dict(h=train_size[0], w=train_size[1],
                            regime="trained", train_steps=train_steps,
                            n_things=n_things, train_dcn_impl="pallas")}
    out = {}
    for regime, kw in runs.items():
        frames = []
        restore = _tve_counted(parity, frames)
        try:
            report, total, wall, peak = _run_counted(
                dev, lambda: parity.tuned_vs_exact(
                    n_frames=n_frames, device=dev, **kw))
        finally:
            restore()
        outside = _tve_check_launches(regime, frames, total, n_frames,
                                      num_levels)
        pf = report["per_frame"]
        stats = dict(regime=regime, resolution=report["resolution"],
                     n_frames=n_frames, wall_s=wall, peak_mem_gib=peak,
                     calib=report["calib"], aggregate=report["aggregate"],
                     n_kept_exact=[m["n_kept_exact"] for m in pf],
                     n_things_exact=[m["n_things_exact"] for m in pf],
                     n_things_tuned=[m["n_things_tuned"] for m in pf],
                     launches_outside_frames=outside,
                     n_loop=[post.n_loop for route, _, post in frames
                             if route == "tuned"])
        log("tuned_vs_exact", json.dumps(stats))
        misses = _tve_misses(report, TVE_BOUNDS[regime])
        if misses:
            raise AssertionError(f"[tuned_vs_exact] {regime} misses "
                                 f"{misses} (value, bound): "
                                 f"{report['aggregate']}")
        out[regime] = stats
    return out


def _device_time_by_kernel(prof):
    by_name = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0)
        if dev_us and ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.key] = (dev_us / 1e3, ev.count)
    return by_name


def report(dcn_rows, bwd_rows, pp_rows, sseg_row, sa_rows, serving_rows,
           fused_rows, stats, build_s):
    """The kernels line: the DCN per frame (sums over its 12 shapes) in
    each dtype, its f32-model bf16 route and its backward per training step
    (sums over the step's 12 shapes), the postprocess kernels at the given
    K's rows, sseg, and slot attention in bf16 and in f32 per frame (its 14
    calls; ``sa_rows``).
    ``launches`` comes from the run of the path each kernel belongs to
    (KERNELS); ``serving_rows`` are the claim scan (one frame, K = 100)
    and the two postproc_v3 entries only tests reach, whose launches are
    read on the batched claim-scan run; ``fused_rows`` the K-minor chain's
    three kernels on its random input (FUSED_SHAPE)."""
    rows = []
    for name, dtype in (("deform_conv2d_hopper", torch.float32),
                        ("deform_conv2d_hopper_bf16", torch.bfloat16),
                        ("deform_conv2d_hopper_bf16_f32", torch.bfloat16)):
        per_shape = dcn_rows[name]
        b_ms, b_by = _fwd_bound(per_shape, dtype)
        rows.append(dict(
            name=name, max_abs_err=max(r["max_abs_err"] for r in per_shape),
            ms=sum(r["ms"] for r in per_shape),
            plain_ms=sum(r["plain_ms"] for r in per_shape),
            bound_ms=b_ms, bound_by=b_by, build_s=build_s["deform_conv"]))
        if dtype == torch.float32:
            rows[-1]["bound_fma_ms"] = _fma_bound(per_shape)
    # the backward per training step: sums over its 12 shapes
    for name, dtype in (("dcn_backward_hopper", torch.float32),
                        ("dcn_backward_hopper_bf16", torch.bfloat16)):
        per_shape = bwd_rows[dtype]
        b_ms, b_by = _bwd_bound(per_shape, dtype)
        pass_ms = {}
        for r in per_shape:
            for part, ms in r["pass_ms"].items():
                pass_ms[part] = pass_ms.get(part, 0.0) + ms
        rows.append(dict(
            name=name, max_abs_err=max(r["max_abs_err"] for r in per_shape),
            ms=sum(r["ms"] for r in per_shape),
            plain_ms=sum(r["plain_ms"] for r in per_shape),
            bound_ms=b_ms, bound_by=b_by,
            bound_parts_ms=_bwd_bound(per_shape, dtype, parts=True),
            pass_ms=pass_ms, build_s=build_s["deform_conv"]))
        if dtype == torch.float32:
            rows[-1]["bound_fma_ms"] = _fma_bound(
                per_shape, ("ops_main", "ops_f32"))
    for name, row in list(pp_rows.items()) + [("sseg_hopper", sseg_row)]:
        rows.append(dict(
            name=name, max_abs_err=row["max_abs_err"], ms=row["ms"],
            alone_ms=row["alone_ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            build_s=build_s["postproc_v3"]))
    for sa_row in sa_rows:
        rows.append(dict(
            name=sa_row["kernel"], max_abs_err=sa_row["max_abs_err"],
            ms=sa_row["ms"], plain_ms=sa_row["plain_ms"],
            bound_ms=sa_row["bound_ms"], bound_by=sa_row["bound_by"],
            bound_parts_ms=sa_row["bound_parts_ms"],
            build_s=build_s["slot_attention"]))
        if "bound_fma_ms" in sa_row:   # f32: the FMA bound beside it
            rows[-1]["bound_fma_ms"] = sa_row["bound_fma_ms"]
    for name, row in serving_rows.items():
        lib = "claim_scan" if name == "claim_scan_hopper" else "postproc_v3"
        rows.append(dict(
            name=name, max_abs_err=row["max_abs_err"], ms=row["ms"],
            alone_ms=row.get("alone_ms"), plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row.get("library_ms"), build_s=build_s[lib]))
    for name, row in fused_rows.items():
        rows.append(dict(
            name=name, max_abs_err=row["max_abs_err"], ms=row["ms"],
            alone_ms=row["alone_ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            build_s=build_s["postproc_v3"]))
    for kern in rows:
        source, replaces, path = KERNELS[kern["name"]]
        # no single PyTorch call computes these functions: torchvision's
        # deform_conv2d is absent; each postprocess kernel (v3 and K-minor)
        # fuses the x4 upsample into its reduction (sseg: interpolate +
        # argmax is two calls); slot
        # attention sums over the axis that scaled_dot_product_attention
        # does not normalise
        # (torch.bincount for hist)
        kern.update(route="cuda", source=source, replaces=replaces,
                    path=path, launches=stats[path]["launches"][kern["name"]],
                    library_ms=kern.get("library_ms"))
    return rows


def main():
    dev, card = phase_device()
    build_s = phase_build()
    dcn_rows = {
        "deform_conv2d_hopper": phase_kernels(dev, dtype=torch.float32),
        "deform_conv2d_hopper_bf16": phase_kernels(dev, dtype=torch.bfloat16),
        # the training step's forward: f32 activations, bf16 compute
        "deform_conv2d_hopper_bf16_f32": phase_kernels(
            dev, levels=TRAIN_LEVELS, b=TRAIN_B, dtype=torch.bfloat16,
            io_dtype=torch.float32)}
    # the pallas_f32 step's forward: the f32 kernel at the training shapes
    # (printed; its launches are read on the train_f32 path)
    phase_kernels(dev, levels=TRAIN_LEVELS, b=TRAIN_B, dtype=torch.float32)
    bwd_rows = {dtype: phase_backward_kernels(dev, dtype=dtype)
                for dtype in (torch.float32, torch.bfloat16)}
    pp_rows = phase_postproc_kernels(dev)
    sseg_row = phase_sseg_kernel(dev)
    sa_rows = [phase_slot_attention(dev),
               phase_slot_attention(dev, dtype=torch.float32)]
    phase_batch_invariance(dev)
    top2_rows = phase_top2_hist(dev)
    phase_argmax_edges(dev)
    phase_claim_edges(dev)
    cfg, cfg32 = slice_config(), f32_config()
    model, frames = prepare(dev, cfg)
    results, stats = phase_slice(dev, cfg, model, frames, "bf16")
    results32, stats32 = phase_slice(dev, cfg32, model, frames[:3], "f32")
    # the path a user takes to evaluate published weights: a reference
    # .pth of the same weights, the halo check, the f32 Pallas-Retriever
    # path; then the eval CLI on it
    scratch = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        ckpt_stats, pth, cfg_ckpt = phase_checkpoint(dev, model, frames[:3],
                                                     scratch)
        phase_cli(dev, cfg_ckpt, pth,
                  [frames[:2], make_clip(H, W, 2, seed=3)], scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    phase_postproc(model, cfg, frames, dev)
    fused_rows, fused_stats = phase_fused_chain(dev, model, cfg, frames[0])
    phase_stages(model, cfg, frames, "bf16")
    phase_stages(model, cfg32, frames[:3], "f32")
    phase_plain(model, cfg, frames, results, results32)
    # serving: a second clip, so the batched videos differ
    frames_b = make_clip(H, W, N_SERVE, seed=2)
    serving_rows = dict(top2_rows)
    serving_rows["claim_scan_hopper"] = phase_claim_scan_kernel(
        dev, model, cfg32, [frames[0], frames_b[0]])
    batched32_stats = phase_batched_pallas(
        dev, model, cfg32, [frames[:2], frames_b[:2]])
    streams = [results[:N_SERVE], phase_slice_results(
        model, cfg, frames_b[:N_SERVE])]
    batched_stats = phase_batched_tuned(
        dev, model, cfg, [frames[:N_SERVE], frames_b[:N_SERVE]], streams)
    # the batched pipeline over every visible card (two replicas on one)
    phase_multi(dev, card, model, cfg, cfg32,
                [frames[:N_SERVE], frames_b[:N_SERVE]], streams,
                batched_stats["ms_per_step"])
    scan_stats = phase_scan(dev, model, cfg, frames[:N_SERVE],
                            results[:N_SERVE])
    del model
    torch.cuda.empty_cache()
    # the tuned-vs-exact check: the bf16 kernel stack against the f32
    # plain stack, calibrated and trained
    phase_tuned_vs_exact(dev)
    torch.cuda.empty_cache()
    # the Swin-L model on the serving paths, then the ResNet plugins
    scratch = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_swin_"))
    try:
        phase_swin(dev, card, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    torch.cuda.empty_cache()
    phase_plugins(dev)
    torch.cuda.empty_cache()
    train_stats, init_state, batch = phase_train(dev)
    torch.cuda.empty_cache()
    train32_stats = phase_train_parity(dev, init_state, batch)
    # the data-parallel step in a world of one against the plain step
    torch.cuda.empty_cache()
    phase_ddp(dev, init_state, batch)
    # the rest of training: the overfit recipe and the eval hook, then the
    # train CLI with the hook
    torch.cuda.empty_cache()
    scratch = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        train_eval_stats = phase_train_eval(dev, scratch / "overfit")
        torch.cuda.empty_cache()
        phase_train_cli(dev, scratch / "cli")
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    # Swin-L training: the train step at the training crop, then overfit
    torch.cuda.empty_cache()
    phase_swin_train(dev, card)
    # the postprocess kernels' numbers at the ladder branch the clip took
    k_path = statistics.mode(r.capacity for r in results)
    if k_path not in pp_rows:
        raise AssertionError(f"the clip took ladder branch {k_path}, not "
                             f"one of the timed shapes {list(pp_rows)}")
    kernels = report(dcn_rows, bwd_rows, pp_rows[k_path], sseg_row, sa_rows,
                     serving_rows, fused_rows,
                     {"bf16": stats, "f32": stats32, "train": train_stats,
                      "train_eval": train_eval_stats,
                      "checkpoint": ckpt_stats,
                      "fused_chain": fused_stats,
                      "train_f32": train32_stats,
                      "batched_pallas": batched32_stats,
                      "tests": batched32_stats, "batched_bf16": batched_stats,
                      "scan": scan_stats}, build_s)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
