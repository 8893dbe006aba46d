#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (slotvps_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises, exit code != 0):
  1. device  — card name and power limit, torch/CUDA versions; TF32 off.
  2. build   — compile the DCN kernel from slotvps_tpu_torch/csrc/ (nvcc).
  3. kernels — the DCN kernel against its plain PyTorch version at the 12
     (tower block, FPN level) shapes of a 1024x2048 frame, each at its
     level's halo; CUDA-event times of both.
  4. slice   — r50_fpn_slotvps at full width and 1024x2048, the port's
     tuned configuration, seeded random weights doctored and calibrated so
     ~48 slots clear the 0.85 keep threshold; a 6-frame synthetic uint8
     clip through InferencePipeline (run_video and process_frame); counts
     the kernel's launches on that path and checks the outputs.
  5. plain   — the first frames again with the plain DCN (dcn_impl="jax")
     on the card; pixel agreement of the semantic and panoptic maps.
  6. report  — the card line, the kernels' JSON line, and last the result
     line {"ok": true, "device": {...}}.

The script imports nothing of JAX.  It exits non-zero, printing no result,
without CUDA or outside a checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import time

import numpy as np
import torch

H, W = 1024, 2048
N_FRAMES = 6
# (H, W, halo) of the FPN levels P2..P5 of a 1024x2048 frame
DCN_LEVELS = ((256, 512, 2), (128, 256, 3), (64, 128, 4), (32, 64, 6))
# (Cin, Cout) of the three semantic-tower blocks
DCN_BLOCKS = ((256, 256), (256, 128), (128, 128))
# kernel vs plain: f32 sums taken in another order (per-tap reduction over
# 9*Cin terms, FMA contraction) differ by a few ulp of the largest partial
# sums; 1e-4 of the output scale leaves two orders of magnitude of margin
DCN_RTOL = 1e-4
KERNEL_SOURCE = "slotvps_tpu_torch/csrc/deform_conv.cu"
KERNEL_REPLACES = "slotvps_tpu/ops/pallas/deform_conv.py:44"


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0), card


def phase_build():
    from slotvps_tpu_torch.ops.cuda import deform_conv as dcn_cuda

    path = dcn_cuda.library_path()
    if path.exists():
        path.unlink()   # always build from the checkout's sources
    path, secs = dcn_cuda.build(verbose=True)
    log("build", f"nvcc built {path.name} in {secs:.2f} s")
    return secs


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


def dcn_case(dev, h, w, cin, cout, halo, seed):
    """Seeded DCN inputs: offsets mostly inside the halo, ~5% of them
    beyond it (clamped), and border pixels whose samples leave the image."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((1, h, w, cin), generator=g, device=dev)
    off = torch.randn((1, h, w, 18), generator=g, device=dev) * (0.75 * halo)
    far = torch.rand((1, h, w, 18), generator=g, device=dev) < 0.05
    off = torch.where(far, torch.sign(off) * (halo + 1.5), off)
    wt = torch.randn((3, 3, cin, cout), generator=g, device=dev) \
        / (9 * cin) ** 0.5
    return x, off, wt


def phase_kernels(dev, levels=DCN_LEVELS, blocks=DCN_BLOCKS, timed=True):
    """Kernel vs plain at every (level, block) shape."""
    from slotvps_tpu_torch.ops.cuda.deform_conv import deform_conv2d_hopper
    from slotvps_tpu_torch.ops.deform_conv import deform_conv2d

    rows = []
    for li, (h, w, halo) in enumerate(levels):
        for bi, (cin, cout) in enumerate(blocks):
            x, off, wt = dcn_case(dev, h, w, cin, cout, halo,
                                  seed=10 * li + bi)
            with torch.no_grad():
                ref = deform_conv2d(x, off, wt, padding=1,
                                    max_displacement=halo)
                out = deform_conv2d_hopper(x, off, wt, halo)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            ok = bool(torch.isfinite(out).all()) and err <= DCN_RTOL * scale
            row = dict(shape=f"P{li + 2} {h}x{w} {cin}->{cout} halo {halo}",
                       max_abs_err=err, max_abs_ref=scale)
            if timed:
                with torch.no_grad():
                    row["ms"] = _cuda_ms(
                        lambda: deform_conv2d_hopper(x, off, wt, halo))
                    row["plain_ms"] = _cuda_ms(
                        lambda: deform_conv2d(x, off, wt, padding=1,
                                              max_displacement=halo))
            log("kernels", json.dumps(row))
            if not ok:
                raise AssertionError(
                    f"DCN kernel disagrees at {row['shape']}: max|d| "
                    f"{err:.3e} > {DCN_RTOL} * max|ref| {scale:.3e}")
            rows.append(row)
    return rows


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
    from slotvps_tpu.eval.fusion import unify_pan_result

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


def phase_slice(dev, cfg, h=H, w=W, n_frames=N_FRAMES, target_valid=48):
    """The main path: returns (model, frames, results, stats)."""
    from slotvps_tpu_torch.inference import InferencePipeline, run_video
    from slotvps_tpu_torch.ops.cuda.deform_conv import deform_conv2d_hopper

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
    cuda = dev.type == "cuda"

    pipe = InferencePipeline(model, cfg, image_size=(h, w))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    deform_conv2d_hopper.launches = 0
    t0 = time.perf_counter()
    results = run_video(pipe, frames)
    wall = time.perf_counter() - t0
    launches = deform_conv2d_hopper.launches
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    n_dcn = 3 * cfg.model.semantic_head.num_levels
    if launches != n_dcn * n_frames:
        raise AssertionError(f"DCN kernel launched {launches} times for "
                             f"{n_frames} frames, want {n_dcn} per frame")
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
    stats = dict(launches=launches, run_video_s=wall,
                 steady_ms_per_frame=statistics.median(times[1:]),
                 first_frame_ms=times[0], peak_mem_gib=peak / 2 ** 30,
                 things_per_frame=n_things,
                 tracked_ids=[len(x) for x in tracked],
                 obj_ids=[r.obj_ids.tolist() for r in results])
    log("slice", json.dumps(stats))
    return model, frames, results, stats


def phase_plain(model, cfg, frames, results, n_frames=2):
    """The first frames again, same weights, with the plain DCN on the same
    device."""
    from slotvps_tpu_torch.inference import InferencePipeline
    from slotvps_tpu_torch.ops.cuda.deform_conv import deform_conv2d_hopper

    sh = dataclasses.replace(cfg.model.semantic_head, dcn_impl="jax")
    plain_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, semantic_head=sh))
    pipe = InferencePipeline(model, plain_cfg,
                             image_size=results[0].panoptic.shape)
    before = deform_conv2d_hopper.launches
    for t, fr in enumerate(frames[:n_frames]):
        r = pipe.process_frame(fr, is_first=(t == 0))
        k = results[t]
        sseg = float((r.sseg == k.sseg).mean())
        pan = float((r.panoptic == k.panoptic).mean())
        log("plain", f"frame {t}: sseg agreement {sseg:.6f}, panoptic "
                     f"agreement {pan:.6f}")
        if r.cls_inds.tolist() != k.cls_inds.tolist() \
                or r.obj_ids.tolist() != k.obj_ids.tolist():
            log("plain", f"frame {t}: kept things differ: kernel "
                         f"cls {k.cls_inds.tolist()} ids "
                         f"{k.obj_ids.tolist()} / plain cls "
                         f"{r.cls_inds.tolist()} ids {r.obj_ids.tolist()}")
        if sseg < 0.999 or pan < 0.99:
            raise AssertionError(f"frame {t}: kernel path and plain path "
                                 f"disagree (sseg {sseg}, panoptic {pan})")
    if deform_conv2d_hopper.launches != before:
        raise AssertionError("dcn_impl='jax' launched the kernel")


def slice_config():
    from slotvps_tpu.config import named_config
    from slotvps_tpu_torch.cli.test_eval_vpq import tune_config

    return tune_config(named_config("r50_fpn_slotvps"))


def main():
    dev, card = phase_device()
    build_s = phase_build()
    rows = phase_kernels(dev)
    cfg = slice_config()
    model, frames, results, stats = phase_slice(dev, cfg)
    phase_plain(model, cfg, frames, results)
    kernels = [{
        "name": "deform_conv2d_hopper",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": stats["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # per frame: the sum over the 12 (level, block) shapes
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "build_s": build_s,
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
