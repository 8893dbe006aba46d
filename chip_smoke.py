#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (slotvps_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises, exit code != 0):
  1. device   — card name and power limit, torch/CUDA versions; TF32 off.
  2. build    — compile both kernel libraries from slotvps_tpu_torch/csrc/
     (one nvcc each, started together).
  3. kernels  — each kernel against its plain PyTorch version on the card,
     with CUDA-event times of both and the bound: the DCN kernel at the 12
     (tower block, FPN level) shapes of a 1024x2048 frame, each at its
     level's halo; theta, claim, argmax and repair at K = 64 and K = 100
     slots of 256x512 low-res masks, with small segments so that repair
     has dirty tiles.
  4. slice    — r50_fpn_slotvps at full width and 1024x2048, the port's
     tuned configuration (DCN kernel f32, fused postprocess), seeded random
     weights doctored and calibrated so ~48 slots clear the 0.85 keep
     threshold; a 6-frame synthetic uint8 clip through InferencePipeline
     (run_video and process_frame); counts every kernel's launches on that
     path and checks the outputs.
  5. postproc — on two clip frames, the decoder outputs captured on the
     card go through postprocess_frame with impl="fused" (the kernels) and
     impl="jax" (the reference path): equal sseg, panoptic >= 99.99 %.
  6. stages   — per-stage times of the slice's frame (device synchronize
     between stages), the postprocess with each impl, and a torch.profiler
     pass: device time by kernel and busy share.
  7. plain    — the first frames again, fully plain (dcn_impl="jax",
     postprocess impl="jax") on the card: no kernel launches; pixel
     agreement with the kernel path.
  8. report   — the card line, the kernels' JSON line, and last the result
     line {"ok": true, "device": {...}}.

The script imports nothing of JAX.  It exits non-zero, printing no result,
without CUDA or outside a checkout of the repository.
"""

from __future__ import annotations

import concurrent.futures
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
# theta: the sum of exp over slots is taken in another order; a few ulp
THETA_RTOL = 1e-5
# (K, h, w) of the postprocess kernels: the ladder's 64-slot prefix and
# all 100 slots, at the 256x512 low-res masks of a 1024x2048 frame
PP_SHAPES = ((64, 256, 512), (100, 256, 512))
PP_VALID = 40            # valid slots of the kernel-phase cases
# fused vs reference postprocess: the fused theta sums in another order,
# which may move a pixel that sits within an ulp of the threshold
PAN_AGREE = 0.9999
# published H100 SXM peaks at 700 W: f32 outside the tensor cores, HBM
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12
SRC = "slotvps_tpu_torch/csrc/"
PV3 = "slotvps_tpu/ops/pallas/postproc_v3.py"
# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "deform_conv2d_hopper": (SRC + "deform_conv.cu",
                             "slotvps_tpu/ops/pallas/deform_conv.py:44"),
    "theta_hopper": (SRC + "postproc_v3.cu", PV3 + ":151"),
    "claim_hopper": (SRC + "postproc_v3.cu", PV3 + ":252"),
    "argmax_hopper": (SRC + "postproc_v3.cu", PV3 + ":351"),
    "repair_hopper": (SRC + "postproc_v3.cu", PV3 + ":462"),
}


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def wrappers():
    """name -> kernel wrapper (each carries its ``launches`` count)."""
    from slotvps_tpu_torch.ops.cuda import postproc_v3 as pv3
    from slotvps_tpu_torch.ops.cuda.deform_conv import deform_conv2d_hopper

    return {"deform_conv2d_hopper": deform_conv2d_hopper,
            "theta_hopper": pv3.theta_hopper,
            "claim_hopper": pv3.claim_hopper,
            "argmax_hopper": pv3.argmax_hopper,
            "repair_hopper": pv3.repair_hopper}


def launch_counts():
    return {name: fn.launches for name, fn in wrappers().items()}


def reset_counts():
    for fn in wrappers().values():
        fn.launches = 0


def bound(n_bytes, n_ops):
    """(bound ms, what bounds it) on the published peaks."""
    t_bytes = n_bytes / HBM_BYTES * 1e3
    t_ops = n_ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    """Both libraries from the checkout's sources, one nvcc each, started
    together.  Returns library name -> seconds."""
    from slotvps_tpu_torch.ops.cuda import deform_conv, postproc_v3

    libs = (deform_conv.LIBRARY, postproc_v3.LIBRARY)
    for lib in libs:
        path = lib.library_path()
        if path.exists():
            path.unlink()   # always build from the checkout's sources
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        futs = {lib.name: pool.submit(lib.build, True) for lib in libs}
        built = {name: f.result() for name, f in futs.items()}
    for name, (path, secs) in built.items():
        log("build", f"nvcc built {path.name} in {secs:.2f} s")
    return {name: secs for name, (_, secs) in built.items()}


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
    """DCN kernel vs plain at every (level, block) shape."""
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
            # each input read once, the output written once; one FMA = 2
            n_bytes = 4 * (h * w * (cin + 18 + cout) + 9 * cin * cout)
            row = dict(shape=f"P{li + 2} {h}x{w} {cin}->{cout} halo {halo}",
                       max_abs_err=err, max_abs_ref=scale,
                       bytes=n_bytes, ops=2 * 9 * cin * cout * h * w)
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


def _pp_bounds(k, h, w, n_valid, n_things, n_kept, n_kept_things,
               dirty_frac, t):
    """(bytes, operations) of the four functions on this run's data.  Each
    counts only the slots its output depends on (theta the valid slots,
    claim the valid things, argmax and repair the kept slots), each input
    read once and each output written once.  One slot's x4 upsample is
    separable: 3 flops per row-phase value and 3 per column-phase value; a
    compare, exp or log is one operation."""
    hw, full = h * w, 16 * h * w
    up = 3 * 4 * hw + 3 * full                   # one slot, rows + columns
    # per valid slot: max, subtract, exp, add; per pixel: log and two adds
    theta = (4 * n_valid * hw + k + 4 * full,
             n_valid * (up + 4 * full) + 3 * full)
    # per thing: compare with theta, count, owner and class test; per kept
    # thing: the claim
    claim = (4 * n_things * hw + 4 * full + full + 5 * k,
             n_things * (up + 5 * full) + n_kept_things * 2 * full)
    # per kept slot: owner test, compare, select; per pixel: its count
    argmax = (4 * n_kept * hw + full + 4 * full + 4 * t * k + 2 * k,
              n_kept * (up + 3 * full) + full)
    # the argmax on the dirty tiles; the clean tiles copied through
    repair = (dirty_frac * (4 * n_kept * hw + full)
              + (1 - dirty_frac) * 4 * full + 4 * full + 8 * t * k + t
              + 2 * k,
              dirty_frac * argmax[1])
    return {"theta_hopper": theta, "claim_hopper": claim,
            "argmax_hopper": argmax, "repair_hopper": repair}


def phase_postproc_kernels(dev, shapes=PP_SHAPES, n_valid=PP_VALID,
                           timed=True):
    """The four postprocess kernels against their plain versions.  Integer
    outputs must be bit-identical given identical inputs; theta within
    THETA_RTOL * max(1, |theta|).  Returns {K: {kernel: row}}."""
    from slotvps_tpu_torch.ops import postproc_v3 as plain
    from slotvps_tpu_torch.ops.cuda import postproc_v3 as hv3

    out = {}
    for k, h, w in shapes:
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
                            n_dirty / dirty.numel(), dirty.numel())
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
            row = dict(kernel=name, K=k, max_abs_err=errs[name],
                       bound_ms=b_ms, bound_by=b_by)
            if timed:
                row["ms"] = _cuda_ms(kern)
                row["plain_ms"] = _cuda_ms(ref, n=5, warmup=1)
            log("kernels", json.dumps(row))
            rows[name] = row
        out[k] = rows
    return out


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


def expected_launches(cfg, results):
    """Each kernel's launches on the path, from what the frames report:
    DCN 3 blocks x levels per frame, theta and argmax one per frame, the
    claim loop one per valid thing slot plus one, repair one per
    small-area iteration."""
    n = len(results)
    return {"deform_conv2d_hopper":
            3 * cfg.model.semantic_head.num_levels * n,
            "theta_hopper": n,
            "claim_hopper": sum(r.n_claim + 1 for r in results),
            "argmax_hopper": n,
            "repair_hopper": sum(r.n_loop for r in results)}


def phase_slice(dev, cfg, h=H, w=W, n_frames=N_FRAMES, target_valid=48):
    """The main path: returns (model, frames, results, stats)."""
    from slotvps_tpu_torch.inference import InferencePipeline, run_video

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
    reset_counts()
    t0 = time.perf_counter()
    results = run_video(pipe, frames)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    want = expected_launches(cfg, results)
    for t, r in enumerate(results):
        log("slice", f"frame {t}: ladder branch {r.capacity} slots, claim "
                     f"over {r.n_claim} valid things, n_loop {r.n_loop}, "
                     f"{len(r.cls_inds)} things kept")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} on {n_frames} "
                             f"frames, want {want}")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the path: "
                             f"{missing}")
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


def phase_stages(model, cfg, frames):
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
    log("stages", "median ms/frame over frames 1..: " + json.dumps(med))

    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t, fr in enumerate(frames[:3]):
            pipe.process_frame(fr, is_first=(t == 0))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0)
        if dev_us and ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.key] = (dev_us / 1e3, ev.count)
    busy = sum(ms for ms, _ in by_name.values())
    if busy == 0:
        log("stages", "torch.profiler saw no device time")
        return med
    log("stages", f"profiler, 3 frames: device {busy:.1f} ms in {wall:.1f} "
                  f"ms wall, busy share {busy / wall:.3f} (profiler on)")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :12]:
        log("stages", f"  {ms:9.3f} ms {n:5d} x {name[:90]}")
    for kern in ("theta_kernel", "claim_kernel", "argmax_kernel"):
        hits = [(ms, n) for name, (ms, n) in by_name.items() if kern in name]
        if hits:
            ms, n = map(sum, zip(*hits))
            log("stages", f"  {kern}: {ms:.3f} ms in {n} launches over 3 "
                          "frames")
    return med


def phase_plain(model, cfg, frames, results, n_frames=2):
    """The first frames again, same weights, fully plain on the same
    device: the plain DCN and the reference postprocess; no kernel may
    launch."""
    from slotvps_tpu_torch.inference import InferencePipeline

    sh = dataclasses.replace(cfg.model.semantic_head, dcn_impl="jax")
    pp = dataclasses.replace(cfg.model.postprocess, impl="jax")
    plain_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, semantic_head=sh, postprocess=pp))
    pipe = InferencePipeline(model, plain_cfg,
                             image_size=results[0].panoptic.shape)
    before = launch_counts()
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
    if launch_counts() != before:
        raise AssertionError(f"the plain path launched kernels: "
                             f"{before} -> {launch_counts()}")


def slice_config():
    from slotvps_tpu_torch.cli.test_eval_vpq import tune_config
    from slotvps_tpu_torch.config import named_config

    return tune_config(named_config("r50_fpn_slotvps"))


def report(dcn_rows, pp_rows, stats, build_s):
    """The kernels line: the DCN per frame (sums over its 12 shapes), the
    postprocess kernels at the given K's rows."""
    b_ms, b_by = bound(sum(r["bytes"] for r in dcn_rows),
                       sum(r["ops"] for r in dcn_rows))
    kernels = [{
        "name": "deform_conv2d_hopper",
        "max_abs_err": max(r["max_abs_err"] for r in dcn_rows),
        "ms": sum(r["ms"] for r in dcn_rows),
        "plain_ms": sum(r["plain_ms"] for r in dcn_rows),
        "bound_ms": b_ms, "bound_by": b_by,
        "build_s": build_s["deform_conv"],
    }]
    for name, row in pp_rows.items():
        kernels.append(dict(
            name=name, max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], build_s=build_s["postproc_v3"]))
    for kern in kernels:
        source, replaces = KERNELS[kern["name"]]
        # no single PyTorch call computes these functions (torchvision's
        # deform_conv2d is absent; each v3 kernel fuses the x4 upsample)
        kern.update(route="cuda", source=source, replaces=replaces,
                    launches=stats["launches"][kern["name"]],
                    library_ms=None)
    return kernels


def main():
    dev, card = phase_device()
    build_s = phase_build()
    dcn_rows = phase_kernels(dev)
    pp_rows = phase_postproc_kernels(dev)
    cfg = slice_config()
    model, frames, results, stats = phase_slice(dev, cfg)
    phase_postproc(model, cfg, frames, dev)
    phase_stages(model, cfg, frames)
    phase_plain(model, cfg, frames, results)
    # the postprocess kernels' numbers at the ladder branch the clip took
    k_path = statistics.mode(r.capacity for r in results)
    if k_path not in pp_rows:
        raise AssertionError(f"the clip took ladder branch {k_path}, not "
                             f"one of the timed shapes {list(pp_rows)}")
    kernels = report(dcn_rows, pp_rows[k_path], stats, build_s)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
