#!/usr/bin/env python3
"""Postprocess stage times and the claim kernels' cost of one checkout, on
one GPU, for comparing two commits inside one card call.

Run on a machine with an NVIDIA Hopper card, once per checkout and in
turns (parent, change, change, parent):

    python3 stage_compare.py <checkout root> <label>

It imports that checkout's ``chip_smoke.py`` and port, builds the kernel
libraries, and on its seeded r50_fpn_slotvps weights and synthetic
1024x2048 clip (4 frames) prints two kinds of JSON lines:

* ``stages``: the postprocess stage of the bf16 path (impl="fused") and of
  the f32 path (impl="fused", "pallas" and "jax"): median host ms over 3
  passes of the 4 frames, each between two device synchronizes; and, from
  a torch.profiler pass over the 4 frames, the claim kernels' device ms
  and launches a frame, and the same for each postprocess kernel by name
  (``<stage>_kernels``: theta, claim, argmax, repair, sseg);
* ``call``: a postprocess wrapper on chip_smoke.py's postprocess cases
  (theta claim at K = 64 and 100; the claim scan on the K = 100 case's
  planes in the K-minor layout; argmax and repair at K = 64, the repair
  with the case's dirty tiles; sseg on chip_smoke.py's [256, 512, 19]
  logits): the CUDA-event ms of a call as chip_smoke.py times it, the
  host's ms to enqueue it, and the profiler's device ms a launch.

The card's name and power limit come with every line.
"""

import concurrent.futures
import dataclasses
import json
import os
import re
import statistics
import sys
import time


# the postprocess kernels' names (csrc/postproc_v3.cu, csrc/claim_scan.cu)
POSTPROC_KERNELS = ("theta", "claim", "argmax", "repair", "sseg")


def _short(kernel):
    """A kernel's name and template arguments from the profiler's key."""
    found = re.search(r"(\w+_kernel(<[^>]*>)?)", kernel)
    return found.group(1) if found else kernel[:60]


def stage_times(cs, torch, dev, card, label):
    from slotvps_tpu_torch.ops.cuda import (claim_scan, deform_conv,
                                            postproc_v3, slot_attention)

    libs = (deform_conv.LIBRARY, postproc_v3.LIBRARY, slot_attention.LIBRARY,
            claim_scan.LIBRARY)
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs))
    cfg, cfg32 = cs.slice_config(), cs.f32_config()
    model, frames = cs.prepare(dev, cfg, n_frames=4)
    size = frames[0].shape[1:3]
    outs = {"bf16": cs._decoder_outputs(model, cfg, frames, dev),
            "f32": cs._decoder_outputs(model, cfg32, frames, dev)}
    res = dict(kind="stages", tree=label, card=card)
    for name, path, impl in (("post_fused_bf16", "bf16", "fused"),
                             ("post_fused_f32", "f32", "fused"),
                             ("post_pallas_f32", "f32", "pallas"),
                             ("post_jax_f32", "f32", "jax")):
        base = (cfg if path == "bf16" else cfg32).model.postprocess
        pcfg = dataclasses.replace(base, impl=impl)
        for o in outs[path]:
            cs._post(o, pcfg, size)
        ms = [cs._timed(lambda o=o: cs._post(o, pcfg, size))[1]
              for _ in range(3) for o in outs[path]]
        res[name + "_ms"] = statistics.median(ms)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for o in outs[path]:
                cs._post(o, pcfg, size)
            torch.cuda.synchronize()
        by_kernel = cs._device_time_by_kernel(prof)
        claim = [(t, n) for kern, (t, n) in by_kernel.items()
                 if "claim" in kern]
        res[name + "_kernels"] = {
            _short(kern): [t / len(frames), n / len(frames)]
            for kern, (t, n) in by_kernel.items()
            if any(part in kern for part in POSTPROC_KERNELS)}
        if claim:
            t_sum, n_sum = map(sum, zip(*claim))
            res[name + "_claim_device_ms_per_frame"] = t_sum / len(frames)
            res[name + "_claim_launches_per_frame"] = n_sum / len(frames)
    print(json.dumps(res), flush=True)


def call_costs(cs, torch, dev, card, label):
    from slotvps_tpu_torch.ops import postproc_v3 as plain
    from slotvps_tpu_torch.ops.cuda import postproc_v3 as hv3
    from slotvps_tpu_torch.ops.cuda.claim_scan import claim_scan_hopper

    calls = {}
    for k in (64, 100):
        m, labels, valid, is_thing, slots, small = cs.postproc_case(
            dev, k, 256, 512, seed=k, n_valid=cs.PP_VALID)
        th = plain.theta(m, valid, 0.4)
        calls[f"claim_hopper_K{k}"] = (
            lambda m=m, th=th, labels=labels, is_thing=is_thing, valid=valid,
            slots=slots: hv3.claim_hopper(m, th, labels, is_thing, valid,
                                          0.03, slots=slots))
        if k == 64:
            keep, owner = plain.claim(m, th, labels, is_thing, valid, 0.03)
            kept = torch.where(is_thing, keep, valid)
            m1, areas = plain.argmax(m, owner, kept, is_thing)
            removed = torch.zeros_like(kept)
            removed[list(small)] = True
            dirty = ((areas > 0) & removed[None]).any(-1)
            calls["argmax_hopper_K64"] = (
                lambda m=m, owner=owner, kept=kept, is_thing=is_thing:
                hv3.argmax_hopper(m, owner, kept, is_thing))
            calls["repair_hopper_K64"] = (
                lambda m=m, owner=owner, m1=m1, kept=kept & ~removed,
                is_thing=is_thing, dirty=dirty, areas=areas:
                hv3.repair_hopper(m, owner, m1, kept, is_thing, dirty,
                                  areas))
    h, w, c = cs.SSEG_SHAPE
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((h, w, c), generator=g, device=dev) * 3
    calls["sseg_hopper"] = lambda: hv3.sseg_hopper(x)
    planes = plain.upsample_slots(m) >= th
    hwk = planes.permute(1, 2, 0).contiguous().permute(2, 0, 1)
    calls["claim_scan_hopper_K100_kminor"] = (
        lambda: claim_scan_hopper(hwk, labels, is_thing, valid, 0.03,
                                  slots=slots))
    for name, fn in calls.items():
        event_ms = cs._cuda_ms(fn, n=20, warmup=3)
        host = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        device = {kern: t / n for kern, (t, n) in
                  cs._device_time_by_kernel(prof).items()}
        print(json.dumps(dict(kind="call", tree=label, card=card, call=name,
                              event_ms=event_ms,
                              host_enqueue_ms=statistics.median(host),
                              device_ms_per_launch=device)), flush=True)


def main():
    if len(sys.argv) != 3:
        raise SystemExit("usage: stage_compare.py <checkout root> <label>")
    root = os.path.abspath(sys.argv[1])
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs

    dev, card = cs.phase_device()
    stage_times(cs, torch, dev, card, sys.argv[2])
    call_costs(cs, torch, dev, card, sys.argv[2])


if __name__ == "__main__":
    main()
