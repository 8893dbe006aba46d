#!/usr/bin/env python3
"""Time edited copies of a wgmma kernel's source on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 kernel_variants.py slot_attention
    python3 kernel_variants.py deform_conv
    python3 kernel_variants.py dcn_backward
    python3 kernel_variants.py dcn_f32
    python3 kernel_variants.py dcn_backward_f32
    python3 kernel_variants.py claim_scan
    python3 kernel_variants.py claim

Each variant is ``slotvps_tpu_torch/csrc/<kernel>.cu`` with a few text
replacements (VARIANTS below; a replacement of three strings edits the
named header of ``csrc/`` instead), compiled with the port's nvcc flags
into a temporary directory and loaded with ctypes.  Slot attention runs at
the decoder's two largest pixel counts (q [1, 100, 256], k and v [1, P, 256]
bf16), the bf16 DCN forward at three shapes of a 1024x2048 frame (bf16 in
and out), the bf16 DCN backward (``dcn_backward``: the same source, its
passes and their parts) at P2 and P4 of the 800x1600 training crop, B = 2,
256 -> 256; ``dcn_f32`` and ``dcn_backward_f32`` do the same for the f32
(split-TF32) forward, f32 in and out, and backward.  ``claim_scan`` runs
the persistent claim scan on binarized planes of a 1024x2048 map (K =
100, 27 valid things in slots 10-36, binarized against theta as the
postprocess does) in the K-minor layout and contiguous; ``claim`` the
theta claim at K = 64 on 256x512 low-res masks (30 valid things), slot-
major and K-minor; each variant also at chunks of 16 ("<variant>_chunk16",
by the geometry, not the source).  One JSON line per (shape, variant):
CUDA-event ms (mean of 20 calls after 3; 10 after 2 for the backward)
and the error relative to the plain version (the backward: of dx, doff
and dW each; the claim loops: the entries of keep and owner that
differ).  The variants that skip work give wrong results on purpose:
they tell where the time goes.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from slotvps_tpu_torch.ops import postproc_v3 as tv3
from slotvps_tpu_torch.ops.claim_scan import claim_scan
from slotvps_tpu_torch.ops.cuda import claim_scan as cs
from slotvps_tpu_torch.ops.cuda import deform_conv as dc
from slotvps_tpu_torch.ops.cuda import postproc_v3 as pv3
from slotvps_tpu_torch.ops.cuda import slot_attention as sa
from slotvps_tpu_torch.ops.cuda.build import NVCC_FLAGS, _nvcc
from slotvps_tpu_torch.ops.cuda.claim_scan import claim_geometry
from slotvps_tpu_torch.ops.deform_conv import (deform_conv2d,
                                               deform_conv2d_backward)
from slotvps_tpu_torch.ops.slot_attention import slot_attention
from slotvps_tpu_torch.utils.precision import setup_precision

CSRC = Path("slotvps_tpu_torch/csrc")
PIXELS = (131072, 32768)
SLOTS = 100
# (H, W, Cin, Cout, halo) of the DCN cases
DCN_SHAPES = ((256, 512, 256, 256, 2), (64, 128, 256, 256, 4),
              (32, 64, 256, 256, 6))
# the three products of a k8 step in csrc/deform_conv.cu's mma3 (the f32
# kernels' split-TF32 product)
_MMA3 = ("  wgmma_tf32<N>(d, ah, desc128(bh, 16, 1024), scale_d);\n"
         "  wgmma_tf32<N>(d, ah, desc128(bl, 16, 1024), 1);\n"
         "  wgmma_tf32<N>(d, al, desc128(bh, 16, 1024), 1);\n")
# kernel -> variant name -> [(text in the source, its replacement)]
VARIANTS = {"slot_attention": {
    "as_is": [],
    # the softmax's normalisation as one IEEE division per slot
    "division_per_slot": [("S[4 * j + 2 * h + e] * rz",
                           "S[4 * j + 2 * h + e] / z")],
    "no_exp": [("expf(S[r] - mx)", "(S[r] - mx)")],
    "no_qk": [("      wgmma<NQ, 0, 0>(S,",
               "      if (st < 0) wgmma<NQ, 0, 0>(S,")],
    "no_pv": [("          wgmma<CHH, 1, 1>(",
               "          if (st < 0) wgmma<CHH, 1, 1>(")],
    "pv_steps_rolled": [
        ("#pragma unroll\n    for (int st = 0; st < TP / 16;",
         "#pragma unroll 1\n    for (int st = 0; st < TP / 16;")],
    "qk_pv_steps_rolled": [
        ("#pragma unroll\n    for (int st = 0; st < TP / 16;",
         "#pragma unroll 1\n    for (int st = 0; st < TP / 16;"),
        ("#pragma unroll\n    for (int st = 0; st < CH / 16;",
         "#pragma unroll 1\n    for (int st = 0; st < CH / 16;")],
    "pv_hi_part_only": [("        for (int c = 0; c < 3; ++c)\n"
                         "          wgmma<CHH",
                         "        for (int c = 0; c < 1; ++c)\n"
                         "          wgmma<CHH")],
}, "deform_conv": {
    "as_is": [],
    # the weight chunk is not copied (the ring's stale bytes are used)
    "no_weight_copy": [("        mbar_arrive_expect_tx(&full[s], NC * "
                        "128);\n        bulk_load(",
                        "        mbar_arrive(&full[s]);\n"
                        "        if (pt < 0) bulk_load(")],
    # the weight image is not rebuilt (the previous call's image is reused)
    "no_weight_image": [("  dcn_wimg_kernel<<<(n_units + 255) / 256, 256, 0, "
                         "stream>>>(",
                         "  if (n_units < 0) dcn_wimg_kernel<<<1, 256, 0, "
                         "stream>>>(")],
    "no_proxy_fence": [("      fence_proxy_async();\n"
                        "      mbar_arrive(&full[s]);",
                        "      mbar_arrive(&full[s]);")],
    "no_a_store": [("        const int p = pix[i];\n"
                    "        *reinterpret_cast<uint4*>(a + p * 128 +",
                    "        const int p = pix[i];\n"
                    "        if (v.x == 12345u)\n"
                    "        *reinterpret_cast<uint4*>(a + p * 128 +")],
    # no corner loads: the samples are formed from zeros
    "no_corner_loads": [("if (tp[i].idx[j] < 0 || c >= Cin) continue;",
                         "if (tp[i].idx[j] > -2 || c >= Cin) continue;")],
    "no_wgmma": [("        wgmma<NC, 0, 0>(acc,",
                  "        if (kk < 0) wgmma<NC, 0, 0>(acc,")],
    "two_stages": [("constexpr int F_STAGES = 4;",
                    "constexpr int F_STAGES = 2;")],
}, "dcn_backward": {
    "as_is": [],
    # whole passes skipped: the time of each pass is as_is minus its row
    "no_data_pass": [("data pass: ds and doff\n  err = ",
                      "data pass: ds and doff\n  if (nci < 0) err = ")],
    "no_dx_pass": [("nci / 32 channels a lane\n  err = ",
                    "nci / 32 channels a lane\n  if (nci < 0) err = ")],
    "no_dw_pass": [("  // 4. dW pass: one partial per split\n  err = ",
                    "  // 4. dW pass: one partial per split\n"
                    "  if (nc < 0) err = ")],
    # dx pass: no scan at all (no loads, no sums), the scan without the ds
    # loads, the scan and loads without the sums
    "dx_no_scan": [("    for (int e0 = 0; e0 < n_e; e0 += 32) {",
                    "    for (int e0 = 0; e0 < 0; e0 += 32) {")],
    "dx_no_ds_loads": [("          if (eh[u] < 0) {\n#pragma unroll\n"
                        "            for (int t = 0; t < CPL; ++t) d[u][t]",
                        "          if (eh[u] > -2) {\n#pragma unroll\n"
                        "            for (int t = 0; t < CPL; ++t) d[u][t]")],
    "dx_no_sums": [("if (col >= 0 && col < XB_COLS && m != 0.f) {",
                    "if (col >= 0 && col < XB_COLS && m != 0.f && "
                    "d[u][0] == 12345.f) {")],
    # dx pass tiles: 16 input columns a block (twice the sums a warp, a
    # window 1.5x narrower per column), 4 hits' loads in flight (2 as is)
    "dx_cols16": [("XB_COLS = 8;", "XB_COLS = 16;")],
    "dx_u4": [("XB_U = 2;", "XB_U = 4;")],
    # data pass: the producers' rounds unrolled 2 deep (1 as is)
    "data_unroll2": [("unroll 1\n      for (int r = 0; r < ROUNDS;",
                      "unroll 2\n      for (int r = 0; r < ROUNDS;")],
    # data pass: no x loads for the corner sums, no ds stores, no products
    "data_no_corner_loads": [("          if (idx[j] >= 0 && c < Cin)\n"
                              "            u[j] = load8(",
                              "          if (idx[j] >= 0 && c < 0)\n"
                              "            u[j] = load8(")],
    "data_no_ds_store": [("        if (live && c < Cin) {\n"
                          "          bf16* dst = ds",
                          "        if (live && c < 0) {\n"
                          "          bf16* dst = ds")],
    "data_no_wgmma": [("          wgmma<NCI, 0, 0>(acc,",
                       "          if (st < 0) wgmma<NCI, 0, 0>(acc,")],
    # dW pass: no corner loads (samples from zeros), no g copies (the
    # ring's stale g), no products
    "dw_no_corner_loads": [("          un[i][j] = load8(x + (img_n + tp[i]",
                            "          if (c < 0) un[i][j] = "
                            "load8(x + (img_n + tp[i]")],
    "dw_no_g_copy": [
        ("        mbar_arrive_expect_tx(&full[s], n_box * FM * 128);\n"
         "        for (int bx = 0; bx < n_box; ++bx)",
         "        mbar_arrive(&full[s]);\n"
         "        for (int bx = 0; bx < 0; ++bx)")],
    "dw_no_wgmma": [("        wgmma<NC, 1, 1>(acc,",
                     "        if (st < 0) wgmma<NC, 1, 1>(acc,")],
}, "dcn_f32": {
    "as_is": [],
    # no corner loads: the samples are formed from zeros
    "no_corner_loads": [("un[i][j] = load4(x + (img + tp[i].idx[j])",
                         "if (c < 0) un[i][j] = load4(x + (img + "
                         "tp[i].idx[j])")],
    # no products: the three TF32 wgmma of each k8 step skipped
    "no_products": [(_MMA3, _MMA3.replace("  wgmma_tf32<N>(",
                                          "  if (scale_d < -1) "
                                          "wgmma_tf32<N>("))],
    # one TF32 pass (Ahi.Bhi) instead of three: the split's cost
    "one_pass": [(_MMA3, _MMA3.split("\n")[0] + "\n")],
    # the accumulators restarted every 8 chunks (a tap at Cin 256) or
    # every 9 * Cin (never), 1 as is: accuracy against the sums' cost
    "flush_8": [("constexpr int TF_FLUSH = 1;", "constexpr int TF_FLUSH = 8;")],
    "flush_never": [("constexpr int TF_FLUSH = 1;",
                     "constexpr int TF_FLUSH = 1 << 20;")],
    # the weight image's two parts not copied (the ring's stale bytes)
    "no_weight_copy": [("        mbar_arrive_expect_tx(&full[s], 2 * NC * "
                        "128);\n        bulk_load(dst, src, NC * 128, "
                        "&full[s]);\n        bulk_load(",
                        "        mbar_arrive(&full[s]);\n"
                        "        if (pt < 0) bulk_load(dst, src, NC * 128, "
                        "&full[s]);\n        if (pt < 0) bulk_load(")],
}, "dcn_backward_f32": {
    "as_is": [],
    # whole passes skipped: the time of each pass is as_is minus its row
    "no_data_pass": [("data pass: ds and doff\n  err = nci == 64 ? "
                      "launch_data_f32",
                      "data pass: ds and doff\n  if (nci < 0) err = "
                      "nci == 64 ? launch_data_f32")],
    "no_dx_pass": [("  err = launch_dx_all<float>(",
                    "  if (nci < 0) err = launch_dx_all<float>(")],
    "no_dw_pass": [("  err = nc == 64 ? launch_dw_f32",
                    "  if (nc < 0) err = nc == 64 ? launch_dw_f32")],
    "no_g_split": [("  dcn_gsplit_kernel<<<", "  if (HW < 0) "
                    "dcn_gsplit_kernel<<<")],
    "no_products": [(_MMA3, _MMA3.replace("  wgmma_tf32<N>(",
                                          "  if (scale_d < -1) "
                                          "wgmma_tf32<N>("))],
    "one_pass": [(_MMA3, _MMA3.split("\n")[0] + "\n")],
    # data pass: no x loads for the corner sums, no ds stores
    "data_no_corner_loads": [("            if (idx[j] >= 0 && c + 4 * h < "
                              "Cin)\n              v = load4(",
                              "            if (idx[j] >= 0 && c + 4 * h < "
                              "0)\n              v = load4(")],
    "data_no_ds_store": [("          if (vec_ds && col + 1 < nlim) {\n"
                          "            *reinterpret_cast<float2*>(row + col)",
                          "          if (vec_ds && col + 1 < -nlim) {\n"
                          "            *reinterpret_cast<float2*>(row + col)"
                          ), ("            if (col < nlim) row[col] = v0;\n"
                              "            if (col + 1 < nlim)",
                              "            if (col < -nlim) row[col] = v0;\n"
                              "            if (col + 1 < -nlim)")],
    # dW pass: no corner loads (samples from zeros); the accumulators
    # flushed to the partial every 64 runs (16 as is: the flushes' cost)
    "dw_no_corner_loads": [("un[i][j] = load4(x + (img_n + tp[i].idx[j])",
                            "if (c < 0) un[i][j] = load4(x + (img_n + "
                            "tp[i].idx[j])")],
    "dw_flush_64": [("constexpr int TW_FLUSH = 16;",
                     "constexpr int TW_FLUSH = 64;")],
}, "claim_scan": {
    "as_is": [],
    # no pixel work: no bits pass, no claim or count a step; the steps'
    # barriers and decisions (every slot rejected: n = 0) remain
    "barriers_only": [
        ("claim_loop.cuh", "      build(st, nbits);\n"
         "      count_chunk(a, s, st, nbits);",
         "      if (nbits < 0) {\n        build(st, nbits);\n"
         "        count_chunk(a, s, st, nbits);\n      }"),
        ("claim_loop.cuh", "    claim_and_count(a, s, t > 0 ? t - 1 : -1, st, t);",
         "    if (st < 0) claim_and_count(a, s, t > 0 ? t - 1 : -1, st, t);")],
    # the bits pass and its counts, no claim or count a step
    "bits_only": [
        ("claim_loop.cuh", "    claim_and_count(a, s, t > 0 ? t - 1 : -1, st, t);",
         "    if (st < 0) claim_and_count(a, s, t > 0 ? t - 1 : -1, st, t);")],
}}
VARIANTS["claim"] = VARIANTS["claim_scan"]
# kernel variants -> the library whose entry points they load
SOURCE = {"slot_attention": "slot_attention", "deform_conv": "deform_conv",
          "dcn_backward": "deform_conv", "dcn_f32": "deform_conv",
          "dcn_backward_f32": "deform_conv", "claim_scan": "claim_scan",
          "claim": "postproc_v3"}
# (B, H, W, Cin, Cout, halo) of the backward's cases: P2 and P4 of the
# 800x1600 training crop (the reference and the current frame)
BWD_SHAPES = ((2, 200, 400, 256, 256, 2), (2, 50, 100, 256, 256, 4))


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _ms(fn, n=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def build(tmp: Path, kernel: str, declare) -> dict:
    """name -> loaded library; every variant compiled at once."""
    base = (CSRC / f"{SOURCE[kernel]}.cu").read_text()
    procs = {}
    for name, reps in VARIANTS[kernel].items():
        var = tmp / name
        var.mkdir()
        files = {f"{name}.cu": base}
        files.update((h.name, h.read_text()) for h in CSRC.glob("*.cuh"))
        for rep in reps:
            where, old, new = rep if len(rep) == 3 else (f"{name}.cu", *rep)
            if old not in files[where]:
                raise SystemExit(f"variant {name}: {old!r} not in {where}")
            files[where] = files[where].replace(old, new)
        for fname, text in files.items():
            (var / fname).write_text(text)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(var / f"{name}.so"), str(var / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on variant {name}:\n{out}")
        regs = [ln.split(":", 1)[1].strip() for ln in out.splitlines()
                if "registers" in ln]
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
        lib = ctypes.CDLL(str(tmp / name / f"{name}.so"))
        declare(lib)
        libs[name] = lib
    return libs


def run_slot_attention(libs, dev, stream):
    for n_pix in PIXELS:
        g = torch.Generator(device=dev).manual_seed(1)
        q, k, v = (torch.randn(s, generator=g, device=dev)
                   .to(torch.bfloat16)
                   for s in ((1, SLOTS, 256), (1, n_pix, 256),
                             (1, n_pix, 256)))
        ref = slot_attention(q, k, v)
        n_runs = sa.sa_grid(1, n_pix, _sms(dev))[0]
        out = torch.empty((1, SLOTS, 256), device=dev)
        part = torch.empty((1, n_runs, SLOTS, 256), device=dev)
        for name, lib in libs.items():
            def run(lib=lib):
                rc = lib.sa_forward_bf16(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), part.data_ptr(), 1, SLOTS, n_pix,
                    n_runs, stream)
                if rc:
                    raise RuntimeError(lib.sa_error_string(rc).decode())
            ms = _ms(run)
            rel = float((out - ref).abs().max() / ref.abs().max())
            print(json.dumps({"P": n_pix, "variant": name, "ms": ms,
                              "rel_err": rel}), flush=True)


def run_deform_conv(libs, dev, stream):
    for h, w, c_in, c_out, halo in DCN_SHAPES:
        g = torch.Generator(device=dev).manual_seed(2)
        x = torch.randn((1, h, w, c_in), generator=g, device=dev)
        off = torch.randn((1, h, w, 18), generator=g, device=dev) * halo
        wt = torch.randn((3, 3, c_in, c_out), generator=g, device=dev) \
            / (9 * c_in) ** 0.5
        x, wt = x.to(torch.bfloat16), wt.to(torch.bfloat16)
        ref = deform_conv2d(x, off, wt, padding=1, max_displacement=halo,
                            compute_dtype=torch.bfloat16).float()
        geo = dc.bf16_forward_geometry(h, w, c_out, _sms(dev))
        wimg = torch.empty((geo.wimg_elems(c_in),), dtype=torch.bfloat16,
                           device=dev)
        out = torch.empty((1, h, w, c_out), dtype=torch.bfloat16, device=dev)
        for name, lib in libs.items():
            def run(lib=lib):
                rc = lib.dcn_forward_bf16(
                    x.data_ptr(), off.data_ptr(), wt.data_ptr(),
                    wimg.data_ptr(), out.data_ptr(), 0, 1, h, w, c_in, c_out,
                    halo, geo.tile_h, geo.tile_w, geo.n_tile, stream)
                if rc:
                    raise RuntimeError(lib.dcn_error_string(rc).decode())
            ms = _ms(run)
            rel = float((out.float() - ref).abs().max() / ref.abs().max())
            print(json.dumps({"shape": [h, w, c_in, c_out], "variant": name,
                              "ms": ms, "rel_err": rel}), flush=True)


def run_dcn_f32(libs, dev, stream):
    for h, w, c_in, c_out, halo in DCN_SHAPES:
        g = torch.Generator(device=dev).manual_seed(2)
        x = torch.randn((1, h, w, c_in), generator=g, device=dev)
        off = torch.randn((1, h, w, 18), generator=g, device=dev) * halo
        wt = torch.randn((3, 3, c_in, c_out), generator=g, device=dev) \
            / (9 * c_in) ** 0.5
        ref = deform_conv2d(x, off, wt, padding=1, max_displacement=halo)
        geo = dc.f32_forward_geometry(h, w, c_out, _sms(dev))
        # the as-is source also at 128 output channels a block (one
        # consumer warpgroup, 4 stages; each sample gathered twice)
        runs = [(name, lib, geo) for name, lib in libs.items()]
        if geo.n_tile == 256:
            runs.append(("as_is_nc128", libs["as_is"], geo._replace(
                n_tile=128, n_ctiles=-(-c_out // 128))))
        out = torch.empty((1, h, w, c_out), device=dev)
        for name, lib, geo in runs:
            wimg = torch.empty((geo.wimg_elems(c_in),), device=dev)

            def run(lib=lib, geo=geo, wimg=wimg):
                rc = lib.dcn_forward_f32(
                    x.data_ptr(), off.data_ptr(), wt.data_ptr(),
                    wimg.data_ptr(), out.data_ptr(), 1, h, w, c_in, c_out,
                    halo, geo.tile_h, geo.tile_w, geo.n_tile, stream)
                if rc:
                    raise RuntimeError(lib.dcn_error_string(rc).decode())
            ms = _ms(run)
            rel = float((out - ref).abs().max() / ref.abs().max())
            print(json.dumps({"shape": [h, w, c_in, c_out], "variant": name,
                              "ms": ms, "rel_err": rel}), flush=True)


def run_dcn_backward_f32(libs, dev, stream):
    for b, h, w, c_in, c_out, halo in BWD_SHAPES:
        g = torch.Generator(device=dev).manual_seed(3)
        x = torch.randn((b, h, w, c_in), generator=g, device=dev)
        off = torch.randn((b, h, w, 18), generator=g, device=dev) * halo
        wt = torch.randn((3, 3, c_in, c_out), generator=g, device=dev) \
            / (9 * c_in) ** 0.5
        gout = torch.randn((b, h, w, c_out), generator=g, device=dev)
        ref = deform_conv2d_backward(x, off, wt, gout, halo, torch.float32)
        geo = dc.f32_backward_geometry(b, h, w, c_in, c_out, _sms(dev))
        outs = (torch.empty((b, h, w, c_in), device=dev),
                torch.empty((b, h, w, 18), device=dev),
                torch.empty((3, 3, c_in, c_out), device=dev))
        wimg = torch.empty((geo.wimg_elems(c_out),), device=dev)
        gt = torch.empty((geo.gt_elems(b, h, w, c_out),), device=dev)
        ds = torch.empty((b * h * w * 9 * c_in,), device=dev)
        part = torch.empty((geo.part_elems(c_in, c_out),), device=dev)
        for name, lib in libs.items():
            for t in outs:
                t.zero_()

            def run(lib=lib):
                rc = lib.dcn_backward_f32(
                    x.data_ptr(), off.data_ptr(), wt.data_ptr(),
                    gout.data_ptr(), wimg.data_ptr(), gt.data_ptr(),
                    outs[0].data_ptr(), outs[1].data_ptr(), ds.data_ptr(),
                    part.data_ptr(), outs[2].data_ptr(), b, h, w, c_in,
                    c_out, c_out, halo, geo.tile_h, geo.tile_w, geo.splits,
                    stream)
                if rc:
                    raise RuntimeError(lib.dcn_error_string(rc).decode())
            ms = _ms(run, n=10, warmup=2)
            rel = {n: float((o - r).abs().max() / r.abs().max())
                   for n, o, r in zip(("dx", "doff", "dW"), outs, ref)}
            print(json.dumps({"shape": [b, h, w, c_in, c_out, halo],
                              "variant": name, "ms": ms, "rel_err": rel}),
                  flush=True)


def run_dcn_backward(libs, dev, stream):
    for b, h, w, c_in, c_out, halo in BWD_SHAPES:
        g = torch.Generator(device=dev).manual_seed(3)
        x = torch.randn((b, h, w, c_in), generator=g, device=dev)
        off = torch.randn((b, h, w, 18), generator=g, device=dev) * halo
        wt = torch.randn((3, 3, c_in, c_out), generator=g, device=dev) \
            / (9 * c_in) ** 0.5
        gout = torch.randn((b, h, w, c_out), generator=g, device=dev)
        x, wt, gout = (t.to(torch.bfloat16) for t in (x, wt, gout))
        ref = deform_conv2d_backward(x, off, wt, gout, halo, torch.bfloat16)
        geo = dc.bf16_backward_geometry(b, h, w, c_in, c_out, _sms(dev))
        outs = (torch.empty((b, h, w, c_in), device=dev),
                torch.empty((b, h, w, 18), device=dev),
                torch.empty((3, 3, c_in, c_out), device=dev))
        wimg = torch.empty((geo.wimg_elems(c_out),), dtype=torch.bfloat16,
                           device=dev)
        ds = torch.empty((b * h * w * 9 * c_in,), dtype=torch.bfloat16,
                         device=dev)
        part = torch.empty((geo.part_elems(c_in, c_out),), device=dev)
        for name, lib in libs.items():
            for t in outs:
                t.zero_()

            def run(lib=lib):
                rc = lib.dcn_backward_bf16(
                    x.data_ptr(), off.data_ptr(), wt.data_ptr(),
                    gout.data_ptr(), wimg.data_ptr(), outs[0].data_ptr(),
                    outs[1].data_ptr(), ds.data_ptr(), part.data_ptr(),
                    outs[2].data_ptr(), b, h, w, c_in, c_out, c_out, halo,
                    geo.tile_h, geo.tile_w, geo.splits, stream)
                if rc:
                    raise RuntimeError(lib.dcn_error_string(rc).decode())
            ms = _ms(run, n=10, warmup=2)
            rel = {n: float((o - r).abs().max() / r.abs().max())
                   for n, o, r in zip(("dx", "doff", "dW"), outs, ref)}
            print(json.dumps({"shape": [b, h, w, c_in, c_out, halo],
                              "variant": name, "ms": ms, "rel_err": rel}),
                  flush=True)


def _claim_inputs(dev, k, h, w, n_valid, n_stuff, seed):
    """Seeded low-res masks [K, h, w] in the postprocess's slot order
    (valid stuff, valid things, invalid), theta at 0.4, and the vectors."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(seed)
    coarse = torch.randn((1, k, h // 16, w // 16), generator=g,
                         device=dev) * 4
    m = F.interpolate(coarse, size=(h, w), mode="bilinear",
                      align_corners=False)[0]
    m = (m + torch.randn((k, h, w), generator=g, device=dev) * 0.5) \
        .contiguous()
    labels = torch.randint(11, 19, (k,), generator=g, device=dev)
    labels[:n_stuff] = torch.randint(0, 11, (n_stuff,), generator=g,
                                     device=dev)
    valid = torch.arange(k, device=dev) < n_valid
    theta = tv3.theta(m, valid, 0.4)
    return m, theta, labels, labels > 10, valid


def _claim_run(libs, entry, args, geo, stream, outs, ref, case):
    """Time each variant's ``entry`` (one video) at ``geo`` and at chunks
    of 16."""
    owner, keep = outs
    counts = torch.empty((3 * keep.shape[-1],), dtype=torch.int32,
                         device=owner.device)
    for name, lib in libs.items():
        for suffix, g in (("", geo), ("_chunk16", geo._replace(chunk=16))):
            group = (g.group,) if entry == "cs_claim_scan" else ()

            def run(lib=lib, g=g, group=group):
                rc = getattr(lib, entry)(
                    *args, g.blocks, g.run, g.chunk, int(g.own_smem),
                    int(g.bits_smem), *group, owner.data_ptr(),
                    keep.data_ptr(), counts.data_ptr(), None, stream)
                if rc:
                    raise RuntimeError(f"{entry}: " + (
                        lib.cs_error_string if entry == "cs_claim_scan"
                        else lib.pp_error_string)(rc).decode())
            ms = _ms(run)
            diff = int((keep != ref[0]).sum()) \
                + int((owner != ref[1]).sum())
            print(json.dumps({"case": case, "variant": name + suffix,
                              "ms": ms, "mismatches": diff}), flush=True)


def run_claim_scan(libs, dev, stream):
    m, theta, labels, is_thing, valid = _claim_inputs(dev, 100, 256, 512,
                                                      37, 10, 4)
    planes = (tv3.upsample_slots(m) >= theta)[None]
    del m, theta
    k, h, w = planes.shape[1:]
    ref = claim_scan(planes, labels[None], is_thing[None], valid[None],
                     0.03)
    geo = claim_geometry(1, h, w, k, _sms(dev))
    owner = torch.empty((1, h, w), dtype=torch.int8, device=dev)
    keep = torch.empty((1, k), dtype=torch.bool, device=dev)
    hwk = planes.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    for case, p in (("k_minor", hwk), ("contiguous", planes)):
        sb, sk, _, sp = p.stride()
        args = (p.data_ptr(), sb, sk, sp, labels.data_ptr(),
                valid.data_ptr(), is_thing.data_ptr(), 0.03, 1, k, h * w, 10,
                37)
        _claim_run(libs, "cs_claim_scan", args, geo, stream, (owner, keep),
                   ref, case)


def run_claim(libs, dev, stream):
    m, theta, labels, is_thing, valid = _claim_inputs(dev, 64, 256, 512, 40,
                                                      10, 4)
    k, h, w = m.shape
    ref = tv3.claim(m, theta, labels, is_thing, valid, 0.03)
    geo = claim_geometry(1, 4 * h, 4 * w, k, _sms(dev),
                         stage=pv3.CLAIM_STAGE)
    owner = torch.empty((4 * h, 4 * w), dtype=torch.int8, device=dev)
    keep = torch.empty((k,), dtype=torch.bool, device=dev)
    m_hwk = m.permute(1, 2, 0).contiguous()
    for case, entry, mm in (("slot_major", "pp_claim", m),
                            ("k_minor", "pp_claim_hwk", m_hwk)):
        args = (mm.data_ptr(), theta.data_ptr(), labels.data_ptr(),
                valid.data_ptr(), is_thing.data_ptr(), 0.03, k, h, w, 10, 40)
        _claim_run(libs, entry, args, geo, stream, (owner, keep), ref, case)


def main():
    kernel = sys.argv[1] if len(sys.argv) > 1 else "slot_attention"
    if kernel not in VARIANTS:
        raise SystemExit(f"kernel_variants: one of {sorted(VARIANTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA device")
    setup_precision()
    dev = torch.device("cuda")
    mod = {"slot_attention": sa, "claim_scan": cs,
           "claim": pv3}.get(kernel, dc)
    run = {"slot_attention": run_slot_attention,
           "deform_conv": run_deform_conv,
           "dcn_backward": run_dcn_backward, "dcn_f32": run_dcn_f32,
           "dcn_backward_f32": run_dcn_backward_f32,
           "claim_scan": run_claim_scan, "claim": run_claim}[kernel]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp), kernel, mod._declare)
        run(libs, dev, torch.cuda.current_stream().cuda_stream)


if __name__ == "__main__":
    main()
