#!/usr/bin/env python3
"""Time edited copies of a wgmma kernel's source on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 kernel_variants.py slot_attention
    python3 kernel_variants.py deform_conv

Each variant is ``slotvps_tpu_torch/csrc/<kernel>.cu`` with a few text
replacements (VARIANTS below), compiled with the port's nvcc flags into a
temporary directory and loaded with ctypes.  Slot attention runs at the
decoder's two largest pixel counts (q [1, 100, 256], k and v [1, P, 256]
bf16), the bf16 DCN forward at three shapes of a 1024x2048 frame (bf16 in
and out).  One JSON line per (shape, variant): CUDA-event ms (mean of 20
calls after 3) and the error relative to the plain version.  The variants
that skip work give wrong results on purpose: they tell where the time
goes.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from slotvps_tpu_torch.ops.cuda import deform_conv as dc
from slotvps_tpu_torch.ops.cuda import slot_attention as sa
from slotvps_tpu_torch.ops.cuda.build import NVCC_FLAGS, _nvcc
from slotvps_tpu_torch.ops.deform_conv import deform_conv2d
from slotvps_tpu_torch.ops.slot_attention import slot_attention
from slotvps_tpu_torch.utils.precision import setup_precision

CSRC = Path("slotvps_tpu_torch/csrc")
PIXELS = (131072, 32768)
SLOTS = 100
# (H, W, Cin, Cout, halo) of the DCN cases
DCN_SHAPES = ((256, 512, 256, 256, 2), (64, 128, 256, 256, 4),
              (32, 64, 256, 256, 6))
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
    "no_a_store": [("        *reinterpret_cast<uint4*>(a + p * 128 +",
                    "        if (v[0] == 12345.f)\n"
                    "        *reinterpret_cast<uint4*>(a + p * 128 +")],
    # no corner loads: the samples are formed from zeros
    "no_corner_loads": [("if (tp[i].idx[j] < 0 || c >= Cin) continue;",
                         "if (tp[i].idx[j] > -2 || c >= Cin) continue;")],
    "no_wgmma": [("        wgmma<NC, 0, 0>(acc,",
                  "        if (kk < 0) wgmma<NC, 0, 0>(acc,")],
    "two_stages": [("constexpr int F_STAGES = 4;",
                    "constexpr int F_STAGES = 2;")],
}}


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
    base = (CSRC / f"{kernel}.cu").read_text()
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, tmp)
    procs = {}
    for name, reps in VARIANTS[kernel].items():
        text = base
        for old, new in reps:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in source")
            text = text.replace(old, new)
        (tmp / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(tmp / f"{name}.so"), str(tmp / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on variant {name}:\n{out}")
        regs = [ln.split(":", 1)[1].strip() for ln in out.splitlines()
                if "registers" in ln]
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
        lib = ctypes.CDLL(str(tmp / f"{name}.so"))
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


def main():
    kernel = sys.argv[1] if len(sys.argv) > 1 else "slot_attention"
    if kernel not in VARIANTS:
        raise SystemExit(f"kernel_variants: one of {sorted(VARIANTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA device")
    setup_precision()
    dev = torch.device("cuda")
    mod = sa if kernel == "slot_attention" else dc
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp), kernel, mod._declare)
        stream = torch.cuda.current_stream().cuda_stream
        (run_slot_attention if kernel == "slot_attention"
         else run_deform_conv)(libs, dev, stream)


if __name__ == "__main__":
    main()
