#!/usr/bin/env python3
"""Time edited copies of a wgmma kernel's source on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 kernel_variants.py slot_attention
    python3 kernel_variants.py slot_attention_f32
    python3 kernel_variants.py deform_conv
    python3 kernel_variants.py dcn_backward
    python3 kernel_variants.py dcn_f32
    python3 kernel_variants.py dcn_backward_f32
    python3 kernel_variants.py claim_scan
    python3 kernel_variants.py claim
    python3 kernel_variants.py theta
    python3 kernel_variants.py argmax
    python3 kernel_variants.py sseg
    python3 kernel_variants.py hist

A second argument names the root of another checkout (e.g. the parent
commit unpacked with ``git archive``): its copy of the kernel's source is
built too, as variant "parent", and timed in the same call, so that a
redesign is compared with the kernel it replaced on one card.  Its C
entries must take the arguments the current ones take.

Each variant is ``slotvps_tpu_torch/csrc/<kernel>.cu`` with a few text
replacements (VARIANTS below; a replacement of three strings edits the
named header of ``csrc/`` instead), compiled with the port's nvcc flags
into a temporary directory and loaded with ctypes.  Slot attention runs at
the decoder's two largest pixel counts (q [1, 100, 256], k and v [1, P, 256]
bf16; ``slot_attention_f32``: the same in f32, the f32 kernel), the bf16 DCN forward at three shapes of a 1024x2048 frame (bf16 in
and out), the bf16 DCN backward (``dcn_backward``: the same source, its
passes and their parts) at P2 and P4 of the 800x1600 training crop, B = 2,
256 -> 256; ``dcn_f32`` and ``dcn_backward_f32`` do the same for the f32
(split-TF32) forward, f32 in and out, and backward.  ``claim_scan`` runs
the persistent claim scan on binarized planes of a 1024x2048 map (K =
100, 27 valid things in slots 10-36, binarized against theta as the
postprocess does) in the K-minor layout and contiguous; ``claim`` the
theta claim at K = 64 on 256x512 low-res masks (30 valid things), slot-
major and K-minor; each variant also at chunks of 16 ("<variant>_chunk16",
by the geometry, not the source).  ``theta`` runs theta on 256x512
low-res masks at K = 64 with 40 valid slots (slot-major) and at K = 100
with every slot valid (K-minor).  ``argmax`` runs the argmax entries on
chip_smoke.py's postprocess cases (``postproc_case``: 256x512 low-res
masks, 40 valid slots, the claim loop's owner map and kept set) at K = 64
and K = 100 (``pp_argmax``), with the runner-up map at K = 64, the
small-area repair with that case's dirty tiles (``pp_repair``) and the
K-minor entry on the K-minor chain's 256x512x100 random masks
(``pp_argmax_hwk``); ``sseg`` the semantic argmax on chip_smoke.py's
[256, 512, 19] logits with ties; ``hist`` the id-map histogram on 1024x2048
maps: the argmax map of chip_smoke.py's K = 64 postprocess case, a uniform
map, random ids at K = 64 and at K = 4096.  For these three, a "wrapper"
line per case also gives the wrapper's time as chip_smoke.py takes it (CUDA events
around one call, its host prologue included), 20 wrapper calls back to
back, and the host's ms to enqueue one call.  One JSON line per (shape, variant):
CUDA-event ms (mean of 20 calls after 3; 10 after 2 for the backward)
and the error relative to the plain version (the backward: of dx, doff
and dW each; the claim loops: the entries of keep and owner that
differ; theta: relative to max(1, |theta|); argmax and sseg: the
entries of the maps and areas that differ), and for the postprocess kernels
the profiler's device ms of the kernel alone ("alone_ms").  The variants
that skip work give wrong results on purpose:
they tell where the time goes.
"""

from __future__ import annotations

import ctypes
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
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
# the three products of a k8 step in csrc/hopper.cuh's mma3 (the f32
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
}, "slot_attention_f32": {
    "as_is": [],
    # q's chunks are not copied (stale shared memory is used)
    "no_q_copy": [("    mbar_arrive_expect_tx(&full[s], Sm::stage);\n"
                   "    bulk_load(sm + s * Sm::stage,\n"
                   "              qimg + ((size_t)b * F_NCH + c) * "
                   "(Sm::q_bytes / 4), Sm::q_bytes,\n"
                   "              &full[s]);",
                   "    mbar_arrive_expect_tx(&full[s], Sm::stage - "
                   "Sm::q_bytes);")],
    "no_qk": [("        mma3<NW>(sc, ah[st], al[st],",
               "        if (st < 0) mma3<NW>(sc, ah[st], al[st],")],
    "no_pv": [("          mma3<NQ>(o[mb], vh[buf][k][mb],",
               "          if (st < 0) mma3<NQ>(o[mb], vh[buf][k][mb],")],
    # both products as one TF32 pass (hi . hi)
    "one_pass": [("hopper.cuh", _MMA3, _MMA3.split("\n")[0] + "\n")],
    "no_exp": [("expf(s_sum[r] - mx)", "(s_sum[r] - mx)")],
    # the scores' A fragments: not split (raw bits as hi, lo = 0)
    "no_k_split": [("        split_frag(v, ah[st], al[st]);",
                    "        for (int j = 0; j < 4; ++j) {\n"
                    "          ah[st][j] = __float_as_uint(v[j]);\n"
                    "          al[st][j] = 0u;\n        }")],
    # the scores' A fragments: neither loaded nor split
    "no_k_frags": [("        split_frag(v, ah[st], al[st]);",
                    "        for (int j = 0; j < 4; ++j) {\n"
                    "          ah[st][j] = st + j;\n"
                    "          al[st][j] = 0u;\n        }")],
    "no_v_split": [("          split_frag(v, vh[buf][k][mb], vl[buf][k][mb]);",
                    "          for (int j = 0; j < 4; ++j) {\n"
                    "            vh[buf][k][mb][j] = __float_as_uint(v[j]);\n"
                    "            vl[buf][k][mb][j] = 0u;\n          }")],
    # p.v's pieces are not flushed to the partial sums
    "no_flush": [("    if ((i + 1) % F_PV_FLUSH == 0 || i + 1 == n_my) {",
                  "    if (L < 0) {")],
    # p.v restarted (and flushed) every 8 tiles, or every tile
    "flush_8": [("constexpr int F_PV_FLUSH = 4;", "constexpr int F_PV_FLUSH = 8;")],
    "flush_1": [("constexpr int F_PV_FLUSH = 4;", "constexpr int F_PV_FLUSH = 1;")],
    # a ring of two chunks at NQ = 104
    "ring_2": [("NQ == 104 ? 3 : 2;", "NQ == 104 ? 2 : 2;")],
    # p's parts are not written (its split is dead code)
    "no_p_store": [("          *reinterpret_cast<uint32_t*>(s_p + off) = hi;\n"
                    "          *reinterpret_cast<uint32_t*>(s_p + Sm::p_part + "
                    "off) = lo;", "")],
    # the warpgroups do not wait for each other (wrong results)
    "no_named_sync": [("named_sync(1, F_CONS);", "")],
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
    "no_products": [("hopper.cuh", _MMA3, _MMA3.replace("  wgmma_tf32<N>(",
                                          "  if (scale_d < -1) "
                                          "wgmma_tf32<N>("))],
    # one TF32 pass (Ahi.Bhi) instead of three: the split's cost
    "one_pass": [("hopper.cuh", _MMA3, _MMA3.split("\n")[0] + "\n")],
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
    "no_products": [("hopper.cuh", _MMA3, _MMA3.replace("  wgmma_tf32<N>(",
                                          "  if (scale_d < -1) "
                                          "wgmma_tf32<N>("))],
    "one_pass": [("hopper.cuh", _MMA3, _MMA3.split("\n")[0] + "\n")],
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
# the tiled postprocess kernels (theta, argmax, sseg) share run_chunks():
# these edits of it stage nothing (stale shared memory is used)
_NO_STAGING = [
    ("  if (n_chunks > 0) {\n    st.load(list, 0, min(CH, n));\n"
     "    st.store(R[0], min(CH, n));\n  }\n", ""),
    ("    if (nc_next > 0) st.load(", "    if (nc_next < 0) st.load("),
    ("    if (nc_next > 0) st.store(", "    if (nc_next < 0) st.store(")]
# one low-res row a block (128 threads)
_ONE_ROW = [("  return hb % 2 == 0 ? 2 : 1;", "  return 1;")]


def _skip_pass(head, indent=4):
    """The pass over the staged slots whose lambda starts with ``head``
    skipped: staging alone (and what comes after the pass)."""
    pad = " " * indent
    return [(pad + "if (!inside) return;\n#pragma unroll 4\n" + head,
             pad + "if (!inside || nc >= 0) return;\n#pragma unroll 4\n"
             + head)]


VARIANTS["theta"] = {
    "as_is": [],
    "no_staging": _NO_STAGING,
    # staging alone: no thread takes the pass over the slots
    "staging_only": _skip_pass(
        "               for (int t = 0; t < nc; ++t) {\n"
        "                 float v[4];\n"
        "                 col_phases(&Rt[t][r][pr][jl], v);\n"
        "#pragma unroll\n"
        "                 for (int c = 0; c < 4; ++c) {\n"
        "                   const float d", indent=15),
    "no_exp": [("const float e = expf(-fabsf(d));",
                "const float e = -fabsf(d);")],
    # one low-res row a block (128 threads), chunks of 8 valid slots
    "one_row": [("constexpr int TH_RB = 2;", "constexpr int TH_RB = 1;")],
    "chunk8": [("constexpr int TH_CH = 16;", "constexpr int TH_CH = 8;")],
}
VARIANTS["argmax"] = {
    "as_is": [],
    "no_staging": _NO_STAGING,
    # staging alone: no thread takes the pass over the kept stuff slots
    # (the maps and areas are still written)
    "staging_only": _skip_pass(
        "    for (int t = 0; t < nc; ++t) {\n"
        "      const int k = s_list[c0 + t];"),
    # the areas are not counted: no shared or global atomics (the entry
    # still zeroes them)
    "no_atomics": [
        ("  if (one && four) {\n    if ((tid & 31) == 0) atomicAdd(",
         "  if (one && four) {\n    if (K < 0) atomicAdd("),
        ("      if (v >= 0 && (tid & 31) == __ffs(peers) - 1)\n"
         "        atomicAdd(&hist[v], __popc(peers));",
         "      if (K < 0) atomicAdd(&hist[v], __popc(peers));"),
        ("    if (hist[k]) atomicAdd(&a.areas[(size_t)t_row * K + k], "
         "hist[k]);", "    if (K < 0) a.areas[k] = hist[k];")],
    # every warp aggregates by id and pixel phase (no one-id fast path)
    "match_any_only": [("  if (one && four) {", "  if (one && four && K < 0) {")],
    # no upsampled value of the owning thing (its loads and arithmetic)
    "no_owner": [("  const bool pre = inside && kept_thing(o0) &&",
                  "  const bool pre = K < 0 && kept_thing(o0) &&"),
                 ("    if (inside && kept_thing(o)) {",
                  "    if (K < 0 && kept_thing(o)) {")],
    # at least 4 blocks an SM (64 registers a thread)
    "min_blocks4": [("__launch_bounds__(4 * RB * CW)\nargmax_kernel",
                     "__launch_bounds__(4 * RB * CW, 4)\nargmax_kernel")],
    "one_row": _ONE_ROW,
    "chunk8": [("constexpr int AM_CH = 16;", "constexpr int AM_CH = 8;")],
}
VARIANTS["sseg"] = {
    "as_is": [],
    "no_staging": _NO_STAGING,
    # staging and the map's store, no pass over the channels
    "staging_only": _skip_pass(
        "    for (int t = 0; t < nc; ++t) {\n      float v[4];\n"
        "      col_phases(&Rt[t][r][pr][jl], v);\n#pragma unroll\n"
        "      for (int c = 0; c < 4; ++c)\n"
        "        if (v[c] > best[c]) {"),
    # the int64 map not stored
    "no_store": [("  o[0] = make_longlong2(id[0], id[1]);\n"
                  "  o[1] = make_longlong2(id[2], id[3]);",
                  "  if (C < 0) {\n    o[0] = make_longlong2(id[0], id[1]);"
                  "\n    o[1] = make_longlong2(id[2], id[3]);\n  }")],
    "one_row": _ONE_ROW,
    # 16 channels a chunk (Cityscapes' 19 in two)
    "chunk16": [("constexpr int SG_CH = 20;", "constexpr int SG_CH = 16;")],
}
VARIANTS["hist"] = {
    "as_is": [],
    # no warp fast path: every thread counts its runs
    "runs_only": [("    if (one && v >= 0) {",
                   "    if (one && v >= 0 && K < 0) {")],
    # the loads and the warp's match, no shared atomics (the block sums
    # and the global atomics stay)
    "no_shared_atomics": [
        ("      if ((threadIdx.x & 31) == 0) atomicAdd(&hist[v], 32 * HN);",
         "      if (K < 0) atomicAdd(&hist[v], 32 * HN);"),
        ("          if (cur >= 0) atomicAdd(&hist[cur], cnt);",
         "          if (cur >= 0 && K < 0) atomicAdd(&hist[cur], cnt);"),
        ("      if (cur >= 0) atomicAdd(&hist[cur], cnt);\n    }",
         "      if (cur >= 0 && K < 0) atomicAdd(&hist[cur], cnt);\n    }")],
    # two 16-byte loads a thread a step (8 ids)
    "two_loads": [("constexpr int HV = 4;", "constexpr int HV = 2;")],
}
# kernel variants -> the library whose entry points they load
SOURCE = {"slot_attention": "slot_attention",
          "slot_attention_f32": "slot_attention", "deform_conv": "deform_conv",
          "dcn_backward": "deform_conv", "dcn_f32": "deform_conv",
          "dcn_backward_f32": "deform_conv", "claim_scan": "claim_scan",
          "claim": "postproc_v3", "theta": "postproc_v3",
          "argmax": "postproc_v3", "sseg": "postproc_v3",
          "hist": "postproc_v3"}
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


def build(tmp: Path, kernel: str, declare, parent: Path = None) -> dict:
    """name -> loaded library; every variant compiled at once, and the
    source of the checkout at ``parent`` as variant "parent"."""
    variants = dict(VARIANTS[kernel])
    if parent is not None:
        variants["parent"] = parent / CSRC
    procs = {}
    for name, reps in variants.items():
        var = tmp / name
        var.mkdir()
        csrc = reps if name == "parent" else CSRC
        files = {f"{name}.cu": (csrc / f"{SOURCE[kernel]}.cu").read_text()}
        files.update((h.name, h.read_text()) for h in csrc.glob("*.cuh"))
        for rep in ([] if name == "parent" else reps):
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


def run_slot_attention(libs, dev, stream, dtype=torch.bfloat16):
    entry = sa.ENTRIES[dtype]
    for n_pix in PIXELS:
        g = torch.Generator(device=dev).manual_seed(1)
        q, k, v = (torch.randn(s, generator=g, device=dev).to(dtype)
                   for s in ((1, SLOTS, 256), (1, n_pix, 256),
                             (1, n_pix, 256)))
        ref = slot_attention(q, k, v)
        grid = sa.sa_f32_grid if dtype == torch.float32 else sa.sa_grid
        n_runs = grid(1, n_pix, _sms(dev))[0]
        out = torch.empty((1, SLOTS, 256), device=dev)
        part = torch.empty(
            (sa.f32_scratch_floats(1, SLOTS, n_runs)
             if dtype == torch.float32 else n_runs * SLOTS * 256,),
            device=dev)
        for name, lib in libs.items():
            def run(lib=lib):
                rc = getattr(lib, entry)(
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


def run_theta(libs, dev, stream):
    """theta at K = 64 with 40 valid slots on 256x512 slot-major masks (the
    postprocess kernel phase's case) and at 256x512x100 K-minor masks,
    every slot valid (the K-minor chain's)."""
    g = torch.Generator(device=dev).manual_seed(5)
    for case, entry, k, n_valid in (("slot_major", "pp_theta", 64, 40),
                                    ("k_minor", "pp_theta_hwk", 100, 100)):
        m = torch.randn((k, 256, 512), generator=g, device=dev) * 4
        valid = torch.arange(k, device=dev) < n_valid
        ref = tv3.theta(m, valid, 0.4)
        mm = m if entry == "pp_theta" else m.permute(1, 2, 0).contiguous()
        valid8 = valid.to(torch.uint8)
        out = torch.empty_like(ref)
        for name, lib in libs.items():
            def run(lib=lib):
                rc = getattr(lib, entry)(mm.data_ptr(), valid8.data_ptr(),
                                         math.log(0.4), out.data_ptr(), k,
                                         256, 512, stream)
                if rc:
                    raise RuntimeError(lib.pp_error_string(rc).decode())
            ms = _ms(run)
            rel = float(((out - ref).abs() / ref.abs().clamp_min(1.0)).max())
            print(json.dumps({"case": case, "K": k, "valid": n_valid,
                              "variant": name, "ms": ms, "rel_err": rel}),
                  flush=True)


def _wrapper_line(case, fn):
    """The wrapper's time as chip_smoke.py takes it (CUDA events around
    one call, host prologue included), 20 calls back to back, and the
    host's ms to enqueue one call (median of 20)."""
    import chip_smoke

    host = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    print(json.dumps({"case": case, "variant": "wrapper",
                      "event_ms": chip_smoke._cuda_ms(fn),
                      "back_to_back_ms": _ms(fn),
                      "host_enqueue_ms": statistics.median(host)}),
          flush=True)


def _pp_variants(libs, case, call, outs, refs, zero=(), alone=False):
    """Each variant's ``call(lib)`` (one launch of a postprocess entry):
    one run on zeroed ``zero`` tensors, whose ``outs`` are held to
    ``refs`` (the entries that differ), then the mean of 20 calls and,
    with ``alone``, the profiler's device ms of the kernel alone (the
    entry's memset not counted)."""
    import chip_smoke

    for name, lib in libs.items():
        for t in zero:
            t.zero_()
        call(lib)
        torch.cuda.synchronize()
        diff = sum(int((o != r).sum()) for o, r in zip(outs, refs))
        row = {"case": case, "variant": name,
               "ms": _ms(lambda lib=lib: call(lib)), "mismatches": diff}
        if alone:
            row["alone_ms"] = chip_smoke._alone_ms(lambda lib=lib: call(lib))
        print(json.dumps(row), flush=True)


def _checked(lib, rc, entry):
    if rc:
        raise RuntimeError(f"{entry}: " + lib.pp_error_string(rc).decode())


def run_argmax(libs, dev, stream):
    """argmax, its runner-up map and repair on chip_smoke.py's postprocess
    cases at K = 64 and 100 (256x512, 40 valid), and the K-minor entry on
    the K-minor chain's random masks (256x512x100, every slot valid)."""
    import chip_smoke
    from slotvps_tpu_torch.ops import postproc_fused as tfu
    from slotvps_tpu_torch.ops.cuda import postproc_fused as pfu

    for k in (64, 100):
        m, labels, valid, is_thing, _, small = chip_smoke.postproc_case(
            dev, k, 256, 512, seed=k, n_valid=chip_smoke.PP_VALID)
        _, h, w = m.shape
        hb = tv3.tile_rows(h)
        th = tv3.theta(m, valid, 0.4)
        keep, owner = tv3.claim(m, th, labels, is_thing, valid, 0.03)
        kept = torch.where(is_thing, keep, valid)
        kept8, thing8 = kept.to(torch.uint8), is_thing.to(torch.uint8)
        r1, r2, r_areas = tv3.argmax(m, owner, kept, is_thing, top2=True)
        m_id, m2_id = torch.empty_like(r1), torch.empty_like(r1)
        areas = torch.empty_like(r_areas)
        for top2 in (False, True) if k == 64 else (False,):
            def call(lib, top2=top2):
                _checked(lib, lib.pp_argmax(
                    m.data_ptr(), owner.data_ptr(), kept8.data_ptr(),
                    thing8.data_ptr(), m_id.data_ptr(),
                    m2_id.data_ptr() if top2 else None, areas.data_ptr(), k,
                    h, w, hb, stream), "pp_argmax")
            case = f"argmax_K{k}" + ("_top2" if top2 else "")
            _pp_variants(libs, case, call,
                         (m_id, areas) + ((m2_id,) if top2 else ()),
                         (r1, r_areas) + ((r2,) if top2 else ()), (areas,))
            _wrapper_line(case, lambda top2=top2: pv3.argmax_hopper(
                m, owner, kept, is_thing, top2=top2))
        removed = torch.zeros_like(kept)
        removed[list(small)] = True
        kept_n = kept & ~removed
        dirty = ((r_areas > 0) & removed[None]).any(-1)
        q1, q_areas = tv3.repair(m, owner, r1, kept_n, is_thing, dirty,
                                 r_areas)
        kept_n8, dirty8 = kept_n.to(torch.uint8), dirty.to(torch.uint8)

        def call(lib):
            _checked(lib, lib.pp_repair(
                m.data_ptr(), owner.data_ptr(), r1.data_ptr(),
                kept_n8.data_ptr(), thing8.data_ptr(), dirty8.data_ptr(),
                r_areas.data_ptr(), m_id.data_ptr(), areas.data_ptr(), k, h,
                w, hb, stream), "pp_repair")
        case = f"repair_K{k}_dirty{int(dirty.sum())}of{dirty.numel()}"
        _pp_variants(libs, case, call, (m_id, areas), (q1, q_areas),
                     (areas,))
        _wrapper_line(case, lambda: pv3.repair_hopper(
            m, owner, r1, kept_n, is_thing, dirty, r_areas))
    h, w, k = chip_smoke.FUSED_SHAPE
    g = torch.Generator(device=dev).manual_seed(11)
    labels = torch.randint(0, 19, (k,), generator=g, device=dev)
    m = torch.randn((h, w, k), generator=g, device=dev)
    valid = torch.ones(k, dtype=torch.bool, device=dev)
    is_thing = labels > 10
    th = tfu.theta_fused(m, valid, 0.4)
    keep, owner = tfu.claim_scan_fused(m, th, labels, is_thing, valid, 0.03)
    kept = torch.where(is_thing, keep, valid)
    kept8, thing8 = kept.to(torch.uint8), is_thing.to(torch.uint8)
    r1, r_areas = tfu.argmax_areas(m, owner, kept, is_thing)
    m_id, areas = torch.empty_like(r1), torch.empty_like(r_areas)

    def call(lib):
        _checked(lib, lib.pp_argmax_hwk(
            m.data_ptr(), owner.data_ptr(), kept8.data_ptr(),
            thing8.data_ptr(), m_id.data_ptr(), areas.data_ptr(), k, h, w,
            stream), "pp_argmax_hwk")
    _pp_variants(libs, "argmax_hwk_K100", call, (m_id, areas),
                 (r1, r_areas), (areas,))
    _wrapper_line("argmax_hwk_K100", lambda: pfu.argmax_areas_hopper(
        m, owner, kept, is_thing))


def run_sseg(libs, dev, stream):
    """sseg on chip_smoke.py's [256, 512, 19] logits (a copied channel and
    a block of equal channels: ties)."""
    import chip_smoke

    h, w, c = chip_smoke.SSEG_SHAPE
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((h, w, c), generator=g, device=dev) * 3
    x[..., c - 1] = x[..., 2]
    x[: h // 8, : w // 8, :] = 0.5
    ref = tv3.sseg(x)
    out = torch.empty_like(ref)

    def call(lib):
        _checked(lib, lib.pp_sseg(x.data_ptr(), out.data_ptr(), c, h, w,
                                  stream), "pp_sseg")
    _pp_variants(libs, f"sseg_{h}x{w}x{c}", call, (out,), (ref,))
    _wrapper_line(f"sseg_{h}x{w}x{c}", lambda: pv3.sseg_hopper(x))


def run_hist(libs, dev, stream):
    """hist on 1024x2048 id maps: the argmax map of chip_smoke.py's K = 64
    postprocess case (256x512 low-res, 40 valid), a uniform map, random
    ids at K = 64 and at K = 4096; each variant's event ms and the
    profiler's device ms of the kernel alone, then the wrapper's line."""
    import chip_smoke

    m, labels, valid, is_thing, _, _ = chip_smoke.postproc_case(
        dev, 64, 256, 512, seed=64, n_valid=chip_smoke.PP_VALID)
    th = tv3.theta(m, valid, 0.4)
    keep, owner = tv3.claim(m, th, labels, is_thing, valid, 0.03)
    kept = torch.where(is_thing, keep, valid)
    argmax_map, _ = tv3.argmax(m, owner, kept, is_thing)
    g = torch.Generator(device=dev).manual_seed(5)
    n = argmax_map.numel()
    cases = {"argmax_map_K64": (argmax_map, 64),
             "uniform_K64": (torch.full((n,), 7, dtype=torch.int32,
                                        device=dev), 64),
             "random_K64": (torch.randint(0, 64, (n,), generator=g,
                                          device=dev, dtype=torch.int32), 64),
             "random_K4096": (torch.randint(0, 4096, (n,), generator=g,
                                            device=dev, dtype=torch.int32),
                              4096)}
    for case, (ids, k) in cases.items():
        ref = tv3.hist(ids, k)
        areas = torch.empty_like(ref)

        def call(lib, ids=ids, k=k, areas=areas):
            _checked(lib, lib.pp_hist(ids.data_ptr(), ids.numel(), k,
                                      areas.data_ptr(), stream), "pp_hist")
        _pp_variants(libs, case, call, (areas,), (ref,), (areas,),
                     alone=True)
        _wrapper_line(case, lambda ids=ids, k=k: pv3.hist_hopper(ids, k))


def main():
    kernel = sys.argv[1] if len(sys.argv) > 1 else "slot_attention"
    if kernel not in VARIANTS:
        raise SystemExit(f"kernel_variants: one of {sorted(VARIANTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA device")
    setup_precision()
    print(json.dumps({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()}), flush=True)
    dev = torch.device("cuda")
    mod = {"slot_attention": sa, "slot_attention_f32": sa,
           "claim_scan": cs, "claim": pv3, "theta": pv3, "argmax": pv3,
           "sseg": pv3, "hist": pv3}.get(kernel, dc)
    run = {"slot_attention": run_slot_attention,
           "slot_attention_f32": lambda libs, dev, stream: run_slot_attention(
               libs, dev, stream, torch.float32),
           "deform_conv": run_deform_conv,
           "dcn_backward": run_dcn_backward, "dcn_f32": run_dcn_f32,
           "dcn_backward_f32": run_dcn_backward_f32,
           "claim_scan": run_claim_scan, "claim": run_claim,
           "theta": run_theta, "argmax": run_argmax,
           "sseg": run_sseg, "hist": run_hist}[kernel]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp), kernel, mod._declare,
                     Path(sys.argv[2]) if len(sys.argv) > 2 else None)
        run(libs, dev, torch.cuda.current_stream().cuda_stream)


if __name__ == "__main__":
    main()
