"""Tuned-vs-exact end-to-end divergence measurement (counterpart of
``slotvps_tpu/utils/parity.py``).

The tuned stack (bf16 activations, the bf16 DCN kernel at the per-level
halos, quarter-res semantic logits on the sseg kernel, the fused
postprocess kernels with the detect-capacity prefix) has per-kernel parity
checks, but the *end-to-end* question (how often does a 1-ulp score flip
cross the sharp keep/claim thresholds, reference
vps_temporal_slots.py:606-608,685-696, at the 0.85 keep rule) needs a
whole-pipeline measurement.

:func:`tuned_vs_exact` runs the same weights through

  * the EXACT pipeline: f32 activations, the plain DCN (``dcn_impl="jax"``,
    f32 sums), full-resolution semantic logits, the reference postprocess
    (no kernel launches), and
  * the TUNED pipeline: bf16 compute, the bf16 DCN kernel at the given
    per-level halos, ``fused_sseg``, the fused postprocess kernels,

streaming several frames (each frame carries the previous frame's
features, as the serving pipeline does, so divergence compounds as it
would in production), and reports pixel agreement of the panoptic /
semantic maps, kept-set deltas and score drift.  The Retriever route is
the base configuration's in both.  ``python -m
slotvps_tpu_torch.cli.tuned_vs_exact`` runs it at 1024x2048 on the card;
``chip_smoke.py``'s tuned_vs_exact phase holds it to the bounds of the
JAX package's ``tests/test_tuned_vs_exact.py``.

The trained regime departs from the JAX package in one place: its overfit
runs with ``TRAINED_OVERFIT``.  The JAX package's recipe (``overfit``'s
defaults) keeps no thing slot confident, in either package, so that regime
would compare the stuff segments alone.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Dict, List, Tuple

import numpy as np
import torch

from slotvps_tpu_torch.models.detector import (decode_pair, extract_features,
                                               init_model)
from slotvps_tpu_torch.models.postprocess import postprocess_frame


def smooth_img(rng, h: int, w: int, scale: int = 16) -> np.ndarray:
    """Low-frequency random image (upsampled coarse noise) — spatially
    structured features, far fewer argmax ties than white noise.  Same
    recipe as the JAX package's golden suite."""
    import cv2

    coarse = rng.standard_normal((h // scale, w // scale, 3))
    img = cv2.resize(coarse.astype(np.float32), (w, h),
                     interpolation=cv2.INTER_LINEAR)
    return img + 0.05 * rng.standard_normal((h, w, 3)).astype(np.float32)


def _kept_list(res) -> List[Tuple[int, float]]:
    kept = np.asarray(res.kept, bool)
    labels = np.asarray(res.labels)[kept]
    scores = np.asarray(res.scores)[kept]
    order = np.lexsort((scores, labels))
    return list(zip(labels[order].tolist(), scores[order].tolist()))


def _match_relabel(pan_a: np.ndarray, pan_b: np.ndarray) -> np.ndarray:
    """Relabel ``pan_b``'s segment ids onto ``pan_a``'s by greedy maximum
    pixel overlap (injective).  Removes pure *rank renumbering*
    divergence — two pipelines keeping the same segments but sorting two
    near-equal scores differently get 100% matched agreement — while real
    kept-set differences still show up as disagreement."""
    a = pan_a.astype(np.int64).ravel()
    b = pan_b.astype(np.int64).ravel()
    pairs, counts = np.unique(a * (1 << 20) + b, return_counts=True)
    ids_a, ids_b = pairs >> 20, pairs & ((1 << 20) - 1)
    order = np.argsort(counts)[::-1]
    mapping: Dict[int, int] = {}
    used_a = set()
    for i in order:
        sa, sb = int(ids_a[i]), int(ids_b[i])
        if sb not in mapping and sa not in used_a:
            mapping[sb] = sa
            used_a.add(sa)
    out = pan_b.copy()
    for sb, sa in mapping.items():
        if sb != sa:
            out[pan_b == sb] = sa
    return out


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _host(res) -> SimpleNamespace:
    """The fields of a PostprocResult that the comparison reads, as numpy
    on the host (scores as f32)."""
    return SimpleNamespace(
        panoptic=_numpy(res.panoptic), sseg=_numpy(res.sseg),
        kept=_numpy(res.kept), labels=_numpy(res.labels),
        scores=_numpy(res.scores).astype(np.float32),
        n_kept=int(res.n_kept), n_things=int(res.n_things))


def compare_results(exact, tuned) -> Dict:
    """Per-frame divergence metrics between two PostprocResults."""
    exact, tuned = _host(exact), _host(tuned)
    e_pan, t_pan = exact.panoptic, tuned.panoptic
    e_sseg, t_sseg = exact.sseg, tuned.sseg
    e_kept, t_kept = _kept_list(exact), _kept_list(tuned)

    # kept-set delta: greedy label-wise matching; leftovers on either
    # side are keep-boundary flips
    drift = 0.0
    by_label: Dict[int, Tuple[List[float], List[float]]] = {}
    for lab, sc in e_kept:
        by_label.setdefault(lab, ([], []))[0].append(sc)
    for lab, sc in t_kept:
        by_label.setdefault(lab, ([], []))[1].append(sc)
    unmatched = 0
    for lab, (se, st) in by_label.items():
        n = min(len(se), len(st))
        unmatched += abs(len(se) - len(st))
        # score-sorted pairing within a label (lists already sorted)
        for i in range(n):
            drift = max(drift, abs(se[-1 - i] - st[-1 - i]))

    t_pan_matched = _match_relabel(e_pan, t_pan)
    return {
        "sseg_agreement": float((e_sseg == t_sseg).mean()),
        "pan_agreement": float((e_pan == t_pan).mean()),
        "pan_agreement_matched": float((e_pan == t_pan_matched).mean()),
        "n_kept_exact": exact.n_kept,
        "n_kept_tuned": tuned.n_kept,
        "n_things_exact": exact.n_things,
        "n_things_tuned": tuned.n_things,
        "kept_unmatched": int(unmatched),
        "max_score_drift": float(drift),
    }


def pipeline_configs(base, halos: Tuple[int, ...]):
    """(exact, tuned) model configurations of ``base`` (a ModelConfig).

    exact: f32, the plain DCN, full-res semantic logits, the reference
    postprocess.  tuned: bf16, the bf16 DCN kernel at ``halos`` (one per
    level), ``fused_sseg``, the fused postprocess.  The Retriever route
    stays ``base``'s in both."""
    sh, pp = base.semantic_head, base.postprocess
    exact = dataclasses.replace(
        base, compute_dtype="float32",
        semantic_head=dataclasses.replace(sh, dcn_impl="jax",
                                          fused_sseg=False),
        postprocess=dataclasses.replace(pp, impl="jax"))
    tuned = dataclasses.replace(
        base, compute_dtype="bfloat16",
        semantic_head=dataclasses.replace(
            sh, dcn_impl="pallas", fused_sseg=True,
            dcn_halo=tuple(halos[:sh.num_levels])),
        postprocess=dataclasses.replace(pp, impl="fused"))
    return exact, tuned


def stream_frame(model, cfg, img, ref_feats, size):
    """One streaming step of a route: the frame's features, the pair decode
    against ``ref_feats`` and the postprocess at ``size``.  Returns (the
    frame's features, its PostprocResult)."""
    cur = extract_features(model, cfg, img)
    outs = decode_pair(model, cfg, ref_feats, cur)
    post = postprocess_frame(
        outs.pred_logits[0], outs.pred_masks[0], outs.embeddings[0],
        outs.fcn_output[0], size, cfg.postprocess)
    return cur, post


# the trained regime's overfit options (``utils/synthetic.overfit``), none
# of which the JAX package's recipe sets: fg_bn calibrated to a mask-logit
# std of 2 (from ~0.006, at which every mask stays ~0.5 everywhere and no
# thing slot's dice passes ~0.15 in 150 steps), the slot queries x8 (the
# factor of ``utils/calibration.doctor_params``) and the heads at a quarter
# of the trunk's rate.  With any one or two of them the thing slots stay
# below the keep rule or give their pixels to the stuff slots
# (``overfit_probe.py``)
TRAINED_OVERFIT = dict(fg_scale=2.0, query_scale=8.0, head_lr_mult=0.25)


def _trained(exact_cfg, halos, h, w, n_frames, seed, train_steps, n_things,
             train_dcn_impl, device):
    """The trained regime: (model, frames, calib)."""
    from slotvps_tpu_torch.utils import diagnostics
    from slotvps_tpu_torch.utils.synthetic import (make_scene, overfit,
                                                   scene_frames,
                                                   scene_train_batch)

    scene = make_scene(h, w, n_things=n_things, seed=seed)
    batch = scene_train_batch(scene)
    # the overfit keeps the zero-init offset convs well inside the halos
    # (measured and asserted below), so the trained weights are valid
    # for both pipelines
    train_cfg = dataclasses.replace(
        exact_cfg, semantic_head=dataclasses.replace(
            exact_cfg.semantic_head, dcn_impl=train_dcn_impl,
            dcn_halo=halos))
    print(f"# parity: overfitting {train_steps} steps at {h}x{w} "
          f"(dcn_impl={train_dcn_impl})", flush=True)
    model = overfit(train_cfg, batch, steps=train_steps, seed=seed,
                    log_every=50, device=device, **TRAINED_OVERFIT)
    print("# parity: overfit done; measuring DCN offsets", flush=True)
    frames = [f[0] for f in scene_frames(scene, n_frames, shift=16)]
    max_off = diagnostics.measure_max_dcn_offset(
        model, exact_cfg, image=torch.from_numpy(frames[0][None]))
    # the halo contract must hold or the tuned pipeline silently clamps
    # samples the exact pipeline doesn't, which would corrupt the parity
    # number; fail loudly instead
    for lvl, (off, halo) in enumerate(zip(max_off, halos)):
        assert float(off) <= halo, (
            f"trained conv_offset head emits offsets up to "
            f"{float(off):.2f} px at level P{lvl + 2} but the tuned "
            f"pipeline's halo is {halo} px — samples would clamp; "
            f"raise the halo or shorten the overfit run")
    calib = {"scale": 1.0, "n_valid_probe": -1,
             "max_abs_offset": [round(float(v), 3) for v in max_off],
             "overfit": dict(TRAINED_OVERFIT, probe=model.probe)}
    return model, frames, calib


def _calibrated(exact_cfg, h, w, n_frames, seed, target_valid, threshold,
                device):
    """The calibrated regime: (model, frames, calib)."""
    from slotvps_tpu_torch.utils.calibration import (calibrate_class_head,
                                                     doctor_params)

    model = init_model(torch.Generator().manual_seed(seed), exact_cfg,
                       device=device)
    doctor_params(model, torch.Generator().manual_seed(seed + 1))
    rng = np.random.default_rng(seed + 2)
    frames = [smooth_img(rng, h, w) for _ in range(n_frames)]
    probe = torch.from_numpy(
        np.ascontiguousarray(frames[0][None, ::4, ::4])).to(device)
    with torch.no_grad():
        f = extract_features(model, exact_cfg, probe)
        logits = decode_pair(model, exact_cfg, f, f).pred_logits[0]
    model, calib = calibrate_class_head(
        model, logits, torch.Generator().manual_seed(seed + 3),
        target_valid=target_valid, threshold=threshold)
    return model, frames, calib


def tuned_vs_exact(
    config_name: str = "r50_fpn_slotvps",
    h: int = 1024,
    w: int = 2048,
    n_frames: int = 4,
    seed: int = 0,
    target_valid: int = 48,
    halos: Tuple[int, ...] = (2, 3, 4, 6),
    regime: str = "calibrated",
    train_steps: int = 300,
    n_things: int = 12,
    train_dcn_impl: str = "pallas",
    device="cuda",
) -> Dict:
    """Run the tuned-vs-exact comparison on ``device`` (the card unless the
    caller asks for the CPU); returns the report dict (per-frame metrics +
    aggregates), with the JAX package's keys and meanings.

    Two regimes:

    * ``calibrated`` — doctored random weights whose class head is
      rescaled so ~``target_valid`` slots *just* clear the 0.85 keep
      rule.  ADVERSARIAL by construction: the calibration multiplies the
      raw slot logits ~10-15x, so bf16 feature noise is amplified by the
      same factor and every kept score sits within noise of the boundary.
      A worst-case boundary-sensitivity bound, not a production parity
      number.
    * ``trained`` — the model overfit on a synthetic multi-object scene
      (``utils/synthetic.py``, with ``TRAINED_OVERFIT``) until its stuff
      and most of its thing slots clear the keep rule, like a production
      checkpoint.  The regime the keep/claim thresholds actually operate
      in.  A trained offset beyond its level's halo raises
      ``AssertionError``.  ``calib`` also holds the overfit's options and
      its best probe.

    Calls :func:`~slotvps_tpu_torch.utils.precision.setup_precision` first,
    so that the exact route's convolutions and GEMMs are f32, not TF32."""
    from slotvps_tpu_torch.config import named_config
    from slotvps_tpu_torch.utils.precision import setup_precision

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"tuned_vs_exact(device={str(device)!r}): CUDA is not "
            "available; pass device='cpu' to run on the CPU")
    if regime not in ("calibrated", "trained"):
        raise ValueError(f"unknown regime {regime!r}")
    setup_precision()
    base = named_config(config_name).model
    exact_cfg, tuned_cfg = pipeline_configs(base, halos)
    if regime == "trained":
        model, frames, calib = _trained(
            exact_cfg, tuned_cfg.semantic_head.dcn_halo, h, w, n_frames,
            seed, train_steps, n_things, train_dcn_impl, device)
    else:
        model, frames, calib = _calibrated(
            exact_cfg, h, w, n_frames, seed, target_valid,
            base.postprocess.threshold, device)

    per_frame = []
    with torch.no_grad():
        img0 = torch.from_numpy(frames[0][None]).to(device)
        e_feats = extract_features(model, exact_cfg, img0)
        t_feats = extract_features(model, tuned_cfg, img0)
        for t, frame in enumerate(frames):
            img = torch.from_numpy(frame[None]).to(device)
            e_feats, e_post = stream_frame(model, exact_cfg, img, e_feats,
                                           (h, w))
            t_feats, t_post = stream_frame(model, tuned_cfg, img, t_feats,
                                           (h, w))
            m = compare_results(e_post, t_post)
            m["frame"] = t
            per_frame.append(m)
            print(f"# parity: frame {t}: pan_matched="
                  f"{m['pan_agreement_matched']:.4f} kept "
                  f"{m['n_kept_exact']}/{m['n_kept_tuned']} things "
                  f"{m['n_things_exact']}/{m['n_things_tuned']}", flush=True)

    agg = {
        "pan_agreement_matched_min": min(
            m["pan_agreement_matched"] for m in per_frame),
        "pan_agreement_matched_mean": float(np.mean(
            [m["pan_agreement_matched"] for m in per_frame])),
        "sseg_agreement_min": min(m["sseg_agreement"] for m in per_frame),
        "kept_unmatched_total": sum(m["kept_unmatched"] for m in per_frame),
        "n_kept_exact_total": sum(m["n_kept_exact"] for m in per_frame),
        "max_score_drift": max(m["max_score_drift"] for m in per_frame),
        "max_n_kept_delta": max(
            abs(m["n_kept_exact"] - m["n_kept_tuned"]) for m in per_frame),
    }
    return {
        "config": config_name,
        "resolution": [h, w],
        "n_frames": n_frames,
        "threshold": base.postprocess.threshold,
        "halos": list(tuned_cfg.semantic_head.dcn_halo),
        "regime": regime,
        "train_steps": train_steps if regime == "trained" else 0,
        "calib": calib,
        "per_frame": per_frame,
        "aggregate": agg,
    }
