#!/usr/bin/env python3
"""The trained regime of the tuned-vs-exact check under variants of the
overfit recipe, with what each ground-truth slot learns on the way.

Run on a machine with an NVIDIA Hopper card (``--device cpu`` for a small
run on the host):

    python3 overfit_probe.py [--size H W] [--steps N] [--things N]
        [--seed S] [--every N] [--out FILE] VARIANT...

A VARIANT is ``name`` or ``name:key=value,...`` with keys of
``utils/synthetic.overfit`` (``query_scale``, ``head_lr_mult``, ``lr``,
``fg_scale``; ``none`` for None): the overfit's options, each in place of
the trained regime's (``utils/parity.TRAINED_OVERFIT``).  So ``regime`` is
the recipe as the trained regime runs it, and
``jax:fg_scale=none,query_scale=1,head_lr_mult=1`` the JAX package's.  For
each variant ``utils/parity.tuned_vs_exact(regime="trained")`` runs at the
given size on 2 frames, its overfit with the variant's options, and every
``--every`` steps the current frame is decoded against itself (no autograd)
to read, for each ground-truth segment i (fixed match: slot i), the softmax
probability of its class, the dice of slot i's sigmoid mask, and slot i's
mean mask logit inside and outside the segment.  One JSON line a variant
goes to ``--out`` (the card's name and power limit, the trace, the probe,
the kept and thing counts a frame of both routes, the aggregates); a
summary line a variant to standard output.
"""

import argparse
import json
import subprocess
import sys
import time

import torch


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not measured"


def _variant(text):
    name, _, rest = text.partition(":")
    kw = {}
    for item in filter(None, rest.split(",")):
        key, _, value = item.partition("=")
        kw[key] = None if value == "none" else float(value)
    return name, kw


def _trace_step(model, cfg, batch, n_gt, step, metrics):
    """What each ground-truth slot holds after ``step``."""
    from slotvps_tpu_torch.models.detector import (decode_pair,
                                                   extract_features)
    from slotvps_tpu_torch.training.losses import dice_similarity

    with torch.no_grad():
        f = extract_features(model, cfg, batch.img)
        o = decode_pair(model, cfg, f, f)
        probs = torch.softmax(o.pred_logits[0].float(), -1)
        masks = o.pred_masks[0].float()
        gt = batch.gt_masks[0][:n_gt]
        idx = torch.arange(n_gt, device=probs.device)
        p_gt = probs[idx, batch.gt_labels[0][:n_gt].long()]
        dice = dice_similarity(masks[:n_gt], gt)[idx, idx]
        inside = gt > 0
        m_in = [float(masks[i][inside[i]].mean()) for i in range(n_gt)]
        m_out = [float(masks[i][~inside[i]].mean()) for i in range(n_gt)]
        rnd = lambda xs: [round(float(x), 4) for x in xs]
        return dict(step=step,
                    loss={k[5:]: round(float(v), 4)
                          for k, v in metrics.items()},
                    p_gt=rnd(p_gt), dice=rnd(dice), m_in=rnd(m_in),
                    m_out=rnd(m_out), argmax=probs[:n_gt].argmax(-1)
                    .tolist(), mask_std=float(masks.std()),
                    fg_weight=float(model.fg_bn.weight[0]))


def run_variant(name, kw, args, card):
    from slotvps_tpu_torch.training import step as train_mod
    from slotvps_tpu_torch.utils import parity, synthetic

    trace, held = [], {}
    base_step, base_overfit = train_mod.train_step, synthetic.overfit

    def traced_step(model, opt, batch, cfg, **k):
        metrics = base_step(model, opt, batch, cfg, **k)
        held["n"] = held.get("n", 0) + 1
        if held["n"] == 1 or held["n"] % args.every == 0:
            trace.append(_trace_step(model, cfg, batch,
                                     int(batch.gt_valid.sum()), held["n"],
                                     metrics))
        return metrics

    def overfit(cfg, batch, **k):
        model = base_overfit(cfg, batch, **{**k, **kw})
        held["probe"] = model.probe
        return model

    train_mod.train_step, synthetic.overfit = traced_step, overfit
    t0 = time.perf_counter()
    try:
        report = parity.tuned_vs_exact(
            h=args.size[0], w=args.size[1], n_frames=2, seed=args.seed,
            regime="trained", train_steps=args.steps, n_things=args.things,
            train_dcn_impl="pallas" if args.device == "cuda" else "jax",
            device=args.device)
        error = None
    except AssertionError as e:   # the halo contract
        report, error = None, str(e)
    finally:
        train_mod.train_step, synthetic.overfit = base_step, base_overfit
    row = dict(variant=name, kw=kw, card=card, size=args.size,
               steps=args.steps, things=args.things, seed=args.seed,
               wall_s=time.perf_counter() - t0, probe=held.get("probe"),
               error=error, trace=trace)
    if report is not None:
        pf = report["per_frame"]
        row.update(
            kept_exact=[m["n_kept_exact"] for m in pf],
            kept_tuned=[m["n_kept_tuned"] for m in pf],
            things_exact=[m["n_things_exact"] for m in pf],
            things_tuned=[m["n_things_tuned"] for m in pf],
            max_abs_offset=report["calib"]["max_abs_offset"],
            aggregate=report["aggregate"])
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="+")
    ap.add_argument("--size", type=int, nargs=2, default=(256, 512))
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--things", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--every", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="chiprun_out/overfit_probe.jsonl")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("overfit_probe.py: CUDA is not available "
                 "(pass --device cpu for a run on the host)")
    card = _card() if args.device == "cuda" else "cpu"
    print(card, flush=True)
    for text in args.variants:
        name, kw = _variant(text)
        row = run_variant(name, kw, args, card)
        with open(args.out, "a") as fh:
            fh.write(json.dumps(row) + "\n")
        last = row["trace"][-1] if row["trace"] else {}
        print(json.dumps(dict(
            variant=name, kw=kw, seed=args.seed,
            wall_s=round(row["wall_s"], 1),
            probe=row["probe"], error=row["error"],
            kept_exact=row.get("kept_exact"),
            things_exact=row.get("things_exact"),
            kept_tuned=row.get("kept_tuned"),
            aggregate=row.get("aggregate"), last_dice=last.get("dice"),
            last_p_gt=last.get("p_gt"))), flush=True)


if __name__ == "__main__":
    main()
