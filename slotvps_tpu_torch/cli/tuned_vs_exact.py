"""The tuned-vs-exact check on the card (counterpart of the JAX package's
root driver ``_tuned_vs_exact.py``): ``utils/parity.tuned_vs_exact`` at
Cityscapes resolution (1024x2048, 4 frames) in both regimes, written as
one JSON report.

  * ``trained``    — the model overfit on a synthetic multi-object scene
    (production-like score and mask statistics; the representative
    number); ``TVE_TRAIN_STEPS`` overfit steps (default 300);
  * ``calibrated`` — doctored random weights packed at the 0.85 keep
    boundary (the adversarial worst case).

Usage:
  python -m slotvps_tpu_torch.cli.tuned_vs_exact [out.json] [regimes]

``regimes`` is a comma-separated subset (default ``trained,calibrated``);
the sections it names are replaced in an existing ``out``, the others
kept.  The report records ``"backend": "cuda"`` and ``"device"``, the
card's name and power limit as ``nvidia-smi`` prints them.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

from slotvps_tpu_torch.utils.parity import tuned_vs_exact

DEFAULT_OUT = "tuned_vs_exact_cuda.json"


def card_name() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``'s
    line for the first card."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0].strip()


def main(out: str = DEFAULT_OUT, regimes: str = "trained,calibrated"):
    if not torch.cuda.is_available():
        raise SystemExit("tuned_vs_exact: torch.cuda.is_available() is false")
    report = {}
    if os.path.exists(out):
        with open(out) as fh:
            report = json.load(fh)
    report.update({"backend": "cuda", "device": card_name()})
    steps = int(os.environ.get("TVE_TRAIN_STEPS", "300"))
    for regime in regimes.split(","):
        print(f"# === regime: {regime} ===", flush=True)
        kw = {"train_steps": steps} if regime == "trained" else {}
        t0 = time.perf_counter()
        report[regime] = tuned_vs_exact(h=1024, w=2048, n_frames=4,
                                        regime=regime, **kw)
        print(json.dumps(report[regime]["aggregate"], indent=1),
              flush=True)
        print(f"# {regime}: {time.perf_counter() - t0:.1f} s", flush=True)
        # written after each regime, so a later one that fails loses
        # nothing measured before it
        with open(out, "w") as fh:
            json.dump(report, fh, indent=1)
        print(f"wrote {out}", flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:])
