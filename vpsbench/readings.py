"""The readings that a cell's limits are set from (not run by the
benchmark's own runs).

    python3 -m vpsbench.readings --workload <name> --seeds 11 12 ... \\
        [--control-seeds 11 12 13] [--seconds S] [--out file.jsonl]

For each seed, one run of the cell as ``vpsbench.run`` makes it (the
window ``--seconds`` long; 0: one call) and the numbers of its judged
videos: the program's readings.  For each control seed also the
control's: the reference with its products' operands rounded to float8
e4m3 and its postprocess stack in bf16, in the program's place, on the
same videos.  One JSON line a seed."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from vpsbench import manifest, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    bench = manifest.benchmark()
    cell = manifest.cell(bench, args.workload)
    cfg_json = manifest.config_file(cell["config"])
    mix = manifest.traffic(cell["traffic"])
    limits = manifest.limits(cell["name"])
    run._cache_dirs()
    card = run.Card(cell["chips"])
    from slotvps_tpu_torch.utils.compile_cache import enable_compile_cache

    enable_compile_cache(os.environ["SLOTVPS_COMPILE_CACHE"])

    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        result = run.run_cell(bench, cell, cfg_json, mix, limits, seed,
                              args.seconds, False, card, time.perf_counter(),
                              control=seed in args.control_seeds)
        row = {"workload": args.workload, "seed": seed,
               "regime": cfg_json["regime"],
               "program": {k: c["value"]
                           for k, c in result["checks"].items()},
               "control": result.get("control")}
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
