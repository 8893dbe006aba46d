"""One run of one cell of the benchmark of ``slotvps_tpu_torch``.

    python3 -m vpsbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Set-up (imports, the kernel libraries from
``vpsbench/_cache/``, the weights and clips from the seed, the warm-up
call) is timed from the start of the process to the first timed call;
then the window runs the cell's mix for ``--seconds``; then, with
``--trace 1``, the profiled call and the stage pass; then the judged call
(the entry once more with the program's stage boundaries recorded); then
the program is freed, the reference judges the sampled videos
(``judge.py``) and the work is counted (``--trace 1``).  Each step is the
cell's driver's (``vpsbench/drivers/``).  Once every reader has run, the
loaded modules are checked for JAX and the JAX package; the last line of
standard output is the result.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import os  # noqa: E402

# one process with few threads: the host's thread pools (torch's, OpenMP's,
# the BLAS's) would otherwise compete with the thread that launches the
# card's work, and the runs spread with the host's load
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "slotvps_tpu")


def _cache_dirs() -> Path:
    """Every build cache of the program at fixed paths inside the
    checkout."""
    cache = HERE / "_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["SLOTVPS_COMPILE_CACHE"] = str(cache / "build")
    return cache


def forbidden_modules(names) -> list:
    """The loaded modules whose whole top-level name is JAX's or the JAX
    package's (``slotvps_tpu_torch`` is neither)."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


class Card:
    """The card a run measures: its checks and readings, in one place so
    that a test can drive a run on the CPU with a stand-in."""

    def __init__(self, chips: int):
        import torch

        if not torch.cuda.is_available():
            sys.exit("vpsbench: no CUDA device; the benchmark runs only on "
                     "the card")
        if torch.cuda.device_count() < chips:
            sys.exit(f"vpsbench: the cell needs {chips} cards, "
                     f"{torch.cuda.device_count()} present")
        self.device = torch.device("cuda:0")
        self.count = chips

    def sync(self) -> None:
        import torch

        torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        import torch

        torch.cuda.reset_peak_memory_stats(self.device)

    def peak_bytes(self) -> int:
        import torch

        return torch.cuda.max_memory_allocated(self.device)

    def free(self) -> None:
        import torch

        torch.cuda.empty_cache()

    def info(self) -> dict:
        import torch

        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(self.device),
                "count": self.count, "power_limit": _power_limit()}


def _power_limit() -> str:
    """nvidia-smi's name and power limit of the card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run_cell(bench, cell, cfg_json, mix, limits, seed: int,
             seconds: float, traced: bool, card, t_start: float,
             control: bool = False) -> dict:
    """One run of ``cell`` on ``card``: the result's fields and, for the
    window's host readings, ``"calls"``; with ``control`` also the
    control's numbers (``"control"``)."""
    from vpsbench import judge, manifest

    driver = manifest.driver(mix["driver"]).Driver(cfg_json, mix, seed,
                                                    card.device)
    driver.warm()
    card.sync()
    gc.collect()
    card.reset_peak()
    setup_s = time.perf_counter() - t_start

    window = driver.window(seconds)
    peak = card.peak_bytes()

    record = {"peaks": cfg_json["peaks"], "window": window}
    if traced:
        record.update(driver.traced())
    records = driver.judged()
    driver.release()
    gc.collect()
    card.free()
    numbers = driver.check(records, window)
    del records
    if traced:
        record["work"] = driver.work()

    metrics = {}
    if traced:
        for m in bench["per_layer"]:
            if "workloads" in m and cell["name"] not in m["workloads"]:
                continue
            value = manifest.metric_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(driver.end_to_end(window), setup_s=setup_s)
        for m in bench["end_to_end"]:
            if "workloads" in m and cell["name"] not in m["workloads"]:
                continue
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    device_info = dict(card.info(), memory_peak_bytes=peak)
    result = {"correct": judge.verdict(numbers, limits),
              "attempted": driver.attempted(window), "failed": 0,
              "metrics": metrics, "device": device_info}
    if traced:
        t = record["trace"]
        device_info["busy_s"] = t["busy_s"]
        device_info["window_s"] = t["window_s"]
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in limits}
    result["calls"] = window["calls"]
    if control:
        result["control"] = driver.control()
    return result


def _host_lines(calls) -> list:
    """The window's host readings, a line a call (streaming: a video)."""
    return [f"host call {i} wall_s {c['wall_s']:.4f} cpu_s {c['cpu_s']:.4f}"
            for i, c in enumerate(calls)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from vpsbench import manifest

    bench = manifest.benchmark()
    cell = manifest.cell(bench, args.workload)
    cfg_json = manifest.config_file(cell["config"])
    mix = manifest.traffic(cell["traffic"])
    limits = manifest.limits(cell["name"])
    _cache_dirs()
    card = Card(cell["chips"])
    import torch

    torch.set_num_threads(1)
    from slotvps_tpu_torch.utils.compile_cache import enable_compile_cache

    enable_compile_cache(os.environ["SLOTVPS_COMPILE_CACHE"])
    result = run_cell(bench, cell, cfg_json, mix, limits, args.seed,
                      args.seconds, bool(args.trace), card, _T_START)
    for line in _host_lines(result.pop("calls")):
        print(line, file=sys.stderr)
    forbidden = forbidden_modules(sys.modules)
    if forbidden:
        print(f"vpsbench: modules of JAX or the JAX package are loaded: "
              f"{forbidden}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
