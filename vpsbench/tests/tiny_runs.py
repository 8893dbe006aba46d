"""Helpers of the CPU tests that drive a whole run at a tiny size."""

from __future__ import annotations

import copy
import time

from vpsbench import manifest, run
from vpsbench.tests import tiny


def plain_f32(cfg_json: dict) -> dict:
    """The file with the port on its plain routes in f32: the program then
    computes what the reference computes, so a clean run reads 0."""
    cfg = copy.deepcopy(cfg_json)
    m = cfg["config"]["model"]
    m["compute_dtype"] = "float32"
    m["semantic_head"]["dcn_impl"] = "jax"
    m["slot_head"]["retriever_impl"] = "jax"
    m["postprocess"]["impl"] = "jax"
    return cfg


def run_tiny(cell_name: str, f32_plain: bool = True, seconds: float = 0.0,
             traced: bool = False, seed: int = 2**31 + 99) -> dict:
    bench = manifest.benchmark()
    cell = manifest.cell(bench, cell_name)
    cfg = tiny.config_json(cell["config"])
    if f32_plain:
        cfg = plain_f32(cfg)
    return run.run_cell(bench, cell, cfg, tiny.mix(cell["traffic"]),
                        manifest.limits(cell_name), seed, seconds, traced,
                        tiny.CpuCard(), time.perf_counter())


def numbers(result: dict) -> dict:
    return {k: c["value"] for k, c in result["checks"].items()}

