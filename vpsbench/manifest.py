"""Everything the harness finds by name.

``BENCHMARK.json`` (at the root of the checkout) names the cells; a cell
names a configuration and a traffic mix.  Each lives in a file of its own:

* ``vpsbench/configs/<config>.json``: the configuration as it is run (the
  port's ``Config`` field for field under ``"config"``, its source, what
  was assumed, the weights' regime and the card's peaks);
* ``vpsbench/traffic/<mix>.json``: the mix's parameters, among them the
  ``"driver"`` (``vpsbench/drivers/<driver>.py``) that drives the port's
  entry with them;
* ``vpsbench/limits/<cell>.json``: the limits of the numbers that decide
  ``correct`` in that cell;
* ``vpsbench/metrics/<metric>.py``: the reader of one per-layer metric,
  ``read(record) -> float | None``.

A later cell, mix, configuration or metric is a new file and a new entry,
never an edit of one that is here.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import Any, Dict, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: Dict[str, Any], workload: str) -> Dict[str, Any]:
    """The ``workloads`` entry named ``workload``."""
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    names = [w["name"] for w in bench["workloads"]]
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {names}")


def _json(kind: str, name: str) -> Dict[str, Any]:
    path = HERE / kind / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def config_file(name: str) -> Dict[str, Any]:
    return _json("configs", name)


def traffic(name: str) -> Dict[str, Any]:
    return _json("traffic", name)


def limits(workload: str) -> Dict[str, float]:
    return _json("limits", workload)


def driver(name: str):
    return importlib.import_module(f"vpsbench.drivers.{name}")


def metric_reader(name: str):
    """``vpsbench/metrics/<name>.py``'s ``read``; a name's dots become
    underscores in the file's name."""
    return importlib.import_module(
        f"vpsbench.metrics.{name.replace('.', '_')}").read


def _rebuild(default: Any, value: Any, where: str) -> Any:
    """``value`` (parsed JSON) in the shape of ``default``: dataclasses
    field by field, lists as tuples."""
    if dataclasses.is_dataclass(default):
        if not isinstance(value, dict):
            raise ValueError(f"{where}: want an object")
        names = {f.name for f in dataclasses.fields(default)}
        unknown = set(value) - names
        if unknown:
            raise ValueError(f"{where}: unknown keys {sorted(unknown)}")
        missing = names - set(value)
        if missing:
            raise ValueError(f"{where}: missing keys {sorted(missing)}")
        return dataclasses.replace(default, **{
            k: _rebuild(getattr(default, k), v, f"{where}.{k}")
            for k, v in value.items()})
    if isinstance(value, list):
        return tuple(_rebuild(None, v, where) for v in value)
    if isinstance(value, dict):
        raise ValueError(f"{where}: unexpected object")
    return value


def build_config(config_module, cfg_json: Dict[str, Any]):
    """The ``Config`` of ``config_module`` (the port's, or the reference's
    copy) that the file's ``"config"`` states, every field of it."""
    base = config_module.named_config(cfg_json["named_config"])
    return _rebuild(base, cfg_json["config"], cfg_json["name"])


def reference_config(cfg_json: Dict[str, Any], compute_dtype: Optional[str]
                     = "float32"):
    """The reference's ``Config`` for the file, in ``compute_dtype`` (f32:
    the reference; the configuration's own dtype for the cost count) with
    the postprocess stack in f32."""
    from vpsbench.reference import config as rconfig

    cfg = build_config(rconfig, cfg_json)
    m = cfg.model
    m = dataclasses.replace(
        m, compute_dtype=compute_dtype or m.compute_dtype,
        postprocess=dataclasses.replace(m.postprocess,
                                        stack_dtype="float32"))
    return dataclasses.replace(cfg, model=m)
