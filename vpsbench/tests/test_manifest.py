"""BENCHMARK.json against the contract's form, and every file a cell
needs found by its name."""

import json
import re
import subprocess
import sys
import types

import pytest
import torch

from vpsbench import manifest, run
from vpsbench.tests import tiny
from vpsbench.tests.tiny_runs import plain_f32

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = manifest.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["vpsbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["why"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metrics_name_their_moves_and_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        moved = e2e[m["moves"]]
        assert set(m.get("workloads", cells)) <= set(
            moved.get("workloads", cells))
    assert all(0 < m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    w = manifest.cell(BENCH, cell)
    cfg = manifest.config_file(w["config"])
    conf = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert conf["file"] == f"vpsbench/configs/{w['config']}.json"
    assert cfg["source"] == conf["source"]
    assert cfg["reduced"] == conf["reduced"]
    mix = manifest.traffic(w["traffic"])
    assert hasattr(manifest.driver(mix["driver"]), "Driver")
    from vpsbench import judge

    limits = manifest.limits(cell)
    assert set(limits) == set(judge.NUMBERS)
    assert all(v >= 0 for v in limits.values())
    for m in BENCH["per_layer"]:
        if cell in m.get("workloads", [cell]):
            assert callable(manifest.metric_reader(m["name"]))


@pytest.mark.parametrize("name", ["r50_fpn_slotvps", "swinl_fpn_slotvps"])
def test_config_file_is_the_tuned_stack(name):
    """The file states the port's tune_config of the named config with the
    slot-attention kernel, every field."""
    import dataclasses

    from slotvps_tpu_torch import config as pconfig
    from slotvps_tpu_torch.cli.test_eval_vpq import tune_config

    want = tune_config(pconfig.named_config(name))
    m = want.model
    want = dataclasses.replace(want, model=dataclasses.replace(
        m, slot_head=dataclasses.replace(m.slot_head,
                                         retriever_impl="pallas")))
    assert manifest.build_config(pconfig, manifest.config_file(name)) == want


def test_config_file_refuses_unknown_keys():
    from slotvps_tpu_torch import config as pconfig

    cfg = manifest.config_file("r50_fpn_slotvps")
    cfg["config"]["model"]["hidden_width"] = 1
    with pytest.raises(ValueError):
        manifest.build_config(pconfig, cfg)


def test_forbidden_modules_by_whole_top_level_name():
    assert run.forbidden_modules(["jax.numpy", "numpy"]) == ["jax"]
    assert run.forbidden_modules(["slotvps_tpu.models.detector"]) == [
        "slotvps_tpu"]
    assert run.forbidden_modules(["jaxlib", "flax.linen"]) == ["flax",
                                                               "jaxlib"]
    assert run.forbidden_modules(["slotvps_tpu_torch.inference",
                                  "jaxtyping", "vpsbench.run"]) == []


def test_harness_imports_no_jax():
    """The harness, its drivers, readers and reference load neither JAX nor
    the JAX package (a fresh process)."""
    code = ("import sys, vpsbench.run, vpsbench.readings, vpsbench.trace, "
            "vpsbench.drivers.batched, vpsbench.drivers.stream, "
            "vpsbench.drivers.video, "
            "vpsbench.reference.pipeline, slotvps_tpu_torch.inference;"
            "from vpsbench import manifest;"
            "[manifest.metric_reader(m['name']) "
            " for m in manifest.benchmark()['per_layer']];"
            "print(vpsbench.run.forbidden_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=manifest.ROOT, check=True)
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_port():
    code = ("import sys, vpsbench.reference.pipeline, "
            "vpsbench.reference.calibration, vpsbench.cost.cost;"
            "print(sorted(n for n in sys.modules "
            "if n.split('.')[0] in ('slotvps_tpu_torch', 'slotvps_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=manifest.ROOT, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_without_a_card_fails():
    """No CUDA device: a non-zero exit and no result line."""
    code = ("import torch; torch.cuda.is_available = lambda: False;"
            "import sys; from vpsbench import run;"
            "sys.exit(run.main(['--workload', 'r50.eval_b8', '--seed', "
            "'4294967311', '--seconds', '1', '--trace', '0']))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=manifest.ROOT)
    assert out.returncode != 0
    assert "correct" not in out.stdout
    assert "no CUDA device" in out.stderr


def _main_on_the_cpu(monkeypatch, capsys, reader=None):
    """``run.main`` of a traced tiny ``r50.stream`` run with the CPU in the
    card's place; (exit code, standard output's lines, standard error)."""
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR",
                "SLOTVPS_COMPILE_CACHE"):
        monkeypatch.setenv(var, "")
    monkeypatch.setattr(run, "Card", lambda chips: tiny.CpuCard())
    cfg = plain_f32(tiny.config_json("r50_fpn_slotvps"))
    mix = tiny.mix("stream")
    monkeypatch.setattr(manifest, "config_file", lambda name: cfg)
    monkeypatch.setattr(manifest, "traffic", lambda name: mix)
    if reader is not None:
        monkeypatch.setattr(manifest, "metric_reader", reader)
    threads = torch.get_num_threads()
    try:
        rc = run.main(["--workload", "r50.stream", "--seed", "4294967311",
                       "--seconds", "0", "--trace", "1"])
    finally:
        torch.set_num_threads(threads)
    out, err = capsys.readouterr()
    return rc, out.splitlines(), err


def test_a_traced_run_prints_its_result_last(monkeypatch, capsys):
    rc, out, err = _main_on_the_cpu(monkeypatch, capsys)
    assert rc == 0
    result = json.loads(out[-1])
    assert result["correct"]
    assert "profiled_frames_per_s" in result["metrics"]
    assert list(result)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check id_miss")


def test_a_reader_that_loads_jax_stops_the_result(monkeypatch, capsys):
    """A per-layer reader that loads JAX (a stand-in module under the
    name ``jax``) runs after the window: the run exits non-zero with no
    result line and names what it found."""
    real = manifest.metric_reader

    def reader(name):
        def read(record):
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
            return real(name)(record)
        return read

    rc, out, err = _main_on_the_cpu(monkeypatch, capsys, reader)
    assert rc != 0
    assert not any(line.lstrip().startswith("{") for line in out)
    assert "['jax']" in err
