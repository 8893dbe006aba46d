"""A run with the timed path broken underneath comes out not correct, for
each fault a cell of this benchmark can have, and the control (the
reference with float8 operands in the program's place) fails the limits.

The runs skip the look for a card (a CPU stand-in) and run at a tiny
size; the program runs its plain routes in f32, so a clean run reads 0
on every number and any reading comes from the fault."""

import numpy as np
import pytest
import torch

from vpsbench import judge, manifest
from vpsbench.tests import tiny
from vpsbench.tests.tiny_runs import numbers, run_tiny


@pytest.mark.parametrize("cell", ["r50.eval_b8", "r50.stream"])
def test_clean_run_is_correct(cell):
    result = run_tiny(cell, seconds=4.0)
    assert result["correct"], result["checks"]
    assert max(numbers(result).values()) == 0.0


def _altered_sseg(monkeypatch):
    """The semantic map of every second frame replaced by class 0 where it
    is produced."""
    from slotvps_tpu_torch import inference

    real = inference.finish_frame
    seen = [0]

    def finish(post, *args, **kwargs):
        res = real(post, *args, **kwargs)
        seen[0] += 1
        if seen[0] % 2 == 0:
            res = res._replace(sseg=np.zeros_like(res.sseg))
        return res

    monkeypatch.setattr(inference, "finish_frame", finish)


def _altered_panoptic(monkeypatch):
    """Every frame's panoptic map flipped left to right where it is
    produced."""
    from slotvps_tpu_torch import inference

    real = inference.finish_frame

    def finish(post, *args, **kwargs):
        res = real(post, *args, **kwargs)
        return res._replace(panoptic=np.ascontiguousarray(
            res.panoptic[:, ::-1]))

    monkeypatch.setattr(inference, "finish_frame", finish)


def _half_the_batch(monkeypatch):
    """The second half of the batch's videos answered with the first
    half's results."""
    from slotvps_tpu_torch import inference

    real = inference.BatchedVideoPipeline.run_videos

    def run_videos(self, videos):
        half = len(videos) // 2
        out = real(self, list(videos[:half]) + list(videos[:half]))
        return out[:half] + out[:half]

    monkeypatch.setattr(inference.BatchedVideoPipeline, "run_videos",
                        run_videos)


def _state_unchanged(monkeypatch):
    """The streaming step keeps its state as it was: no carried features,
    no carried tracks (every frame starts a video)."""
    from slotvps_tpu_torch import inference

    real = inference.InferencePipeline.process_frame

    def process_frame(self, img, is_first, ref_img=None):
        return real(self, img, True, ref_img)

    monkeypatch.setattr(inference.InferencePipeline, "process_frame",
                        process_frame)


FAULTS = [("r50.eval_b8", _altered_sseg), ("r50.eval_b8", _altered_panoptic),
          ("r50.eval_b8", _half_the_batch), ("r50.stream", _altered_sseg),
          ("r50.stream", _state_unchanged)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    result = run_tiny(cell, seconds=4.0)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  manifest.benchmark()["workloads"]])
def test_control_fails_the_limits(cell):
    """The reference with float8 operands and a bf16 postprocess stack, in
    the program's place, misses at least one of the cell's limits (tiny
    size, the cell's judged videos)."""
    w = manifest.cell(manifest.benchmark(), cell)
    mix = tiny.mix(w["traffic"])
    driver = manifest.driver(mix["driver"]).Driver(
        tiny.config_json(w["config"]), mix, 2**31 + 5, torch.device("cpu"))
    assert not judge.verdict(driver.control(), manifest.limits(cell))
