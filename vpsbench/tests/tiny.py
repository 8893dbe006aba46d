"""A run of the benchmark at a size the CPU holds: the cells' files with
an R18 backbone and 128x256 frames, a CPU stand-in for the card."""

from __future__ import annotations

import copy

import torch

from vpsbench import manifest

SIZE = (256, 128)          # img_scale (w, h): the calibration's probe needs
                           # quarter-size maps of at least 32x64


def config_json(name: str = "r50_fpn_slotvps", depth: int = 18) -> dict:
    cfg = copy.deepcopy(manifest.config_file(name))
    model = cfg["config"]["model"]
    if model["backbone"] == "resnet":
        model["resnet"]["depth"] = depth
    else:
        model["swin"].update(embed_dim=32, depths=[2, 2, 2, 2],
                             num_heads=[1, 2, 4, 8])
    cfg["config"]["data"]["img_scale"] = list(SIZE)
    model["postprocess"]["detect_capacity"] = 16
    cfg["regime"]["target_valid"] = 12
    return cfg


def mix(name: str) -> dict:
    m = copy.deepcopy(manifest.traffic(name))
    m.update(videos=2, frames=3, warm_frames=2, trace_skip=1, trace_steps=1,
             stage_frames=2, check_videos=2)
    if "batch" in m:
        m["batch"] = 2
    return m


class CpuCard:
    """The card's stand-in: the CPU, nothing to wait for, no peak."""

    device = torch.device("cpu")
    count = 1

    def sync(self):
        pass

    def reset_peak(self):
        pass

    def peak_bytes(self):
        return 0

    def free(self):
        pass

    def info(self):
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "power_limit": ""}
