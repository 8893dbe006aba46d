"""The benchmark's own tests: ``python3 -m pytest -q vpsbench/tests``
from the root of the repo (CPU; the ``cuda`` tests skip without a card)."""

import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")
    torch.set_num_threads(4)
