"""Seeded synthetic video, made on the device in bulk.

The recipe of ``chip_smoke.py``'s ``make_clip``: each video is a grid of
32-px blocks of random colour, panning 16 px a frame, with uniform pixel
noise in [-12, 12], clipped to uint8 BGR.  Every seed gives the same
sizes; only the content changes.  Video ``v`` of a seed draws from its own
generator (``seed`` and ``v``), so a video's frames do not depend on how
many videos a cell asks for.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

BLOCK = 32
PAN = 16
NOISE = 12


def _video_gen(seed: int, index: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + 7919 * (index + 1)) % (1 << 63))
    return gen


def video(seed: int, index: int, h: int, w: int, n_frames: int,
          device) -> torch.Tensor:
    """Video ``index`` of ``seed``: uint8 [n_frames, h, w, 3] on
    ``device``."""
    gen = _video_gen(seed, index, device)
    blocks = torch.randint(0, 256, (h // BLOCK + 1, w // BLOCK + 1, 3),
                           generator=gen, device=device, dtype=torch.int16)
    base = blocks.repeat_interleave(BLOCK, 0).repeat_interleave(BLOCK, 1)
    base = base[:h, :w]
    noise = torch.randint(-NOISE, NOISE + 1, (n_frames, h, w, 3),
                          generator=gen, device=device, dtype=torch.int16)
    frames = torch.stack([torch.roll(base, PAN * t, dims=1)
                          for t in range(n_frames)]) + noise
    return frames.clamp_(0, 255).to(torch.uint8)


def host_video(seed: int, index: int, h: int, w: int, n_frames: int,
               device) -> List[np.ndarray]:
    """:func:`video` as the pipelines take a clip: a list of [1, h, w, 3]
    uint8 host arrays."""
    frames = video(seed, index, h, w, n_frames, device).cpu().numpy()
    return [frames[t:t + 1] for t in range(n_frames)]


def probe_frame(seed: int, h: int, w: int, device) -> torch.Tensor:
    """A frame of no clip (the calibration's probe): [1, h, w, 3]."""
    return video(seed, -2, h, w, 1, device)
