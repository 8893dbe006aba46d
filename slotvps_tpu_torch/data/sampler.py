"""Aspect-ratio-grouped batch sampling.

Behavioral re-implementation of the reference's train samplers
(reference mmdet/datasets/loader/sampler.py:37-73 ``GroupSampler``,
:77-158 ``DistributedGroupSampler``; group flags from
mmdet/datasets/custom.py:122-132): images are grouped by aspect ratio
(flag 1 when width/height > 1), each batch is drawn from ONE group, and
groups are padded to a whole number of batches by repeating their head.
Mixing portrait and landscape frames in one batch forces the padded
static shape to cover both orientations — on TPU that wastes MXU cycles
on pad pixels, so same-group batching matters wherever the dataset mixes
aspect ratios (Mapillary; Cityscapes is uniformly 1024x2048 and
degenerates to a plain shuffle).

Functional numpy design instead of torch Sampler objects: one call
returns the epoch's full index order, already deterministic in
(seed, epoch) — resume-safe and trivially shardable by rank.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def aspect_ratio_flags(img_infos: Sequence[dict]) -> np.ndarray:
    """Group flag per image: 1 if width/height > 1
    (reference custom.py:122-132)."""
    flags = np.zeros((len(img_infos),), np.uint8)
    for i, info in enumerate(img_infos):
        if info["width"] / info["height"] > 1:
            flags[i] = 1
    return flags


def group_shuffled_indices(flags: np.ndarray, samples_per_batch: int,
                           rng: np.random.Generator) -> np.ndarray:
    """One epoch of GroupSampler order (reference sampler.py:50-70).

    Shuffle within each aspect-ratio group, pad each group to a multiple
    of ``samples_per_batch`` by repeating its (shuffled) head, split into
    batch-sized chunks and permute the chunks — every window
    ``order[b*s:(b+1)*s]`` contains one group only.
    Returns int64 [num_samples] (>= len(flags) due to padding)."""
    flags = np.asarray(flags)
    chunks = []
    for g in range(int(flags.max()) + 1 if len(flags) else 0):
        idx = np.where(flags == g)[0]
        if len(idx) == 0:
            continue
        rng.shuffle(idx)
        extra = int(np.ceil(len(idx) / samples_per_batch)
                    ) * samples_per_batch - len(idx)
        idx = np.concatenate([idx, idx[:extra]])
        chunks.append(idx)
    indices = np.concatenate(chunks) if chunks else np.zeros((0,), np.int64)
    order = rng.permutation(len(indices) // samples_per_batch)
    batched = indices.reshape(-1, samples_per_batch)[order]
    return batched.reshape(-1).astype(np.int64)


def distributed_group_indices(flags: np.ndarray, samples_per_gpu: int,
                              num_replicas: int, rank: int,
                              rng: np.random.Generator) -> np.ndarray:
    """Per-rank epoch order (reference sampler.py:119-152): every group
    padded to a multiple of ``samples_per_gpu * num_replicas``, chunks
    permuted globally with the SAME rng on every rank, then each rank
    takes its contiguous slice — ranks see disjoint same-group batches."""
    flags = np.asarray(flags)
    per_rank_quantum = samples_per_gpu * num_replicas
    indices = []
    for g in range(int(flags.max()) + 1 if len(flags) else 0):
        idx = np.where(flags == g)[0]
        if len(idx) == 0:
            continue
        rng.shuffle(idx)
        extra = int(np.ceil(len(idx) / per_rank_quantum)
                    ) * per_rank_quantum - len(idx)
        idx = np.concatenate([idx, idx[:extra]])
        indices.append(idx)
    indices = np.concatenate(indices) if indices else np.zeros((0,), np.int64)
    order = rng.permutation(len(indices) // samples_per_gpu)
    indices = indices.reshape(-1, samples_per_gpu)[order].reshape(-1)
    num_samples = len(indices) // num_replicas
    return indices[rank * num_samples:(rank + 1) * num_samples] \
        .astype(np.int64)
