"""JAX parameter tree -> the port's ``state_dict``.

``from_jax_params`` inverts the layout transforms of
``slotvps_tpu/utils/checkpoint.py`` (which maps torch checkpoints into the
JAX tree): conv HWIO -> OIHW, linear ``[in, out]`` -> ``[out, in]``, MHA
packed ``in_proj`` ``[d, 3d]`` -> ``in_proj_weight`` ``[3d, d]``.  Leaf
names map as ``w -> weight``, ``b -> bias``, ``scale -> weight``,
``mean -> running_mean``, ``var -> running_var``; dict keys and list
indices join with dots, which is the port's module path by construction.

Every JAX leaf is consumed exactly once and every parameter and buffer of
the port's model is filled exactly once; anything else raises.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from slotvps_tpu_torch.config import ModelConfig

_LEAF = {"w": "weight", "b": "bias", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),))
    else:
        yield prefix, np.asarray(tree)


def _convert_leaf(path: tuple, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    *mods, leaf = path
    if mods and mods[-1] == "in_proj":
        # packed MHA projection: [d, 3d] -> torch in_proj_weight [3d, d]
        name = {"w": "in_proj_weight", "b": "in_proj_bias"}[leaf]
        return ".".join(mods[:-1] + [name]), (arr.T if leaf == "w" else arr)
    if leaf not in _LEAF:
        return ".".join(path), arr   # e.g. init_mask_query, as is
    if leaf == "w":
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)   # HWIO -> OIHW
        elif arr.ndim == 2:
            arr = arr.T                        # [in, out] -> [out, in]
        else:
            raise ValueError(f"{'.'.join(path)}: weight of rank {arr.ndim}")
    return ".".join(mods + [_LEAF[leaf]]), arr


def from_jax_params(tree, model_cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Convert a JAX parameter tree (numpy or array leaves) to a state dict
    for :func:`slotvps_tpu_torch.models.detector.init_model`'s model."""
    from slotvps_tpu_torch.models.detector import Detector

    expected = Detector(torch.Generator().manual_seed(0),
                        model_cfg).state_dict()
    state: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(tree):
        name, arr = _convert_leaf(path, arr)
        if name in state:
            raise ValueError(f"two JAX leaves map to {name}")
        if name not in expected:
            raise KeyError(f"JAX leaf {'.'.join(path)} -> {name} has no "
                           "counterpart in the port")
        want = tuple(expected[name].shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != {want}")
        state[name] = torch.from_numpy(np.array(arr, dtype=np.float32))
    missing = sorted(set(expected) - set(state))
    if missing:
        raise KeyError(f"port entries not filled by the JAX tree: {missing}")
    return state
