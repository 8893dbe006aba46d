"""The process mesh (counterpart of ``slotvps_tpu/parallel/mesh.py``).

A ``DeviceMesh`` over the processes of the default group with the JAX
package's axes: ``data`` (data parallel over clips, the only parallelism
the reference has) and ``model`` (tensor parallel; no entry point uses it).
Each process holds one device, so a data-parallel step gives each
coordinate along ``data`` its rows of the batch (:func:`batch_rows`, the
counterpart of ``batch_sharding``) and averages the gradients
(``training/step.average_gradients``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> DeviceMesh:
    """A (n_data, n_model) mesh named ("data", "model") over the first
    ``n_data * n_model`` ranks of the started default group, on "cuda"
    when the group runs NCCL, else "cpu"; ``n_data`` defaults to world //
    n_model."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group (init_distributed)")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if not (n_data >= 1 and n_model >= 1 and n_data * n_model <= world):
        raise ValueError(f"mesh ({n_data}, {n_model}) does not fit "
                         f"{world} processes")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(n_data * n_model).reshape(n_data, n_model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))


def batch_rows(batch_size: int, mesh: Optional[DeviceMesh] = None) -> slice:
    """This process's rows of a batch's leading axis: an equal block for
    each coordinate along "data", in order (the JAX package's
    ``batch_sharding``: ``P("data")``).  Without a mesh, every row."""
    if mesh is None:
        return slice(0, batch_size)
    n_data = mesh.size(mesh.mesh_dim_names.index("data"))
    if batch_size % n_data:
        raise ValueError(f"batch {batch_size} does not split over "
                         f"{n_data} data ranks")
    b = batch_size // n_data
    d = mesh.get_local_rank("data")
    return slice(d * b, (d + 1) * b)
