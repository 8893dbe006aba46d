"""Multi-process set-up and host-side gathers on ``torch.distributed``
(counterpart of ``slotvps_tpu/parallel/env.py``).

The reference launches one process per GPU and reads its rank from the
launcher (reference mmdet/apis/env.py:13-55: ``RANK``,
``OMPI_COMM_WORLD_RANK``, ``SLURM_PROCID``); it gathers per-rank results
through pickle files and a barrier (eval_hooks.py:40-79).  Here:

* :func:`init_distributed` starts the default process group from what a
  launcher sets (torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``,
  SLURM's and Open MPI's), NCCL on the card and gloo on the CPU, and pins
  the process to its local card;
* :func:`all_gather_host` gathers a host-side tree from every process with
  ``all_gather_object``, no files.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# (rank, world size, local rank) variables of each launcher, in the order
# they are read
_LAUNCHERS = (("RANK", "WORLD_SIZE", "LOCAL_RANK"),
              ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID"),
              ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",
               "OMPI_COMM_WORLD_LOCAL_RANK"))


def _launcher_env():
    """(rank, world, local rank) of the first launcher whose world size is
    set, else None."""
    for rank, world, local in _LAUNCHERS:
        if world in os.environ:
            r = int(os.environ.get(rank, 0))
            return r, int(os.environ[world]), int(os.environ.get(local, r))
    return None


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda",
                     backend: Optional[str] = None) -> Optional[torch.device]:
    """Start the default process group; returns this process's device
    (``cuda:<local rank>`` on the card), or None when there is nothing to
    start: no launcher variable is set and no argument given, one process.

    ``coordinator_address`` is the group's rendezvous (``tcp://host:port``);
    without it ``MASTER_ADDR`` / ``MASTER_PORT`` are read (torchrun sets
    them).  ``num_processes`` and ``process_id`` override the launcher's
    world size and rank.  ``device``: "cuda" (the default) starts NCCL and
    sets the process's CUDA device from its local rank (a card a local
    rank); "cpu" starts gloo.  ``backend`` overrides the choice: "gloo"
    with ``device="cuda"`` lets several processes share one card (the
    local rank modulo the cards there are; NCCL refuses two ranks on one
    device), which the tensor-parallel step's all-reduces allow."""
    env = _launcher_env()
    if env is None and num_processes is None \
            and coordinator_address is None:
        return None
    rank, world, local = env if env is not None else (0, 1, 0)
    if num_processes is not None:
        world = num_processes
    if process_id is not None:
        rank = process_id
        if env is None:
            local = process_id
    init_method = coordinator_address
    if init_method is None:
        if "MASTER_ADDR" not in os.environ:
            raise ValueError("init_distributed: give coordinator_address "
                             "(tcp://host:port) or set MASTER_ADDR and "
                             "MASTER_PORT")
        init_method = "env://"
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: CUDA is not available")
        backend = backend or "nccl"
        n_cards = torch.cuda.device_count()
        if backend == "nccl" and local >= n_cards:
            raise RuntimeError(f"init_distributed: local rank {local} has "
                               f"no card of its own ({n_cards} cards); "
                               "NCCL puts one rank on a card")
        dev = torch.device("cuda", local % n_cards)
        torch.cuda.set_device(dev)
    else:
        dev, backend = torch.device(kind), backend or "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    return dev


def _stack(leaves):
    first = leaves[0]
    if isinstance(first, dict):
        return {k: _stack([leaf[k] for leaf in leaves]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack(list(parts)) for parts in zip(*leaves))
    return np.stack([np.asarray(leaf) for leaf in leaves])


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def all_gather_host(tree):
    """Every process's ``tree`` (dicts, lists and tuples of arrays,
    tensors or numbers), each leaf stacked over the processes in rank
    order on a new leading axis, as numpy arrays (the JAX package's
    ``process_allgather``).  One process: a leading axis of 1."""
    local = _to_host(tree)
    if not dist.is_initialized():
        return _stack([local])
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, local)
    return _stack(parts)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def broadcast_state(module: torch.nn.Module, src: int = 0):
    """Every parameter and buffer of ``module`` set to process ``src``'s,
    in place, so that the data-parallel replicas start equal."""
    if not dist.is_initialized():
        return
    with torch.no_grad():
        for t in module.state_dict().values():
            dist.broadcast(t, src=src)
