"""The process mesh and the tensor-parallel rule (counterpart of
``slotvps_tpu/parallel/mesh.py``).

A ``DeviceMesh`` over the processes of the default group with the JAX
package's axes: ``data`` (data parallel over clips, the only parallelism
the reference has) and ``model`` (tensor parallel over the decoder FFNs).
Each process holds one device, so a data-parallel step gives each
coordinate along ``data`` its rows of the batch (:func:`batch_rows`, the
counterpart of ``batch_sharding``) and averages the gradients over the
``data`` group (``training/step.average_gradients``).

Tensor parallel (:func:`param_sharding`, :func:`shard_model`): the FFN
pair ``linear1`` (column parallel) -> activation -> ``linear2`` (row
parallel) of every decoder stage and temporal head runs on this rank's
slice of the hidden dimension.  A sharded parameter holds its rank's shard
as a plain tensor, so the optimizer, the casts and the rest of the forward
see ordinary tensors; :func:`tp_ffn` brings the pair back to replicated
tensors with one all-reduce over ``model`` in the forward and one in the
backward (the Megatron-LM pattern), where XLA inserts the same collectives
from the JAX package's specs.  Only ``all_reduce`` is used, which gloo
runs on CUDA tensors too.
"""

from __future__ import annotations

import types
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Placement, Replicate, Shard


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A (n_data, n_model) mesh named ("data", "model") over the first
    ``n_data * n_model`` ranks of the started default group; ``n_data``
    defaults to world // n_model.  ``device_type`` is that of the tensors
    the ranks hold: by default "cuda" when the group runs NCCL, else
    "cpu" (a gloo group whose ranks hold CUDA tensors passes "cuda")."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group (init_distributed)")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if not (n_data >= 1 and n_model >= 1 and n_data * n_model <= world):
        raise ValueError(f"mesh ({n_data}, {n_model}) does not fit "
                         f"{world} processes")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(n_data * n_model).reshape(n_data, n_model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))


def _axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def batch_rows(batch_size: int, mesh: Optional[DeviceMesh] = None) -> slice:
    """This process's rows of a batch's leading axis: an equal block for
    each coordinate along "data", in order (the JAX package's
    ``batch_sharding``: ``P("data")``); the ranks along "model" share
    them.  Without a mesh, every row."""
    if mesh is None:
        return slice(0, batch_size)
    n_data = _axis_size(mesh, "data")
    if batch_size % n_data:
        raise ValueError(f"batch {batch_size} does not split over "
                         f"{n_data} data ranks")
    b = batch_size // n_data
    d = mesh.get_local_rank("data")
    return slice(d * b, (d + 1) * b)


def param_sharding(model: torch.nn.Module,
                   mesh: DeviceMesh) -> Dict[str, Placement]:
    """Each parameter's placement on the mesh's "model" axis: the JAX
    package's rule in torch's ``[out, in]`` weight layout.  A 2-D
    ``linear1`` weight (JAX ``P(None, "model")`` on ``[in, out]``) is
    ``Shard(0)`` where ``out`` splits over the "model" ranks; a 2-D
    ``linear2`` weight (``P("model", None)``) is ``Shard(1)`` where ``in``
    does; everything else, biases included, is ``Replicate()``, and
    everything with one "model" rank."""
    n_model = _axis_size(mesh, "model")
    out = {}
    for name, p in model.named_parameters():
        spec = Replicate()
        if n_model > 1 and p.ndim == 2 and name.endswith("weight"):
            if "linear1" in name and p.shape[0] % n_model == 0:
                spec = Shard(0)
            elif "linear2" in name and p.shape[1] % n_model == 0:
                spec = Shard(1)
        out[name] = spec
    return out


def shard_model(model: torch.nn.Module,
                mesh: DeviceMesh) -> Dict[str, Placement]:
    """Place ``model``'s parameters by :func:`param_sharding`, in place:
    each ``Shard(d)`` parameter keeps this rank's block along ``d`` (the
    same Parameter object, so an optimizer built before still holds it),
    and each FFN pair whose two weights are sharded runs :func:`tp_ffn`.
    Returns the placements."""
    sharding = param_sharding(model, mesh)
    n = _axis_size(mesh, "model")
    if n == 1:
        return sharding
    tp = types.SimpleNamespace(group=mesh.get_group("model"), size=n,
                               rank=mesh.get_local_rank("model"))
    for name, spec in sharding.items():
        if isinstance(spec, Shard):
            p = model.get_parameter(name)
            p.data = p.data.chunk(n, dim=spec.dim)[tp.rank].contiguous()
            p.tp_group = tp.group
    for name, mod in model.named_modules():
        prefix = f"{name}." if name else ""
        keys = [f"{prefix}{k}.weight" for k in ("linear1", "linear2")]
        if not all(k in sharding for k in keys):
            continue
        placed = [isinstance(sharding[k], Shard) for k in keys]
        if all(placed):
            mod.linear1.tp = tp
        elif any(placed):
            raise ValueError(f"{name}: one FFN weight sharded, not both")
    return sharding


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the "model" ranks (each
    holds the part that flowed through its hidden slice)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """The partial products summed over the "model" ranks; identity
    backward (every rank needs the whole gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SliceReplicated(torch.autograd.Function):
    """This rank's block of a replicated vector; the gradient placed back
    in the whole vector and summed over the ranks, so a replicated
    parameter gets the same gradient on each of them."""

    @staticmethod
    def forward(ctx, v, tp):
        ctx.tp, ctx.n = tp, v.shape[0]
        return v.chunk(tp.size)[tp.rank]

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.n)
        full.chunk(ctx.tp.size)[ctx.tp.rank].copy_(g)
        dist.all_reduce(full, group=ctx.tp.group)
        return full, None


def tp_ffn(linear1, linear2, act, x):
    """``linear2(act(linear1(x)))`` on this rank's hidden slice: ``x``
    replicated in, the row-parallel products summed over "model", then
    ``linear2``'s bias, replicated out."""
    from slotvps_tpu_torch.models.layers import linear

    tp = linear1.tp
    x = _CopyToModel.apply(x, tp.group)
    b1 = (None if linear1.bias is None
          else _SliceReplicated.apply(linear1.bias, tp))
    y = _ReduceFromModel.apply(linear(act(linear(x, linear1.weight, b1)),
                                      linear2.weight), tp.group)
    return y if linear2.bias is None else y + linear2.bias.to(y.dtype)


def full_tensor(local: torch.Tensor, spec: Placement,
                mesh: DeviceMesh) -> torch.Tensor:
    """The whole tensor of a parameter (or its gradient) placed by
    ``spec``: a ``Shard(d)`` block set into zeros and summed over "model"
    (an all-reduce: gloo's CUDA path has no all-gather into one tensor);
    a replicated one as it is."""
    if not isinstance(spec, Shard):
        return local
    n = _axis_size(mesh, "model")
    shape = list(local.shape)
    shape[spec.dim] *= n
    full = local.new_zeros(shape)
    full.chunk(n, dim=spec.dim)[mesh.get_local_rank("model")].copy_(local)
    dist.all_reduce(full, group=mesh.get_group("model"))
    return full
