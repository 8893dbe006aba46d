"""One rank of the two-process data-parallel check of
``tests/test_torch_swin_train.py`` (gloo on the CPU; run as a script, not
collected by pytest).

    python tests/torch_dp_worker.py <rank> <port> <inputs.pt> <outputs.pt>

The inputs hold the port's model configuration, the model's state and a
batch of two samples.  The rank starts a two-process group with
``init_distributed``, keeps its rows of the batch (``make_mesh`` +
``batch_rows``: sample ``rank``) and computes:

* the data-parallel step's loss terms and gradients (``train_step`` with
  the group; its optimizer does nothing, so the gradients are the averaged
  ones before any clip);
* the same with a plain mean of the ranks' means: ``loss_fn`` on the rank's
  sample alone, its gradients averaged over the group;
* ``all_gather_host`` of a tree holding the rank, and the mesh's shape and
  the rank's rows.

It writes them with ``torch.save``.  It imports no JAX.
"""

import sys
import types

import numpy as np
import torch
import torch.distributed as dist

from slotvps_tpu_torch.models.detector import init_model
from slotvps_tpu_torch.parallel.env import (all_gather_host,
                                            init_distributed, process_count,
                                            process_index)
from slotvps_tpu_torch.parallel.mesh import batch_rows, make_mesh
from slotvps_tpu_torch.training import step as tstep


def main(rank, port, inputs, outputs):
    torch.set_num_threads(1)
    data = torch.load(inputs, weights_only=False)
    cfg = data["cfg"]
    init_distributed(f"tcp://localhost:{port}", num_processes=2,
                     process_id=rank, device="cpu")
    try:
        mesh = make_mesh()
        rows = batch_rows(2, mesh)
        local = tstep.make_train_batch(**{k: v[rows]
                                          for k, v in data["batch"].items()})
        model = init_model(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
        model.load_state_dict(data["state"])
        params = [p for p in model.parameters() if p.requires_grad]
        keep = types.SimpleNamespace(zero_grad=model.zero_grad,
                                     step=lambda: None)

        def grads():
            return {n: p.grad.clone() for n, p in model.named_parameters()}

        metrics = tstep.train_step(model, keep, local, cfg, fixed_match=True,
                                   group=dist.group.WORLD)
        out = dict(metrics={k: float(v) for k, v in metrics.items()},
                   grads=grads())
        model.zero_grad()
        total, _ = tstep.loss_fn(model, cfg, local, fixed_match=True)
        total.backward()
        tstep.average_gradients(params, dist.group.WORLD)
        out["naive_grads"] = grads()
        out["gathered"] = all_gather_host(
            {"rank": process_index(), "x": np.full(3, float(rank)),
             "pair": (rank, [rank * 10])})
        out["mesh"] = dict(names=mesh.mesh_dim_names,
                           shape=tuple(mesh.mesh.shape),
                           world=process_count(), rows=(rows.start,
                                                        rows.stop))
        torch.save(out, outputs)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
