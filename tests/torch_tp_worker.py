"""One rank of the four-process dp x tp check of ``tests/test_torch_tp.py``
(gloo on the CPU; run as a script, not collected by pytest).

    python tests/torch_tp_worker.py <rank> <port> <outputs.pt>

The rank starts a four-process group with ``init_distributed`` and a
(2, 2) ("data", "model") mesh, builds ``cli/dryrun_multichip``'s compact
model from seed 0 on the CPU and runs that command's step
(``run_steps``: ``shard_model``, one ``train_step`` with the mesh on
``dryrun_batch(2)``), three times from the same weights:

* as it is;
* with the clip's sum of the shards' squares over "model" left out
  (``training/step._sum_over_model`` patched to return its input);
* with the data-parallel averages taken over every rank, not the mesh's
  "data" group (the mesh's ``get_group("data")`` patched to WORLD; the
  step's rows kept).

It writes each run's metrics, whole gradients and parameters with
``torch.save``, and this rank's placements.  It imports no JAX.
"""

import sys

import torch
import torch.distributed as dist

from slotvps_tpu_torch.cli.dryrun_multichip import (dryrun_batch,
                                                    dryrun_config, run_steps)
from slotvps_tpu_torch.models.detector import init_model
from slotvps_tpu_torch.parallel.env import init_distributed
from slotvps_tpu_torch.parallel.mesh import batch_rows, make_mesh
from slotvps_tpu_torch.training import step as tstep


def _run(cfg, mesh):
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    return run_steps(model, cfg, dryrun_batch(2), mesh)


def main(rank, port, outputs):
    torch.set_num_threads(1)
    init_distributed(f"tcp://localhost:{port}", num_processes=4,
                     process_id=rank, device="cpu")
    try:
        mesh = make_mesh(2, 2)
        cfg = dryrun_config()
        out = {"tp": _run(cfg, mesh),
               "mesh": (tuple(mesh.mesh.shape), mesh.get_local_rank("data"),
                        mesh.get_local_rank("model"))}
        keep = tstep._sum_over_model
        tstep._sum_over_model = lambda sq, group: sq
        try:
            out["no_model_sum"] = _run(cfg, mesh)
        finally:
            tstep._sum_over_model = keep
        # the mesh's ranks along "data" come from get_group too: the rows
        # stay the rank's own
        rows, get_group = batch_rows(2, mesh), mesh.get_group
        tstep.batch_rows = lambda n, m: rows
        mesh.get_group = (lambda dim=None: dist.group.WORLD if dim == "data"
                          else get_group(dim))
        out["world_average"] = _run(cfg, mesh)
        torch.save(out, outputs)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
