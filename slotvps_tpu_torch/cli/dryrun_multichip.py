"""One full train step over a dp x tp process mesh (counterpart of the
root ``__graft_entry__.py`` ``dryrun_multichip``).

Every process of the launcher (torchrun, SLURM, Open MPI;
``parallel/env.init_distributed``) is one rank of a ("data", "model")
mesh: tp = 2 when the world is even and at least 4, else 1, the rest data
parallel.  The model is built from seed 0, its parameters placed by
``parallel/mesh.param_sharding`` (the decoder FFNs split over "model"),
and one AdamW step (``training/step.train_step`` with the mesh, every loss
and the Hungarian matching) runs on a seeded 32x32 batch of two GT slots
a sample, one sample a data rank; the metrics are printed.  The model is
the compact configuration of the JAX package's dry run (R18, one head a
decoder level, 4 levels, temporal stages (2, 3), 20 proposals) unless
``--full`` asks for ``r50_fpn_slotvps`` at full width.

The ranks hold their device's tensors: the rank's card (NCCL), or with
``--backend gloo`` the card shared by several ranks (NCCL puts one rank on
a card; the step's collectives are all-reduces, which gloo runs on CUDA
tensors), or the CPU with ``--device cpu``.  Without a launcher it runs a
world of one.

Usage:
  torchrun --nproc_per_node 4 -m slotvps_tpu_torch.cli.dryrun_multichip
  torchrun --nproc_per_node 4 -m slotvps_tpu_torch.cli.dryrun_multichip \\
      --backend gloo          # four ranks on one card: dp 2 x tp 2
  torchrun --nproc_per_node 4 -m slotvps_tpu_torch.cli.dryrun_multichip \\
      --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import socket
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from slotvps_tpu_torch.config import (ModelConfig, ResNetConfig,
                                      SlotHeadConfig, r50_fpn_slotvps)


def tp_degree(world: int) -> int:
    """The "model" axis of a world: 2 when it is even and at least 4."""
    return 2 if world % 2 == 0 and world >= 4 else 1


def dryrun_config(full: bool = False) -> ModelConfig:
    """``r50_fpn_slotvps``'s model, compact unless ``full``: R18, one
    head a decoder level over 4 levels, temporal stages (2, 3), 20
    proposals (``__graft_entry__.dryrun_multichip``)."""
    base = r50_fpn_slotvps().model
    if full:
        return base
    return dataclasses.replace(
        base, resnet=ResNetConfig(depth=18),
        slot_head=SlotHeadConfig(per_dh_num_heads=(1, 1, 1, 1),
                                 dh_num_heads=4,
                                 apply_temporal_query_atten_stages=(2, 3)),
        proposal_num=20)


def dryrun_batch(n_data: int, size: int = 32, n_gt: int = 2, seed: int = 0):
    """The dry run's batch of ``n_data`` samples (``size`` x ``size``
    frames, ``n_gt`` GT slots, 19 classes), drawn from numpy's
    ``default_rng(seed)`` in the JAX package's order."""
    from slotvps_tpu_torch.training.step import make_train_batch

    rng = np.random.default_rng(seed)
    b, h, w, g = n_data, size, size, n_gt
    return make_train_batch(
        img=rng.standard_normal((b, h, w, 3)).astype(np.float32),
        ref_img=rng.standard_normal((b, h, w, 3)).astype(np.float32),
        gt_labels=rng.integers(0, 19, (b, g)).astype(np.int32),
        gt_masks=rng.integers(0, 2, (b, g, h // 4, w // 4))
        .astype(np.float32),
        gt_valid=np.ones((b, g), bool),
        gt_semantic=rng.integers(0, 19, (b, h // 4, w // 4))
        .astype(np.int32))


def run_steps(model, cfg: ModelConfig, batch, mesh, steps: int = 1,
              lr: float = 1e-4) -> Dict:
    """Place ``model`` on ``mesh`` (``shard_model``), take ``steps``
    AdamW steps on the whole ``batch`` and return, for each step, its
    metrics, its wall ms (host clock, ending in a synchronize on the card),
    the gradients' global norm before the clip and, after it, each
    parameter's whole gradient (clipped, as the update used it) and value,
    on the CPU."""
    from slotvps_tpu_torch.parallel.mesh import full_tensor, shard_model
    from slotvps_tpu_torch.training.step import make_optimizer, train_step

    sharding = shard_model(model, mesh)
    opt = make_optimizer(model, lr=lr)
    named = dict(model.named_parameters())
    cuda = batch.img.device.type == "cuda"
    out = {k: [] for k in ("metrics", "step_ms", "grad_norm", "grads",
                           "params")}
    for _ in range(steps):
        t0 = time.perf_counter()
        m = train_step(model, opt, batch, cfg, mesh=mesh)
        if cuda:
            torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["grad_norm"].append(float(opt.global_norm))
        for key, of in (("grads", lambda p: p.grad),
                        ("params", lambda p: p.detach())):
            out[key].append({n: full_tensor(of(p), sharding[n], mesh)
                             .to("cpu", copy=True)
                             for n, p in named.items()})
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="one train step over a dp x tp mesh")
    p.add_argument("--full", action="store_true",
                   help="r50_fpn_slotvps at full width (default: the "
                        "compact configuration)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="default: nccl on the card, gloo on the CPU")
    return p.parse_args(argv)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def main(argv=None):
    from slotvps_tpu_torch.models.detector import init_model
    from slotvps_tpu_torch.parallel.env import init_distributed
    from slotvps_tpu_torch.parallel.mesh import make_mesh
    from slotvps_tpu_torch.utils.compile_cache import enable_compile_cache
    from slotvps_tpu_torch.utils.precision import setup_precision

    enable_compile_cache()
    args = parse_args(argv)
    device = init_distributed(device=args.device, backend=args.backend)
    if device is None:
        device = init_distributed(f"tcp://localhost:{_free_port()}",
                                  num_processes=1, process_id=0,
                                  device=args.device, backend=args.backend)
    try:
        if device.type == "cuda":
            setup_precision()
        world = dist.get_world_size()
        n_model = tp_degree(world)
        mesh = make_mesh(world // n_model, n_model, device_type=device.type)
        cfg = dryrun_config(args.full)
        model = init_model(torch.Generator().manual_seed(0), cfg,
                           device=device)
        batch = dryrun_batch(world // n_model).to(device)
        out = run_steps(model, cfg, batch, mesh)
        if dist.get_rank() == 0:
            print(f"mesh (data={world // n_model}, model={n_model}) on "
                  f"{device.type}, {dist.get_backend()}", flush=True)
            print(f"dryrun_multichip ok ({out['step_ms'][0]:.1f} ms):",
                  out["metrics"][0], flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
