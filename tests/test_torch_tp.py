"""Tensor parallel on the CPU: the port's ``param_sharding`` against the
JAX package's, and ``cli/dryrun_multichip``'s dp x tp step against the
plain step.

* ``param_sharding`` of the tiny model (``tiny_model_cfg``) on a (4, 2)
  and an (8, 1) mesh, and on a (4, 2) mesh with a stage FFN of 63 hidden
  units (2 does not divide it: replicated; the temporal heads' 1024 still
  shard), equals the JAX package's specs for the same configuration
  (its tree from ``jax.eval_shape``, its mesh over the conftest's 8
  virtual devices) in torch's layout: ``P(None, "model")`` on ``[in,
  out]`` is ``Shard(0)``, ``P("model", None)`` is ``Shard(1)``, ``P()``
  is ``Replicate()``.  The port's meshes come from a "fake" process group
  of 8 ranks in this one process.
* Four gloo processes (``tests/torch_tp_worker.py``, started first so
  they run beside the rest) run the command's step on a dp 2 x tp 2 mesh:
  the compact model from seed 0, ``dryrun_batch(2)``, one AdamW step.
  The plain one-process step on the same batch here is the reference:
  each loss term within LOSS_RTOL; each whole gradient (the shards
  gathered; clipped, as the update used it) within GRAD_RTOL of its
  max|g|, floored at GRAD_FLOOR of the largest tensor's (measured:
  2.9e-5; the loss terms 2.9e-7); the parameters after the update equal,
  bit for bit, torch's AdamW applied to the initial weights with those
  gradients, and lie within 2 lr of the plain step's (Adam's first update
  is lr g / (|g| + eps): a gradient entry at the rounding level may take
  the other sign); the gradients' global norm before the clip within
  NORM_RTOL of the plain step's (measured: 1.2e-5).  The step with the
  clip's "model" sum left out or with the data averages over all four
  ranks fails both the gradient tolerance (4.9e-4 and 0.60) and the norm
  tolerance (4.6e-4 and 4.2e-4).
"""

import dataclasses
import os
import pathlib
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from slotvps_tpu import config as jconfig
from slotvps_tpu.models import detector as jdet
from slotvps_tpu.parallel import mesh as jmesh
from slotvps_tpu_torch import config as tconfig
from slotvps_tpu_torch.cli.dryrun_multichip import (dryrun_batch,
                                                    dryrun_config, tp_degree)
from slotvps_tpu_torch.models.detector import init_model
from slotvps_tpu_torch.parallel import mesh as tmesh
from slotvps_tpu_torch.training.step import make_optimizer, train_step
from slotvps_tpu_torch.utils.convert import _convert_leaf
from tests.test_torch_models import tiny_model_cfg

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = pathlib.Path(__file__).with_name("torch_tp_worker.py")
WORKER_TIMEOUT = 300
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-2
NORM_RTOL = 5e-5
LR = 1e-4
RUNS = ("tp", "no_model_sum", "world_average")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """The four ranks' outputs and the plain step's metrics, gradients,
    parameters before and after."""
    tmp = tmp_path_factory.mktemp("tp")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    ranks = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(port),
         str(tmp / f"out{r}.pt")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    try:
        cfg = dryrun_config()
        model = init_model(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt = make_optimizer(model, lr=LR)
        metrics = train_step(model, opt, dryrun_batch(2), cfg)
        plain = dict(
            metrics={k: float(v) for k, v in metrics.items()},
            grad_norm=float(opt.global_norm),
            grads={n: p.grad.clone() for n, p in model.named_parameters()},
            params={n: p.detach().clone()
                    for n, p in model.named_parameters()},
            before=before)
        outs = []
        for proc in ranks:
            log, _ = proc.communicate(timeout=WORKER_TIMEOUT)
            assert proc.returncode == 0, log[-4000:]
        for r in range(4):
            outs.append(torch.load(tmp / f"out{r}.pt", weights_only=False))
        yield plain, outs
    finally:
        for proc in ranks:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture
def fake_world():
    """A process group of 8 ranks in this process (the "fake" backend:
    collectives do nothing), for meshes of the JAX tests' shapes."""
    dist.init_process_group("fake", rank=0, world_size=8, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def _jax_spec_to_torch(spec):
    return {(): Replicate(), (None, "model"): Shard(0),
            ("model", None): Shard(1)}[tuple(spec)]


def _key(k):
    return str(getattr(k, "key", getattr(k, "idx", k)))


@pytest.mark.parametrize("n_data,n_model,hidden", [
    (4, 2, 2048), (8, 1, 2048), (4, 2, 63)])
def test_param_sharding_matches_jax(fake_world, n_data, n_model, hidden):
    def cfg_of(config):
        cfg = tiny_model_cfg(config=config)
        return dataclasses.replace(cfg, slot_head=dataclasses.replace(
            cfg.slot_head, dim_feedforward=hidden))

    model = init_model(torch.Generator().manual_seed(0), cfg_of(tconfig),
                       device="cpu")
    ours = tmesh.param_sharding(model, tmesh.make_mesh(n_data, n_model))
    shapes = jax.eval_shape(lambda k: jdet.init_model(k, cfg_of(jconfig)),
                            jax.random.PRNGKey(0))
    ref = jmesh.param_sharding(shapes, jmesh.make_mesh(
        n_data, n_model, devices=jax.devices()[:n_data * n_model]))
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    specs = jax.tree_util.tree_leaves(ref)
    assert len(leaves) == len(specs)
    seen, buffers = set(), dict(model.named_buffers())
    for (path, leaf), sharding in zip(leaves, specs):
        name, _ = _convert_leaf(tuple(_key(k) for k in path),
                                np.empty(leaf.shape))
        want = _jax_spec_to_torch(sharding.spec)
        if name in buffers:
            assert want == Replicate(), name
            continue
        assert ours[name] == want, (name, ours[name], want)
        seen.add(name)
    assert seen == set(ours)
    n_shard = sum(isinstance(s, Shard) for s in ours.values())
    # two FFN weights in each of 4 stages and each of 2 temporal heads
    assert n_shard == {(2, 2048): 12, (1, 2048): 0, (2, 63): 4}[
        (n_model, hidden)]


def test_tp_degree_is_the_jax_rule():
    for n in range(1, 17):
        assert tp_degree(n) == (2 if n % 2 == 0 and n >= 4 else 1)


def _grad_ratio(grads, want):
    """max over tensors of max|d| / max(max|g|, GRAD_FLOOR * largest)."""
    top = max(float(g.abs().max()) for g in want.values())
    return max(float((grads[n] - g).abs().max())
               / max(float(g.abs().max()), GRAD_FLOOR * top)
               for n, g in want.items())


def _norm_ratio(run, plain):
    """The first step's global norm before the clip against the plain
    step's, relative."""
    return abs(run["grad_norm"][0] - plain["grad_norm"]) / plain["grad_norm"]


def test_tp_step_matches_plain_step(tp_runs):
    plain, outs = tp_runs
    assert [o["mesh"] for o in outs] == [
        ((2, 2), d, m) for d in (0, 1) for m in (0, 1)]
    for name, value in outs[0]["tp"]["params"][0].items():
        # one model on every rank: the replicated gradients are averaged
        # over "model" too
        assert all(torch.equal(o["tp"]["params"][0][name], value)
                   for o in outs), name
    for out in outs:
        got = out["tp"]
        for k, v in plain["metrics"].items():
            np.testing.assert_allclose(got["metrics"][0][k], v,
                                       rtol=LOSS_RTOL, err_msg=k)
        assert _grad_ratio(got["grads"][0], plain["grads"]) <= GRAD_RTOL
        assert _norm_ratio(got, plain) <= NORM_RTOL
        # the sharded update: torch's AdamW on the whole tensors
        replay = {n: torch.nn.Parameter(p.clone())
                  for n, p in plain["before"].items()}
        for n, p in replay.items():
            p.grad = got["grads"][0][n]
        torch.optim.AdamW(replay.values(), lr=LR, weight_decay=1e-4).step()
        for n, p in replay.items():
            assert torch.equal(p.detach(), got["params"][0][n]), n
            assert float((got["params"][0][n] - plain["params"][n]).abs()
                         .max()) <= 2 * LR * (1 + 1e-3), n


@pytest.mark.parametrize("run", RUNS[1:])
def test_tp_step_needs_the_model_sum_and_the_data_group(tp_runs, run):
    plain, outs = tp_runs
    for out in outs:
        assert _grad_ratio(out[run]["grads"][0],
                           plain["grads"]) > 3 * GRAD_RTOL
        assert _norm_ratio(out[run], plain) > 3 * NORM_RTOL
