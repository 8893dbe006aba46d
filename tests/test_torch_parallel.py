"""The port's ``parallel/`` package and ``utils/profiler.py`` on the CPU,
against the JAX package where it has a counterpart.

* ``init_distributed`` starts nothing without a launcher, reads torchrun's,
  SLURM's and Open MPI's variables, and asks for a rendezvous it was not
  given.
* In a world of one gloo process: ``make_mesh`` has the JAX package's axis
  names and shape and refuses a mesh that does not fit, as JAX's does;
  ``batch_rows`` gives the rows JAX's ``batch_sharding`` places on the
  device; ``all_gather_host`` stacks on a leading axis of 1.  The
  two-process case is in tests/test_torch_swin_train.py.
* ``count_params`` of the tiny R18 and Swin detectors equals the JAX
  package's count of its tree (from ``jax.eval_shape``), and
  ``params_to_string`` its format; ``time_fn`` and ``trace`` run.
"""

import socket

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from slotvps_tpu import config as jconfig
from slotvps_tpu.models import detector as jdet
from slotvps_tpu.parallel import mesh as jmesh
from slotvps_tpu.utils import profiler as jprof
from slotvps_tpu_torch import config as tconfig
from slotvps_tpu_torch.models import detector as tdet
from slotvps_tpu_torch.parallel import env, mesh
from slotvps_tpu_torch.utils import profiler as tprof
from tests.test_torch_models import tiny_model_cfg
from tests.test_torch_swin import swin_model_cfg

LAUNCHERS = (("RANK", "WORLD_SIZE", "LOCAL_RANK"),
             ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID"),
             ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",
              "OMPI_COMM_WORLD_LOCAL_RANK"))


@pytest.fixture
def no_launcher(monkeypatch):
    for names in LAUNCHERS:
        for name in names:
            monkeypatch.delenv(name, raising=False)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)


@pytest.fixture
def world_of_one(no_launcher):
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dev = env.init_distributed(f"tcp://localhost:{port}", num_processes=1,
                               process_id=0, device="cpu")
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def test_init_distributed_reads_the_launchers(no_launcher, monkeypatch):
    assert env.init_distributed() is None
    assert not dist.is_initialized()
    assert (env.process_count(), env.process_index()) == (1, 0)
    for names in LAUNCHERS:
        with monkeypatch.context() as m:
            for name, value in zip(names, ("3", "8", "1")):
                m.setenv(name, value)
            assert env._launcher_env() == (3, 8, 1)
            with pytest.raises(ValueError, match="MASTER_ADDR"):
                env.init_distributed(device="cpu")
    assert not dist.is_initialized()


def test_mesh_rows_and_gather_match_jax(world_of_one):
    assert world_of_one == torch.device("cpu")
    assert (env.process_count(), env.process_index()) == (1, 0)
    ours = mesh.make_mesh()
    ref = jmesh.make_mesh(devices=jax.devices()[:1])
    assert ours.mesh_dim_names == ref.axis_names == ("data", "model")
    assert tuple(ours.mesh.shape) == ref.devices.shape == (1, 1)
    with pytest.raises(ValueError, match="does not fit"):
        mesh.make_mesh(n_data=2)
    with pytest.raises(AssertionError):
        jmesh.make_mesh(n_data=2, devices=jax.devices()[:1])
    batch = np.arange(4 * 3).reshape(4, 3)
    (shard,) = jax.device_put(batch, jmesh.batch_sharding(ref)) \
        .addressable_shards
    np.testing.assert_array_equal(batch[mesh.batch_rows(4, ours)],
                                  np.asarray(shard.data))
    assert mesh.batch_rows(3) == slice(0, 3)
    got = env.all_gather_host({"a": torch.arange(3), "b": (1.5, [np.ones(2)])})
    np.testing.assert_array_equal(got["a"], [[0, 1, 2]])
    np.testing.assert_array_equal(got["b"][0], [1.5])
    assert got["b"][1][0].shape == (1, 2)


def test_all_gather_host_in_one_process(no_launcher):
    got = env.all_gather_host([torch.ones(2, 2), 3])
    assert got[0].shape == (1, 2, 2) and got[1].tolist() == [3]


@pytest.mark.parametrize("kind", ["resnet", "swin"])
def test_count_params_matches_jax(kind):
    make = tiny_model_cfg if kind == "resnet" else swin_model_cfg
    cfg, tcfg = make(config=jconfig), make(config=tconfig)
    model = tdet.init_model(torch.Generator().manual_seed(0), tcfg,
                            device="cpu")
    shapes = jax.eval_shape(lambda k: jdet.init_model(k, cfg),
                            jax.random.PRNGKey(0))
    n = tprof.count_params(model)
    assert n == jprof.count_params(shapes)
    for k in (0, 999, 1000, 12345, 999999, 10 ** 6, n):
        assert tprof.params_to_string(k) == jprof.params_to_string(k)


def test_time_fn_and_trace(tmp_path):
    x = torch.ones(64, 64)
    assert tprof.time_fn(lambda a: a @ a, x, iters=3, warmup=1) > 0
    with tprof.trace(str(tmp_path)):
        (x @ x).sum()
    assert any(p.name.endswith(".json") for p in tmp_path.rglob("*"))
