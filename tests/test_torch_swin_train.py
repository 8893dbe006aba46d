"""Swin training on the CPU against the JAX package: the tiny Swin
detector's loss terms and gradients, two ``overfit`` steps, and the
data-parallel step on two gloo processes, all held to one compiled JAX
``value_and_grad(loss_fn)``.

Config: ``tests/test_torch_swin.py``'s ``swin_model_cfg`` (embed 32, depths
(2, 2, 4, 2), window 7, the tiny slot head), 32x64 frames, B = 2 samples
whose semantic maps have 16 and 112 valid pixels of 128: the data-parallel
step must weigh them by the whole batch's count.

* ``loss_fn`` (fixed_match) and every parameter's gradient of the port at
  B = 2 against the JAX package's, with the weights doctored and the
  Retrievers softened (``_doctored``), at ``tests/test_torch_training.py``'s
  tolerances: the terms rtol STEP_RTOL, each gradient tensor within
  GRAD_RTOL * max(max|g|, GRAD_FLOOR).
* ``overfit`` for two steps (query scale 3, heads at 4 x lr, cosine decay
  over 2 steps) on that batch from the port's seeded init, against the
  JAX package's ``overfit`` from the same weights, at
  ``tests/test_torch_overfit.py``'s tolerances.  Compiled whole, the JAX
  package's step takes ~85 s here, so its ``overfit`` runs with the step
  left uncompiled (``jax.jit`` passes that one function through) and
  ``train_step`` taking its gradient from the ``value_and_grad`` above and
  its update compiled on its own; the rest is the recipe's own code (query
  scale, caps, groups, FPN fix, no BN calibration on Swin).
* Two processes (``tests/torch_dp_worker.py``, gloo, started before the JAX
  compile so that they run beside it): rank r holds sample r; the
  all-reduced gradients and the averaged loss terms against the JAX
  package's B = 2 step at the same tolerances; the same step with a plain
  mean of the ranks' means fails them; ``all_gather_host`` stacks in rank
  order; the mesh is (2, 1) named ("data", "model") and rank r's rows are
  [r, r + 1), as the JAX package's ``batch_sharding`` places a batch of 2
  on two devices.
"""

import functools
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from slotvps_tpu.models import detector as jdet
from slotvps_tpu.parallel.mesh import batch_sharding, make_mesh
from slotvps_tpu.training import step as jstep
from slotvps_tpu.utils import synthetic as jsyn
from slotvps_tpu_torch import config as tconfig
from slotvps_tpu_torch.models import detector as tdet
from slotvps_tpu_torch.training import step as tstep
from slotvps_tpu_torch.utils import synthetic as tsyn
from slotvps_tpu_torch.utils.calibration import doctor_params
from slotvps_tpu_torch.utils.convert import from_jax_params
from tests.test_torch_overfit import (HEAD_MULT, LR, QUERY_SCALE, STEP2_RTOL,
                                      _grouped_lr_checks)
from tests.test_torch_swin import jax_params_of, swin_model_cfg
from tests.test_torch_training import (GRAD_FLOOR, GRAD_RTOL, STEP_RTOL,
                                       _batch, _close_terms)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = pathlib.Path(__file__).with_name("torch_dp_worker.py")
WORKER_TIMEOUT = 120


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays():
    """``tests/test_torch_training.py``'s batch at B = 2, sample 0's
    semantic map ignored but for its last row (16 valid pixels against
    112)."""
    arrays = _batch(b=2)
    arrays["gt_semantic"][0, :7] = 255
    return arrays


def _doctored(model):
    """Fractional DCN offsets, as tests/test_torch_training.py's weights,
    and the Retrievers' q / k LayerNorm scales at 1/8 (that test's are at
    1/4): the Retriever's unscaled slot softmax turns the two frameworks'
    f32 rounding into gradient differences, which the Swin features make
    larger (at 1/4, 5.3e-3 of max|g| on stage 1's Retriever against the
    3e-3 allowed; at 1/8, 1.5e-4 at most)."""
    with torch.no_grad():
        doctor_params(model, torch.Generator().manual_seed(1),
                      fg_scale=0.1, fg_var=1.0)
        for name, mod in model.named_modules():
            if name.endswith(("inst_interact.norm_q",
                              "inst_interact.norm_k")):
                mod.weight.mul_(0.125)
    return model


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def swin_train(tmp_path_factory):
    """The port's doctored tiny Swin detector, its JAX tree, the batch,
    the two data-parallel ranks (started here, collected by their test),
    and the JAX package's jitted value_and_grad with its value there."""
    tcfg = swin_model_cfg(config=tconfig)
    cfg = swin_model_cfg()
    model = _doctored(tdet.init_model(torch.Generator().manual_seed(0),
                                      tcfg, device="cpu"))
    arrays = _arrays()
    tmp = tmp_path_factory.mktemp("dp")
    torch.save({"cfg": tcfg, "state": model.state_dict(),
                "batch": {k: torch.from_numpy(v) for k, v in arrays.items()}},
               tmp / "in.pt")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    ranks = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(port), str(tmp / "in.pt"),
         str(tmp / f"out{r}.pt")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        params = jax_params_of(model, cfg)
        jb = jstep.make_train_batch(**{k: jnp.asarray(v)
                                       for k, v in arrays.items()})
        vg = jax.jit(jax.value_and_grad(functools.partial(
            jstep.loss_fn, cfg=cfg, fixed_match=True), has_aux=True))
        (_, metrics), grads = vg(params, batch=jb)
        yield dict(tcfg=tcfg, cfg=cfg, model=model, arrays=arrays, jb=jb,
                   vg=vg, metrics=metrics, tmp=tmp, ranks=ranks,
                   grads=from_jax_params(jax.tree.map(np.asarray, grads),
                                         tcfg))
    finally:
        for proc in ranks:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def _grad_errors(grads, want):
    """name -> (max|d|, allowed) of every gradient tensor."""
    out = {}
    for name, g in grads.items():
        w = want[name].numpy()
        scale = max(np.abs(w).max(), GRAD_FLOOR)
        out[name] = (float(np.abs(g.numpy() - w).max()), GRAD_RTOL * scale)
    return out


def test_swin_loss_fn_and_gradients_match_jax(swin_train):
    """The port's loss_fn (fixed_match) at B = 2 and its backward: every
    loss term and every parameter's gradient against the JAX package's
    value_and_grad mapped by from_jax_params."""
    s = swin_train
    model = s["model"]
    model.zero_grad()
    total, ours = tstep.loss_fn(model, s["tcfg"],
                                tstep.make_train_batch(**s["arrays"]),
                                fixed_match=True)
    _close_terms(ours, s["metrics"])
    total.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert all(g is not None for g in grads.values())
    assert any(n.startswith("backbone.stage2.blocks.3.") for n in grads)
    for name, (err, allowed) in _grad_errors(grads, s["grads"]).items():
        assert err <= allowed, (name, err, allowed)
    model.zero_grad()


def test_data_parallel_step_matches_jax_batch(swin_train):
    """Two gloo ranks, one sample each (valid semantic pixels 16 and 112):
    the all-reduced gradients and the averaged loss terms equal the JAX
    package's step on the batch of 2; a plain mean of the ranks' means
    does not; the host gather, the mesh and the rows."""
    s = swin_train
    outs = []
    for r, proc in enumerate(s["ranks"]):
        log, _ = proc.communicate(timeout=WORKER_TIMEOUT)
        assert proc.returncode == 0, log
        outs.append(torch.load(s["tmp"] / f"out{r}.pt", weights_only=False))
    a, b = outs
    for name, g in a["grads"].items():
        assert torch.equal(g, b["grads"][name]), name
    for k, v in s["metrics"].items():
        np.testing.assert_allclose(a["metrics"][k], float(v), rtol=STEP_RTOL,
                                   err_msg=k)
    for name, (err, allowed) in _grad_errors(a["grads"], s["grads"]).items():
        assert err <= allowed, (name, err, allowed)
    naive = _grad_errors(a["naive_grads"], s["grads"])
    failed = [n for n, (err, allowed) in naive.items() if err > allowed]
    assert "semantic_head.conv_pred.weight" in failed, naive

    for out in outs:
        gathered = out["gathered"]
        np.testing.assert_array_equal(gathered["rank"], [0, 1])
        np.testing.assert_array_equal(gathered["x"], [[0.0] * 3, [1.0] * 3])
        np.testing.assert_array_equal(gathered["pair"][0], [0, 1])
        np.testing.assert_array_equal(gathered["pair"][1][0], [0, 10])
    jmesh = make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])
    placed = jax.device_put(np.arange(2), batch_sharding(jmesh))
    want_rows = {shard.device: shard.index[0]
                 for shard in placed.addressable_shards}
    for r, out in enumerate(outs):
        mesh = out["mesh"]
        assert mesh["names"] == jmesh.axis_names
        assert mesh["shape"] == tuple(jmesh.devices.shape)
        assert mesh["world"] == 2
        rows = want_rows[jmesh.devices[r, 0]]
        assert mesh["rows"] == (rows.start, rows.stop)


def test_swin_overfit_two_steps_match_jax(swin_train, monkeypatch):
    """overfit for two steps from the port's seeded init (not doctored) on
    the B = 2 batch, against the JAX package's overfit from the same
    weights (its whole step uncompiled but for the value_and_grad above):
    each step's loss_total, the parameters after step 1 and after both
    steps, each group held to its own lr as tests/test_torch_overfit.py
    holds the ResNet's; the port's parameters moved."""
    s = swin_train
    tcfg, cfg, vg = s["tcfg"], s["cfg"], s["vg"]
    model = tdet.init_model(torch.Generator().manual_seed(0), tcfg,
                            device="cpu")
    state = {k: v.clone() for k, v in model.state_dict().items()}
    jloss, jafter1, loss, after1 = [], [], [], []

    real_jit, update = jax.jit, []

    def jax_step(params, opt_state, batch, cfg, optimizer, fixed_match):
        """The JAX package's train_step, its gradient from ``vg`` and its
        update compiled on its own."""
        assert fixed_match
        (_, metrics), grads = vg(params, batch=batch)
        if not update:
            def apply(grads, opt_state, params):
                updates, opt_state = optimizer.update(grads, opt_state,
                                                      params)
                return optax.apply_updates(params, updates), opt_state
            update.append(real_jit(apply))
        params, opt_state = update[0](grads, opt_state, params)
        jloss.append(float(metrics["loss_total"]))
        if not jafter1:
            jafter1.append(jax.tree.map(np.array, params))
        return params, opt_state, metrics

    real_tstep = tstep.train_step

    def port_step(model, *a, **k):
        out = real_tstep(model, *a, **k)
        loss.append(float(out["loss_total"]))
        if not after1:
            after1.append({n: p.detach().clone()
                           for n, p in model.named_parameters()})
        return out

    jparams0 = jax_params_of(model, cfg)
    monkeypatch.setattr(jdet, "init_model", lambda key, c: jparams0)
    monkeypatch.setattr(jstep, "train_step", jax_step)
    monkeypatch.setattr(tstep, "train_step", port_step)
    kw = dict(steps=2, lr=LR, seed=0, head_lr_mult=HEAD_MULT,
              query_scale=QUERY_SCALE)
    def jit_but_the_step(f, *a, **k):
        if isinstance(f, functools.partial) and f.func is jax_step:
            return f
        return real_jit(f, *a, **k)

    with monkeypatch.context() as m:
        m.setattr(jax, "jit", jit_but_the_step)
        jparams = jsyn.overfit(cfg, s["jb"], **kw)
    batch = tstep.make_train_batch(**s["arrays"])
    model = tsyn.overfit(tcfg, batch, device="cpu", state_dict=state, **kw)
    assert len(jloss) == len(loss) == 2
    np.testing.assert_allclose(loss[0], jloss[0], rtol=STEP_RTOL)
    np.testing.assert_allclose(loss[1], jloss[1], rtol=STEP2_RTOL)
    _grouped_lr_checks(model, tcfg, state, after1[0], jafter1[0], jparams)
