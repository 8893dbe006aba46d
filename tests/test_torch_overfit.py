"""The rest of training on the CPU, against the JAX package: the
training-mode BatchNorm, the backbone's BN calibration (replay check
included), the overfit recipe's norm caps, its two-group optimizer and
FPN gain fix, ``overfit`` itself for two steps from the JAX package's init,
and the sigmoid focal loss; and the port's own fg_bn calibration
(``calibrate_fg_bn``, ``overfit(fg_scale=...)``).

All at the tiny configuration of tests/test_train_eval_loop.py
(``_tiny_model_cfg``: R18, 20 slots, 4 decoder stages; the plain DCN)
and 32x64 frames of the synthetic scene (4 things, 7 GT slots).

Tolerances: batch_norm_train and the FPN fix rtol 1e-5 (f32 sums in
another order); each calibrated statistic within 2e-5 of its site's max
|statistic| (a site's input is the output of every layer before it, so the
two packages' f32 roundings compound over up to 20 conv + BN layers:
measured at most 3.0e-6 at the first site and 1.7e-5 at the last; entries
near 0 differ by up to 6e-3 of themselves, which is why no per-entry
rtol); the norm caps rtol 1e-4 (each package takes an f32 norm of up to
2.4M entries, summed in its own order: measured 1.2e-5 apart); the focal
loss rtol 1e-6; the
grouped optimizer fed the same gradients as optax within 1e-2 * lr * the
group's multiplier (f32 rounding of the same update; as
tests/test_torch_training.py states for AdamW).  ``overfit`` for two steps
from the JAX package's init: step 1's loss_total within STEP_RTOL of the
JAX package's (measured 2e-7) and step 2's within 1e-3 (measured 1.7e-4:
step 2 runs on parameters that already differ, below);
after step 1's update, every parameter within 2 * its group's lr of the
JAX package's (Adam's first update is lr * g / (|g| + eps): a gradient
entry near 0 whose sign differs between the two frameworks' sums moves
its parameter by up to lr the other way) and at least 97 % of the entries
within 1e-2 * the group's lr (measured 99.5 % of the trunk's, 99.9 % of
the heads'); after both steps, every parameter within 2 * (1 + 0.525 *
1.0014) * its group's lr (a sign flip in each step: the cosine decay's
second lr is 0.525 of the first, and Adam's second update is at most
1.0014 * its lr; measured 3.00 * the trunk's lr, 2.89 * the heads').  The
BN statistics recalibrated from parameters that differ that much differ
by up to 84 % of a site's max at layer 4 after two steps (the differences
compound through the backbone), so the test holds them by their
definition instead (see ``test_overfit_two_steps_match_jax``)."""

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import optax
import pytest
import torch

from slotvps_tpu.models import detector as jdet
from slotvps_tpu.models import layers as jL
from slotvps_tpu.models import resnet as jres
from slotvps_tpu.ops.focal_loss import sigmoid_focal_loss as jfocal
from slotvps_tpu.utils import synthetic as jsyn
from slotvps_tpu_torch import config as tconfig
from slotvps_tpu_torch.models import layers as tL
from slotvps_tpu_torch.models import resnet as tres
from slotvps_tpu_torch.ops.focal_loss import sigmoid_focal_loss
from slotvps_tpu_torch.utils import synthetic as tsyn
from slotvps_tpu_torch.utils.convert import _convert_leaf, from_jax_params

from test_torch_models import port_model, tiny_model_cfg

H, W = 32, 64
LR = 2e-3
HEAD_MULT = 4.0
QUERY_SCALE = 3.0
BN_STAT_TOL = 2e-5
CAP_RTOL = 1e-4
STEP_RTOL = 1e-4      # a step's loss, as tests/test_torch_training.py
STEP2_RTOL = 1e-3     # the second step's loss, on parameters that differ
ADAM2 = 1.0014        # Adam's second update at most, a multiple of its lr


def _jax_names(tree):
    """[(JAX keystr, port name, leaf)] of every leaf."""
    out = []
    for path, leaf in jtu.tree_flatten_with_path(tree)[0]:
        keys = tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
        out.append((jtu.keystr(path),
                    _convert_leaf(keys, np.asarray(leaf))[0], leaf))
    return out


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The module's torch work on one CPU thread: its tensors are tiny, and
    the test runner's parallel workers oversubscribe the cores when each
    torch process spins a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def init():
    """(JAX cfg, port cfg, JAX init params, the port's state of them)."""
    cfg = tiny_model_cfg()
    params = jdet.init_model(jax.random.PRNGKey(0), cfg)
    tcfg = tiny_model_cfg(config=tconfig)
    state = from_jax_params(jax.tree.map(np.asarray, params), tcfg)
    return cfg, tcfg, params, state


@pytest.fixture(scope="module")
def scene():
    return tsyn.make_scene(H, W, n_things=4, seed=0)


@pytest.mark.parametrize("shape,axes", [((2, 6, 10, 8), (0, 1, 2)),
                                        ((5, 8), (0,)),
                                        ((1, 1, 1, 3), (0, 1, 2))])
def test_batch_norm_train_matches_jax(shape, axes):
    """y and the new running statistics (momentum 0.1, unbiased batch
    variance; n = 1 keeps the variance's divisor at 1)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    c = shape[-1]
    p = {k: rng.standard_normal(c).astype(np.float32)
         for k in ("scale", "bias", "mean")}
    p["var"] = rng.random(c).astype(np.float32) + 0.5
    y_j, st_j = jL.batch_norm_train(p, jnp.asarray(x), axes)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    y, st = tL.batch_norm_train(torch.from_numpy(x), t["scale"], t["bias"],
                                t["mean"], t["var"], axes)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-5,
                               atol=1e-6)
    for k in ("mean", "var"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(st_j[k]),
                                   rtol=1e-5, atol=1e-7)


def test_calibrate_bn_stats_matches_jax(init, scene):
    """Every backbone BN's written mean and biased variance, with the
    replay check on both sides, on the [ref; cur] pair of the scene."""
    cfg, tcfg, params, state = init
    batch = tsyn.scene_train_batch(scene)
    x = np.concatenate([batch.ref_img.numpy(), batch.img.numpy()])
    jp = jax.tree.map(np.asarray, params)
    jres.calibrate_bn_stats(jp["backbone"], jnp.asarray(x), depth=18,
                            check=True)
    model = port_model(params, tcfg)
    tres.calibrate_bn_stats(model.backbone, torch.from_numpy(x), check=True)
    sites = list(tres.iter_bns(model.backbone))
    jsites = list(jres._iter_bns(jp["backbone"], 18))
    assert len(sites) == len(jsites) == 20
    for i, (bn, jbn) in enumerate(zip(sites, jsites)):
        for got, key in ((bn.running_mean, "mean"), (bn.running_var, "var")):
            want = np.asarray(jbn[key])
            np.testing.assert_allclose(
                got.numpy(), want, rtol=0,
                atol=BN_STAT_TOL * float(np.abs(want).max()),
                err_msg=f"site {i} {key}")


def test_calibrate_bn_stats_refuses_a_site_order_it_did_not_see(
        init, monkeypatch):
    """Statistics are paired with sites by the forward's own calls: an
    iter_bns in another order raises instead of writing mis-paired
    statistics."""
    _, tcfg, params, _ = init
    model = port_model(params, tcfg)
    order = list(tres.iter_bns(model.backbone))
    order[1], order[2] = order[2], order[1]
    monkeypatch.setattr(tres, "iter_bns", lambda bb: iter(order))
    x = torch.zeros((1, H, W, 3))
    with pytest.raises(RuntimeError, match="iter_bns"):
        tres.calibrate_bn_stats(model.backbone, x)


def test_norm_caps_match_jax(init):
    """Every parameter's cap decision and value against the JAX
    package's renorm, read off its effect: every leaf doubled (a zero leaf
    set to ones), then renormed: a capped leaf comes back at its cap, a
    free one unchanged."""
    cfg, tcfg, params, _ = init
    # a zero-init leaf (the DCN offset convs) must be among them
    jp = jax.tree.map(np.asarray, params)
    renorm = jsyn._norm_cap_fn(jp)
    up = jax.tree.map(lambda a: 2 * a if np.any(a) else np.ones_like(a), jp)
    after = renorm(up)
    jcap = {}
    for (ks, name, a), (_, _, b) in zip(_jax_names(up), _jax_names(after)):
        na = float(np.linalg.norm(np.asarray(a, np.float64)))
        nb = float(np.linalg.norm(np.asarray(b, np.float64)))
        jcap[name] = None if np.isclose(na, nb, rtol=1e-6) else nb
    model = port_model(params, tcfg)
    caps = tsyn.cap_map(model)
    assert set(caps) == {n for n in jcap if "running_" not in n}
    assert any(c == 0.007 for c in caps.values())
    assert any(c is None for c in caps.values())
    for name, cap in caps.items():
        if cap is None:
            assert jcap[name] is None, name
        else:
            assert jcap[name] == pytest.approx(cap, rel=CAP_RTOL), name
    # the port's renorm does the same to the same doubled parameters
    tren = tsyn._norm_cap_fn(model)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(2 * p if p.any() else torch.ones_like(p))
    tren(model)
    for ks, name, leaf in _jax_names(after):
        if "running_" in name:
            continue
        got = model.get_parameter(name).detach().numpy()
        want = np.asarray(leaf)
        if want.ndim == 4:
            want = want.transpose(3, 2, 0, 1)
        elif want.ndim == 2 and not name.endswith("init_mask_query"):
            want = want.T
        np.testing.assert_allclose(got, want, rtol=CAP_RTOL, atol=1e-7,
                                   err_msg=ks)


def test_grouped_optimizer_matches_optax(init):
    """Two steps fed the same gradients: step 1 the trunk's norm 100 (its
    group clips it) and the heads' 0.5 (their own norm: not clipped; a
    global clip would clip them too), step 2 both 0.5; cosine decay over 2
    steps; the frozen BN statistics unchanged."""
    cfg, tcfg, params, _ = init
    jp = jax.tree.map(np.asarray, params)
    model = port_model(params, tcfg)
    opt = tsyn._grouped_optimizer(model, LR, 10.0, decay_steps=2)
    heads = set(opt.groups["head"])
    assert heads and set(opt.groups["trunk"]).isdisjoint(heads)
    assert heads | set(opt.groups["trunk"]) == {
        n for n, _ in model.named_parameters()}
    rng = np.random.default_rng(1)
    names = _jax_names(jp)

    def grads_for(norms):
        out = {}
        for g, names_g in opt.groups.items():
            arrs = {n: rng.standard_normal(model.get_parameter(n).shape)
                    .astype(np.float32) for n in names_g}
            total = float(np.sqrt(sum(float((a * a).sum())
                                      for a in arrs.values())))
            out.update({n: (a * (norms[g] / total)).astype(np.float32)
                        for n, a in arrs.items()})
        return out

    steps = [grads_for({"trunk": 100.0, "head": 0.5}),
             grads_for({"trunk": 0.5, "head": 0.5})]
    jopt = jsyn._grouped_optimizer(jp, LR, 10.0, decay_steps=2)
    jstate = jopt.init(jp)
    update = jax.jit(jopt.update)
    leaves, treedef = jtu.tree_flatten(jp)
    for g in steps:
        jg = []
        for (_, name, leaf) in names:
            if name in g:
                a = g[name]
                a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else (
                    a.T if a.ndim == 2 and not name.endswith(
                        "init_mask_query") else a)
                jg.append(a)
            else:
                jg.append(np.ones_like(leaf))   # BN statistics: frozen
        upd, jstate = update(jtu.tree_unflatten(treedef, jg), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.zero_grad()
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(g[n])
        opt.step()
    want = from_jax_params(jp, tcfg)
    for n, p in model.named_parameters():
        mult = 10.0 if n in heads else 1.0
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   rtol=0, atol=1e-2 * LR * mult,
                                   err_msg=n)
    for n, b in model.named_buffers():
        assert torch.equal(b, want[n]), n


def test_fpn_gain_fix_matches_jax(init, scene):
    """The first call records each level's RMS; after the FPN's output
    convs are scaled (1.5, 0.5, 2, 1), the second call brings both
    packages' convs to the same weights."""
    cfg, tcfg, params, _ = init
    img = tsyn.scene_train_batch(scene).img.numpy()
    jp = jax.tree.map(np.asarray, params)
    model = port_model(params, tcfg)
    jfix = jsyn._fpn_gain_fix(cfg, jnp.asarray(img))
    tfix = tsyn._fpn_gain_fix(tcfg, torch.from_numpy(img))
    jfix(jp)
    tfix(model)
    gains = (1.5, 0.5, 2.0, 1.0)
    for lvl, g in enumerate(gains):
        conv = jp["fpn"]["fpn"][lvl]
        conv["w"] = conv["w"] * g
        conv["b"] = conv["b"] + 0.1
        with torch.no_grad():
            model.fpn.fpn[lvl].weight.mul_(g)
            model.fpn.fpn[lvl].bias.add_(0.1)
    jfix(jp)
    tfix(model)
    for lvl in range(len(gains)):
        conv = model.fpn.fpn[lvl]
        np.testing.assert_allclose(
            conv.weight.detach().numpy(),
            np.asarray(jp["fpn"]["fpn"][lvl]["w"]).transpose(3, 2, 0, 1),
            rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(conv.bias.detach().numpy(),
                                   np.asarray(jp["fpn"]["fpn"][lvl]["b"]),
                                   rtol=1e-5, atol=1e-8)


def test_overfit_two_steps_match_jax(init, scene, monkeypatch):
    """overfit for two steps (query scale 3, heads at 4 x lr, cosine decay
    over 2 steps) from the JAX package's init carried across.  Each step's
    loss_total against the JAX package's; the parameters right after step
    1's update, and after both steps, each group held to its own lr (see
    the module's docstring); the port's parameters moved.  The backbone's
    BN statistics are recalibrated after each step from parameters that
    differ, so they are held by what they are: the JAX package's equal the
    port's calibration of the JAX package's final parameters (BN_STAT_TOL
    of each site's max), and the port's equal its calibration of its own
    final parameters, bit for bit; the head's frozen BNs are untouched."""
    from slotvps_tpu.training import step as jstep
    from slotvps_tpu_torch.training import step as tstep

    cfg, tcfg, params, state = init
    jloss, jafter1, loss, after1 = [], [], [], []
    real_jstep, real_tstep = jstep.train_step, tstep.train_step

    def jax_step(*a, **k):                 # traced once, inside jit
        out = real_jstep(*a, **k)

        def record(total, p):
            jloss.append(float(total))
            if not jafter1:
                jafter1.append(jax.tree.map(np.array, p))
        jax.debug.callback(record, out[2]["loss_total"], out[0])
        return out

    def port_step(model, *a, **k):
        out = real_tstep(model, *a, **k)
        loss.append(float(out["loss_total"]))
        if not after1:
            after1.append({n: p.detach().clone()
                           for n, p in model.named_parameters()})
        return out

    monkeypatch.setattr(jstep, "train_step", jax_step)
    monkeypatch.setattr(tstep, "train_step", port_step)
    kw = dict(steps=2, lr=LR, seed=0, head_lr_mult=HEAD_MULT,
              query_scale=QUERY_SCALE)
    jparams = jsyn.overfit(cfg, jsyn.scene_train_batch(scene), **kw)
    batch = tsyn.scene_train_batch(scene)
    model = tsyn.overfit(tcfg, batch, device="cpu", state_dict=state, **kw)
    assert len(jloss) == len(loss) == 2
    np.testing.assert_allclose(loss[0], jloss[0], rtol=STEP_RTOL)
    np.testing.assert_allclose(loss[1], jloss[1], rtol=STEP2_RTOL)

    want = _grouped_lr_checks(model, tcfg, state, after1[0], jafter1[0],
                              jparams)
    both = torch.cat([batch.ref_img, batch.img])
    got = {k: v.clone() for k, v in model.state_dict().items()}
    tres.calibrate_bn_stats(model.backbone, both)
    jmodel = port_model(jparams, tcfg)
    tres.calibrate_bn_stats(jmodel.backbone, both)
    for n, b in model.named_buffers():
        if not n.startswith("backbone."):
            assert torch.equal(got[n], state[n]), n
            continue
        assert torch.equal(got[n], b), n
        np.testing.assert_allclose(
            jmodel.get_buffer(n).numpy(), want[n].numpy(), rtol=0,
            atol=BN_STAT_TOL * float(want[n].abs().max()), err_msg=n)


def _grouped_lr_checks(model, tcfg, state, after1, jafter1, jparams):
    """Two overfit steps' parameters against the JAX package's, each
    group held to its own lr (see the module's docstring): ``after1`` /
    ``jafter1`` right after step 1's update (every entry within 2 * lr, 97 %
    within 1e-2 * lr), ``model`` / ``jparams`` after both steps; the port's
    parameters moved from ``state``.  Returns the JAX package's final
    state mapped by from_jax_params."""
    heads = set(tsyn._grouped_optimizer(model, LR, HEAD_MULT).groups["head"])
    group_lr = {n: LR * (HEAD_MULT if n in heads else 1.0)
                for n, _ in model.named_parameters()}
    want1 = from_jax_params(jafter1, tcfg)
    near = {"trunk": [0, 0], "head": [0, 0]}
    for n, got in after1.items():
        d = (got - want1[n]).abs()
        assert float(d.max()) <= 2 * group_lr[n] * (1 + 1e-3), n
        g = near["head" if n in heads else "trunk"]
        g[0] += int((d <= 1e-2 * group_lr[n]).sum())
        g[1] += d.numel()
    for g, (close, total) in near.items():
        assert close >= 0.97 * total, (g, close / total)

    want = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg)
    two_steps = 2 * (1 + tsyn._cosine_decay(1.0, 2)(1) * ADAM2)
    moved = 0
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   rtol=0, atol=two_steps * group_lr[n],
                                   err_msg=n)
        moved += int(not torch.equal(p.detach(), state[n]))
    assert moved > 0.9 * len(list(model.parameters()))
    return want


def test_overfit_keeps_a_copy_of_the_best_state(init, scene, monkeypatch,
                                                capsys):
    """The port alone, 3 steps with the probe every 2 steps from step 2
    on (the recipe's 20 and 100, scaled down): the probe fires at step 2,
    step 3 then changes the parameters in place, and the returned model
    holds the state the probe saw, not the last one: the best state is a
    copy."""
    from slotvps_tpu_torch.models import detector
    from slotvps_tpu_torch.training import step as tstep

    _, tcfg, _, state = init
    seen, last = [], []
    real_extract, real_step = detector.extract_features, tstep.train_step

    def extract(model, cfg, img):        # only the probe calls it
        seen.append({k: v.clone() for k, v in model.state_dict().items()})
        return real_extract(model, cfg, img)

    def step(model, *a, **k):
        out = real_step(model, *a, **k)
        last[:] = [{k: v.clone() for k, v in model.state_dict().items()}]
        return out

    monkeypatch.setattr(detector, "extract_features", extract)
    monkeypatch.setattr(tstep, "train_step", step)
    monkeypatch.setattr(tsyn, "PROBE_EVERY", 2)
    monkeypatch.setattr(tsyn, "PROBE_FROM", 2)
    model = tsyn.overfit(tcfg, tsyn.scene_train_batch(scene), steps=3,
                         lr=LR, device="cpu", state_dict=state, log_every=3,
                         head_lr_mult=HEAD_MULT, query_scale=QUERY_SCALE)
    assert len(seen) == 1 and "best @ step 2" in capsys.readouterr().out
    final = model.state_dict()
    assert all(torch.equal(final[k], v) for k, v in seen[0].items())
    assert any(not torch.equal(last[0][k], v) for k, v in seen[0].items())


def _mask_logits(model, tcfg, img):
    from slotvps_tpu_torch.models.detector import (decode_pair,
                                                   extract_features)

    with torch.no_grad():
        f = extract_features(model, tcfg, img)
        return decode_pair(model, tcfg, f, f).pred_masks.float()


def test_calibrate_fg_bn_centres_the_mask_logits(init, scene):
    """The port's own step (the JAX package has none): after
    calibrate_fg_bn the mask logits of the frame it saw have mean 0 and
    standard deviation ``scale`` (f32 statistics of 20 x 8 x 16 logits:
    within 1e-4 of ``scale``), and nothing but fg_bn changed."""
    scale = 2.0
    _, tcfg, params, state = init
    model = port_model(params, tcfg)
    img = tsyn.scene_train_batch(scene).img
    before = _mask_logits(model, tcfg, img)
    tsyn.calibrate_fg_bn(model, tcfg, img, scale)
    after = _mask_logits(model, tcfg, img)
    var, mean = torch.var_mean(after, correction=0)
    assert abs(float(mean)) <= 1e-4 * scale
    np.testing.assert_allclose(float(var.sqrt()), scale, rtol=1e-4)
    # an affine map of the same logits
    np.testing.assert_allclose(
        after.numpy(), ((before - before.mean()) / before.std(
            correction=0) * scale).numpy(), rtol=1e-3, atol=1e-3 * scale)
    got = model.state_dict()
    assert float(got["fg_bn.weight"]) == scale
    assert float(got["fg_bn.bias"]) == 0.0
    for k, v in state.items():
        if not k.startswith("fg_bn."):
            assert torch.equal(got[k], v), k


def test_overfit_calibrates_fg_bn_once_before_the_first_step(
        init, scene, monkeypatch):
    """With ``fg_scale`` the calibration runs once, after the backbone's
    BN calibration and before the first step (without it the recipe is
    the JAX package's: ``test_overfit_two_steps_match_jax``)."""
    from slotvps_tpu_torch.training import step as tstep

    _, tcfg, _, state = init
    events = []
    real_fg, real_bn = tsyn.calibrate_fg_bn, tres.calibrate_bn_stats
    real_step = tstep.train_step
    monkeypatch.setattr(tsyn, "calibrate_fg_bn", lambda m, c, img, s: (
        events.append(("fg", s)), real_fg(m, c, img, s))[1])
    monkeypatch.setattr(tres, "calibrate_bn_stats", lambda *a, **k: (
        events.append(("bn",)), real_bn(*a, **k))[1])
    monkeypatch.setattr(tstep, "train_step", lambda *a, **k: (
        events.append(("step",)), real_step(*a, **k))[1])
    tsyn.overfit(tcfg, tsyn.scene_train_batch(scene), steps=1, lr=LR,
                 device="cpu", state_dict=state, fg_scale=1.5)
    assert events == [("bn",), ("fg", 1.5), ("step",), ("bn",)]


def test_sigmoid_focal_loss_matches_jax():
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((37, 8)) * 4).astype(np.float32)
    targets = rng.integers(0, 9, 37).astype(np.int32)
    want = np.asarray(jfocal(jnp.asarray(logits), jnp.asarray(targets)))
    got = sigmoid_focal_loss(torch.from_numpy(logits),
                             torch.from_numpy(targets))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    got = sigmoid_focal_loss(torch.from_numpy(logits),
                             torch.from_numpy(targets), gamma=1.5, alpha=0.4)
    want = np.asarray(jfocal(jnp.asarray(logits), jnp.asarray(targets),
                             gamma=1.5, alpha=0.4))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
