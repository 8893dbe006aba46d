"""Port parity of the training step on the CPU: each loss against its JAX
function (with ``fixed_match`` both ways, the Hungarian matching on the
host), the whole ``loss_fn`` and its gradient tree for the small R18 model
at ``dcn_impl="jax"`` against ``jax.value_and_grad`` of the JAX package's
(the gradient tree mapped by ``from_jax_params``), two AdamW steps and the
weight decay against ``optax``, the frozen BN statistics, ``lr_schedule``, ``make_batch`` on a
tiny on-disk dataset, and the synthetic scene's TrainBatch.  The DCN
tower's gradients on the kernel routes ("pallas", "pallas_f32") are held
at block level in tests/test_torch_dcn_backward.py.

The JAX package's ``match_slots`` reads ``optax.assignment.
hungarian_algorithm(cost.T)``'s column indices as if its rows came back in
GT order; for a wide matrix (fewer GT than slots) they come back in
``top_k`` order, so GT g gets the slot matched to another GT (a fault of
the JAX package, shown by ``test_jax_matching_reads_rows_out_of_order``).
The port assigns by row index.  Where a test holds the port's matching
against the JAX package's, the JAX side runs with that function read by row
index (``jax_matching_by_row``); the JAX package is not edited.

Tolerances: the losses rtol 1e-5 (f32 on both sides, sums in another
order); loss_fn's terms rtol 1e-4 and each gradient tensor within
3e-3 * max(max|g|, 1e-5) of it (f32 through ~20 layers forward and back;
measured at most 2.1e-3, on the first DCN block's weight, whose gradient
sums four levels through GroupNorm, and on the FPN below it; the
semantic head alone agrees to 1e-6; a gradient that is 0 in exact
arithmetic is noise of ~1e-8); the
optimizer fed the same gradients as optax within 1e-2 * lr (f32 rounding
of the same update); the parameters after two whole steps within 4 * lr of
the JAX package's: Adam's first updates are lr * g / (|g| + eps), so a
gradient entry near 0 whose sign differs between the two frameworks' sums
moves its parameter by up to 2 * lr a step (measured: 6 % of the entries
move more than 1e-2 * lr apart, the largest 2.9 * lr)."""

import contextlib
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from slotvps_tpu import config as jconfig
from slotvps_tpu.training import losses as jlosses
from slotvps_tpu.training import step as jstep
from slotvps_tpu_torch import config as tconfig
from slotvps_tpu_torch.training import losses as tlosses
from slotvps_tpu_torch.training import step as tstep
from slotvps_tpu_torch.utils.convert import from_jax_params

from test_torch_bf16 import soften_retrievers
from test_torch_models import doctored_params, port_model, tiny_model_cfg

H, W = 32, 64
G = 6
LOSS_RTOL = 1e-5
STEP_RTOL = 1e-4
GRAD_RTOL = 3e-3
GRAD_FLOOR = 1e-5
ADAM_ATOL = 1e-6          # 1e-2 * lr


def _t(a):
    return torch.from_numpy(np.array(a))


def _hungarian_by_row(cost):
    """optax's Hungarian solution with its column indices put in row
    order."""
    rows, cols = optax.assignment.hungarian_algorithm(cost)
    return (jnp.arange(cost.shape[0]),
            jnp.zeros(cost.shape[0], cols.dtype).at[rows].set(cols))


@contextlib.contextmanager
def jax_matching_by_row():
    """The JAX package's losses with the Hungarian solution read by row
    index (a test-side patch of the module's ``assignment`` name)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlosses, "assignment", types.SimpleNamespace(
            hungarian_algorithm=_hungarian_by_row))
        yield


def test_jax_matching_reads_rows_out_of_order(rng):
    """The fault the patch above works around: on a wide cost matrix
    optax returns the rows out of order, so the JAX package's slot_idx
    differs from the row-wise assignment, which the port computes."""
    logits, masks, labels, gt_masks, valid = _loss_case(rng)
    args = (jax.nn.softmax(jnp.asarray(logits)),
            jlosses.dice_similarity(jnp.asarray(masks),
                                    jnp.asarray(gt_masks)),
            jnp.asarray(labels), jnp.asarray(valid))
    raw, _ = jlosses.match_slots(*args)
    with jax_matching_by_row():
        by_row, _ = jlosses.match_slots(*args)
    cost = tlosses.match_cost(*(_t(a) for a in args))
    ours = tlosses.hungarian([cost])[0].numpy()
    np.testing.assert_array_equal(ours[valid], np.asarray(by_row)[valid])
    assert (np.asarray(raw)[valid] != ours[valid]).any()


def _loss_case(rng, n_slots=10, g=G, h=8, w=12, n_cls=19, n_valid=4):
    logits = rng.standard_normal((n_slots, n_cls)).astype(np.float32) * 2
    masks = rng.standard_normal((n_slots, h, w)).astype(np.float32) * 3
    gt_masks = (rng.random((g, h, w)) < 0.3).astype(np.float32)
    labels = rng.integers(0, n_cls, g).astype(np.int32)
    valid = np.arange(g) < n_valid
    return logits, masks, labels, gt_masks, valid


@pytest.mark.parametrize("fixed_match", [False, True])
def test_pq_loss_matches_jax(rng, fixed_match):
    logits, masks, labels, gt_masks, valid = _loss_case(rng)
    with jax_matching_by_row():
        ref, ref_idx = jlosses.pq_loss_with_match(
            *(jnp.asarray(a) for a in (logits, masks, labels, gt_masks,
                                       valid)), fixed_match=fixed_match)
    ours, idx = tlosses.pq_loss_with_match(
        *(_t(a) for a in (logits, masks, labels, gt_masks, valid)),
        fixed_match=fixed_match)
    for k in ref:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]),
                                   rtol=LOSS_RTOL)
    # only the valid GT rows' assignment is defined (invalid rows cost 0)
    np.testing.assert_array_equal(idx.numpy()[valid],
                                  np.asarray(ref_idx)[valid])
    plain = tlosses.pq_loss(*(_t(a) for a in (logits, masks, labels,
                                               gt_masks, valid)),
                            fixed_match=fixed_match)
    for k in ref:
        assert torch.equal(plain[k], ours[k])


def test_dice_and_matching_match_jax(rng):
    logits, masks, labels, gt_masks, valid = _loss_case(rng, n_slots=12)
    dice = tlosses.dice_similarity(_t(masks), _t(gt_masks))
    ref = jlosses.dice_similarity(jnp.asarray(masks), jnp.asarray(gt_masks))
    np.testing.assert_allclose(dice.numpy(), np.asarray(ref), rtol=1e-6)
    probs = torch.softmax(_t(logits), -1)
    idx, v = tlosses.match_slots(probs, dice, _t(labels), _t(valid))
    with jax_matching_by_row():
        jidx, _ = jlosses.match_slots(jax.nn.softmax(jnp.asarray(logits)),
                                      ref, jnp.asarray(labels),
                                      jnp.asarray(valid))
    np.testing.assert_array_equal(idx.numpy()[valid],
                                  np.asarray(jidx)[valid])
    assert len(set(idx.tolist())) == G       # an assignment: distinct slots
    # several matrices in one round trip give each its own assignment
    costs = [tlosses.match_cost(probs, dice, _t(labels), _t(valid)),
             tlosses.match_cost(probs.flip(0), dice.flip(0), _t(labels),
                                _t(valid))]
    a, b = tlosses.hungarian(costs)
    assert torch.equal(a, idx)
    np.testing.assert_array_equal((11 - b).numpy()[valid], idx[valid])


def test_match_and_insdis_losses_match_jax(rng):
    from slotvps_tpu.models.track_head import init_track_head
    from slotvps_tpu_torch.models.track_head import TrackHead

    tcfg = jconfig.TrackHeadConfig()
    d = tcfg.in_channels_query
    tp = init_track_head(jax.random.PRNGKey(0), tcfg)
    head = TrackHead(torch.Generator().manual_seed(0),
                     tconfig.TrackHeadConfig())
    head.load_state_dict({f"fcs.{i}.{n}": _t(
        np.asarray(fc["w"]).T if n == "weight" else fc["b"])
        for i, fc in enumerate(tp["fcs"]) for n in ("weight", "bias")})
    cur = rng.standard_normal((10, d)).astype(np.float32)
    ref = rng.standard_normal((10, d)).astype(np.float32)
    cur_idx = rng.permutation(10)[:G]
    ref_idx = rng.permutation(10)[:G]
    pids = np.array([1, 0, 3, 2, 5, 0], np.int32)
    valid = np.array([1, 1, 1, 1, 0, 0], bool)
    ref_valid = np.array([1, 1, 0, 1, 1, 0], bool)
    want = jlosses.match_loss(*(jnp.asarray(a) for a in (
        cur, ref, cur_idx, ref_idx, pids, valid, ref_valid)), tp)
    with torch.no_grad():
        ours = tlosses.match_loss(head, *(_t(a) for a in (
            cur, ref, cur_idx, ref_idx, pids, valid, ref_valid)))
    np.testing.assert_allclose(float(ours), float(want), rtol=LOSS_RTOL)

    feat = rng.standard_normal((8, 12, 16)).astype(np.float32)
    feat /= np.linalg.norm(feat, axis=-1, keepdims=True)
    _, _, _, gt_masks, gvalid = _loss_case(rng)
    want = jlosses.insdis_loss(jnp.asarray(feat), jnp.asarray(gt_masks),
                               jnp.asarray(gvalid))
    ours = tlosses.insdis_loss(_t(feat), _t(gt_masks), _t(gvalid))
    np.testing.assert_allclose(float(ours), float(want), rtol=LOSS_RTOL)


def _batch(seed=0, b=1):
    """A seeded TrainBatch (numpy): blob GT masks at quarter resolution,
    4 of G valid, a semantic map with ignored pixels."""
    rng = np.random.default_rng(seed)
    qh, qw = H // 4, W // 4
    img = 0.25 * rng.standard_normal((b, H, W, 3)).astype(np.float32)
    ref_img = np.roll(img, 2, axis=2)
    masks = np.zeros((b, G, qh, qw), np.float32)
    for i in range(b):
        for j in range(G):
            y, x = rng.integers(0, qh - 3), rng.integers(0, qw - 4)
            masks[i, j, y:y + 3, x:x + 4] = 1
    labels = rng.integers(0, 19, (b, G)).astype(np.int32)
    valid = np.tile(np.arange(G) < 4, (b, 1))
    sem = rng.integers(0, 19, (b, qh, qw)).astype(np.int32)
    sem[:, :2] = 255
    pids = np.where(valid, np.arange(1, G + 1), 0).astype(np.int32)
    pids[:, 1] = 0
    return dict(img=img, ref_img=ref_img, gt_labels=labels, gt_masks=masks,
                gt_valid=valid, gt_semantic=sem, ref_gt_labels=labels,
                ref_gt_masks=np.roll(masks, 1, axis=-1),
                ref_gt_valid=valid, gt_pids=pids)


@pytest.fixture(scope="module")
def jax_step():
    """JAX params of the tiny model, the batch, and the JAX package's jitted
    value_and_grad of loss_fn (fixed_match=True) with its value at the
    params."""
    cfg = tiny_model_cfg()
    # the Retriever's q and k LayerNorm scales quartered: at init its
    # unscaled slot softmax (scores ~100) turns f32 rounding differences
    # into ~1e-2 gradient differences over a whole decode
    params = soften_retrievers(doctored_params(cfg, fg_scale=0.1,
                                               fg_var=1.0), 0.25)
    arrays = _batch()
    jb = jstep.make_train_batch(**{k: jnp.asarray(v)
                                   for k, v in arrays.items()})
    vg = jax.jit(jax.value_and_grad(functools.partial(
        jstep.loss_fn, cfg=cfg, fixed_match=True), has_aux=True))
    (_, metrics), grads = vg(params, batch=jb)
    return cfg, params, arrays, jb, vg, (metrics, grads)


def _close_terms(ours, metrics):
    assert set(ours) == set(metrics)
    for k in metrics:
        np.testing.assert_allclose(float(ours[k].detach()), float(metrics[k]),
                                   rtol=STEP_RTOL, err_msg=k)


def test_loss_fn_and_gradients_match_jax(jax_step):
    """The whole forward and backward of the step at dcn_impl="jax": every
    loss term, and every parameter's gradient against the JAX gradient
    tree mapped by from_jax_params (the BN statistics get none)."""
    cfg, params, arrays, _, _, (metrics, grads) = jax_step
    tcfg = tiny_model_cfg(config=tconfig)
    model = port_model(params, tcfg)
    total, ours = tstep.loss_fn(model, tcfg,
                                tstep.make_train_batch(**arrays),
                                fixed_match=True)
    assert list(ours)[-1] == "loss_total" and len(ours) == 8
    _close_terms(ours, metrics)
    total.backward()
    want = from_jax_params(jax.tree.map(np.asarray, grads), tcfg)
    named = dict(model.named_parameters())
    assert set(named) | set(dict(model.named_buffers())) == set(want)
    for name, p in named.items():
        g = want[name].numpy()
        assert p.grad is not None, name
        # a gradient that is zero in exact arithmetic (the q LayerNorm
        # bias under the slot softmax) is f32 noise on both sides
        scale = max(np.abs(g).max(), GRAD_FLOOR)
        err = np.abs(p.grad.numpy() - g).max()
        assert err <= GRAD_RTOL * scale, (name, err, scale)
    for b in model.buffers():
        assert b.grad is None


def test_loss_fn_with_matching_matches_jax(jax_step):
    """fixed_match=False: every matching of the step (current frame,
    reference frame, three auxiliary stages) in one host round trip, the
    loss terms against the JAX package's (its matching read by row)."""
    cfg, params, arrays, jb, _, _ = jax_step
    with jax_matching_by_row():
        metrics = jax.jit(functools.partial(
            jstep.loss_fn, cfg=cfg, fixed_match=False))(params, batch=jb)[1]
    tcfg = tiny_model_cfg(config=tconfig)
    model = port_model(params, tcfg)
    calls = []
    real = tstep.hungarian

    def counting(costs):
        calls.append(len(costs))
        return real(costs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tstep, "hungarian", counting)
        with torch.no_grad():
            _, ours = tstep.loss_fn(model, tcfg,
                                    tstep.make_train_batch(**arrays))
    assert calls == [2 + 3]
    _close_terms(ours, metrics)


def test_two_adamw_steps_match_optax(jax_step):
    """The port's train_step twice.  Its optimizer entry by entry against
    the JAX package's make_optimizer (optax) fed the same gradients: every
    parameter within ADAM_ATOL of it.  The whole step against the JAX
    package's two steps on its own gradients: the loss after them within
    STEP_RTOL, every parameter within 4 * lr (Adam's first updates are
    lr * g / (|g| + eps), so an entry whose gradient lies near 0 and
    differs in sign between the two frameworks' sums moves by up to 2 * lr
    a step), and the BN statistics bit-unchanged on both sides."""
    cfg, params, arrays, jb, vg, (jm, grads) = jax_step
    lr = 1e-4
    opt = jstep.make_optimizer(lr=lr, params=params)

    @jax.jit
    def update(grads, state, p):
        updates, state = opt.update(grads, state, p)
        return optax.apply_updates(p, updates), state

    state = opt.init(params)
    jp = params
    for i in range(2):
        if i:
            (_, jm), grads = vg(jp, batch=jb)
        jp, state = update(grads, state, jp)

    tcfg = tiny_model_cfg(config=tconfig)
    model = port_model(params, tcfg)
    before = {k: v.clone() for k, v in model.named_buffers()}
    start = [p.detach().numpy().copy() for p in model.parameters()]
    topt = tstep.make_optimizer(model, lr=lr)
    # the gradients each step hands its optimizer
    seen, real_step = [], topt.step

    def recording_step():
        seen.append([p.grad.numpy().copy() for p in topt.params])
        real_step()

    topt.step = recording_step
    batch = tstep.make_train_batch(**arrays)
    for _ in range(2):
        tm = tstep.train_step(model, topt, batch, tcfg, fixed_match=True)
    assert topt.count == 2

    # the optimizer: the JAX package's chain (clip, adamw) on the same
    # gradients, over the parameters (the BN statistics are buffers)
    ref_opt = jstep.make_optimizer(lr=lr)
    ref = [jnp.asarray(p) for p in start]
    ref_state = ref_opt.init(ref)
    for step in seen:
        updates, ref_state = ref_opt.update([jnp.asarray(g) for g in step],
                                            ref_state, ref)
        ref = optax.apply_updates(ref, updates)
    for (name, p), r in zip(model.named_parameters(), ref):
        d = np.abs(p.detach().numpy() - np.asarray(r)).max()
        assert d <= ADAM_ATOL, (name, d)

    np.testing.assert_allclose(float(tm["loss_total"]),
                               float(jm["loss_total"]), rtol=STEP_RTOL)
    want = from_jax_params(jax.tree.map(np.asarray, jp), tcfg)
    init = from_jax_params(jax.tree.map(np.asarray, params), tcfg)
    moved = 0
    for name, p in model.named_parameters():
        d = np.abs(p.detach().numpy() - want[name].numpy()).max()
        assert d <= 4 * lr, (name, d)
        moved += int(not torch.equal(p.detach(), init[name]))
    assert moved > 0.9 * len(dict(model.named_parameters()))
    for name, b in model.named_buffers():
        assert torch.equal(b, before[name]), name
        np.testing.assert_array_equal(b.numpy(), want[name].numpy())


def test_adamw_weight_decay_matches_optax(rng):
    """Two steps of the port's AdamW against optax's chain on large
    parameters, with the gradient 0 on half of the entries, so that the
    decoupled weight decay alone moves those (lr and the decay raised: at
    the reference's 1e-4 and 1e-4 it changes a parameter by 1e-8 of
    itself, under f32's resolution in either framework)."""
    lr, wd = 1e-2, 0.1
    params = [rng.standard_normal(s).astype(np.float32) * 50
              for s in ((6, 5), (11,))]
    grads = [[np.where(rng.random(p.shape) < 0.5, 0,
                       rng.standard_normal(p.shape)).astype(np.float32)
              for p in params] for _ in range(2)]
    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adamw(lr, weight_decay=wd))
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    ours = [torch.nn.Parameter(_t(p)) for p in params]
    topt = tstep.AdamW(ours, lr=lr, weight_decay=wd, clip_norm=1.0)
    for step in grads:
        updates, state = opt.update([jnp.asarray(g) for g in step], state,
                                    jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(ours, step):
            p.grad = _t(g)
        topt.step()
    for p, p0, g, ref in zip(ours, params, zip(*grads), jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref),
                                   rtol=1e-6, atol=1e-5)
        still = (g[0] == 0) & (g[1] == 0)
        assert still.any()
        np.testing.assert_allclose(p.detach().numpy()[still],
                                   p0[still] * (1 - lr * wd) ** 2,
                                   rtol=1e-6)


def test_lr_schedule_matches_jax():
    from slotvps_tpu.cli.train import lr_schedule as jax_schedule
    from slotvps_tpu_torch.cli.train import lr_schedule

    ours, ref = lr_schedule(1e-4, 40), jax_schedule(1e-4, 40)
    for count in (0, 1, 250, 320, 439, 440, 499, 500, 501, 800):
        np.testing.assert_allclose(ours(count), float(ref(count)),
                                   rtol=1e-6, err_msg=str(count))
    assert ours(0) == pytest.approx(1e-4 / 3)


def test_optimizer_first_update_uses_schedule_zero():
    """Update n uses schedule(n): with AdamW's first step a sign step,
    each parameter moves by schedule(0) (no weight decay, no clip)."""
    p = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    opt = tstep.AdamW([p], lr=lambda n: 0.1 * (n + 1), weight_decay=0.0,
                      clip_norm=1e9)
    p.grad = torch.tensor([3.0, -5.0])
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), [0.9, -1.9], rtol=1e-6)
    assert opt.count == 1


def test_clip_by_global_norm_matches_optax(rng):
    grads = [rng.standard_normal(s).astype(np.float32) * 3
             for s in ((4, 5), (7,), (2, 3, 2))]
    for max_norm in (1.0, 1e3):
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], None)
        ours = [_t(g) for g in grads]
        tstep._clip_by_global_norm(ours, max_norm)
        for a, b in zip(ours, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_scene_train_batch_matches_jax():
    from slotvps_tpu.utils import synthetic as jsyn
    from slotvps_tpu_torch.utils import synthetic as tsyn

    scene = tsyn.make_scene(32, 64, n_things=3, seed=1)
    ref_scene = jsyn.make_scene(32, 64, n_things=3, seed=1)
    for a, b in zip(scene, ref_scene):
        np.testing.assert_array_equal(a, b)
    ours = tsyn.scene_train_batch(scene, shift=4, g_cap=8)
    ref = jsyn.scene_train_batch(ref_scene, shift=4, g_cap=8)
    assert isinstance(ours, tstep.TrainBatch)
    for name, a, b in zip(tstep.TrainBatch._fields, ours, ref):
        assert isinstance(a, torch.Tensor), name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    for a, b in zip(tsyn.scene_frames(scene, 2, 4),
                    jsyn.scene_frames(ref_scene, 2, 4)):
        np.testing.assert_array_equal(a, b)


def test_make_batch_matches_jax(tmp_path):
    """The CLI's batch assembly through the real train pipeline (cv2) on a
    tiny on-disk dataset: the same seeded rng gives the same batch."""
    from argparse import Namespace

    from slotvps_tpu.cli.train import make_batch as jax_make_batch
    from slotvps_tpu.data.dataset import RepeatDataset as JRepeat
    from slotvps_tpu.data.transforms import TrainAugConfig as JAug
    from slotvps_tpu_torch.cli.train import make_batch
    from slotvps_tpu_torch.data.dataset import (CityscapesVPSDataset,
                                                RepeatDataset)
    from slotvps_tpu_torch.data.transforms import TrainAugConfig

    from test_training import _disk_dataset

    jds = _disk_dataset(tmp_path)
    ds = CityscapesVPSDataset(str(tmp_path / "ann.json"), str(tmp_path))
    args = Namespace(offsets="0_shift_3", seg_prefix=None, crop=(32, 64),
                     gt_capacity=8)
    kw = dict(img_scale=(128, 64), ratio_range=(1.0, 1.0),
              crop_size=(32, 64), shift_padding=5)
    idxs = [len(ds) * 8 - 1, len(ds), 1]
    ours = make_batch(RepeatDataset(ds, 8), idxs, args,
                      tconfig.named_config("r50_fpn_slotvps"),
                      np.random.default_rng(0), TrainAugConfig(**kw))
    ref = jax_make_batch(JRepeat(jds, 8), idxs, args,
                         jconfig.named_config("r50_fpn_slotvps"),
                         np.random.default_rng(0), JAug(**kw))
    assert ours.img.shape == (3, 32, 64, 3) and ours.gt_valid.any()
    for name, a, b in zip(tstep.TrainBatch._fields, ours, ref):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def test_train_step_refuses_bf16_training():
    tcfg = dataclasses.replace(tiny_model_cfg(config=tconfig),
                               compute_dtype="bfloat16")
    model = tstep.Detector(torch.Generator().manual_seed(0), tcfg)
    with pytest.raises(NotImplementedError, match="float32"):
        tstep.loss_fn(model, tcfg, tstep.make_train_batch(**_batch()))


def test_train_state_round_trip(tmp_path):
    """cli/train.py's torch.save train state: the model, the optimizer's
    moments and count, and the step come back."""
    from slotvps_tpu_torch.cli import train as cli

    tcfg = tiny_model_cfg(config=tconfig)
    model = tstep.Detector(torch.Generator().manual_seed(0), tcfg)
    opt = tstep.make_optimizer(model)
    for p in model.parameters():
        p.grad = torch.full_like(p, 0.5)
    opt.step()
    path = tmp_path / "epoch_1.pt"
    cli.save_train_state(path, model, opt, 7)
    model2 = tstep.Detector(torch.Generator().manual_seed(1), tcfg)
    opt2 = tstep.make_optimizer(model2)
    assert cli.load_train_state(path, model2, opt2, "cpu") == 7
    assert opt2.count == 1
    for (k, a), b in zip(model.state_dict().items(),
                         model2.state_dict().values()):
        assert torch.equal(a, b), k
    m1 = opt.state_dict()["adamw"]["state"]
    m2 = opt2.state_dict()["adamw"]["state"]
    assert set(m1) == set(m2)
    for i in m1:
        assert torch.equal(m1[i]["exp_avg"], m2[i]["exp_avg"])


def test_train_cli_runs_the_eval_hook(tmp_path, monkeypatch):
    """cli.train.main with --eval_every 1 on the CPU: one epoch of two
    steps on a tiny on-disk dataset (tests/test_training.py's, one video
    of two 64x128 frames, 128x128 crops: the pseudo-video shift pads by
    50 px), then the val VPQ hook on
    tests/test_eval_hooks.py's 2-frame fixture; the hook writes its
    vpq-final.txt under work_dir/val_epoch_1.  The CLI's named config is
    the tiny model at the fixture's frame size."""
    from slotvps_tpu_torch.cli import train as cli

    from test_eval_hooks import _write_fixture
    from test_torch_eval_hooks import _run_cfg
    from test_training import _disk_dataset

    (tmp_path / "train").mkdir()
    (tmp_path / "val").mkdir()
    _disk_dataset(tmp_path / "train", n_videos=1)
    ann, img_prefix, truth_dir, gt_json = _write_fixture(tmp_path / "val")
    cfg = _run_cfg(tconfig, tiny_model_cfg(config=tconfig))
    monkeypatch.setattr(cli, "named_config", lambda name: cfg)
    work = tmp_path / "work"
    # one torch thread: tiny tensors, and the test runner's parallel
    # workers oversubscribe the cores with a thread per core each
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cli.main(["--ann_file", str(tmp_path / "train" / "ann.json"),
                  "--img_prefix", str(tmp_path / "train"),
                  "--work_dir", str(work), "--total_epochs", "1",
                  "--repeat_times", "1", "--crop", "128", "128",
                  "--gt_capacity", "8", "--log_interval", "1",
                  "--data_workers", "1", "--device", "cpu",
                  "--eval_every", "1", "--val_ann_file", ann,
                  "--val_img_prefix", img_prefix,
                  "--val_truth_dir", truth_dir,
                  "--val_pan_gt_json_file", gt_json,
                  "--val_max_videos", "1"])
    finally:
        torch.set_num_threads(threads)
    assert (work / "epoch_1.pt").exists()
    assert (work / "val_epoch_1" / "vpq-final.txt").exists()
    assert (work / "val_epoch_1" / "pred.json").exists()
