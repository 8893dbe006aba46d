"""Port parity of the Swin backbone (``swinl_fpn_slotvps``) and of the
slice that runs on it, against the JAX package on the CPU.

Config: a tiny Swin (embed 32, depths (2, 2, 4, 2), heads (2, 2, 4, 4),
window 7; stage 2 takes the JAX package's ``_stage_scan`` path) on B = 2
images of 72x104: windows padded on every stage, odd patch merges, maps
smaller than the window on the last stage (odd blocks still shift), two
images under one shift mask.

* ``rel_pos_index``, ``shift_mask`` and the window partition / reverse are
  equal exactly.
* ``apply_swin``: f32 within 1e-5 * max|ref| (sums in another order),
  bf16 within 2e-2 * max|ref| (the port's bf16 module rule).
* ``convert_swin`` equal to the JAX converter leaf for leaf on a synthetic
  reference state dict, with and without the patch-embedding norm; a Swin
  tree from ``from_jax_params`` loads strictly; a reference .pth loads
  bit for bit; chip_smoke's key map writes the same state dict.
* The slice: a tiny Swin detector (the tiny slot head of
  ``tiny_model_cfg``) with the weights doctored and the class head
  calibrated (~12 of 20 slots clear the keep rule on a probe frame), a
  2-frame clip through both packages' ``InferencePipeline``.  f32 (the
  port on its f32 kernel routes, the DCN and the Retriever, whose
  wrappers run the plain versions on the CPU; the JAX package plain):
  ``extract_features`` within 1e-4, the semantic map, the panoptic map,
  the kept classes and the track ids equal, the kept scores within 1e-4.
  bf16 (both plain, Retriever q/k LayerNorm scales quartered as in
  tests/test_torch_tuned.py, torch at one thread): ``extract_features``, the
  feature path the Swin backbone feeds, within 2e-2 * max|ref| (the
  port's bf16 module rule; measured <= 1.9e-2), then the clip with the
  floors of tests/test_torch_tuned.py's rule set just under this regime's
  readings: semantic map 98.77 %, 98.61 %; matched panoptic 96.27 %,
  93.62 % on frames 0, 1.  Its kept-class equality does not hold here and
  is not asserted: the two packages' bf16 decoders, fed their own
  features, give class logits 1.41 apart (of a 33 max; the calibrated
  head scales them ~20x), so slots whose scores lie near the 0.85 keep
  rule change sides (frame 1 keeps 2 things in JAX, 4 in the port; JAX's
  own bf16 run agrees with its f32 run on 82.7 % of that frame's matched
  panoptic pixels).  The f32 slice above is the exact check.
* The eval CLI with ``--config swinl_fpn_slotvps`` and a reference .pth
  (``named_config`` patched to the tiny Swin), with ``--tuned``,
  ``--batch_videos 2`` and ``--scan``.

The JAX parameters are built without JAX's init (whose eager compile
costs ~10 s a model here): the port initializes, and the JAX tree of
``jax.eval_shape(init_model)`` takes its values through the inverse of
``from_jax_params``; ``from_jax_params`` then carries them back.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotvps_tpu import config as jconfig
from slotvps_tpu.inference import InferencePipeline as JaxPipeline
from slotvps_tpu.models import detector as jdet
from slotvps_tpu.models import swin as jswin
from slotvps_tpu.utils import calibration as jcal
from slotvps_tpu.utils import checkpoint as jckpt
from slotvps_tpu.utils.parity import _match_relabel
from slotvps_tpu_torch import config as tconfig
from slotvps_tpu_torch.inference import (InferencePipeline,
                                         _device_normalize, run_video)
from slotvps_tpu_torch.models import detector as tdet
from slotvps_tpu_torch.models import swin as tswin
from slotvps_tpu_torch.utils import checkpoint as tckpt
from slotvps_tpu_torch.utils.convert import _convert_leaf, from_jax_params
from tests.test_checkpoint import _to_torch_sd
from tests.test_torch_bf16 import soften_retrievers
from tests.test_torch_models import port_model, tiny_model_cfg
from tests.test_torch_slice import _clip

SWIN = dict(embed_dim=32, depths=(2, 2, 4, 2), num_heads=(2, 2, 4, 4),
            window_size=7)
B, IH, IW = 2, 72, 104          # the backbone tests' images
H, W = 64, 128                  # the slice's frames
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_SSEG_AGREE = 0.98          # measured min 0.98608
BF16_PAN_AGREE = 0.93           # measured min 0.93616, ids matched
CPU_THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    """The port's CPU sums at a fixed thread count: its bf16 results depend
    on it (see tests/test_torch_tuned.py), and one thread keeps the small
    torch work fast beside the other test workers.  The worker's own count
    is restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(CPU_THREADS)
    yield
    torch.set_num_threads(n)


def swin_model_cfg(dcn_impl="jax", config=jconfig, patch_norm=True,
                   **changes):
    """``tiny_model_cfg`` with the tiny Swin backbone, from ``config``'s
    package."""
    cfg = tiny_model_cfg(dcn_impl, config)
    return dataclasses.replace(
        cfg, backbone="swin",
        swin=config.SwinConfig(patch_norm=patch_norm, **SWIN), **changes)


def jax_params_of(module, init):
    """The JAX parameter tree of ``init`` holding ``module``'s values: the
    tree's structure from ``jax.eval_shape`` of the JAX init (no compile),
    each leaf the port's tensor through the inverse of ``_convert_leaf``
    (its transpose read off an index array).  ``init``: a JAX ModelConfig
    (the detector's ``init_model``) or a function of a key."""
    if not callable(init):
        cfg = init
        init = lambda k: jdet.init_model(k, cfg)  # noqa: E731
    state = module.state_dict()

    def leaf(path, shape):
        keys = tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
        idx = np.arange(int(np.prod(shape.shape))).reshape(shape.shape)
        name, port_idx = _convert_leaf(keys, idx)
        out = np.empty(idx.size, np.float32)
        out[np.asarray(port_idx).ravel()] = state[name].numpy().ravel()
        return out.reshape(shape.shape)

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def swin_backbone_sd(bb, scfg):
    """A Swin backbone tree in the reference's key names
    (mmdet/models/backbones/swin_transformer.py), with the derived
    ``relative_position_index`` buffers a reference checkpoint holds."""
    sd = {}

    def lin(name, p):
        sd[f"{name}.weight"] = np.asarray(p["w"]).T
        if "b" in p:
            sd[f"{name}.bias"] = np.asarray(p["b"])

    def norm(name, p):
        sd[f"{name}.weight"] = np.asarray(p["scale"])
        sd[f"{name}.bias"] = np.asarray(p["bias"])

    pe = bb["patch_embed"]
    sd["patch_embed.proj.weight"] = np.asarray(
        pe["proj"]["w"]).transpose(3, 2, 0, 1)
    sd["patch_embed.proj.bias"] = np.asarray(pe["proj"]["b"])
    if pe["norm"] is not None:
        norm("patch_embed.norm", pe["norm"])
    index = np.asarray(jswin._rel_pos_index(scfg.window_size))
    for si in range(len(scfg.depths)):
        stage = bb[f"stage{si}"]
        for bi, bp in enumerate(stage["blocks"]):
            pre = f"layers.{si}.blocks.{bi}"
            norm(f"{pre}.norm1", bp["norm1"])
            lin(f"{pre}.attn.qkv", bp["qkv"])
            lin(f"{pre}.attn.proj", bp["proj"])
            sd[f"{pre}.attn.relative_position_bias_table"] = np.asarray(
                bp["rel_pos_bias"])
            sd[f"{pre}.attn.relative_position_index"] = index
            norm(f"{pre}.norm2", bp["norm2"])
            lin(f"{pre}.mlp.fc1", bp["fc1"])
            lin(f"{pre}.mlp.fc2", bp["fc2"])
        if "downsample" in stage:
            lin(f"layers.{si}.downsample.reduction",
                stage["downsample"]["reduction"])
            norm(f"layers.{si}.downsample.norm", stage["downsample"]["norm"])
    for i in scfg.out_indices:
        norm(f"norm{i}", bb[f"out_norm{i}"])
    return sd


def swin_reference_sd(params, cfg):
    """A Swin detector's JAX tree in the reference checkpoint's key names:
    tests/test_checkpoint.py ``_to_torch_sd`` for the rest of the model
    (a stub R50 backbone, dropped), :func:`swin_backbone_sd` for the
    backbone."""
    r50 = dataclasses.replace(cfg, backbone="resnet",
                              resnet=jconfig.ResNetConfig(depth=50))
    stub = {"conv1": {"w": np.zeros((7, 7, 3, 64), np.float32)},
            "bn1": {k: np.zeros(64, np.float32)
                    for k in ("scale", "bias", "mean", "var")},
            **{f"layer{i}": [] for i in range(1, 5)}}
    sd = {k: v for k, v in _to_torch_sd(dict(params, backbone=stub),
                                        r50).items()
          if not k.startswith("image_model.backbone.")}
    sd.update({"image_model.backbone." + k: v for k, v in
               swin_backbone_sd(params["backbone"], cfg.swin).items()})
    return sd


# ---------------------------------------------------------------------------
# the backbone
# ---------------------------------------------------------------------------


def test_derived_tables_are_exact():
    for window in (7, 4):
        np.testing.assert_array_equal(
            tswin.rel_pos_index(window).numpy(),
            np.asarray(jswin._rel_pos_index(window)))
    # padded map sizes of the 72x104 stages (21x28 .. 7x7), and one
    # taller than wide
    jax_mask = jax.jit(jswin._shift_mask, static_argnums=(0, 1, 2, 3))
    for hp, wp in ((21, 28), (14, 14), (7, 7), (14, 7)):
        np.testing.assert_array_equal(
            tswin.shift_mask(hp, wp, 7, 3).numpy(),
            np.asarray(jax_mask(hp, wp, 7, 3)), err_msg=(hp, wp))
    x = np.random.default_rng(0).standard_normal((2, 21, 28, 5)).astype(
        np.float32)
    wins = tswin.window_partition(torch.from_numpy(x), 7)
    np.testing.assert_array_equal(
        wins.numpy(), np.asarray(jswin._window_partition(jnp.asarray(x), 7)))
    np.testing.assert_array_equal(
        tswin.window_reverse(wins, 7, 2, 21, 28).numpy(), x)


@pytest.fixture(scope="module")
def swin_pair():
    """(JAX Swin tree, the port's Swin holding it, images [B, 72, 104, 3])."""
    tcfg = swin_model_cfg(config=tconfig)
    model = tdet.init_model(torch.Generator().manual_seed(0), tcfg,
                            device="cpu")
    params = jax_params_of(model, swin_model_cfg())["backbone"]
    img = np.random.default_rng(0).standard_normal(
        (B, IH, IW, 3)).astype(np.float32)
    return params, model.backbone, img


@pytest.mark.parametrize("dtype, rtol", [("float32", 1e-5),
                                         ("bfloat16", 2e-2)])
def test_apply_swin_matches_jax(swin_pair, dtype, rtol):
    params, backbone, img = swin_pair
    scfg = jconfig.SwinConfig(**SWIN)
    ref = jax.jit(lambda p, x: jswin.apply_swin(p, x, scfg))(
        params, jnp.asarray(img, jnp.dtype(dtype)))
    with torch.no_grad():
        ours = backbone(torch.from_numpy(img).to(getattr(torch, dtype)))
    assert [tuple(a.shape) for a in ours] == [
        (B, 18, 26, 32), (B, 9, 13, 64), (B, 5, 7, 128), (B, 3, 4, 256)]
    for a, b in zip(ours, ref):
        assert a.dtype == getattr(torch, dtype)
        b = np.asarray(b.astype(jnp.float32))
        err = np.abs(a.float().numpy() - b).max()
        assert err <= rtol * np.abs(b).max(), (a.shape, err)
    # the derived tables are not parameters
    assert not any("rel_index" in k or "mask" in k
                   for k in backbone.state_dict())


@pytest.mark.parametrize("patch_norm", [True, False])
def test_convert_swin_matches_jax(swin_pair, patch_norm):
    """The port's ``convert_swin`` equals the JAX package's on a reference
    state dict, leaf for leaf (``relative_position_index`` ignored); the
    tree loads strictly through ``from_jax_params``."""
    params, _, _ = swin_pair
    if not patch_norm:
        params = dict(params, patch_embed=dict(params["patch_embed"],
                                               norm=None))
    scfg = tconfig.SwinConfig(patch_norm=patch_norm, **SWIN)
    sd = swin_backbone_sd(params, scfg)
    assert ("patch_embed.norm.weight" in sd) == patch_norm
    want = jckpt.convert_swin(sd, jconfig.SwinConfig(patch_norm=patch_norm,
                                                     **SWIN))
    got = tckpt.convert_swin(sd, scfg)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g)
    for path, leaf in flat_w:
        assert isinstance(flat_g[path], np.ndarray)
        np.testing.assert_array_equal(flat_g[path], np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))
    assert (got["patch_embed"]["norm"] is None) == (not patch_norm)
    tcfg = swin_model_cfg(config=tconfig, patch_norm=patch_norm)
    model = tdet.init_model(torch.Generator().manual_seed(1), tcfg,
                            device="cpu")
    tree = jax_params_of(model, swin_model_cfg(patch_norm=patch_norm))
    state = from_jax_params(dict(tree, backbone=got), tcfg)
    model.load_state_dict(state, strict=True)
    np.testing.assert_array_equal(
        model.backbone.stage2.blocks[3].rel_pos_bias.detach().numpy(),
        sd["layers.2.blocks.3.attn.relative_position_bias_table"])


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def swin_slice():
    """Doctored, softened, class-calibrated JAX tree of the tiny Swin
    detector (~12 of 20 slots clear the keep rule on a probe frame outside
    the clip), and the JAX f32 pipeline's results on a 2-frame clip."""
    cfg = swin_model_cfg()
    tcfg = swin_model_cfg("pallas_f32", tconfig)
    init = tdet.init_model(torch.Generator().manual_seed(1), tcfg,
                           device="cpu")
    params = soften_retrievers(jcal.doctor_params(
        jax_params_of(init, cfg), jax.random.PRNGKey(1)), 0.25)
    img = _device_normalize(torch.from_numpy(_clip(99, 1, H, W)[0]),
                            tconfig.Config().data)
    with torch.no_grad():
        model = port_model(params, tcfg)
        f = tdet.extract_features(model, tcfg, img)
        logits = tdet.decode_pair(model, tcfg, f, f).pred_logits[0]
    params, info = jcal.calibrate_class_head(
        params, logits.numpy(), jax.random.PRNGKey(2), target_valid=12)
    assert info["n_valid_probe"] == 12
    jp = JaxPipeline(params, jconfig.Config(model=cfg))
    frames = _clip(0, 2, H, W)
    ref = [jp.process_frame(fr, is_first=(t == 0))
           for t, fr in enumerate(frames)]
    return params, jp, frames, ref


def _f32_port_cfg():
    """The f32 Pallas-Retriever path: f32 DCN and slot-attention kernel
    routes (plain on CPU tensors)."""
    cfg = swin_model_cfg("pallas_f32", tconfig)
    return dataclasses.replace(cfg, slot_head=dataclasses.replace(
        cfg.slot_head, retriever_impl="pallas"))


def test_swin_extract_features_matches_jax(swin_slice):
    params, jp, frames, _ = swin_slice
    tcfg = _f32_port_cfg()
    ref = jp._extract(params, jnp.asarray(frames[1]))
    img = _device_normalize(torch.from_numpy(frames[1]),
                            tconfig.Config().data)
    with torch.no_grad():
        ours = tdet.extract_features(port_model(params, tcfg), tcfg, img)
    assert [tuple(f.shape[1:3]) for f in ours.feat_trans] == [
        (2, 4), (4, 8), (8, 16), (16, 32)]
    for a, b in zip((*ours.feat_trans, ours.fcn_output),
                    (*ref.feat_trans, ref.fcn_output)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32_TOL)


def test_swin_slice_matches_jax_f32(swin_slice):
    params, _, frames, ref = swin_slice
    tcfg = tconfig.Config(model=_f32_port_cfg())
    ours = run_video(InferencePipeline(port_model(params, tcfg.model), tcfg),
                     frames)
    for t, (a, b) in enumerate(zip(ref, ours)):
        np.testing.assert_array_equal(b.sseg, a.sseg, err_msg=f"frame {t}")
        np.testing.assert_array_equal(b.panoptic, a.panoptic,
                                      err_msg=f"frame {t}")
        assert b.cls_inds.tolist() == a.cls_inds.tolist(), t
        assert b.obj_ids.tolist() == a.obj_ids.tolist(), t
        np.testing.assert_allclose(b.cls_prob, a.cls_prob, **F32_TOL)
    # the regime is not trivial: things are kept and tracked
    assert all(len(r.cls_inds) for r in ours)
    assert set(ours[0].obj_ids) & set(ours[1].obj_ids)


def test_swin_slice_matches_jax_bf16(swin_slice):
    params, _, frames, _ = swin_slice
    cfg = swin_model_cfg(compute_dtype="bfloat16")
    jp = JaxPipeline(params, jconfig.Config(model=cfg))
    ref = [jp.process_frame(fr, is_first=(t == 0))
           for t, fr in enumerate(frames)]
    tcfg = tconfig.Config(model=swin_model_cfg(
        config=tconfig, compute_dtype="bfloat16"))
    model = port_model(params, tcfg.model)
    feats = jp._extract(params, jnp.asarray(frames[1]))
    img = _device_normalize(torch.from_numpy(frames[1]), tcfg.data)
    with torch.no_grad():
        ours = tdet.extract_features(model, tcfg.model, img)
    for a, b in zip((*ours.feat_trans, ours.fcn_output),
                    (*feats.feat_trans, feats.fcn_output)):
        b = np.asarray(b.astype(jnp.float32))
        assert np.abs(a.float().numpy() - b).max() <= 2e-2 * np.abs(b).max()
    ours = run_video(InferencePipeline(model, tcfg), frames)
    for t, (a, b) in enumerate(zip(ref, ours)):
        sseg = float((a.sseg == b.sseg).mean())
        pan = float((a.panoptic == _match_relabel(a.panoptic,
                                                  b.panoptic)).mean())
        assert sseg >= BF16_SSEG_AGREE and pan >= BF16_PAN_AGREE, \
            (t, sseg, pan)
        assert len(a.cls_inds) and len(b.cls_inds), t


def test_swin_reference_checkpoint_and_chip_smoke_key_map(swin_slice,
                                                         tmp_path):
    """A reference .pth of the Swin detector: the port's
    ``load_torch_checkpoint`` gives the ``state_dict`` that the JAX
    package's loader followed by ``from_jax_params`` gives, bit for bit,
    and the model's own values; chip_smoke.py's key map writes that .pth's
    state dict from the port's model."""
    import chip_smoke

    params = swin_slice[0]
    cfg, tcfg = swin_model_cfg(), swin_model_cfg(config=tconfig)
    sd = swin_reference_sd(params, cfg)
    pth = tmp_path / "swin.pth"
    torch.save({"state_dict": {k: torch.tensor(v) for k, v in sd.items()},
                "meta": {"config": "swinl_fpn_slotvps"}}, pth)
    want = from_jax_params(jax.tree.map(
        np.asarray, jckpt.load_torch_checkpoint(str(pth), cfg)), tcfg)
    got = tckpt.load_torch_checkpoint(str(pth), tcfg)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    model = port_model(params, tcfg)
    for key, val in model.state_dict().items():
        assert torch.equal(got[key], val), key
    ours = chip_smoke.reference_state_dict(model, tcfg)
    assert set(ours) == set(sd)
    for key, val in sd.items():
        np.testing.assert_array_equal(ours[key].numpy(), val, err_msg=key)


@pytest.mark.parametrize("flags", [("--tuned",), ("--batch_videos", "2"),
                                   ("--scan",)])
def test_cli_runs_swinl_with_a_reference_checkpoint(swin_slice, tmp_path,
                                                    monkeypatch, flags):
    """``--config swinl_fpn_slotvps --checkpoint x.pth`` with each serving
    flag, ``named_config`` patched to the tiny Swin on the f32
    Pallas-Retriever path (``--tuned`` turns it into the bf16 stack), 2
    videos x 2 frames at 32x64: a VPQ summary and 4 predictions."""
    import json

    import chip_smoke
    from slotvps_tpu_torch.cli import test_eval_vpq as cli

    params = swin_slice[0]
    h, w = 32, 64
    base = tconfig.named_config("swinl_fpn_slotvps")
    assert base.model.backbone == "swin"
    small = dataclasses.replace(
        base, model=_f32_port_cfg(),
        data=dataclasses.replace(base.data, img_scale=(w, h),
                                 nframes_span_test=2),
        eval=dataclasses.replace(base.eval, nframes_per_video=2,
                                 panoptic_stuff_area_limit=64))
    asked = []
    monkeypatch.setattr(cli, "named_config",
                        lambda name: asked.append(name) or small)
    pth = tmp_path / "swin.pth"
    torch.save({"state_dict": {
        k: torch.tensor(v)
        for k, v in swin_reference_sd(params, swin_model_cfg()).items()}},
        pth)
    videos = [_clip(5, 2, h, w), _clip(6, 2, h, w)]
    ann, img_dir, truth_dir, gt_json = chip_smoke.write_cli_dataset(
        tmp_path / "data", videos)
    out = tmp_path / "out" / "out.pkl"
    summary = cli.main([
        "--config", "swinl_fpn_slotvps", "--device", "cpu", "--checkpoint",
        str(pth), *flags, "--ann_file", str(ann), "--img_prefix",
        str(img_dir), "--out", str(out), "--truth_dir", str(truth_dir),
        "--pan_gt_json_file", str(gt_json)])
    assert asked == ["swinl_fpn_slotvps"]
    assert 0.0 <= summary["vpq_all"] <= 100.0
    pred = json.loads((tmp_path / "out" / "out_pans_unified" /
                       "pred.json").read_text())
    assert len(pred["annotations"]) == 4
