"""Port parity of checkpoint loading, the DCN halo diagnostics,
``forward_frame`` and the eval CLI's checkpoint flags.

* A state dict in the reference's key names, built from JAX init
  parameters, saved with ``torch.save`` bare and as ``{"state_dict": ...,
  "meta": ...}``: the port's ``load_torch_checkpoint`` gives the
  ``state_dict`` that the JAX package's ``load_torch_checkpoint`` followed
  by ``from_jax_params`` gives, bit for bit (both only transpose).
* ``convert_torchvision_resnet`` equal to the JAX package's, bit for bit,
  on bottleneck (R50) and basic (R18) blocks.
* ``offset_clamp_stats`` equal to the JAX function; ``measure_max_dcn_offset``
  within 1e-5 of max (f32 sums in another order: the plain DCN at halo 16
  against the XLA DCN at halo 16); ``forward_frame`` within 1e-4, the
  tolerance of tests/test_torch_models.py.
"""

import ast
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotvps_tpu import config as jconfig
from slotvps_tpu.models import detector as jdet
from slotvps_tpu.ops import deform_conv as jdc
from slotvps_tpu.utils import checkpoint as jckpt
from slotvps_tpu.utils import diagnostics as jdiag
from slotvps_tpu_torch import config as tconfig
from slotvps_tpu_torch.models import detector as tdet
from slotvps_tpu_torch.ops import deform_conv as tdc
from slotvps_tpu_torch.utils import checkpoint as tckpt
from slotvps_tpu_torch.utils import diagnostics as tdiag
from slotvps_tpu_torch.utils.convert import from_jax_params
from tests.test_checkpoint import _to_torch_sd
from tests.test_torch_models import doctored_params, port_model, tiny_model_cfg

H, W = 64, 128


def _ref_state_dict(params, cfg):
    """The JAX tree ``params`` in the reference checkpoint's key names:
    tests/test_checkpoint.py ``_to_torch_sd`` with basic blocks (R18) too."""
    if cfg.resnet.depth >= 50:
        return _to_torch_sd(params, cfg)
    r50 = dataclasses.replace(cfg, resnet=jconfig.ResNetConfig(depth=50))
    stub = dict(params, backbone={
        "conv1": params["backbone"]["conv1"], "bn1": params["backbone"]["bn1"],
        **{f"layer{i}": [] for i in range(1, 5)}})
    sd = _to_torch_sd(stub, r50)
    sd.update({"image_model.backbone." + k: v
               for k, v in _resnet_sd(params["backbone"]).items()})
    return sd


def _resnet_sd(backbone):
    """A backbone tree in torchvision's key names (basic or bottleneck)."""
    sd = {}

    def conv(name, p):
        sd[f"{name}.weight"] = np.asarray(p["w"]).transpose(3, 2, 0, 1)

    def bn(name, p):
        for leaf, key in (("scale", "weight"), ("bias", "bias"),
                          ("mean", "running_mean"), ("var", "running_var")):
            sd[f"{name}.{key}"] = np.asarray(p[leaf])

    conv("conv1", backbone["conv1"])
    bn("bn1", backbone["bn1"])
    for si in range(1, 5):
        for bi, bp in enumerate(backbone[f"layer{si}"]):
            for key, p in bp.items():
                pre = f"layer{si}.{bi}"
                if key == "downsample":
                    conv(f"{pre}.downsample.0", p["conv"])
                    bn(f"{pre}.downsample.1", p["bn"])
                elif key.startswith("conv"):
                    conv(f"{pre}.{key}", p)
                else:
                    bn(f"{pre}.{key}", p)
    return sd


def _r50_cfg(config):
    return dataclasses.replace(tiny_model_cfg(config=config),
                               resnet=config.ResNetConfig(depth=50))


@pytest.fixture(scope="module")
def r50_checkpoint(tmp_path_factory):
    """(JAX params, reference-key state dict, bare .pth, wrapped .pth) of
    an R50 model with a tiny decoder."""
    cfg = _r50_cfg(jconfig)
    params = jdet.init_model(jax.random.PRNGKey(4), cfg)
    sd = _ref_state_dict(params, cfg)
    root = tmp_path_factory.mktemp("ckpt")
    tensors = {k: torch.tensor(np.asarray(v))
               for k, v in sd.items()}
    bare, wrapped = root / "bare.pth", root / "wrapped.pth"
    torch.save(tensors, bare)
    torch.save({"state_dict": tensors,
                "meta": {"CLASSES": ["car", "person"], "epoch": 12}},
               wrapped)
    return params, sd, bare, wrapped


@pytest.mark.parametrize("form", ["bare", "wrapped"])
def test_load_torch_checkpoint_matches_jax(r50_checkpoint, form):
    params, _, bare, wrapped = r50_checkpoint
    path = str(bare if form == "bare" else wrapped)
    tcfg = _r50_cfg(tconfig)
    want = from_jax_params(jax.tree.map(
        np.asarray, jckpt.load_torch_checkpoint(path, _r50_cfg(jconfig))),
        tcfg)
    got = tckpt.load_torch_checkpoint(path, tcfg)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype == torch.float32, key
        assert torch.equal(got[key], want[key]), key
    # and the weights are the JAX init's
    model = tdet.init_model(torch.Generator().manual_seed(9), tcfg,
                            device="cpu")
    model.load_state_dict(got, strict=True)
    np.testing.assert_array_equal(
        model.init_mask_query.detach().numpy(),
        np.asarray(params["init_mask_query"]))


def test_ref_state_dict_is_the_jax_helper(r50_checkpoint):
    """The R18 helper here agrees with tests/test_checkpoint.py's own on the
    bottleneck backbone it covers."""
    params, sd, _, _ = r50_checkpoint
    ours = {"image_model.backbone." + k: v
            for k, v in _resnet_sd(params["backbone"]).items()}
    for key, val in ours.items():
        np.testing.assert_array_equal(val, sd[key], err_msg=key)
    assert set(ours) == {k for k in sd if k.startswith("image_model.backbone")}


@pytest.mark.parametrize("depth", [18, 50])
def test_convert_torchvision_resnet_matches_jax(depth):
    cfg = dataclasses.replace(tiny_model_cfg(),
                              resnet=jconfig.ResNetConfig(depth=depth))
    params = jdet.init_model(jax.random.PRNGKey(depth), cfg)
    sd = _resnet_sd(params["backbone"])
    want = jckpt.convert_torchvision_resnet(sd, depth)
    got = tckpt.convert_torchvision_resnet(sd, depth)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g)
    for path, leaf in flat_w:
        assert isinstance(flat_g[path], np.ndarray)
        np.testing.assert_array_equal(flat_g[path], np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


def test_swin_checkpoint_raises():
    """A Swin checkpoint converts (``convert_swin``, held leaf for leaf
    against the JAX converter in tests/test_torch_swin.py); one that lacks
    the Swin backbone's keys raises on the first missing key, as the JAX
    converter does."""
    cfg = dataclasses.replace(tconfig.ModelConfig(), backbone="swin")
    jcfg = dataclasses.replace(jconfig.ModelConfig(), backbone="swin")
    for convert, c in ((tckpt.convert_slotvps_checkpoint, cfg),
                       (jckpt.convert_slotvps_checkpoint, jcfg)):
        with pytest.raises(KeyError, match="patch_embed.proj.weight"):
            convert({}, c)
    sd = {"patch_embed.proj.weight": np.ones((8, 3, 4, 4), np.float32),
          "patch_embed.proj.bias": np.zeros(8, np.float32)}
    scfg = tconfig.SwinConfig(depths=(), num_heads=(), out_indices=())
    tree = tckpt.convert_swin(sd, scfg)
    assert tree["patch_embed"]["norm"] is None
    assert tree["patch_embed"]["proj"]["w"].shape == (4, 4, 3, 8)


def test_save_load_checkpoint_round_trip(tmp_path):
    tcfg = tiny_model_cfg(config=tconfig)
    model = tdet.init_model(torch.Generator().manual_seed(1), tcfg,
                            device="cpu")
    tckpt.save_checkpoint(str(tmp_path / "m.pt"), model)
    other = tdet.init_model(torch.Generator().manual_seed(2), tcfg,
                            device="cpu")
    assert tckpt.load_checkpoint(str(tmp_path / "m.pt"), other) is other
    state = tckpt.load_checkpoint(str(tmp_path / "m.pt"))
    for key, val in model.state_dict().items():
        assert torch.equal(other.state_dict()[key], val), key
        assert torch.equal(state[key], val), key


def test_load_checkpoint_refuses_an_orbax_directory(tmp_path):
    (tmp_path / "ckpt").mkdir()
    (tmp_path / "ckpt" / "_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="orbax"):
        tckpt.load_checkpoint(str(tmp_path / "ckpt"))


@pytest.mark.parametrize("sh", [
    dict(dcn_impl="jax", dcn_halo=0), dict(dcn_impl="pallas", dcn_halo=0),
    dict(dcn_impl="pallas_f32", dcn_halo=5),
    dict(dcn_impl="pallas", dcn_halo=(2, 0, 4, 6)),
    dict(dcn_impl="jax", dcn_halo=(0, 3, 0, 9))])
def test_effective_halo_matches_jax(sh):
    want = jdiag.effective_halo(jconfig.SemanticHeadConfig(**sh))
    got = tdiag.effective_halo(tconfig.SemanticHeadConfig(**sh))
    assert got == want and len(got) == 4


def test_offset_clamp_stats_matches_jax():
    rng = np.random.default_rng(5)
    off = (3 * rng.standard_normal((2, 8, 12, 18))).astype(np.float32)
    for halo in (1, 2, 4, 16):
        jm, jr = jdc.offset_clamp_stats(jnp.asarray(off), halo)
        tm, tr = tdc.offset_clamp_stats(torch.from_numpy(off), halo)
        assert float(tm) == float(jm)
        assert float(tr) == pytest.approx(float(jr), abs=1e-7)


@pytest.fixture(scope="module")
def tiny_pair():
    """(JAX params, JAX cfg, the port's model, cfg, a quarter-scale image)
    as tests/test_torch_models.py ``pair`` builds them."""
    cfg = tiny_model_cfg()
    params = doctored_params(cfg, fg_scale=0.1, fg_var=1.0)
    tcfg = tiny_model_cfg("pallas_f32", tconfig)
    img = 0.25 * np.random.default_rng(0).standard_normal(
        (1, H, W, 3)).astype(np.float32)
    return params, cfg, port_model(params, tcfg), tcfg, img


def test_measure_max_dcn_offset_matches_jax(tiny_pair):
    params, cfg, model, tcfg, img = tiny_pair
    want = jdiag.measure_max_dcn_offset(params, cfg,
                                        images=[jnp.asarray(img)])
    got = tdiag.measure_max_dcn_offset(model, tcfg,
                                       images=[torch.from_numpy(img)])
    assert got.shape == (4,) and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * want.max())


def test_check_dcn_halo_raises_a_doctored_level(tiny_pair):
    """A conv_offset head whose bias pushes every tap 6 px out clamps at
    every level's halo (the tower is shared): the check recommends >= 6
    everywhere; with per-level halos (2, 2, 8, 8) only the levels that
    would clamp are raised."""
    _, _, model, tcfg, img = tiny_pair
    image = torch.from_numpy(img)
    mx, eff, rec = tdiag.check_dcn_halo(model, tcfg, image=image, warn=False)
    assert eff == (2, 3, 4, 6) and 0 < mx
    bias = model.semantic_head.tower[0].offset.bias
    saved = bias.detach().clone()
    try:
        with torch.no_grad():
            bias.fill_(6.0)
        with pytest.warns(RuntimeWarning, match="dcn_halo"):
            mx, eff, rec = tdiag.check_dcn_halo(model, tcfg, image=image)
        assert mx >= 6.0 and all(r >= 8 for r in rec)
        cfg2 = dataclasses.replace(tcfg, semantic_head=dataclasses.replace(
            tcfg.semantic_head, dcn_halo=(2, 2, 9, 9)))
        _, eff2, rec2 = tdiag.check_dcn_halo(model, cfg2, image=image,
                                             warn=False)
        assert eff2 == (2, 2, 9, 9) and rec2[2:] == (9, 9)
        assert all(r >= 8 for r in rec2[:2])
    finally:
        with torch.no_grad():
            bias.copy_(saved)


def test_forward_frame_matches_jax(tiny_pair):
    params, cfg, model, tcfg, img = tiny_pair
    ref_img = np.roll(img, 3, axis=2)
    jo = jax.jit(lambda p, x, r: jdet.forward_frame(p, cfg, x, r))(
        params, jnp.asarray(img), jnp.asarray(ref_img))
    with torch.no_grad():
        to = tdet.forward_frame(model, tcfg, torch.from_numpy(img),
                                torch.from_numpy(ref_img))
    for name in ("pred_logits", "embeddings", "pred_masks", "fcn_output"):
        np.testing.assert_allclose(getattr(to, name).numpy(),
                                   np.asarray(getattr(jo, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def _cli_run(tmp_path, monkeypatch, capsys, pth, tag):
    from slotvps_tpu_torch.cli import test_eval_vpq as cli
    from tests.test_torch_slice import _write_fixture

    h, w = 32, 64
    base = tconfig.named_config("r50_fpn_slotvps")
    model = dataclasses.replace(
        tiny_model_cfg("pallas_f32", tconfig),
        slot_head=dataclasses.replace(tiny_model_cfg(
            config=tconfig).slot_head, retriever_impl="pallas"))
    small = dataclasses.replace(
        base, model=model,
        data=dataclasses.replace(base.data, img_scale=(w, h)),
        eval=dataclasses.replace(base.eval, nframes_per_video=2,
                                 panoptic_stuff_area_limit=64))
    monkeypatch.setattr(cli, "named_config", lambda name: small)
    root = tmp_path / tag
    root.mkdir()
    ann, img_dir, truth_dir, gt_json = _write_fixture(root, h, w)
    out = root / "out" / "out.pkl"
    summary = cli.main([
        "--device", "cpu", "--checkpoint", str(pth), "--save_diff_fig",
        "--debug_postproc", "--n_video", "1", "--ann_file", str(ann),
        "--img_prefix", str(img_dir), "--out", str(out), "--truth_dir",
        str(truth_dir), "--pan_gt_json_file", str(gt_json)])
    return summary, root / "out" / "out_pans_unified", capsys.readouterr().out


def test_cli_evaluates_a_reference_checkpoint(tmp_path, monkeypatch,
                                              capsys):
    """``--checkpoint x.pth --save_diff_fig --debug_postproc --n_video 1``
    on the CPU with the f32 Pallas-Retriever config: the halo line, the
    per-frame lines, pan_diff/*.png and the VPQ summary; then with the
    first tower block's offset head pushed 6 px out, the halos raised."""
    cfg = tiny_model_cfg()
    params = doctored_params(cfg)
    sd = {k: torch.tensor(np.asarray(v))
          for k, v in _ref_state_dict(params, cfg).items()}
    pth = tmp_path / "ref.pth"
    torch.save({"state_dict": sd, "meta": {}}, pth)
    summary, out_dir, log = _cli_run(tmp_path, monkeypatch, capsys, pth,
                                     "plain")
    assert 0.0 <= summary["vpq_all"] <= 100.0
    assert "DCN offsets: checkpoint emits up to" in log
    assert "per-level halos in effect: (2, 3, 4, 6) px" in log
    assert "no checkpoint given" not in log
    assert log.count("[postproc] ") == 2
    assert len(list((out_dir / "pan_diff").glob("*.png"))) == 2
    pred = json.loads((out_dir / "pred.json").read_text())
    assert len(pred["annotations"]) == 2

    sd["image_model.panopticFPN.deform_convs.0.0.conv_offset.bias"] = \
        torch.full((18,), 6.0)
    torch.save(sd, pth)
    summary, _, log = _cli_run(tmp_path, monkeypatch, capsys, pth, "wide")
    assert 0.0 <= summary["vpq_all"] <= 100.0
    line = next(x for x in log.splitlines() if "raising dcn_halo" in x)
    rec = ast.literal_eval(line.split("->")[1].split("so")[0].strip())
    assert len(rec) == 4 and all(r >= 8 for r in rec), line


def test_chip_smoke_reference_state_dict(tiny_pair):
    """chip_smoke.py writes its reference-format .pth with its own key map
    (port names -> reference names): it gives the state dict built here
    from the JAX tree, and the port's loader reads it back bit for bit."""
    import chip_smoke

    params, cfg, model, tcfg, _ = tiny_pair
    ours = chip_smoke.reference_state_dict(model, tcfg)
    want = _ref_state_dict(params, cfg)
    assert set(ours) == set(want)
    for key, val in want.items():
        np.testing.assert_array_equal(ours[key].numpy(), val, err_msg=key)
