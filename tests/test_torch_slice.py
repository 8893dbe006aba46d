"""Port parity of the whole slice, plus the converter, the calibration, the
CLI and the port's import rule.

The slice: a calibrated 3-frame clip through both packages'
``InferencePipeline`` — the JAX package with ``dcn_impl="jax"``, the port
with ``"pallas_f32"`` (whose wrapper runs the plain DCN on CPU), at the
same per-level halos.  Semantic map, panoptic map, thing classes and track
ids must be equal.  Thing scores agree within 1e-4: the calibrated class
head scales the logits ~15x, and at that scale both packages' f32 logits lie
~5e-4 from a float64 evaluation, which moves a softmax score near 0.85 by up
to ~5e-5."""

import ast
import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from slotvps_tpu.config import Config
from slotvps_tpu.inference import InferencePipeline as JaxPipeline
from slotvps_tpu.inference import _device_normalize as jax_normalize
from slotvps_tpu.models import detector as jdet
from slotvps_tpu.utils import calibration as jcal
from slotvps_tpu_torch import config as tconfig
from slotvps_tpu_torch.inference import InferencePipeline, run_video
from slotvps_tpu_torch.models import detector as tdet
from slotvps_tpu_torch.ops.cuda.deform_conv import deform_conv2d_hopper
from slotvps_tpu_torch.utils import calibration as tcal
from slotvps_tpu_torch.utils.convert import from_jax_params
from tests.test_torch_models import (doctored_params, port_model,
                                     tiny_model_cfg)

REPO = Path(__file__).resolve().parents[1]
H, W = 64, 128


def _clip(seed, n, h=H, w=W):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (1, h, w, 3), dtype=np.uint8)
            for _ in range(n)]


def _jax_probe_logits(params, cfg, frame):
    img = jax_normalize(jax.numpy.asarray(frame), Config().data)
    return jax.jit(lambda p, x: jdet.decode_pair(
        p, cfg, *(2 * [jdet.extract_features(p, cfg, x)])).pred_logits[0])(
            params, img)


@pytest.fixture(scope="module")
def calibrated():
    """JAX init -> doctor -> class head calibrated on a probe frame
    outside the clip (~12 of 20 slots clear the 0.85 keep rule)."""
    cfg = tiny_model_cfg()
    params = doctored_params(cfg)
    logits = _jax_probe_logits(params, cfg, _clip(99, 1)[0])
    params, info = jcal.calibrate_class_head(
        params, logits, jax.random.PRNGKey(2), target_valid=12)
    return cfg, params, info


def test_whole_slice_matches_jax(calibrated):
    cfg, params, _ = calibrated
    frames = _clip(0, 3)
    jp = JaxPipeline(params, Config(model=cfg))
    tcfg = tconfig.Config(model=tiny_model_cfg("pallas_f32", tconfig))
    tp = InferencePipeline(port_model(params, tcfg.model), tcfg)
    ref = [jp.process_frame(f, is_first=(t == 0))
           for t, f in enumerate(frames)]
    ours = run_video(tp, frames)
    for t, (a, b) in enumerate(zip(ref, ours)):
        np.testing.assert_array_equal(b.sseg, a.sseg, err_msg=f"frame {t}")
        np.testing.assert_array_equal(b.panoptic, a.panoptic,
                                      err_msg=f"frame {t}")
        assert b.cls_inds.tolist() == a.cls_inds.tolist(), t
        assert b.obj_ids.tolist() == a.obj_ids.tolist(), t
        np.testing.assert_allclose(b.cls_prob, a.cls_prob, rtol=0,
                                   atol=1e-4)
    # the regime is not trivial: things are kept and tracked
    assert all(len(r.cls_inds) for r in ours)
    assert any(set(a.obj_ids) & set(b.obj_ids)
               for a, b in zip(ours, ours[1:]))


def test_whole_slice_fused_postprocess_matches_jax(calibrated):
    """The port's --tuned postprocess (impl="fused", whose kernel wrappers
    run their plain versions on CPU) against the JAX package's reference
    postprocess on the same clip: equal maps, classes and track ids."""
    cfg, params, _ = calibrated
    frames = _clip(0, 3)
    jp = JaxPipeline(params, Config(model=cfg))
    tm = tiny_model_cfg("pallas_f32", tconfig)
    tm = dataclasses.replace(tm, postprocess=dataclasses.replace(
        tm.postprocess, impl="fused"))
    tp = InferencePipeline(port_model(params, tm), tconfig.Config(model=tm))
    ref = [jp.process_frame(f, is_first=(t == 0))
           for t, f in enumerate(frames)]
    ours = run_video(tp, frames)
    for t, (a, b) in enumerate(zip(ref, ours)):
        np.testing.assert_array_equal(b.sseg, a.sseg, err_msg=f"frame {t}")
        np.testing.assert_array_equal(b.panoptic, a.panoptic,
                                      err_msg=f"frame {t}")
        assert b.cls_inds.tolist() == a.cls_inds.tolist(), t
        assert b.obj_ids.tolist() == a.obj_ids.tolist(), t
    assert all(len(r.cls_inds) for r in ours)


def test_converter_covers_every_leaf(calibrated):
    _, params, _ = calibrated
    cfg = tiny_model_cfg(config=tconfig)
    leaves = jax.tree.leaves(params)
    state = from_jax_params(jax.tree.map(np.asarray, params), cfg)
    model = tdet.init_model(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    assert set(state) == set(model.state_dict())
    assert len(state) == len(leaves)
    conv = np.asarray(params["backbone"]["layer2"][0]["conv1"]["w"])
    np.testing.assert_array_equal(
        state["backbone.layer2.0.conv1.weight"].numpy(),
        conv.transpose(3, 2, 0, 1))
    lin = np.asarray(params["slot_head"]["stages"][1]["linear1"]["w"])
    np.testing.assert_array_equal(
        state["slot_head.stages.1.linear1.weight"].numpy(), lin.T)
    inp = np.asarray(params["slot_head"]["stages"][0]["self_attn"]
                     ["in_proj"]["w"])
    np.testing.assert_array_equal(
        state["slot_head.stages.0.self_attn.in_proj_weight"].numpy(), inp.T)
    bn = params["backbone"]["bn1"]
    np.testing.assert_array_equal(
        state["backbone.bn1.running_var"].numpy(), np.asarray(bn["var"]))


def test_converter_rejects_incomplete_or_extra_trees(calibrated):
    _, params, _ = calibrated
    cfg = tiny_model_cfg(config=tconfig)
    tree = jax.tree.map(np.asarray, params)
    missing = dict(tree, fg_bn={k: v for k, v in tree["fg_bn"].items()
                                if k != "var"})
    with pytest.raises(KeyError, match="not filled"):
        from_jax_params(missing, cfg)
    with pytest.raises(KeyError, match="no counterpart"):
        from_jax_params(dict(tree, stray=np.zeros(3)), cfg)
    dup = dict(tree, conv_trans=dict(tree["conv_trans"],
                                     bias=tree["conv_trans"]["b"]))
    with pytest.raises(ValueError, match="two JAX leaves"):
        from_jax_params(dup, cfg)
    bad = dict(tree, init_mask_query=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(bad, cfg)


def test_calibration_matches_jax_without_noise(calibrated):
    """Same probe logits, no noise: the bisection and the new class head
    agree with the JAX package's."""
    _, params, _ = calibrated
    cfg = tiny_model_cfg(config=tconfig)
    logits = np.random.default_rng(4).standard_normal(
        (20, 20)).astype(np.float32) * 3
    jparams, jinfo = jcal.calibrate_class_head(
        params, logits, jax.random.PRNGKey(0), target_valid=9,
        noise_std=0.0)
    model = port_model(params, cfg)
    model, tinfo = tcal.calibrate_class_head(
        model, torch.from_numpy(logits), torch.Generator().manual_seed(0),
        target_valid=9, noise_std=0.0)
    assert tinfo["scale"] == jinfo["scale"]
    assert tinfo["n_valid_probe"] == jinfo["n_valid_probe"] == 9
    head = jparams["slot_head"]["stages"][-1]["class_logits"]
    got = model.slot_head.stages[-1].class_logits
    np.testing.assert_allclose(got.weight.detach().numpy(),
                               np.asarray(head["w"]).T, rtol=1e-6)
    np.testing.assert_allclose(got.bias.detach().numpy(),
                               np.asarray(head["b"]), rtol=1e-6, atol=1e-6)


def test_port_calibration_reaches_target():
    """The port's own seeded init -> doctor -> calibrate (the regime
    chip_smoke.py runs on the card)."""
    from slotvps_tpu_torch.inference import _device_normalize

    cfg = tiny_model_cfg("pallas_f32", tconfig)
    model = tdet.init_model(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    query = model.init_mask_query.detach().clone()
    tcal.doctor_params(model, torch.Generator().manual_seed(1))
    torch.testing.assert_close(model.init_mask_query.detach(), 8 * query)
    for blk in model.semantic_head.tower:
        assert float(blk.offset.bias.detach().abs().max()) <= 1.5
        assert float(blk.offset.weight.detach().abs().max()) == 0.0
    assert float(model.fg_bn.weight.detach()) == 2.0
    img = _device_normalize(torch.from_numpy(_clip(1, 1)[0]),
                            tconfig.Config().data)
    with torch.no_grad():
        f = tdet.extract_features(model, cfg, img)
        logits = tdet.decode_pair(model, cfg, f, f).pred_logits[0]
    model, info = tcal.calibrate_class_head(
        model, logits, torch.Generator().manual_seed(2), target_valid=12)
    assert info["n_valid_probe"] == 12
    with torch.no_grad():
        probs = torch.softmax(
            tdet.decode_pair(model, cfg, f, f).pred_logits[0], -1)
    valid = (probs.argmax(-1) != 19) & (probs.amax(-1) > 0.85)
    assert abs(int(valid.sum()) - 12) <= 1


def test_pipeline_counts_kernel_launches_only_on_cuda(calibrated):
    """On CPU the kernel route runs the plain version and counts nothing;
    chip_smoke.py asserts 12 launches per frame on the card."""
    _, params, _ = calibrated
    tcfg = tconfig.Config(model=tiny_model_cfg("pallas_f32", tconfig))
    before = deform_conv2d_hopper.launches
    res = InferencePipeline(port_model(params, tcfg.model),
                            tcfg).process_frame(_clip(5, 1)[0], True)
    assert res.panoptic.shape == (H, W)
    assert deform_conv2d_hopper.launches == before


def _write_fixture(root, h, w):
    """2-frame video (vid 1, fids 1-2) on disk, as tests/test_eval_hooks.py
    writes it."""
    cv2 = pytest.importorskip("cv2")
    from PIL import Image

    from slotvps_tpu_torch.eval.color import CITYSCAPES_CATEGORIES, id2rgb

    img_dir, truth_dir = root / "img", root / "gt"
    img_dir.mkdir()
    truth_dir.mkdir()
    rng = np.random.default_rng(0)
    images, gt_images, gt_annos = [], [], []
    id_map = np.full((h, w), 1, np.uint32)
    id_map[8:20, 10:30] = 1001
    segs = [{"id": 1, "category_id": 0, "iscrowd": 0,
             "area": int((id_map == 1).sum())},
            {"id": 1001, "category_id": 11, "iscrowd": 0,
             "area": int((id_map == 1001).sum())}]
    for fid in (1, 2):
        name = f"0001_{fid:04d}_city_newImg8bit.png"
        cv2.imwrite(str(img_dir / name),
                    rng.integers(0, 255, (h, w, 3), np.uint8))
        images.append({"id": 10000 + fid, "file_name": name,
                       "height": h, "width": w})
        gt_images.append({"id": 10000 + fid, "file_name": name})
        gt_annos.append({"segments_info": [dict(s) for s in segs]})
        Image.fromarray(id2rgb(id_map)).save(
            truth_dir / name.replace("_newImg8bit.png", "_final_mask.png"))
    ann_file, gt_json = root / "ann.json", root / "gt_pan.json"
    ann_file.write_text(json.dumps({
        "images": images, "annotations": [],
        "categories": list(CITYSCAPES_CATEGORIES)}))
    gt_json.write_text(json.dumps({
        "images": gt_images, "annotations": gt_annos,
        "categories": list(CITYSCAPES_CATEGORIES)}))
    return ann_file, img_dir, truth_dir, gt_json


def test_cli_streaming_eval(tmp_path, monkeypatch):
    from slotvps_tpu_torch.cli import test_eval_vpq as cli
    from slotvps_tpu_torch.config import named_config

    h, w = 32, 64
    base = named_config("r50_fpn_slotvps")
    small = dataclasses.replace(
        base, model=tiny_model_cfg(config=tconfig),
        data=dataclasses.replace(base.data, img_scale=(w, h)),
        eval=dataclasses.replace(base.eval, nframes_per_video=2,
                                 panoptic_stuff_area_limit=64))
    monkeypatch.setattr(cli, "named_config", lambda name: small)
    ann, img_dir, truth_dir, gt_json = _write_fixture(tmp_path, h, w)
    out = tmp_path / "out" / "out.pkl"
    summary = cli.main([
        "--device", "cpu", "--tuned", "--ann_file", str(ann),
        "--img_prefix", str(img_dir), "--out", str(out),
        "--truth_dir", str(truth_dir), "--pan_gt_json_file", str(gt_json)])
    assert 0.0 <= summary["vpq_all"] <= 100.0
    pred = json.loads((tmp_path / "out" / "out_pans_unified" /
                       "pred.json").read_text())
    assert len(pred["annotations"]) == 2
    tuned = cli.tune_config(base).model
    assert tuned.semantic_head.dcn_impl == "pallas_f32"
    assert tuned.postprocess.impl == "fused"
    assert tuned.postprocess.detect_capacity == 64


def test_cli_device_flag():
    from slotvps_tpu_torch.cli.test_eval_vpq import parse_args, resolve_device

    assert parse_args(["--ann_file", "a", "--img_prefix", "b"]).device \
        == "cuda"
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device("cuda")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    """Static check (a sys.modules check cannot work where JAX is
    preloaded): no module of the port, and not chip_smoke.py, imports JAX
    or any module of the JAX package, lazy imports inside functions
    included."""
    files = sorted((REPO / "slotvps_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax", "slotvps_tpu"):
                bad.append(f"{f.relative_to(REPO)}: {mod}")
    assert not bad, bad
