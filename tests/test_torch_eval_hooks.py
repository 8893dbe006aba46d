"""The train-time evaluation of the port on the CPU, against the JAX
package: image PQ (``eval/pq.py pq_compute``) on the same frames, and the
``--eval_every`` entry point (``eval/hooks.py run_val_eval``) on
tests/test_eval_hooks.py's on-disk fixture (a 2-frame 32x64 video, its
annotation json, ground-truth PNGs and json) with the same weights.

So that the comparison is not of two empty predictions, both packages
get weights whose slots are kept: the JAX package's init, doctored
(``doctored_params``: fractional DCN offsets) and with its class head
calibrated (``calibrate_class_head``) on the fixture's first frame so that
~12 of the 20 slots clear the 0.85 keep rule; both sides then keep
things on both frames (the test records each pipeline's per-frame thing
classes and holds them equal and non-empty; fusion's semantic vote then
drops those things of the random semantic head, so pred.json holds stuff
segments only).  The pred.json files must be equal and the VPQ summaries
equal exactly (the same fused maps through the same numpy evaluator), as
must pq.txt."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from slotvps_tpu import config as jconfig
from slotvps_tpu.eval import hooks as jhooks
from slotvps_tpu.eval import pq as jpq
from slotvps_tpu.inference import _device_normalize as jax_normalize
from slotvps_tpu.models import detector as jdet
from slotvps_tpu.utils import calibration as jcal
from slotvps_tpu_torch import config as tconfig
from slotvps_tpu_torch.eval import hooks as thooks
from slotvps_tpu_torch.eval import pq as tpq

from test_eval_hooks import H, W, _write_fixture
from test_torch_models import doctored_params, port_model, tiny_model_cfg

cv2 = pytest.importorskip("cv2")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The module's torch work on one CPU thread: its tensors are tiny, and
    the test runner's parallel workers oversubscribe the cores when each
    torch process spins a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_cfg(config, model_cfg):
    """The fixture's config: the tiny model, 32x64 frames, 2-frame
    videos, the stuff-area limit scaled to the frame (as
    tests/test_train_eval_loop.py ``_full_cfg``)."""
    base = config.named_config("r50_fpn_slotvps")
    return dataclasses.replace(
        base, model=model_cfg,
        data=dataclasses.replace(base.data, img_scale=(W, H)),
        eval=dataclasses.replace(base.eval, nframes_per_video=2,
                                 panoptic_stuff_area_limit=64))


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("val")
    return root, _write_fixture(root)


@pytest.fixture(scope="module")
def calibrated(fixture):
    """JAX params with ~12 of 20 slots kept on the fixture's first frame,
    and both packages' configs."""
    _, (_, img_prefix, _, _) = fixture
    cfg = _run_cfg(jconfig, tiny_model_cfg())
    params = doctored_params(cfg.model)
    frame = cv2.imread(f"{img_prefix}/0001_0001_city_newImg8bit.png")[None]
    img = jax_normalize(jax.numpy.asarray(frame), cfg.data)
    logits = jax.jit(lambda p, x: jdet.decode_pair(
        p, cfg.model, *(2 * [jdet.extract_features(p, cfg.model, x)]))
        .pred_logits[0])(params, img)
    params, _ = jcal.calibrate_class_head(params, logits,
                                          jax.random.PRNGKey(2),
                                          target_valid=12)
    tcfg = _run_cfg(tconfig, tiny_model_cfg(config=tconfig))
    return cfg, tcfg, params


def _recording(monkeypatch, cls, kept):
    """Record each frame's kept thing classes of pipeline class ``cls``."""
    real = cls.process_frame

    def process_frame(self, *a, **k):
        res = real(self, *a, **k)
        kept.append(np.asarray(res.cls_inds).tolist())
        return res
    monkeypatch.setattr(cls, "process_frame", process_frame)


def test_run_val_eval_matches_jax(fixture, calibrated, tmp_path,
                                  monkeypatch):
    from slotvps_tpu import inference as jinf
    from slotvps_tpu_torch import inference as tinf

    _, (ann, img_prefix, truth_dir, gt_json) = fixture
    cfg, tcfg, params = calibrated
    jout, tout = tmp_path / "jax", tmp_path / "port"
    jkept, tkept = [], []
    _recording(monkeypatch, jinf.InferencePipeline, jkept)
    _recording(monkeypatch, tinf.InferencePipeline, tkept)
    want = jhooks.run_val_eval(params, cfg, ann, img_prefix, truth_dir,
                               gt_json, output_dir=str(jout), max_videos=1)
    model = port_model(params, tcfg.model)
    got = thooks.run_val_eval(model, tcfg, ann, img_prefix, truth_dir,
                              gt_json, output_dir=str(tout), max_videos=1)
    assert got == want
    pred = json.loads((tout / "pred.json").read_text())
    assert pred == json.loads((jout / "pred.json").read_text())
    assert len(pred["annotations"]) == 2
    assert tkept == jkept and len(tkept) == 2 and all(tkept), \
        f"things kept: port {tkept}, JAX {jkept}"
    for name in ("vpq-final.txt", "vpq-0.txt"):
        assert (tout / name).read_text() == (jout / name).read_text()


def test_run_val_eval_missing_gt_png_raises(fixture, calibrated, tmp_path):
    """The ground-truth file mapping is exercised: an empty truth_dir
    fails loudly instead of scoring zero frames."""
    _, (ann, img_prefix, _, gt_json) = fixture
    _, tcfg, params = calibrated
    model = port_model(params, tcfg.model)
    with pytest.raises(FileNotFoundError):
        thooks.run_val_eval(model, tcfg, ann, img_prefix, str(tmp_path),
                            gt_json, max_videos=1)


def _pq_frames(seed=0, n=3, h=16, w=24):
    """n (gt json, pred json, gt pan, pred pan) frames: a stuff class and
    two things, the prediction's regions shifted and one thing split."""
    from slotvps_tpu_torch.eval.color import id2rgb

    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(n):
        gt = np.ones((h, w), np.uint32)
        y, x = rng.integers(0, h // 2), rng.integers(0, w // 2)
        gt[y:y + h // 2, x:x + w // 3] = 1001
        gt[h - 5:, w - 7:] = 1002
        pred = np.roll(gt, int(rng.integers(-2, 3)), axis=1)
        pred[pred == 1002] = 2002
        pred[:2, :3] = 3001
        segs = lambda m, cats: [  # noqa: E731
            {"id": int(i), "category_id": cats[int(i)], "iscrowd": 0,
             "area": int((m == i).sum())} for i in np.unique(m)]
        cats = {1: 0, 1001: 11, 1002: 13, 2002: 13, 3001: 11}
        frames.append(({"segments_info": segs(gt, cats)},
                       {"segments_info": segs(pred, cats)},
                       id2rgb(gt), id2rgb(pred)))
    return frames


def test_pq_compute_matches_jax(tmp_path):
    from slotvps_tpu_torch.eval.color import CITYSCAPES_CATEGORIES

    cats = {c["id"]: c for c in CITYSCAPES_CATEGORIES}
    gj, pj, gp, pp = map(list, zip(*_pq_frames()))
    want = jpq.pq_compute(gj, pj, gp, pp, cats,
                          output_dir=str(tmp_path / "jax"))
    got = tpq.pq_compute(gj, pj, gp, pp, cats,
                         output_dir=str(tmp_path / "port"))
    assert got == want
    assert 0 < got["All"]["pq"] < 1 and got["Things"]["n"] == 2
    assert (tmp_path / "port" / "pq.txt").read_text() \
        == (tmp_path / "jax" / "pq.txt").read_text()
