"""The port's own copies of the JAX-free modules (config, tracking, eval,
native) against the JAX package's modules: same inputs, equal outputs.
Also the port's entry-point device rule: ``init_model`` runs on the card
unless the caller asks for the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from slotvps_tpu import config as jconfig
from slotvps_tpu import tracking as jtracking
from slotvps_tpu.eval import fusion as jfusion
from slotvps_tpu.eval import vpq as jvpq
from slotvps_tpu_torch import config as tconfig
from slotvps_tpu_torch import native as tnative
from slotvps_tpu_torch import tracking as ttracking
from slotvps_tpu_torch.eval import fusion as tfusion
from slotvps_tpu_torch.eval import vpq as tvpq
from slotvps_tpu_torch.eval.color import CITYSCAPES_CATEGORIES

NAMES = ("r50_fpn_slotvps", "swinl_fpn_slotvps", "r50_fpn_slotvps_viper",
         "r50_fpn_slotvps_mv")


@pytest.mark.parametrize("name", NAMES)
def test_named_configs_match(name):
    ours = tconfig.named_config(name)
    ref = jconfig.named_config(name)
    assert type(ours) is tconfig.Config and type(ref) is jconfig.Config
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


@pytest.mark.parametrize("name", NAMES)
def test_tune_config_matches_jax(name):
    """The port's --tuned configuration is the JAX package's, field for
    field: bf16, the bf16 DCN route, fused_sseg, per-level halos, the fused
    postprocess, the Retriever left at "jax"."""
    from slotvps_tpu.cli.test_eval_vpq import tune_config as jax_tune
    from slotvps_tpu_torch.cli.test_eval_vpq import tune_config

    ours = tune_config(tconfig.named_config(name))
    ref = jax_tune(jconfig.named_config(name))
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.model.compute_dtype == "bfloat16"
    assert ours.model.slot_head.retriever_impl == "jax"


def test_track_state_ids_match():
    rng = np.random.default_rng(0)
    ours, ref = ttracking.TrackState(), jtracking.TrackState()
    emb = rng.standard_normal((5, 8)).astype(np.float32)
    np.testing.assert_array_equal(ours.start(emb), ref.start(emb))
    for _ in range(6):
        n = int(rng.integers(1, 8))
        emb = rng.standard_normal((n, 8)).astype(np.float32)
        score = rng.standard_normal(
            (n, ref.embeddings.shape[0] + 1)) * 3
        np.testing.assert_array_equal(ours.update(score, emb),
                                      ref.update(score, emb))
        np.testing.assert_array_equal(ours.embeddings, ref.embeddings)
    assert ref.embeddings.shape[0] > 5


def _clip(n=6, h=32, w=64, seed=0):
    """Semantic maps, fused maps with 0-3 thing instances per frame, their
    classes and track ids, and ground-truth id maps with segments_info."""
    rng = np.random.default_rng(seed)
    segs, pans, cls_inds, obj_ids, gts = [], [], [], [], []
    for t in range(n):
        seg = rng.integers(0, 11, (h // 8, w // 8)).repeat(8, 0).repeat(8, 1)
        pan = seg.copy()
        k = int(rng.integers(0, 4))
        cls = rng.integers(1, 9, k)
        for i in range(k):
            y, x = rng.integers(0, h - 8), rng.integers(0, w - 12)
            pan[y:y + 8, x:x + 12] = 11 + i
            seg[y:y + 8, x:x + 12] = cls[i] + 10 if i != 1 else 3
        segs.append(seg.astype(np.uint8))
        pans.append(pan.astype(np.uint8))
        cls_inds.append(cls.astype(np.int64))
        obj_ids.append(rng.permutation(5)[:k].astype(np.int64))
        # id 0 is void: stuff class c -> id c + 1, thing -> 1000 c + t % 2
        gt = np.where(seg < 11, seg + 1, 1000 * seg + t % 2) \
            .astype(np.uint32)
        ids, areas = np.unique(gt, return_counts=True)
        gts.append((gt, [{"id": int(i), "iscrowd": 0, "area": int(a),
                          "category_id": int(i // 1000 if i >= 1000
                                             else i - 1)}
                         for i, a in zip(ids, areas)]))
    return segs, pans, cls_inds, obj_ids, gts


@pytest.mark.parametrize("use_native", [True, False])
def test_unify_pan_result_matches(use_native):
    segs, pans, cls_inds, obj_ids, _ = _clip()
    kw = dict(stuff_area_limit=64, id_last_stuff=10, use_native=use_native)
    ours = tfusion.unify_pan_result(segs, pans, cls_inds, obj_ids, **kw)
    ref = jfusion.unify_pan_result(segs, pans, cls_inds, obj_ids, **kw)
    assert len(ours) == len(ref) == 6
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    if use_native:
        assert tnative.available()


def test_native_library_builds_inside_the_port():
    from pathlib import Path

    assert tnative.available()
    build = Path(tnative.__file__).resolve().parents[1] / "_build"
    assert list(build.glob("libslotvps_fusion_*.so"))


def test_video_fusion_and_vpq_match(tmp_path):
    """inference_panoptic_video + final_eval on a tiny synthetic clip."""
    from slotvps_tpu_torch.eval.color import rgb2id

    segs, pans, cls_inds, obj_ids, gts = _clip()
    pans_2ch = tfusion.unify_pan_result(segs, pans, cls_inds, obj_ids,
                                        stuff_area_limit=64)
    names = [f"0001_{t + 1:04d}_city_newImg8bit.png" for t in range(6)]
    out = {}
    for tag, fusion, vpq in (("ours", tfusion, tvpq),
                             ("ref", jfusion, jvpq)):
        pred_pans, pred_json = fusion.inference_panoptic_video(
            pans_2ch, str(tmp_path / tag) + "/", list(CITYSCAPES_CATEGORIES),
            names, nframes_per_video=6)
        cats = {c["id"]: c for c in CITYSCAPES_CATEGORIES}
        gt_pans = [np.stack([g % 256, g // 256 % 256, g // 65536], -1)
                   .astype(np.uint8) for g, _ in gts]
        gt_jsons = [{"segments_info": s} for _, s in gts]
        summary = vpq.final_eval(pred_json["annotations"], gt_jsons, gt_pans,
                                 pred_pans, cats, nframes_per_video=6,
                                 verbose=False)
        out[tag] = (pred_pans, pred_json, summary)
    (p1, j1, s1), (p2, j2, s2) = out["ours"], out["ref"]
    for a, b in zip(p1, p2):
        np.testing.assert_array_equal(a, b)
    assert j1 == j2
    assert s1 == s2
    assert 0.0 < s1["vpq_all"] < 100.0
    assert len(np.unique(rgb2id(p1[0]))) > 2


def test_init_model_runs_on_the_card_unless_asked():
    from slotvps_tpu_torch.models import detector as tdet
    from tests.test_torch_models import tiny_model_cfg

    cfg = tiny_model_cfg(config=tconfig)
    if torch.cuda.is_available():
        model = tdet.init_model(torch.Generator().manual_seed(0), cfg)
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdet.init_model(torch.Generator().manual_seed(0), cfg)
    model = tdet.init_model(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    assert next(model.parameters()).device.type == "cpu"


# ---- the trainer's data path: transforms, mask, sampler, synthetic ----

def _frame_gt_pair(h=64, w=128):
    """The same synthetic frame and GT as each package's FrameGT."""
    from slotvps_tpu.data.transforms import FrameGT as JFrameGT
    from slotvps_tpu_torch.data.transforms import FrameGT

    from test_training import _synthetic_frame

    img, gt = _synthetic_frame(h, w)
    fields = {f.name: getattr(gt, f.name)
              for f in dataclasses.fields(JFrameGT)}
    return img, gt, FrameGT(**fields)


def _assert_same(a, b, path="out"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif dataclasses.is_dataclass(a):
        _assert_same(dataclasses.asdict(a), dataclasses.asdict(b), path)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif a is None or np.isscalar(a):
        assert a == b, path
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


@pytest.mark.parametrize("pseudo_video", [True, False])
def test_train_pipeline_copy_matches(pseudo_video):
    """apply_train_pipeline with the same seeded rng: every output equal,
    for the pseudo-video shift and for a real reference frame."""
    from slotvps_tpu.data import transforms as jt
    from slotvps_tpu_torch.data import transforms as tt

    img, jgt, tgt = _frame_gt_pair()
    kw = dict(img_scale=(128, 64), ratio_range=(0.8, 1.2),
              crop_size=(48, 96), shift_padding=10)
    n = 0
    for seed in range(4):
        ref = (None, None) if pseudo_video else (img[:, ::-1].copy(), None)
        out_j = jt.apply_train_pipeline(
            img, jgt, ref[0], None if pseudo_video else jgt,
            jt.TrainAugConfig(**kw), np.random.default_rng(seed),
            pseudo_video=pseudo_video)
        out_t = tt.apply_train_pipeline(
            img, tgt, ref[0], None if pseudo_video else tgt,
            tt.TrainAugConfig(**kw), np.random.default_rng(seed),
            pseudo_video=pseudo_video)
        assert (out_j is None) == (out_t is None)
        if out_j is not None:
            n += 1
            _assert_same(out_t, out_j)
    assert n > 0


def test_augment_copies_match():
    """The augmentations outside the released pipeline (expand, the
    min-IoU crop with its bbox_overlaps, photometric distortion)."""
    from slotvps_tpu.data import transforms as jt
    from slotvps_tpu.eval.detection import bbox_overlaps
    from slotvps_tpu_torch.data import transforms as tt

    img, jgt, tgt = _frame_gt_pair()
    for fn in ("expand", "min_iou_random_crop"):
        for seed in range(3):
            a = getattr(tt, fn)(img, tgt, np.random.default_rng(seed))
            b = getattr(jt, fn)(img, jgt, np.random.default_rng(seed))
            _assert_same(a, b, fn)
    _assert_same(tt.photometric_distortion(img, np.random.default_rng(1)),
                 jt.photometric_distortion(img, np.random.default_rng(1)))
    boxes = np.random.default_rng(0).uniform(0, 50, (5, 4))
    boxes[:, 2:] += boxes[:, :2]
    for mode in ("iou", "iof"):
        np.testing.assert_array_equal(
            tt.bbox_overlaps(boxes, boxes[::-1], mode),
            bbox_overlaps(boxes, boxes[::-1], mode))


def test_mask_copy_matches():
    from slotvps_tpu.data import mask as jm
    from slotvps_tpu_torch.data import mask as tm

    rng = np.random.default_rng(0)
    m = (rng.random((20, 30)) < 0.3).astype(np.uint8)
    rle_t, rle_j = tm.encode_rle(m), jm.encode_rle(m)
    assert rle_t == rle_j
    np.testing.assert_array_equal(tm.decode_mask(rle_t, 20, 30),
                                  jm.decode_mask(rle_j, 20, 30))
    np.testing.assert_array_equal(tm.decode_mask(rle_t, 20, 30), m)
    poly = [[2.0, 3.0, 25.0, 4.0, 20.0, 17.0, 4.0, 15.0]]
    np.testing.assert_array_equal(tm.decode_mask(poly, 20, 30),
                                  jm.decode_mask(poly, 20, 30))


def test_sampler_copy_matches():
    from slotvps_tpu.data import sampler as js
    from slotvps_tpu_torch.data import sampler as ts

    infos = [{"height": 64, "width": 128 if i % 3 else 32}
             for i in range(11)]
    flags = ts.aspect_ratio_flags(infos)
    np.testing.assert_array_equal(flags, js.aspect_ratio_flags(infos))
    for spb in (1, 2, 3):
        np.testing.assert_array_equal(
            ts.group_shuffled_indices(flags, spb, np.random.default_rng(5)),
            js.group_shuffled_indices(flags, spb, np.random.default_rng(5)))
    for rank in (0, 1):
        np.testing.assert_array_equal(
            ts.distributed_group_indices(flags, 2, 2, rank,
                                         np.random.default_rng(7)),
            js.distributed_group_indices(flags, 2, 2, rank,
                                         np.random.default_rng(7)))


def test_synthetic_scene_copy_matches():
    from slotvps_tpu.utils import synthetic as js
    from slotvps_tpu_torch.utils import synthetic as ts

    for h, w, n in ((48, 96, 5), (40, 40, 12)):
        a, b = ts.make_scene(h, w, n_things=n, seed=3), js.make_scene(
            h, w, n_things=n, seed=3)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(ts.norm_img(a.img), js.norm_img(b.img))


def _boxes(rng, n, size=60.0):
    b = rng.uniform(0, size, (n, 4)).astype(np.float32)
    b[:, 2:] = b[:, :2] + rng.uniform(1, 25, (n, 2))
    return b


def _detections(rng, n_img=3, n_cls=3):
    """Per image, per class [n, 5] detections (boxes near the GT, some
    classes empty) and the GT boxes and 1-based labels."""
    dets, gts, labels = [], [], []
    for i in range(n_img):
        gt = _boxes(rng, 4 + i)
        lab = rng.integers(1, n_cls + 1, len(gt))
        per_cls = []
        for c in range(n_cls):
            near = gt[lab == c + 1] + rng.normal(0, 3, (int((lab == c + 1)
                                                            .sum()), 4))
            boxes = np.concatenate([near, _boxes(rng, int(rng.integers(
                0, 3)))]).astype(np.float32)
            per_cls.append(np.concatenate(
                [boxes, rng.uniform(0, 1, (len(boxes), 1))], axis=1)
                .astype(np.float32))
        dets.append(per_cls)
        gts.append(gt)
        labels.append(lab)
    return dets, gts, labels


@pytest.mark.parametrize("mode", ["iou", "iof"])
def test_detection_overlaps_and_ap_copy_matches(mode):
    """eval/detection.py: bbox_overlaps (and transforms', the same
    function), average_precision in both modes on 1-D and 2-D curves,
    _tpfp_default with and without ignored GT."""
    from slotvps_tpu.eval import detection as jd
    from slotvps_tpu_torch.data import transforms as tt
    from slotvps_tpu_torch.eval import detection as td

    rng = np.random.default_rng(11)
    a, b = _boxes(rng, 6), _boxes(rng, 5)
    _assert_same(td.bbox_overlaps(a, b, mode), jd.bbox_overlaps(a, b, mode))
    _assert_same(td.bbox_overlaps(a[:0], b, mode),
                 jd.bbox_overlaps(a[:0], b, mode))
    assert tt.bbox_overlaps is td.bbox_overlaps
    rec = np.sort(rng.uniform(0, 1, (2, 9)), axis=1)
    prec = rng.uniform(0, 1, (2, 9))
    for ap_mode in ("area", "11points"):
        _assert_same(td.average_precision(rec, prec, ap_mode),
                     jd.average_precision(rec, prec, ap_mode))
        _assert_same(td.average_precision(rec[0], prec[0], ap_mode),
                     jd.average_precision(rec[0], prec[0], ap_mode))
    with pytest.raises(ValueError):
        td.average_precision(rec, prec, "bad")
    det = np.concatenate([b + rng.normal(0, 2, b.shape),
                          rng.uniform(0, 1, (len(b), 1))], axis=1)
    ignore = np.asarray([False, True, False, False, True])
    for gt_ignore in (None, ignore):
        for thr in (0.3, 0.5):
            _assert_same(td._tpfp_default(det, b, gt_ignore, thr),
                         jd._tpfp_default(det, b, gt_ignore, thr))
    _assert_same(td._tpfp_default(det, b[:0], None, 0.5),
                 jd._tpfp_default(det, b[:0], None, 0.5))


@pytest.mark.parametrize("mode", ["area", "11points"])
def test_detection_eval_copy_matches(mode):
    """eval_map in both AP modes, eval_recalls with scored and unscored
    proposals, confusion_matrix."""
    from slotvps_tpu.eval import detection as jd
    from slotvps_tpu_torch.eval import detection as td

    rng = np.random.default_rng(12)
    dets, gts, labels = _detections(rng)
    for thr in (0.3, 0.5, 0.75):
        _assert_same(td.eval_map(dets, gts, labels, thr, mode),
                     jd.eval_map(dets, gts, labels, thr, mode))
    scored = [np.concatenate([g + rng.normal(0, 4, g.shape),
                              rng.uniform(0, 1, (len(g), 1))], axis=1)
              for g in gts]
    for props in (scored, [p[:, :4] for p in scored]):
        _assert_same(
            td.eval_recalls(gts, props, (1, 3, 10), (0.3, 0.5, 0.7)),
            jd.eval_recalls(gts, props, (1, 3, 10), (0.3, 0.5, 0.7)))
    gt_l = rng.integers(0, 19, (24, 32))
    pred_l = np.where(rng.random(gt_l.shape) < 0.8, gt_l,
                      rng.integers(0, 19, gt_l.shape))
    _assert_same(td.confusion_matrix(gt_l, pred_l, 19),
                 jd.confusion_matrix(gt_l, pred_l, 19))


def test_detection_json_copy_matches(tmp_path):
    """The COCO json helpers: xyxy2xywh, det2json / json2det round trip,
    proposal2json, results2json's files, its TypeError."""
    import json

    from slotvps_tpu.eval import detection as jd
    from slotvps_tpu_torch.eval import detection as td

    rng = np.random.default_rng(13)
    dets, gts, _ = _detections(rng)
    ids = [10001, 10002, 20001]
    _assert_same(td.xyxy2xywh(gts[0][0]), jd.xyxy2xywh(gts[0][0]))
    payload = td.det2json(ids, dets)
    _assert_same(payload, jd.det2json(ids, dets))
    back = td.json2det(payload, ids, 3)
    _assert_same(back, jd.json2det(payload, ids, 3))
    for x, y in zip(back, dets):
        for c, d in zip(x, y):
            np.testing.assert_allclose(c, d, rtol=0, atol=1e-4)
    props = [np.concatenate([g, rng.uniform(0, 1, (len(g), 1))], axis=1)
             for g in gts]
    _assert_same(td.proposal2json(ids, props), jd.proposal2json(ids, props))
    for results in (dets, props):
        ours = td.results2json(ids, results, str(tmp_path / "ours"))
        ref = jd.results2json(ids, results, str(tmp_path / "ref"))
        assert set(ours) == set(ref)
        for kind in ours:
            with open(ours[kind]) as a, open(ref[kind]) as b:
                assert json.load(a) == json.load(b)
    with pytest.raises(TypeError):
        td.results2json(ids, [(1, 2)], str(tmp_path / "bad"))
