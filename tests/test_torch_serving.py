"""Port parity of the serving paths: on-device tracking, the batched and
whole-clip pipelines, and the CLI's --batch_videos / --scan.

* ``tracking_device`` against the JAX package's ``tracking_jax`` on random
  cases (contested claims, a pool that fills up and saturates): ids, pool
  size and embeddings equal; unsaturated, also against the port's host
  loop ``TrackState``.
* The slice: a calibrated tiny clip and a shifted copy of it through the
  port's ``BatchedVideoPipeline`` (B = 2) and ``VideoScanner`` with
  ``postprocess.impl="pallas"`` (the claim-scan kernel's wrapper, its plain
  version on CPU), against the JAX package's streaming
  ``InferencePipeline`` per video with ``impl="pallas"`` (claim_scan_pallas
  in Pallas interpret mode): maps, classes and track ids equal; thing
  scores within 1e-4 (the calibrated logits' f32 rounding, as in
  tests/test_torch_slice.py).
* The CLI: ``--batch_videos 2`` (with a padded tail group) and ``--scan``
  write the artifacts of its streaming run; a chunk that is not one video
  raises.
"""

import dataclasses
import json
import pickle
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from slotvps_tpu import tracking_jax as tj
from slotvps_tpu.config import Config
from slotvps_tpu.inference import InferencePipeline as JaxPipeline
from slotvps_tpu_torch import config as tconfig
from slotvps_tpu_torch import tracking_device as td
from slotvps_tpu_torch.inference import (BatchedVideoPipeline,
                                         InferencePipeline, VideoScanner,
                                         _warn_pool_saturation, run_video)
from slotvps_tpu_torch.tracking import TrackState
from tests.test_torch_models import port_model, tiny_model_cfg
from tests.test_torch_slice import _clip, calibrated  # noqa: F401

K, D = 8, 6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one CPU thread: its tensors are tiny, and
    the test runner's parallel workers oversubscribe the cores when each
    torch process spins a thread per core (the batched and CLI cases took
    100-270 s each that way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_pool(emb, size, started=True):
    return tj.PoolState(jnp.asarray(emb), jnp.asarray(size, jnp.int32),
                        jnp.asarray(started))


def _port_pool(emb, size, started=True):
    return td.PoolState(torch.from_numpy(emb),
                        torch.tensor(size, dtype=torch.int32), started)


def _assert_pools_equal(ids_t, pool_t, ids_j, pool_j):
    assert ids_t.dtype == torch.int32
    assert ids_t.tolist() == np.asarray(ids_j).tolist()
    assert int(pool_t.size) == int(pool_j.size)
    np.testing.assert_array_equal(pool_t.embeddings.numpy(),
                                  np.asarray(pool_j.embeddings))


def _update_case(rng, n_cur, n_pool, cap, contested):
    cur = rng.standard_normal((K, D)).astype(np.float32)
    emb = np.zeros((cap, D), np.float32)
    emb[:n_pool] = rng.standard_normal((n_pool, D))
    score = rng.standard_normal((K, cap + 1)).astype(np.float32) * 3
    if contested:
        # most rows go for the same two pool ids; one tie in likelihood
        score[:, 1:3] += 8.0
        score[1] = score[0]
    valid = np.zeros(K, bool)
    valid[rng.permutation(K)[:n_cur]] = True
    return cur, emb, score, valid


@pytest.mark.parametrize("seed,n_cur,n_pool,cap,contested", [
    (0, 5, 3, 16, False), (1, 8, 4, 16, True), (2, 3, 1, 16, True),
    (3, 6, 6, 16, False), (4, 8, 5, 8, True),    # fills the pool exactly
    (5, 8, 6, 8, False), (6, 7, 8, 8, True),     # saturates
])
def test_update_pool_matches_jax(seed, n_cur, n_pool, cap, contested):
    rng = np.random.default_rng(seed)
    cur, emb, score, valid = _update_case(rng, n_cur, n_pool, cap,
                                          contested)
    ids_j, pool_j = jax.jit(tj.update_pool)(
        _jax_pool(emb, n_pool), jnp.asarray(score), jnp.asarray(cur),
        jnp.asarray(valid))
    ids_t, pool_t = td.update_pool(
        _port_pool(emb, n_pool), torch.from_numpy(score),
        torch.from_numpy(cur), torch.from_numpy(valid))
    _assert_pools_equal(ids_t, pool_t, ids_j, pool_j)
    assert pool_t.started
    saturated = int(ids_t.max()) >= cap
    if not saturated:
        host = TrackState()
        host.embeddings = emb[:n_pool].copy()
        rows = np.nonzero(valid)[0]
        host_ids = host.update(score[rows][:, :n_pool + 1], cur[rows])
        assert ids_t[rows].tolist() == host_ids.tolist()
        np.testing.assert_array_equal(
            pool_t.embeddings[:int(pool_t.size)].numpy(), host.embeddings)
    else:
        # appends past capacity are dropped, never written over slot P-1
        assert int(pool_t.size) == cap
    assert (ids_t[~torch.from_numpy(valid)] == -1).all()


@pytest.mark.parametrize("n_cur,cap", [(5, 8), (8, 6), (0, 4)])
def test_start_pool_and_track_step_match_jax(n_cur, cap):
    rng = np.random.default_rng(n_cur)
    cur = rng.standard_normal((K, D)).astype(np.float32)
    valid = np.zeros(K, bool)
    valid[rng.permutation(K)[:n_cur]] = True
    score = rng.standard_normal((K, cap + 1)).astype(np.float32)
    pool_j = tj.init_pool(cap, D)
    pool_t = td.init_pool(cap, D, device="cpu")
    for step in range(3):
        ids_j, pool_j = jax.jit(tj.track_step)(
            pool_j, jnp.asarray(score), jnp.asarray(cur), jnp.asarray(valid))
        ids_t, pool_t = td.track_step(
            pool_t, torch.from_numpy(score), torch.from_numpy(cur),
            torch.from_numpy(valid))
        _assert_pools_equal(ids_t, pool_t, ids_j, pool_j)
        assert pool_t.started and bool(pool_j.started)
        if step == 0 and n_cur <= cap:
            host = TrackState()
            host_ids = host.start(cur[valid])
            assert ids_t[torch.from_numpy(valid)].tolist() \
                == host_ids.tolist()
        cur = cur[::-1].copy()


def test_pool_saturation_warning():
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        _warn_pool_saturation(np.array([[0, 1, -1], [2, 3, -1]]), 4)
    assert not rec
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        _warn_pool_saturation(np.array([[0, 1, -1], [2, 4, -1]]), 4)
    assert any("pool saturated" in str(w.message) for w in rec)


# ---- the slice: batched and whole-clip serving against JAX streaming ----

def _assert_same_results(ref, ours, label):
    assert len(ref) == len(ours)
    for t, (a, b) in enumerate(zip(ref, ours)):
        msg = f"{label} frame {t}"
        np.testing.assert_array_equal(b.sseg, a.sseg, err_msg=msg)
        np.testing.assert_array_equal(b.panoptic, a.panoptic, err_msg=msg)
        assert b.cls_inds.tolist() == a.cls_inds.tolist(), msg
        assert b.obj_ids.tolist() == a.obj_ids.tolist(), msg
        np.testing.assert_allclose(b.cls_prob, a.cls_prob, rtol=0,
                                   atol=1e-4, err_msg=msg)


def test_batched_and_scan_match_jax_streaming(calibrated):  # noqa: F811
    cfg, params, _ = calibrated
    pallas = dataclasses.replace(cfg, postprocess=dataclasses.replace(
        cfg.postprocess, impl="pallas"))
    clip = _clip(0, 3)
    clips = [clip, [np.roll(f, 24, axis=2) for f in clip]]
    jp = JaxPipeline(params, Config(model=pallas))
    with pltpu.force_tpu_interpret_mode():
        refs = [[jp.process_frame(f, is_first=(t == 0))
                 for t, f in enumerate(c)] for c in clips]

    tm = tiny_model_cfg("pallas_f32", tconfig)
    tm = dataclasses.replace(tm, postprocess=dataclasses.replace(
        tm.postprocess, impl="pallas"))
    tcfg = tconfig.Config(model=tm)
    model = port_model(params, tm)
    batched = BatchedVideoPipeline(model, tcfg, 2).run_videos(clips)
    scanner = VideoScanner(model, tcfg)
    for v, (ref, c) in enumerate(zip(refs, clips)):
        _assert_same_results(ref, batched[v], f"batched video {v}")
        _assert_same_results(ref, scanner.run_video(c), f"scan video {v}")
        # the regime is not trivial: things are kept, claimed and tracked
        assert all(len(r.cls_inds) for r in batched[v])
        assert all(r.n_claim > 0 for r in batched[v])
        assert any(set(a.obj_ids) & set(b.obj_ids)
                   for a, b in zip(ref, ref[1:]))
    # the port's streaming run agrees too (the pallas route on CPU is the
    # plain claim loop)
    stream = run_video(InferencePipeline(model, tcfg), clips[1])
    _assert_same_results(refs[1], stream, "stream video 1")


def test_batched_equals_port_streaming_bit_for_bit(calibrated):  # noqa: F811
    """f32: BatchedVideoPipeline (B = 2) returns each video's streaming
    results exactly, thing scores included (the backbone and the decoder
    take one frame at a time; at batch 2 the CPU's f32 GEMMs move the
    scores in their last bits)."""
    cfg, params, _ = calibrated
    tm = tiny_model_cfg("pallas_f32", tconfig)
    tcfg = tconfig.Config(model=tm)
    model = port_model(params, tm)
    clip = _clip(0, 3)
    clips = [clip, [np.roll(f, 24, axis=2) for f in clip]]
    batched = BatchedVideoPipeline(model, tcfg, 2).run_videos(clips)
    for v, c in enumerate(clips):
        stream = run_video(InferencePipeline(model, tcfg), c)
        assert all(len(r.cls_inds) for r in stream)
        for t, (a, b) in enumerate(zip(stream, batched[v])):
            for name in ("sseg", "panoptic", "cls_inds", "obj_ids",
                         "cls_prob"):
                assert np.array_equal(getattr(a, name), getattr(b, name)), \
                    (v, t, name)


@pytest.mark.parametrize("batch", [2, 3])
def test_batched_pipeline_replicas(calibrated, batch):  # noqa: F811
    """devices=["cpu", "cpu"]: B = 2 splits over two replicas of the model
    (one video each), B = 3 over one (n_devices 1, the largest divisor of 3
    that fits); each video equals its streaming run bit for bit (f32).  A
    replica on the model's device is the model itself.  The default is the
    model's device.  The videos must share a length."""
    cfg, params, _ = calibrated
    tm = tiny_model_cfg("pallas_f32", tconfig)
    tcfg = tconfig.Config(model=tm)
    model = port_model(params, tm)
    clip = _clip(0, 2)
    clips = [[np.roll(f, 24 * v, axis=2) for f in clip]
             for v in range(batch)]
    pipe = BatchedVideoPipeline(model, tcfg, batch, devices=["cpu", "cpu"])
    assert pipe.n_devices == {2: 2, 3: 1}[batch]
    assert [r.model for r in pipe.replicas] == [model] * pipe.n_devices
    batched = pipe.run_videos(clips)
    for v, c in enumerate(clips):
        stream = run_video(InferencePipeline(model, tcfg), c)
        for t, (a, b) in enumerate(zip(stream, batched[v])):
            for name in ("sseg", "panoptic", "cls_inds", "obj_ids",
                         "cls_prob"):
                assert np.array_equal(getattr(a, name), getattr(b, name)), \
                    (v, t, name)
    assert BatchedVideoPipeline(model, tcfg, batch).n_devices == 1
    with pytest.raises(ValueError, match="share a length"):
        pipe.run_videos([[clip[0]]] * (batch - 1) + [[]])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_extract_takes_each_frame_at_batch_1(monkeypatch, dtype):
    """BatchedVideoPipeline's replica feeds the backbone one frame at a
    time: every extract_features call sees one frame, and each frame's
    features equal those of the streaming pipeline's batch-1 call bit for
    bit (at batch 2 the backbone's convolutions may sum in another order)."""
    import slotvps_tpu_torch.inference as inf
    from slotvps_tpu_torch.models.detector import init_model

    tm = dataclasses.replace(tiny_model_cfg("pallas_f32", tconfig),
                             compute_dtype=dtype)
    tcfg = tconfig.Config(model=tm)
    model = init_model(torch.Generator().manual_seed(0), tm, device="cpu")
    img = np.concatenate(_clip(5, 2))
    batches, real = [], inf.extract_features

    def counted(model, cfg, x):
        batches.append(x.shape[0])
        return real(model, cfg, x)

    monkeypatch.setattr(inf, "extract_features", counted)
    with torch.inference_mode():
        both = BatchedVideoPipeline(model, tcfg, 2).replicas[0]._extract(
            img)
        assert batches == [1, 1]
        stream = InferencePipeline(model, tcfg)
        for i in range(2):
            alone = stream._extract(img[i:i + 1])
            for a, b in zip(alone.feat_trans + (alone.fcn_output,),
                            both.feat_trans + (both.fcn_output,)):
                assert torch.equal(a[0], b[i])


# ---- the CLI ----

def _write_videos(root, h, w, n_videos, n_frames):
    """``n_videos`` videos of ``n_frames`` frames on disk (iid = vid * 10000
    + fid), as tests/test_torch_slice.py writes one."""
    cv2 = pytest.importorskip("cv2")
    from slotvps_tpu_torch.eval.color import CITYSCAPES_CATEGORIES

    img_dir = root / "img"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    images = []
    for vid in range(1, n_videos + 1):
        base = rng.integers(0, 255, (h, w, 3), np.uint8)
        for fid in range(1, n_frames + 1):
            name = f"{vid:04d}_{fid:04d}_city_newImg8bit.png"
            cv2.imwrite(str(img_dir / name), np.roll(base, 4 * fid, axis=1))
            images.append({"id": vid * 10000 + fid, "file_name": name,
                           "height": h, "width": w})
    ann_file = root / "ann.json"
    ann_file.write_text(json.dumps({
        "images": images, "annotations": [],
        "categories": list(CITYSCAPES_CATEGORIES)}))
    return ann_file, img_dir


def test_cli_batched_and_scan_write_the_streaming_artifacts(tmp_path,
                                                             monkeypatch):
    from slotvps_tpu_torch.cli import test_eval_vpq as cli
    from slotvps_tpu_torch.config import named_config
    from slotvps_tpu_torch.inference import _device_normalize
    from slotvps_tpu_torch.models import detector as tdet
    from slotvps_tpu_torch.utils import calibration as tcal

    h, w, n_frames = 32, 64, 2
    base = named_config("r50_fpn_slotvps")
    model_cfg = tiny_model_cfg(config=tconfig)
    span = {"span": n_frames}
    monkeypatch.setattr(cli, "named_config", lambda name: dataclasses.replace(
        base, model=model_cfg,
        data=dataclasses.replace(base.data, img_scale=(w, h),
                                 nframes_span_test=span["span"]),
        eval=dataclasses.replace(base.eval, nframes_per_video=n_frames)))

    def calibrated_init(gen, cfg, device):
        """The seeded init, doctored and calibrated on a probe frame
        outside the dataset (~12 slots clear the keep rule), so that the
        runs keep and track things."""
        model = tdet.init_model(gen, cfg, device=device)
        tcal.doctor_params(model, torch.Generator().manual_seed(1))
        with torch.no_grad():
            img = _device_normalize(torch.from_numpy(_clip(1, 1, h, w)[0]),
                                    base.data)
            f = tdet.extract_features(model, cfg, img)
            logits = tdet.decode_pair(model, cfg, f, f).pred_logits[0]
        return tcal.calibrate_class_head(
            model, logits, torch.Generator().manual_seed(2),
            target_valid=12)[0]

    monkeypatch.setattr(cli, "init_model", calibrated_init)
    ann, img_dir = _write_videos(tmp_path, h, w, 3, n_frames)

    def run(name, *flags):
        out = tmp_path / name / "out.pkl"
        cli.main(["--device", "cpu", "--ann_file", str(ann), "--img_prefix",
                  str(img_dir), "--out", str(out), *flags])
        with open(str(out).replace(".pkl", "_pred_pans_2ch.pkl"), "rb") as f:
            pans = pickle.load(f)
        pred = json.loads((tmp_path / name / "out_pans_unified" /
                           "pred.json").read_text())
        return pans, pred

    stream = run("stream")
    assert len(stream[0]) == 6 and len(stream[1]["annotations"]) == 6
    assert any((p[..., 1] > 0).any() for p in stream[0])   # things kept
    for name, flags in (("batched", ("--batch_videos", "2")),
                        ("scan", ("--scan",))):
        pans, pred = run(name, *flags)
        assert len(pans) == len(stream[0])
        for a, b in zip(stream[0], pans):
            np.testing.assert_array_equal(b, a, err_msg=name)
        assert pred == stream[1], name
    span["span"] = 3    # chunks of 3 frames straddle the 2-frame videos
    with pytest.raises(RuntimeError, match="aligned with"):
        run("misaligned", "--scan")
