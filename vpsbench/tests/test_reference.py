"""The frozen reference computes what the port's plain routes compute, and
the frozen cost formulas and counter are the port's."""

import dataclasses

import numpy as np
import pytest
import torch

from vpsbench import clips
from vpsbench.cost import cost as frozen
from vpsbench.drivers import stream, video
from vpsbench.reference import pipeline
from vpsbench.tests import tiny
from vpsbench.tests.tiny_runs import plain_f32


@pytest.fixture(scope="module", params=["r50_fpn_slotvps",
                                        "swinl_fpn_slotvps"])
def tiny_models(request):
    d = stream.Driver(plain_f32(tiny.config_json(request.param)),
                      tiny.mix("stream"), 2**33 + 3, torch.device("cpu"))
    return d.ref, d.model, d.cfg, d.ref_cfg, d.videos


def test_state_dicts_are_the_same_tensors(tiny_models):
    ref, model, *_ = tiny_models
    a, b = ref.state_dict(), model.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_features_and_decode_match_the_port(tiny_models):
    from slotvps_tpu_torch.inference import _device_normalize
    from slotvps_tpu_torch.models import detector as pdet
    from vpsbench.reference import detector as rdet

    ref, model, port_cfg, ref_cfg, videos = tiny_models
    frame = torch.from_numpy(videos[0][0])
    with torch.inference_mode():
        pf = pdet.extract_features(model, port_cfg.model, _device_normalize(
            frame, port_cfg.data))
        rf = rdet.extract_features(ref, ref_cfg.model, pipeline.normalize(
            frame, ref_cfg.data))
        for a, b in zip(pf.feat_trans + (pf.fcn_output,),
                        rf.feat_trans + (rf.fcn_output,)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        po = pdet.decode_pair(model, port_cfg.model, pf, pf)
        ro = rdet.decode_pair(ref, ref_cfg.model, rf, rf)
        for a, b in zip(po, ro):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_streamed_video_matches_the_port(tiny_models):
    from slotvps_tpu_torch.inference import InferencePipeline, run_video

    ref, model, port_cfg, ref_cfg, videos = tiny_models
    size = tuple(videos[0][0].shape[1:3])
    ours = run_video(InferencePipeline(model, port_cfg, image_size=size),
                     videos[0])
    theirs = pipeline.run_video(ref, ref_cfg,
                                torch.from_numpy(np.concatenate(videos[0])))
    assert any(len(r.cls_inds) for r in theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.panoptic, b.panoptic)
        np.testing.assert_array_equal(a.sseg, b.sseg)
        np.testing.assert_array_equal(a.cls_inds, b.cls_inds)
        np.testing.assert_array_equal(a.obj_ids, b.obj_ids)
        np.testing.assert_allclose(a.cls_prob, b.cls_prob, rtol=1e-5)


def test_clips_are_seeded_and_shaped():
    a = clips.video(2**31 + 3, 1, 64, 96, 3, "cpu")
    b = clips.video(2**31 + 3, 1, 64, 96, 3, "cpu")
    c = clips.video(2**31 + 4, 1, 64, 96, 3, "cpu")
    assert a.dtype == torch.uint8 and a.shape == (3, 64, 96, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # the pan: frame 1 is frame 0's blocks moved 16 px to the right
    moved = (a[1, :, 16:].int() - a[0, :, :-16].int()).abs()
    assert int(moved.max()) <= 2 * clips.NOISE


LEVELS = ((256, 512), (128, 256), (64, 128), (32, 64))
BLOCKS = ((256, 256), (256, 128), (128, 128))


def test_frozen_formulas_are_the_ports_at_the_cells_shapes():
    from slotvps_tpu_torch.utils import cost as port

    def same(a, b):
        return dataclasses.astuple(a) == dataclasses.astuple(b)

    for h, w in LEVELS:
        for cin, cout in BLOCKS:
            for sizes in ((2, 2, 4), (4, 4, 4)):
                assert same(frozen.dcn_forward(1, h, w, cin, cout, *sizes),
                           port.dcn_forward(1, h, w, cin, cout, *sizes))
            assert same(frozen.dcn_backward(2, h, w, cin, cout),
                port.dcn_backward(2, h, w, cin, cout))
        for b in (1, 8):
            assert same(frozen.slot_attention(b, 100, h * w, 256, 2),
                port.slot_attention(b, 100, h * w, 256, 2))
    for k, n in ((64, 48), (100, 100)):
        assert same(frozen.theta(k, 256, 512, n),
                           port.theta(k, 256, 512, n))
        assert same(frozen.claim(k, 256, 512, n, n // 2),
            port.claim(k, 256, 512, n, n // 2))
        assert same(frozen.argmax(k, 256, 512, 11, 4096, 32),
            port.argmax(k, 256, 512, 11, 4096, 32))
    assert same(frozen.sseg(256, 512, 19), port.sseg(256, 512, 19))


def test_frozen_count_equals_the_ports(tiny_models):
    """One frame counted on the reference (drivers/video.frame_work) and
    on the port (its cost_analysis) in bf16: the same flops."""
    from slotvps_tpu_torch.inference import _device_normalize
    from slotvps_tpu_torch.models import detector as pdet
    from slotvps_tpu_torch.models.postprocess import postprocess_frame
    from slotvps_tpu_torch.utils.profiler import cost_analysis
    ref, model, port_cfg, ref_cfg, videos = tiny_models
    m = dataclasses.replace(port_cfg.model, compute_dtype="bfloat16")
    frame = torch.from_numpy(videos[0][0])

    def step():
        f = pdet.extract_features(model, m, _device_normalize(frame,
                                                              port_cfg.data))
        o = pdet.decode_pair(model, m, f, f)
        postprocess_frame(o.pred_logits[0], o.pred_masks[0],
                          o.embeddings[0], o.fcn_output[0],
                          tuple(frame.shape[1:3]), m.postprocess)

    with torch.inference_mode():
        theirs = cost_analysis(step)
    count_cfg = dataclasses.replace(ref_cfg, model=dataclasses.replace(
        ref_cfg.model, compute_dtype="bfloat16"))
    ours = video.frame_work(ref, count_cfg, frame[None][0])
    assert ours["flops"] == theirs["flops"]
    assert {n for n, _ in ours["entries"]} == {"dcn", "slot_attention",
                                               "postprocess"}
