"""Port parity of the whole tuned bf16 slice: a tiny calibrated 3-frame
clip through both packages' ``InferencePipeline`` in the configuration of
the JAX package's ``--tuned`` with the slot-attention kernel
(``retriever_impl="pallas"``): bf16 compute, the bf16 DCN kernel route,
``fused_sseg`` and the fused postprocess.  The JAX package runs its Pallas
kernels in interpret mode; the port's kernel wrappers run their plain
versions on CPU tensors.

What is held, per frame: the kept thing classes are equal; the track ids
of the thing segments matched by overlap correspond one to one over the
clip; the semantic map agrees on >= 98.5 % of pixels and the panoptic map
on >= 92 % after matching segment ids by overlap.  Each floor sits just
under its reading.  Measured per frame (0, 1, 2): semantic map 99.12 %,
98.66 %, 99.07 %; matched panoptic 97.52 %, 92.58 %, 97.74 %, the
disagreement all on the border of a kept thing and a stuff segment.  A
mask upsample shifted by one pixel reads 91.55 % on frame 1 and fails.

Why not the 99 % / 98 % of the JAX package's trained regime: the two
packages round bf16 at other places (torch eager after every op, XLA on
fused chains), so the decoder's outputs differ by up to ~2e-2 * max, and
the calibrated class head multiplies the class logits by ~37 so that ~12
slots sit at the 0.85 keep rule.  The class logits then differ by ~1.5
(~0.1 of their spread over slots) and the masks of the random-noise frames
have many pixels near a tie of two slots.  The semantic map depends on the
feature path only and does not move with the decoder.

The kept set is that sensitive: torch's CPU bf16 convolutions and matmuls
sum in an order that depends on the thread count (one thread sums
otherwise than 2, 4 or 8, which agree), and at one thread the port keeps
one more thing on frame 0.  So the module runs the port at 4 threads: the
result is then the same on any host.

The weights are seeded and calibrated as in tests/test_torch_slice.py,
with one change: the Retriever's q and k LayerNorm scales are quartered.
At their init value the Retriever's softmax over slots takes unscaled dot
products of LayerNormed 256-d vectors (scores of order 100), which turns
one-ulp bf16 differences into other winning slots; each package's bf16
decode then lies ~0.1-0.3 * max from its own f32 decode, and two bf16
implementations cannot agree more closely than that.  Quartered, the
scores are of order 6 and the whole bf16 decode agrees within 2e-2
(tests/test_torch_bf16.py)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from slotvps_tpu import config as jconfig
from slotvps_tpu.inference import InferencePipeline as JaxPipeline
from slotvps_tpu.utils import calibration as jcal
from slotvps_tpu_torch import config as tconfig
from slotvps_tpu_torch.inference import (InferencePipeline,
                                         _device_normalize, run_video)
from slotvps_tpu_torch.models import detector as tdet
from slotvps_tpu_torch.ops.cuda.deform_conv import deform_conv2d_hopper
from slotvps_tpu_torch.ops.cuda.postproc_v3 import sseg_hopper
from slotvps_tpu_torch.ops.cuda.slot_attention import slot_attention_hopper
from slotvps_tpu_torch.utils.parity import _match_relabel
from tests.test_torch_bf16 import (_assert_module, _bf16_cfg,
                                   soften_retrievers)
from tests.test_torch_models import doctored_params, port_model
from tests.test_torch_slice import _clip

SSEG_AGREE = 0.985     # measured min 0.98657
PAN_AGREE = 0.92       # measured min 0.92578, ids matched by overlap
CPU_THREADS = 4


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    """The port's CPU bf16 reductions at a fixed thread count (see the
    module docstring); the worker's own count is restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(CPU_THREADS)
    yield
    torch.set_num_threads(n)


def tuned_cfg(config):
    """``tune_config`` of ``config``'s package on the tiny R18 model, with
    ``retriever_impl="pallas"`` (bench.py's ``BENCH_RETRIEVER=pallas``) and
    ``detect_capacity`` 0: the capacity ladder (each branch one more
    interpret-mode compile here) is held against the JAX package in
    tests/test_torch_postproc_v3.py."""
    cfg = _bf16_cfg(config)
    return dataclasses.replace(cfg, postprocess=dataclasses.replace(
        cfg.postprocess, impl="fused", detect_capacity=0))


@pytest.fixture(scope="module")
def tuned_pair():
    """The JAX pipeline (compiled once) and calibrated parameters: ~12 of
    20 slots clear the 0.85 keep rule on a probe frame outside the clip."""
    cfg = tuned_cfg(jconfig)
    params = soften_retrievers(doctored_params(cfg), 0.25)
    # the probe's class logits from the port (the same bf16 function, and
    # no interpret-mode compile of one more JAX decode)
    tcfg = tuned_cfg(tconfig)
    img = _device_normalize(torch.from_numpy(_clip(99, 1)[0]),
                            tconfig.Config().data)
    model = port_model(params, tcfg)
    with torch.no_grad():
        f = tdet.extract_features(model, tcfg, img)
        logits = tdet.decode_pair(model, tcfg, f, f).pred_logits[0]
    params, _ = jcal.calibrate_class_head(
        params, logits.numpy(), jax.random.PRNGKey(2), target_valid=12)
    return JaxPipeline(params, jconfig.Config(model=cfg)), params


def test_tuned_extract_features_matches_jax(tuned_pair):
    """R18 + FPN + the semantic head on the bf16 DCN route with
    ``fused_sseg`` (quarter-res logits) + conv_trans, from the same uint8
    frame: every output within 2e-2 * max|ref| (the module bound of
    tests/test_torch_bf16.py; the JAX side is the pipeline's own compiled
    extract step, shared with the slice test)."""
    jp, params = tuned_pair
    frame = _clip(7, 1)[0]
    with pltpu.force_tpu_interpret_mode():
        ref = jp._extract(params, frame)
    tcfg = tuned_cfg(tconfig)
    img = _device_normalize(torch.from_numpy(frame), tconfig.Config().data)
    with torch.no_grad():
        ours = tdet.extract_features(port_model(params, tcfg), tcfg, img)
    assert ours.fcn_output.shape == (1, 16, 32, 19)
    assert ours.fcn_output.dtype == torch.float32
    for a, b in zip((*ours.feat_trans, ours.fcn_output),
                    (*ref.feat_trans, ref.fcn_output)):
        assert a.dtype == (torch.float32 if a is ours.fcn_output
                           else torch.bfloat16)
        _assert_module(a, b)


def test_tuned_slice_matches_jax(tuned_pair):
    jp, params = tuned_pair
    frames = _clip(0, 3)
    with pltpu.force_tpu_interpret_mode():
        ref = [jp.process_frame(f, is_first=(t == 0))
               for t, f in enumerate(frames)]
    tcfg = tconfig.Config(model=tuned_cfg(tconfig))
    counts = (dict(deform_conv2d_hopper.launches), sseg_hopper.launches,
              slot_attention_hopper.launches)
    ours = run_video(InferencePipeline(port_model(params, tcfg.model), tcfg),
                     frames)
    # on CPU the wrappers run their plain versions and count nothing
    assert counts == (deform_conv2d_hopper.launches, sseg_hopper.launches,
                      slot_attention_hopper.launches)
    stuff_num = tcfg.model.stuff_num
    ids = set()       # (port track id, JAX track id) of matched things
    for t, (a, b) in enumerate(zip(ref, ours)):
        assert b.sseg.shape == a.sseg.shape == frames[0].shape[1:3]
        sseg = float((a.sseg == b.sseg).mean())
        pan = float((a.panoptic == _match_relabel(a.panoptic,
                                                  b.panoptic)).mean())
        assert sseg >= SSEG_AGREE and pan >= PAN_AGREE, (t, sseg, pan)
        assert sorted(b.cls_inds.tolist()) == sorted(a.cls_inds.tolist()), t
        for sb in np.unique(b.panoptic):
            if stuff_num <= sb < 255:
                sa = np.bincount(a.panoptic[b.panoptic == sb],
                                 minlength=256).argmax()
                if stuff_num <= sa < 255:
                    ids.add((int(b.obj_ids[sb - stuff_num]),
                             int(a.obj_ids[sa - stuff_num])))
    # one object, one id: the matched ids correspond one to one over the
    # clip (the ids themselves may be offset by a differing kept stuff
    # slot, which takes an id on the first frame)
    assert ids
    assert len({p for p, _ in ids}) == len({j for _, j in ids}) == len(ids)
    # the regime is not trivial: things are kept and tracked
    assert all(len(r.cls_inds) for r in ours)
    assert any(set(a.obj_ids) & set(b.obj_ids)
               for a, b in zip(ours, ours[1:]))
