"""Port parity: backbone + FPN, semantic head, decoder and track head of
slotvps_tpu_torch against the JAX package, with the same parameters
(initialized in JAX, converted by slotvps_tpu_torch/utils/convert.py) and
the same numpy inputs, at a small size (R18, 20 slots, 64x128).

Tolerance rtol = atol = 1e-4 (f32 on both sides, sums in another order).
The shared helpers here also serve the other test_torch_* files.  Each
package gets its own config objects: ``tiny_model_cfg`` builds from the
JAX package's config module or from the port's copy of it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotvps_tpu import config as jconfig
from slotvps_tpu.models import detector as jdet
from slotvps_tpu_torch import config as tconfig
from slotvps_tpu_torch.models import detector as tdet
from slotvps_tpu_torch.utils.convert import from_jax_params

H, W = 64, 128
TOL = dict(rtol=1e-4, atol=1e-4)


def tiny_model_cfg(dcn_impl="jax", config=jconfig):
    """R18 / 20 slots / 4 decoder stages, per-level halos (2, 3, 4, 6),
    built from ``config``: ``jconfig`` for the JAX package, ``tconfig`` for
    the port."""
    cfg = config.ModelConfig(
        resnet=config.ResNetConfig(depth=18),
        slot_head=config.SlotHeadConfig(
            per_dh_num_heads=(1, 1, 1, 1), dh_num_heads=4,
            apply_temporal_query_atten_stages=(2, 3)),
        proposal_num=20)
    return dataclasses.replace(cfg, semantic_head=dataclasses.replace(
        cfg.semantic_head, dcn_impl=dcn_impl, dcn_halo=(2, 3, 4, 6)))


def port_model(params, cfg):
    """The port's model (port config ``cfg``) on the CPU, holding the JAX
    parameters ``params``."""
    state = from_jax_params(jax.tree.map(np.asarray, params), cfg)
    model = tdet.init_model(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    model.load_state_dict(state, strict=True)
    return model


def doctored_params(cfg, seed=0, **doctor_kw):
    """JAX init + doctor_params (nonzero fractional DCN offsets)."""
    from slotvps_tpu.utils.calibration import doctor_params

    params = jdet.init_model(jax.random.PRNGKey(seed), cfg)
    return doctor_params(params, jax.random.PRNGKey(seed + 1), **doctor_kw)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(ours, ref, **tol):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


@pytest.fixture(scope="module")
def pair():
    cfg = tiny_model_cfg()
    # fractional DCN offsets; fg_bn left at its reference init (0.1, var 1)
    # so mask logits stay at unit scale
    params = doctored_params(cfg, fg_scale=0.1, fg_var=1.0)
    model = port_model(params, tiny_model_cfg("pallas_f32", tconfig))
    # a random-init backbone with identity BN statistics amplifies its
    # input ~5x; a quarter-scale image keeps features at unit scale
    img = 0.25 * np.random.default_rng(0).standard_normal(
        (1, H, W, 3)).astype(np.float32)
    return cfg, params, model, img


def test_backbone_and_fpn(pair):
    from slotvps_tpu.models.fpn import apply_fpn
    from slotvps_tpu.models.resnet import apply_resnet

    cfg, params, model, img = pair
    ref = jax.jit(lambda p, x: apply_fpn(
        p["fpn"], apply_resnet(p["backbone"], x, depth=18)))(
            params, jnp.asarray(img))
    with torch.no_grad():
        ours = model.fpn(model.backbone(_t(img)))
    assert len(ours) == len(ref) == 5
    for a, b in zip(ours, ref):
        _close(a, b)


def test_bottleneck_backbone_and_fpn():
    """R50, the slice's backbone (bottleneck blocks, 256..2048-ch FPN
    inputs), at a 32x64 image."""
    from slotvps_tpu.models.fpn import apply_fpn
    from slotvps_tpu.models.resnet import apply_resnet

    cfg = dataclasses.replace(tiny_model_cfg(),
                              resnet=jconfig.ResNetConfig(depth=50))
    params = jdet.init_model(jax.random.PRNGKey(3), cfg)
    model = port_model(params, dataclasses.replace(
        tiny_model_cfg(config=tconfig),
        resnet=tconfig.ResNetConfig(depth=50)))
    # the random-init R50 with identity BN statistics amplifies its input
    # ~1000x, and is linear in it (no biases): a 1e-3-scale image keeps
    # the outputs at unit scale
    img = 1e-3 * np.random.default_rng(3).standard_normal(
        (1, 32, 64, 3)).astype(np.float32)
    ref = jax.jit(lambda p, x: apply_fpn(
        p["fpn"], apply_resnet(p["backbone"], x, depth=50)))(
            params, jnp.asarray(img))
    with torch.no_grad():
        ours = model.fpn(model.backbone(_t(img)))
    assert [a.shape[-1] for a in ours] == [256] * 5
    for a, b in zip(ours, ref):
        _close(a, b)


def test_semantic_head_kernel_route_vs_jax(pair):
    """JAX dcn_impl='jax' vs the port's 'pallas_f32' (its wrapper runs the
    plain version on CPU), same halos, same FPN inputs."""
    from slotvps_tpu.models.semantic_head import apply_semantic_head

    cfg, params, model, _ = pair
    rng = np.random.default_rng(1)
    fpn = [rng.standard_normal((1, H // s, W // s, 256)).astype(np.float32)
           for s in (4, 8, 16, 32)]
    ref = jax.jit(lambda p, xs: apply_semantic_head(
        p, xs, cfg.semantic_head))(params["semantic_head"],
                                   [jnp.asarray(f) for f in fpn])
    with torch.no_grad():
        ours = model.semantic_head(
            [_t(f) for f in fpn],
            tiny_model_cfg("pallas_f32", tconfig).semantic_head)
    _close(ours[0], ref[0])
    _close(ours[1], ref[1])
    for a, b in zip(ours[2], ref[2]):
        _close(a, b)


def test_extract_features_and_decoder(pair):
    cfg, params, model, img = pair
    tcfg = tiny_model_cfg("pallas_f32", tconfig)
    jf = jax.jit(lambda p, x: jdet.extract_features(p, cfg, x))(
        params, jnp.asarray(img))
    with torch.no_grad():
        tf = tdet.extract_features(model, tcfg, _t(img))
    for a, b in zip(tf.feat_trans, jf.feat_trans):
        _close(a, b)
    _close(tf.fcn_output, jf.fcn_output)

    # the decoder on identical features: a shifted copy as reference frame
    ref_feats = jax.tree.map(lambda a: jnp.roll(a, 1, axis=2), jf)
    jo = jax.jit(lambda p, r, c: jdet.decode_pair(p, cfg, r, c))(
        params, ref_feats, jf)
    to_t = lambda f: tdet.FrameFeatures(  # noqa: E731
        tuple(_t(a) for a in f.feat_trans), _t(f.fcn_output))
    with torch.no_grad():
        to = tdet.decode_pair(model, tcfg, to_t(ref_feats), to_t(jf))
    _close(to.pred_logits, jo.pred_logits)
    _close(to.embeddings, jo.embeddings)
    _close(to.pred_masks, jo.pred_masks)
    _close(to.fcn_output, jo.fcn_output)


def test_position_embedding():
    from slotvps_tpu.models.position_encoding import (
        sine_position_embedding as jpe)
    from slotvps_tpu_torch.models.position_encoding import (
        sine_position_embedding as tpe)

    _close(tpe(6, 10, num_pos_feats=16), jpe(6, 10, num_pos_feats=16))


def test_track_head(pair):
    from slotvps_tpu.models.track_head import apply_track_head

    _, params, model, _ = pair
    rng = np.random.default_rng(2)
    cur = rng.standard_normal((5, 256)).astype(np.float32)
    prev = rng.standard_normal((7, 256)).astype(np.float32)
    ref = apply_track_head(params["track_head"], jnp.asarray(cur),
                           jnp.asarray(prev))
    with torch.no_grad():
        ours = model.track_head(_t(cur), _t(prev))
    assert ours.shape == (5, 8)
    _close(ours, ref)


def test_unported_configuration_raises():
    cfg = tiny_model_cfg(config=tconfig)
    for bad in (dataclasses.replace(cfg, compute_dtype="bfloat16"),
                dataclasses.replace(cfg, backbone="swin"),
                dataclasses.replace(cfg, pos_embedding="learned")):
        with pytest.raises(NotImplementedError):
            tdet.check_supported(bad)
