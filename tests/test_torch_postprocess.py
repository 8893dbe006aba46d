"""Port parity: the reference postprocess path of slotvps_tpu_torch against
the JAX package's ``postprocess_frame(impl="jax")`` and the literal numpy
golden model of tests/test_postprocess.py.

Integer outputs (kept set, labels, ranks, panoptic and semantic maps) must
be equal; scores agree to f32 rounding of the softmax (rtol 1e-6)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotvps_tpu.config import PostprocessConfig
from slotvps_tpu.models.postprocess import postprocess_frame as jax_post
from slotvps_tpu_torch.models.postprocess import postprocess_frame
from tests.test_postprocess import (D, K, _case, _zero_pixel_case,
                                    golden_postprocess)


def _both(logits, masks, emb, fcn, out_size, cfg):
    ref = jax_post(jnp.asarray(logits), jnp.asarray(masks), jnp.asarray(emb),
                   jnp.asarray(fcn), out_size, cfg)
    ours = postprocess_frame(torch.from_numpy(logits),
                             torch.from_numpy(masks), torch.from_numpy(emb),
                             torch.from_numpy(fcn), out_size, cfg)
    return ref, ours


def _assert_same(ref, ours):
    for name in ("kept", "is_thing", "labels", "thing_rank", "panoptic",
                 "sseg"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_allclose(ours.scores.numpy(), np.asarray(ref.scores),
                               rtol=1e-6)
    np.testing.assert_array_equal(ours.embeddings.numpy(),
                                  np.asarray(ref.embeddings))
    assert ours.n_kept == int(ref.n_kept)
    assert ours.n_things == int(ref.n_things)
    assert ours.n_loop == int(ref.n_loop)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_matches_jax_and_golden(seed):
    rng = np.random.default_rng(seed)
    logits, masks, cfg = _case(rng)
    out_size = (64, 96)
    fcn = rng.standard_normal((*out_size, 19)).astype(np.float32)
    emb = rng.standard_normal((K, D)).astype(np.float32)
    ref, ours = _both(logits, masks, emb, fcn, out_size, cfg)
    _assert_same(ref, ours)

    g_classes, g_scores, _, _, g_pan = golden_postprocess(
        logits, masks, out_size, cfg)
    kept = ours.kept.numpy()
    assert ours.labels.numpy()[kept].tolist() == g_classes.tolist()
    np.testing.assert_allclose(ours.scores.numpy()[kept], g_scores,
                               rtol=1e-5)
    np.testing.assert_array_equal(ours.panoptic.numpy(), g_pan)


def test_resized_target_and_quarter_res_semantics():
    """Target size != 4x the mask size (the VIPER crop path) and
    quarter-res semantic logits (upsampled x4, then resized)."""
    rng = np.random.default_rng(7)
    logits, masks, cfg = _case(rng)
    out_size = (60, 90)
    fcn = rng.standard_normal((16, 24, 19)).astype(np.float32)
    emb = rng.standard_normal((K, D)).astype(np.float32)
    ref, ours = _both(logits, masks, emb, fcn, out_size, cfg)
    _assert_same(ref, ours)


@pytest.mark.parametrize("option", ["4_256", "4096_256"])
def test_other_small_area_filters(option):
    rng = np.random.default_rng(3)
    logits, masks, cfg = _case(rng)
    cfg = dataclasses.replace(cfg, filter_small_option=option)
    fcn = rng.standard_normal((64, 96, 19)).astype(np.float32)
    emb = rng.standard_normal((K, D)).astype(np.float32)
    ref, ours = _both(logits, masks, emb, fcn, (64, 96), cfg)
    _assert_same(ref, ours)


def test_no_kept_slots_all_void():
    logits = np.zeros((K, 20), np.float32)
    logits[:, -1] = 10.0
    masks = np.random.default_rng(0).standard_normal(
        (K, 16, 24)).astype(np.float32)
    ref, ours = _both(logits, masks, np.zeros((K, D), np.float32),
                      np.zeros((64, 96, 19), np.float32), (64, 96),
                      PostprocessConfig())
    _assert_same(ref, ours)
    assert ours.n_kept == 0 and (ours.panoptic == 255).all()


def test_zero_pixel_kept_thing_renumbering():
    logits, masks = _zero_pixel_case()
    rng = np.random.default_rng(0)
    fcn = rng.standard_normal((64, 96, 19)).astype(np.float32)
    emb = rng.standard_normal((K, D)).astype(np.float32)
    ref, ours = _both(logits, masks, emb, fcn, (64, 96),
                      PostprocessConfig())
    _assert_same(ref, ours)


def test_dedup_map_high_class_ids():
    from slotvps_tpu_torch.models.postprocess import _dedup_map

    mapped = _dedup_map(torch.tensor([33, 33, 40, 5]),
                        torch.tensor([False, False, False, True]),
                        torch.tensor([True, True, True, True]))
    assert mapped.tolist() == [0, 0, 2, 3]


@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_kernel_routes_not_ported_yet(impl):
    rng = np.random.default_rng(0)
    logits, masks, cfg = _case(rng)
    with pytest.raises(NotImplementedError):
        postprocess_frame(torch.from_numpy(logits), torch.from_numpy(masks),
                          torch.zeros((K, D)), torch.zeros((64, 96, 19)),
                          (64, 96), dataclasses.replace(cfg, impl=impl))
