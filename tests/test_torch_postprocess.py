"""Port parity: the reference postprocess path of slotvps_tpu_torch against
the JAX package's ``postprocess_frame(impl="jax")`` and the literal numpy
golden model of tests/test_postprocess.py, and the port's fused path
(``impl="fused"``) against the JAX package's on the constructions of
tests/test_postprocess.py and across the capacity ladder.

Integer outputs (kept set, labels, ranks, panoptic and semantic maps) must
be equal; scores agree to f32 rounding of the softmax (rtol 1e-6)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotvps_tpu.config import PostprocessConfig
from slotvps_tpu.models.postprocess import postprocess_frame as jax_post
from slotvps_tpu_torch import config as tconfig
from slotvps_tpu_torch.models.postprocess import postprocess_frame
from tests.test_postprocess import (D, K, _case, _zero_pixel_case,
                                    golden_postprocess)
from tests.test_torch_postproc_v3 import (_confident, _frame,
                                          assert_fused_matches_jax)


def _port_cfg(cfg: PostprocessConfig) -> tconfig.PostprocessConfig:
    return tconfig.PostprocessConfig(**dataclasses.asdict(cfg))


def _both(logits, masks, emb, fcn, out_size, cfg):
    ref = jax_post(jnp.asarray(logits), jnp.asarray(masks), jnp.asarray(emb),
                   jnp.asarray(fcn), out_size, cfg)
    ours = postprocess_frame(torch.from_numpy(logits),
                             torch.from_numpy(masks), torch.from_numpy(emb),
                             torch.from_numpy(fcn), out_size, _port_cfg(cfg))
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
    """The two kernel routes, both ported now (the name is the one this
    test had while they were not).  The fused path, quarter-res semantic
    logits included (semantic_head fused_sseg: the sseg kernel's wrapper,
    its plain version on CPU), gives the semantic map of the reference
    staging.  impl='pallas' (the claim-scan kernel's wrapper, its plain
    version on CPU) equals the JAX package's impl='pallas' (claim_scan_pallas
    in Pallas interpret mode) and the port's impl='jax', to the tolerances
    of :func:`_assert_same`."""
    rng = np.random.default_rng(0)
    logits, masks, cfg = _case(rng)
    if impl == "pallas":
        from jax.experimental.pallas import tpu as pltpu

        fcn = rng.standard_normal((64, 96, 19)).astype(np.float32)
        emb = rng.standard_normal((K, D)).astype(np.float32)
        pcfg = dataclasses.replace(cfg, impl="pallas")
        with pltpu.force_tpu_interpret_mode():
            ref, ours = _both(logits, masks, emb, fcn, (64, 96), pcfg)
        _assert_same(ref, ours)
        plain = postprocess_frame(
            torch.from_numpy(logits), torch.from_numpy(masks),
            torch.from_numpy(emb), torch.from_numpy(fcn), (64, 96),
            _port_cfg(dataclasses.replace(cfg, impl="jax")))
        for name in ("kept", "panoptic", "sseg", "thing_rank"):
            assert torch.equal(getattr(ours, name), getattr(plain, name))
        assert ours.n_claim == plain.n_claim > 0
        assert ours.n_things > 0
        return
    fcn = torch.from_numpy(rng.standard_normal((16, 24, 19)).astype(
        np.float32))
    args = (torch.from_numpy(logits), torch.from_numpy(masks),
            torch.zeros((K, D)), fcn, (64, 96))
    from slotvps_tpu_torch.ops.interpolate import upsample_x4_bilinear

    r = postprocess_frame(*args, _port_cfg(dataclasses.replace(
        cfg, impl=impl)))
    ref = postprocess_frame(*args, _port_cfg(dataclasses.replace(
        cfg, impl="jax")))
    assert torch.equal(r.sseg, torch.argmax(upsample_x4_bilinear(fcn), -1))
    assert torch.equal(r.sseg, ref.sseg)
    assert torch.equal(r.panoptic, ref.panoptic)


# ---- the fused path against the JAX package's (Pallas interpret mode) ----

CAP16 = PostprocessConfig(impl="fused", detect_capacity=16)


def _patch_runner_up_removed():
    """tests/test_postprocess.py test_patch_loop_runner_up_also_removed:
    two stacked small stuff regions, winner and runner-up removed in the
    same filter iteration."""
    logits = np.full((K, 20), -10.0, np.float32)
    masks = np.full((K, 16, 24), -20.0, np.float32)
    logits[0, 1] = 10.0
    masks[0] = 1.0
    logits[1, 3] = 10.0
    masks[1] = 0.0
    masks[1, 8, 12] = 1.4
    logits[2, 4] = 10.0
    masks[2] = 0.0
    masks[2, 8, 12] = 1.35
    logits[3:, -1] = 10.0
    return logits, masks


def _patch_dedup_fold():
    """tests/test_postprocess.py test_patch_loop_dedup_fold_then_patch:
    duplicate stuff slots (folded area 0) and a small thing."""
    logits = np.full((K, 20), -10.0, np.float32)
    masks = np.full((K, 16, 24), -20.0, np.float32)
    logits[0, 1] = 10.0
    masks[0] = 1.0
    logits[1, 5] = 10.0
    masks[1, 2:8, 2:10] = 5.0
    logits[2, 5] = 9.5
    masks[2, 4:10, 4:12] = 4.0
    logits[3, 15] = 10.0
    masks[3, 12, 18] = 30.0
    logits[4:, -1] = 10.0
    return logits, masks


@pytest.mark.parametrize("case", ["runner_up_removed", "dedup_fold",
                                  "zero_pixel_thing"])
def test_fused_matches_jax_constructions(case):
    build = {"runner_up_removed": _patch_runner_up_removed,
             "dedup_fold": _patch_dedup_fold,
             "zero_pixel_thing": _zero_pixel_case}[case]
    logits, masks = build()
    ours = assert_fused_matches_jax(_frame(logits, masks, 0), CAP16)
    assert ours.n_loop >= 1 and ours.capacity == 8
    labels = ours.labels.numpy()[ours.kept.numpy()]
    if case == "runner_up_removed":
        assert labels.tolist() == [1]
    if case == "zero_pixel_thing":
        assert sorted(labels.tolist()) == [2, 16]


@pytest.mark.parametrize("n_valid,capacity", [(6, 8), (12, 16), (20, K)])
def test_fused_ladder_capacity_16(n_valid, capacity):
    """detect_capacity 16: the half branch (8 slots), the capacity branch
    and the full branch."""
    rng = np.random.default_rng(100 + n_valid)
    logits, masks = _confident(rng, n_valid)
    ours = assert_fused_matches_jax(_frame(logits, masks, n_valid), CAP16)
    assert ours.capacity == capacity
    assert ours.n_things > 0


@pytest.mark.parametrize("seed,thr,capacity", [(1, 0.6, 8), (3, 0.05, K)])
def test_fused_matches_jax_capacity_cases(seed, thr, capacity):
    """The random cases of tests/test_postproc_capacity.py at
    detect_capacity 8: threshold 0.6 keeps few slots (the sliced branch),
    0.05 nearly all (the full branch)."""
    from tests.test_postproc_capacity import _case as capacity_case

    args, out_size, cfg = capacity_case(np.random.default_rng(seed), thr)
    assert out_size == (64, 96)
    frame = tuple(np.asarray(a) for a in args)
    ours = assert_fused_matches_jax(
        frame, dataclasses.replace(cfg, impl="fused", detect_capacity=8))
    assert ours.capacity == capacity
    assert ours.n_kept > 0
