"""Port parity of the fused postprocess: the plain versions of the four
kernels (slotvps_tpu_torch/ops/postproc_v3.py, which the Hopper wrappers
run on CPU tensors) against the JAX package's Pallas kernels, and the
port's ``postprocess_frame(impl="fused")`` against the JAX package's, at a
small size (K = 24 slots, 16x24 or 32x24 low-res masks).

The JAX side runs in Pallas interpret mode, as tests/test_postprocess.py
runs it, jitted so that each configuration compiles once.  Tolerance:
theta to 1e-6 * max(1, |theta|) (the sums of exp are taken in another
order); every integer output exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from slotvps_tpu.config import PostprocessConfig as JaxPostprocessConfig
from slotvps_tpu.models.postprocess import postprocess_frame as jax_post
from slotvps_tpu.ops.pallas import postproc_v3 as jv3
from slotvps_tpu_torch.config import PostprocessConfig
from slotvps_tpu_torch.models.postprocess import postprocess_frame
from slotvps_tpu_torch.ops import postproc_v3 as tv3
from slotvps_tpu_torch.ops.cuda import postproc_v3 as hv3

K, C, D = 24, 20, 8
OUT = (64, 96)
_JAX_POST = jax.jit(jax_post, static_argnums=(4, 5))


def _t(a):
    return torch.from_numpy(np.array(a))


def _blobs(rng, k, h, w):
    """Seeded mask logits with coherent blobs, as tests/test_postprocess.py
    makes them."""
    masks = rng.standard_normal((k, h, w)).astype(np.float32) * 2
    for i in range(0, k, 3):
        y, x = rng.integers(0, h - 4), rng.integers(0, w - 6)
        masks[i, y:y + 6, x:x + 8] += 6.0
    return masks


def _slot_meta(rng, k):
    labels = rng.integers(0, 19, k).astype(np.int32)
    valid = rng.random(k) < 0.7
    return labels, valid, labels > 10


@pytest.fixture(scope="module")
def kernel_case():
    """One [24, 32, 24] case run through the four JAX kernels in turn.
    Slot 5 copies slot 2 (same thing class): the claim loop rejects it for
    overlap; slot 7 is a thing with no pixel over theta (rejected as
    degenerate)."""
    rng = np.random.default_rng(0)
    masks = _blobs(rng, K, 32, 24)
    labels, valid, is_thing = _slot_meta(rng, K)
    labels[[2, 5, 7]] = 13
    valid[[2, 5, 7]] = is_thing[[2, 5, 7]] = True
    masks[5] = masks[2] + 0.01 * rng.standard_normal((32, 24))
    masks[7] = -20.0
    with pltpu.force_tpu_interpret_mode():
        theta_b = jax.jit(jv3.theta_v3, static_argnums=2)(
            masks, valid, 0.4)
        keep_b, owner_b = jax.jit(jv3.claim_v3, static_argnums=5)(
            masks, theta_b, labels, is_thing, valid, 0.03)
    kept = np.where(is_thing, np.asarray(keep_b), valid)
    return dict(masks=masks, labels=labels, valid=valid, is_thing=is_thing,
                theta_b=theta_b, keep=np.asarray(keep_b), owner_b=owner_b,
                kept=kept)


def test_theta_matches_jax_kernel(kernel_case):
    c = kernel_case
    ref = np.asarray(jv3.from_blocked(c["theta_b"]))
    ours = hv3.theta_hopper(_t(c["masks"]), _t(c["valid"]), 0.4).numpy()
    assert ours.shape == (128, 96) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(ref).max()))


def test_claim_matches_jax_kernel(kernel_case):
    """Same theta (the JAX kernel's) into both claim loops."""
    c = kernel_case
    theta = _t(jv3.from_blocked(c["theta_b"]))
    keep, owner = hv3.claim_hopper(_t(c["masks"]), theta, _t(c["labels"]),
                                   _t(c["is_thing"]), _t(c["valid"]), 0.03)
    np.testing.assert_array_equal(keep.numpy(), c["keep"])
    np.testing.assert_array_equal(owner.numpy(),
                                  np.asarray(jv3.from_blocked(c["owner_b"])))
    # the regime is not trivial: some things claim, some are rejected
    things = c["valid"] & c["is_thing"]
    assert 0 < keep.sum() < things.sum()
    assert (owner.numpy() >= 0).mean() > 0.1


def _argmax_both(c, kept):
    with pltpu.force_tpu_interpret_mode():
        m_b, areas = jax.jit(jv3.argmax_v3, static_argnames="per_tile")(
            c["masks"], c["owner_b"], kept, c["is_thing"], per_tile=True)
    owner = _t(jv3.from_blocked(c["owner_b"]))
    m_id, areas_t = hv3.argmax_hopper(_t(c["masks"]), owner, _t(kept),
                                      _t(c["is_thing"]))
    return (np.asarray(jv3.from_blocked(m_b)), np.asarray(areas)), \
        (m_id, areas_t)


def test_argmax_matches_jax_kernel(kernel_case):
    c = kernel_case
    (m_ref, areas_ref), (m_id, areas_t) = _argmax_both(c, c["kept"])
    assert m_id.dtype == torch.int32 and areas_t.shape == (4, K)
    np.testing.assert_array_equal(m_id.numpy(), m_ref)
    # the JAX kernel pads the slot axis to a multiple of 8: always zero
    np.testing.assert_array_equal(areas_t.numpy(), areas_ref[:, :K])
    assert not areas_ref[:, K:].any()
    assert len(np.unique(m_ref)) > 4


def test_repair_matches_jax_kernel(kernel_case):
    """Remove the kept slot whose pixels touch the fewest row tiles: those
    tiles are dirty, the others are copied through."""
    c = kernel_case
    (m_ref, areas_ref), (m1, areas_t) = _argmax_both(c, c["kept"])
    n_tiles = (areas_ref[:, :K] > 0).sum(0)
    kept_ids = np.nonzero(c["kept"] & (n_tiles > 0))[0]
    removed = np.zeros(K, bool)
    removed[kept_ids[np.argmin(n_tiles[kept_ids])]] = True
    kept_n = c["kept"] & ~removed
    dirty = ((areas_ref[:, :K] > 0) & removed[None]).any(-1)
    assert dirty.any() and not dirty.all(), dirty
    with pltpu.force_tpu_interpret_mode():
        m_b, a_b = jax.jit(jv3.repair_v3)(
            c["masks"], c["owner_b"], jv3.to_blocked(jnp.asarray(m_ref)),
            kept_n, c["is_thing"], dirty, jnp.asarray(areas_ref))
    owner = _t(jv3.from_blocked(c["owner_b"]))
    m1n, a_n = hv3.repair_hopper(_t(c["masks"]), owner, m1, _t(kept_n),
                                 _t(c["is_thing"]), _t(dirty), areas_t)
    np.testing.assert_array_equal(m1n.numpy(),
                                  np.asarray(jv3.from_blocked(m_b)))
    np.testing.assert_array_equal(a_n.numpy(), np.asarray(a_b)[:, :K])
    assert not np.isin(m1n.numpy(), np.nonzero(removed)[0]).any()


def test_wrappers_count_no_launch_on_cpu(kernel_case):
    c = kernel_case
    fns = (hv3.theta_hopper, hv3.claim_hopper, hv3.argmax_hopper,
           hv3.repair_hopper)
    before = [f.launches for f in fns]
    _argmax_both(c, c["kept"])
    hv3.theta_hopper(_t(c["masks"]), _t(c["valid"]), 0.4)
    assert [f.launches for f in fns] == before


def test_wrappers_reject_mixed_devices_and_bad_maps():
    m = torch.zeros((4, 8, 8))
    with pytest.raises(ValueError, match="one CUDA device"):
        hv3.theta_hopper(m, torch.ones(4, dtype=torch.bool, device="meta"),
                         0.4)
    assert tv3.tile_rows(16) == 8 and tv3.tile_rows(12) == 4


# ---- the whole fused path against the JAX package's ----

def _frame(logits, masks, seed):
    rng = np.random.default_rng(seed)
    fcn = rng.standard_normal((*OUT, 19)).astype(np.float32)
    emb = rng.standard_normal((masks.shape[0], D)).astype(np.float32)
    return logits, masks, emb, fcn


def _confident(rng, n_valid, masks=None):
    """Logits with exactly ``n_valid`` slots over the 0.85 keep rule
    (stuff and things mixed), the rest no-object; blob masks."""
    logits = rng.standard_normal((K, C)).astype(np.float32)
    logits[:, -1] += 8.0
    for i in rng.permutation(K)[:n_valid]:
        logits[i, rng.integers(0, 19)] += 14.0
    if masks is None:
        masks = _blobs(rng, K, 16, 24)
    return logits, masks


def assert_fused_matches_jax(frame, jcfg: JaxPostprocessConfig):
    """The port's impl="fused" and the JAX package's (interpret mode) on
    the same frame: equal kept, panoptic, thing_rank, sseg, n_kept,
    n_things and n_loop.  Returns the port's result."""
    tcfg = PostprocessConfig(**dataclasses.asdict(jcfg))
    assert tcfg.impl == "fused"
    with pltpu.force_tpu_interpret_mode():
        ref = _JAX_POST(*(jnp.asarray(a) for a in frame), OUT, jcfg)
        ref = jax.tree.map(np.asarray, ref)
    ours = postprocess_frame(*(_t(a) for a in frame), OUT, tcfg)
    for name in ("kept", "panoptic", "thing_rank", "sseg"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      getattr(ref, name), err_msg=name)
    assert (ours.n_kept, ours.n_things, ours.n_loop) == (
        int(ref.n_kept), int(ref.n_things), int(ref.n_loop))
    return ours


CAP8 = JaxPostprocessConfig(impl="fused", detect_capacity=8)


@pytest.mark.parametrize("n_valid,capacity", [(5, 8), (8, 8), (13, K)])
def test_fused_ladder_capacity_8(n_valid, capacity):
    """detect_capacity 8: the sliced branch (n_valid <= 8, the boundary
    included) and the full branch (n_valid > 8)."""
    rng = np.random.default_rng(n_valid)
    logits, masks = _confident(rng, n_valid)
    ours = assert_fused_matches_jax(_frame(logits, masks, n_valid), CAP8)
    assert ours.capacity == capacity
    assert ours.n_things > 0 and ours.kept.shape == (K,)
