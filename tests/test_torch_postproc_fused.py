"""Port parity of the K-minor postprocess: the plain versions of the three
kernels (slotvps_tpu_torch/ops/postproc_fused.py, which the Hopper wrappers
run on CPU tensors) against the JAX package's Pallas kernels of
slotvps_tpu/ops/pallas/postproc_fused.py, and the plain fused chain against
the port's plain v3 chain, at h, w, K = 8, 16, 12.

The JAX side runs in Pallas interpret mode, as tests/test_torch_postproc_v3.py
runs the v3 kernels, each function jitted once for the module's one shape.
Tolerances: theta to 1e-6 * max(1, |theta|) (the TPU kernel sums exp in
f32 over 128 lanes, the plain version in float64); every integer output
(keep, owner, m_id, areas) exactly."""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from slotvps_tpu.ops.pallas import postproc_fused as jfused
from slotvps_tpu_torch.ops import postproc_fused as tfused
from slotvps_tpu_torch.ops import postproc_v3 as tv3
from slotvps_tpu_torch.ops.cuda import postproc_fused as hfused

H, W, K = 8, 16, 12
THR, FRAC = 0.4, 0.03
THETA_ATOL = 1e-6     # times max(1, |theta|)
_THETA = jax.jit(jfused.theta_pallas, static_argnums=2)
_CLAIM = jax.jit(jfused.claim_scan_fused, static_argnums=5)
_ARGMAX = jax.jit(jfused.argmax_areas_pallas)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax(fn, *args):
    with pltpu.force_tpu_interpret_mode():
        return jax.tree.map(np.asarray, fn(*args))


def _blob_case(seed=0):
    """K-minor masks [8, 16, 12] with planted blobs so that things are
    kept; slot 5 copies slot 2 (same thing class: rejected for overlap),
    slot 7 is a thing with no pixel over theta (rejected as degenerate),
    slots 9 and 10 are invalid."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((H, W, K)).astype(np.float32) * 2
    for i in range(0, K, 2):
        y, x = rng.integers(0, H - 3), rng.integers(0, W - 4)
        m[y:y + 3, x:x + 4, i] += 7.0
    labels = rng.integers(0, 19, K).astype(np.int32)
    labels[[2, 5, 7]] = 13
    labels[[0, 4]] = [3, 15]
    m[..., 5] = m[..., 2] + 0.01 * rng.standard_normal((H, W))
    m[..., 7] = -20.0
    valid = np.ones(K, bool)
    valid[[9, 10]] = False
    return m, labels, valid, labels > 10


def _assert_theta(ours, ref):
    assert ours.shape == (4 * H, 4 * W) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                               atol=THETA_ATOL * max(1.0, np.abs(ref).max()))


def _chain_both(m, labels, valid, is_thing):
    """theta, claim and argmax-areas through the JAX kernels and the port's
    wrappers (plain versions on CPU tensors), each claim given the JAX
    kernel's theta and each argmax the JAX claim's owner map.  Returns
    (jax results, port results) as dicts."""
    theta_j = _jax(_THETA, m, valid, THR)
    keep_j, owner_j = _jax(_CLAIM, m, theta_j, labels, is_thing, valid, FRAC)
    kept = np.where(is_thing, keep_j, valid)
    m_id_j, areas_j = _jax(_ARGMAX, m, owner_j, kept, is_thing)
    theta = hfused.theta_fused_hopper(_t(m), _t(valid), THR)
    keep, owner = hfused.claim_scan_fused_hopper(
        _t(m), _t(theta_j), _t(labels), _t(is_thing), _t(valid), FRAC)
    m_id, areas = hfused.argmax_areas_hopper(_t(m), _t(owner_j), _t(kept),
                                             _t(is_thing))
    return (dict(theta=theta_j, keep=keep_j, owner=owner_j, m_id=m_id_j,
                 areas=areas_j),
            dict(theta=theta, keep=keep, owner=owner, m_id=m_id,
                 areas=areas))


@pytest.fixture(scope="module")
def blob_chain():
    case = _blob_case()
    return case, _chain_both(*case)


def test_theta_matches_jax_kernel(blob_chain):
    _, (ref, ours) = blob_chain
    _assert_theta(ours["theta"], ref["theta"])


def test_claim_matches_jax_kernel(blob_chain):
    """Same theta (the JAX kernel's) into both claim loops; slot 5 is
    rejected for overlap, slot 7 as degenerate, some things claim."""
    (m, labels, valid, is_thing), (ref, ours) = blob_chain
    assert ours["owner"].dtype == torch.int8
    np.testing.assert_array_equal(ours["keep"].numpy(), ref["keep"])
    np.testing.assert_array_equal(ours["owner"].numpy(), ref["owner"])
    keep = ours["keep"].numpy()
    assert not keep[5] and not keep[7] and keep[2]
    assert 0 < keep.sum() < (valid & is_thing).sum()
    assert (ours["owner"].numpy() >= 0).mean() > 0.05


def test_argmax_areas_matches_jax_kernel(blob_chain):
    _, (ref, ours) = blob_chain
    assert ours["m_id"].dtype == torch.int32 and ours["areas"].shape == (K,)
    np.testing.assert_array_equal(ours["m_id"].numpy(), ref["m_id"])
    np.testing.assert_array_equal(ours["areas"].numpy(), ref["areas"])
    assert ours["areas"].sum() == 16 * H * W
    assert len(np.unique(ref["m_id"])) > 3


def _edge_case(n_overlap):
    """Constant masks and a hand-set theta that carve exact planes: slot 0
    (thing, class 13, mask 10) is on at ``n_overlap`` pixels, slot 1 (thing,
    class 13, mask 20) at those and 100 - n_overlap more, so slot 1 overlaps
    slot 0's claim on n_overlap of its 100 pixels.  Slot 2 (thing, class
    14, mask 30) is on where slot 1 is: no overlap with its own class."""
    m = np.zeros((H, W, K), np.float32)
    m[..., 0], m[..., 1], m[..., 2] = 10.0, 20.0, 30.0
    m[..., 3:] = -50.0
    theta = np.full((4 * H, 4 * W), 1e30, np.float32)
    flat = theta.reshape(-1)
    flat[:n_overlap] = 10.0
    flat[n_overlap:100] = 20.0
    labels = np.full(K, 3, np.int32)
    labels[:3] = [13, 13, 14]
    valid = np.zeros(K, bool)
    valid[:3] = True
    return m, theta, labels, valid, labels > 10


@pytest.mark.parametrize("n_overlap,kept", [(3, True), (4, False)])
def test_claim_fraction_edge(n_overlap, kept):
    """The 3 % rule at its edge: 3 of 100 pixels owned by a slot of the same
    class keeps the slot (not > 0.03), 4 of 100 rejects it."""
    m, theta, labels, valid, is_thing = _edge_case(n_overlap)
    keep_j, owner_j = _jax(_CLAIM, m, theta, labels, is_thing, valid, FRAC)
    keep, owner = hfused.claim_scan_fused_hopper(
        _t(m), _t(theta), _t(labels), _t(is_thing), _t(valid), FRAC)
    np.testing.assert_array_equal(keep.numpy(), keep_j)
    np.testing.assert_array_equal(owner.numpy(), owner_j)
    assert keep.numpy()[:3].tolist() == [True, kept, True]
    assert (owner.numpy() == 0).sum() == n_overlap


def _invalid_case():
    m, labels, valid, is_thing = _blob_case(seed=1)
    valid[::2] = False
    return m, labels, valid, is_thing


def _all_stuff_case():
    m, labels, valid, _ = _blob_case(seed=2)
    labels = labels % 11
    return m, labels, valid, labels > 10


@pytest.mark.parametrize("make", [_invalid_case, _all_stuff_case],
                         ids=["invalid_slots", "all_stuff"])
def test_chain_matches_jax_kernels(make):
    """Half the slots invalid (excluded from theta, never kept), and a
    frame with no thing slot (nothing claims: owner all -1)."""
    m, labels, valid, is_thing = make()
    ref, ours = _chain_both(m, labels, valid, is_thing)
    _assert_theta(ours["theta"], ref["theta"])
    for name in ("keep", "owner", "m_id", "areas"):
        np.testing.assert_array_equal(ours[name].numpy(), ref[name],
                                      err_msg=name)
    if not is_thing.any():
        assert (ours["owner"].numpy() == -1).all()
    assert not np.isin(ours["m_id"].numpy(), np.nonzero(~valid)[0]).any()


def test_fused_chain_matches_v3_chain():
    """The plain fused chain on K-minor masks and the plain v3 chain on the
    same masks slot-major: equal theta, keep, owner, m_id and areas."""
    m, labels, valid, is_thing = (_t(a) for a in _blob_case(seed=3))
    th = tfused.theta_fused(m, valid, THR)
    m_khw = m.permute(2, 0, 1).contiguous()
    th3 = tv3.theta(m_khw, valid, THR)
    assert torch.equal(th, th3)
    keep, owner = tfused.claim_scan_fused(m, th, labels, is_thing, valid,
                                          FRAC)
    keep3, owner3 = tv3.claim(m_khw, th3, labels, is_thing, valid, FRAC)
    assert torch.equal(keep, keep3) and torch.equal(owner, owner3)
    kept = torch.where(is_thing, keep, valid)
    m_id, areas = tfused.argmax_areas(m, owner, kept, is_thing)
    m_id3, areas_t = tv3.argmax(m_khw, owner, kept, is_thing)
    assert torch.equal(m_id, m_id3)
    assert torch.equal(areas, areas_t.sum(0).to(torch.int32))
    assert keep.any() and areas.dtype == torch.int32


def test_wrappers_count_no_launch_on_cpu(blob_chain):
    (m, labels, valid, is_thing), _ = blob_chain
    fns = (hfused.theta_fused_hopper, hfused.claim_scan_fused_hopper,
           hfused.argmax_areas_hopper)
    before = [f.launches for f in fns]
    _chain_both(m, labels, valid, is_thing)
    assert [f.launches for f in fns] == before


def test_wrappers_reject_bad_input():
    m = torch.zeros((8, 8, 4))
    meta = torch.ones(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        hfused.theta_fused_hopper(m, meta, THR)
    with pytest.raises(ValueError, match="one CUDA device"):
        hfused.argmax_areas_hopper(m.to("meta"), torch.zeros(
            (32, 32), dtype=torch.int8), meta, meta)
    with pytest.raises(ValueError, match=r"\[h, w, K\]"):
        tfused.theta_fused(torch.zeros((8, 8)), torch.ones(4, dtype=bool),
                           THR)
