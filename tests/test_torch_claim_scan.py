"""Port parity of the claim-scan kernel's plain version and of the two
postproc_v3 entries that only tests reach.

* ``ops/claim_scan.claim_scan`` (the plain version of the Hopper kernel
  ``claim_scan_hopper``, which runs it on CPU tensors) against the JAX
  package's ``claim_scan_pallas`` in Pallas interpret mode: keep and owner
  equal, on constructed overlaps at, above and below the 3 % rule (3/100,
  4/100, 1/33, 2/67), all-0 and all-1 planes, invalid and stuff slots, on
  random planes up to K = 127, and in the [B, K, H, W] form against
  ``jax.vmap(claim_scan_pallas)`` (its custom batching rule).
* ``ops/postproc_v3.argmax(top2=True)`` and ``hist`` against
  ``argmax_v3(top2=True)`` and ``hist_v3`` on the case of
  tests/test_postprocess.py ``test_argmax_v3_top2_and_hist``: equal maps
  and counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from slotvps_tpu.ops.pallas.claim_scan import claim_scan_pallas
from slotvps_tpu_torch.ops import postproc_v3 as plain
from slotvps_tpu_torch.ops.claim_scan import claim_scan
from slotvps_tpu_torch.ops.cuda import postproc_v3 as hv3
from slotvps_tpu_torch.ops.cuda.claim_scan import claim_scan_hopper

FRAC = 0.03


def _jax_claim(planes, labels, is_thing, valid, batched=False):
    args = [jnp.asarray(a) for a in (planes, labels, is_thing, valid)]
    with pltpu.force_tpu_interpret_mode():
        if batched:
            keep, owner = jax.vmap(claim_scan_pallas,
                                   in_axes=(0, 0, 0, 0, None))(*args, FRAC)
        else:
            keep, owner = claim_scan_pallas(*args, FRAC)
    return np.asarray(keep), np.asarray(owner)


def _port_claim(planes, labels, is_thing, valid):
    keep, owner = claim_scan_hopper(
        torch.from_numpy(planes), torch.from_numpy(labels),
        torch.from_numpy(is_thing), torch.from_numpy(valid), FRAC)
    return keep.numpy(), owner.numpy()


def _constructed():
    """[K, 16, 32] planes built from flat pixel sets; slot -> (expected
    keep, why)."""
    h, w = 16, 32
    n_pix = h * w
    sets = {
        0: range(0, 100),                              # first claim
        1: list(range(97, 197)),                       # 3/100: == 3 %
        2: [5] + list(range(300, 332)),                # 1/33 > 3 %
        3: [10, 11, 12, 13] + list(range(350, 446)),   # 4/100 > 3 %
        4: list(range(0, 50)) + list(range(450, 460)),  # other class
        5: [],                                         # all-0
        6: range(n_pix),                               # all-1
        7: range(0, 300),                              # valid stuff
        8: range(200, 300),                            # invalid thing
        9: [20, 21] + list(range(446, 450))
        + list(range(460, 511)) + list(range(332, 342)),  # 2/67 < 3 %
    }
    k = len(sets)
    planes = np.zeros((k, n_pix), bool)
    for i, px in sets.items():
        planes[i, list(px)] = True
    labels = np.array([11, 11, 11, 11, 12, 11, 11, 3, 11, 11], np.int32)
    is_thing = labels > 10
    valid = np.ones(k, bool)
    valid[8] = False
    expect = [True, True, False, False, True, False, False, False, False,
              True]
    assert planes[9].sum() == 67
    return planes.reshape(k, h, w), labels, is_thing, valid, expect


def test_constructed_overlaps_at_the_rule():
    planes, labels, is_thing, valid, expect = _constructed()
    keep, owner = _port_claim(planes, labels, is_thing, valid)
    jkeep, jowner = _jax_claim(planes, labels, is_thing, valid)
    assert keep.tolist() == expect
    np.testing.assert_array_equal(keep, jkeep)
    np.testing.assert_array_equal(owner, jowner)
    flat = owner.reshape(-1)
    assert (flat[:100] == 0).all() and (flat[100:197] == 1).all()
    assert (flat[450:460] == 4).all()           # other class claims
    assert not np.isin(flat, [2, 3, 5, 6, 7, 8]).any()


def _random(rng, k, h, w, n_classes=3):
    """Blobs of a few classes, so same-class overlaps land on both sides
    of the rule; some slots invalid, some stuff, one all-0 and one all-1."""
    yy, xx = np.mgrid[:h, :w]
    cy = rng.integers(0, h, k)[:, None, None]
    cx = rng.integers(0, w, k)[:, None, None]
    r = rng.integers(1, max(h, w) // 2, k)[:, None, None]
    planes = (yy - cy) ** 2 + (xx - cx) ** 2 <= r ** 2
    planes &= rng.random((k, h, w)) > 0.05
    planes[rng.integers(k)] = False
    planes[rng.integers(k)] = True
    labels = rng.integers(11, 11 + n_classes, k).astype(np.int32)
    labels[rng.random(k) < 0.15] = 4
    return (planes, labels, labels > 10, rng.random(k) > 0.2)


@pytest.mark.parametrize("seed,k", [(0, 8), (1, 20), (2, 64), (3, 127)])
def test_random_planes_match_jax(seed, k):
    rng = np.random.default_rng(seed)
    planes, labels, is_thing, valid = _random(rng, k, 12, 20)
    keep, owner = _port_claim(planes, labels, is_thing, valid)
    jkeep, jowner = _jax_claim(planes, labels, is_thing, valid)
    np.testing.assert_array_equal(keep, jkeep)
    np.testing.assert_array_equal(owner, jowner)
    things = valid & is_thing
    assert keep[things].any() and not keep[things].all()


def test_batched_form_matches_jax_vmap():
    """[B, K, H, W] with different planes, labels and flags per video:
    the JAX side runs claim_scan_pallas's custom batching rule."""
    rng = np.random.default_rng(7)
    cases = [_random(rng, 24, 12, 20) for _ in range(3)]
    planes, labels, is_thing, valid = (np.stack(x) for x in zip(*cases))
    keep, owner = _port_claim(planes, labels, is_thing, valid)
    jkeep, jowner = _jax_claim(planes, labels, is_thing, valid,
                               batched=True)
    assert keep.shape == (3, 24) and owner.shape == (3, 12, 20)
    np.testing.assert_array_equal(keep, jkeep)
    np.testing.assert_array_equal(owner, jowner)
    for b, case in enumerate(cases):
        one = claim_scan(*(torch.from_numpy(a) for a in case), FRAC)
        assert torch.equal(one[0], torch.from_numpy(keep[b]))
        assert torch.equal(one[1], torch.from_numpy(owner[b]))


def test_int8_planes_and_the_int8_limit():
    planes, labels, is_thing, valid, expect = _constructed()
    keep, owner = claim_scan(torch.from_numpy(planes.astype(np.int8)),
                             torch.from_numpy(labels),
                             torch.from_numpy(is_thing),
                             torch.from_numpy(valid), FRAC)
    assert keep.tolist() == expect
    big = torch.zeros((128, 4, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="int8 owner"):
        claim_scan(big, torch.zeros(128, dtype=torch.int32),
                   torch.ones(128, dtype=torch.bool),
                   torch.ones(128, dtype=torch.bool), FRAC)


def test_plain_fused_claim_is_the_same_loop():
    """ops/postproc_v3.claim binarizes against theta and runs the same
    claim_scan: equal to claim_scan on the planes up >= theta."""
    rng = np.random.default_rng(3)
    k, h, w = 12, 8, 10
    m = torch.from_numpy(rng.standard_normal((k, h, w)).astype(np.float32))
    valid = torch.from_numpy(rng.random(k) > 0.2)
    labels = torch.from_numpy(rng.integers(9, 13, k))
    is_thing = labels > 10
    th = plain.theta(m, valid, 0.4)
    keep, owner = plain.claim(m, th, labels, is_thing, valid, FRAC)
    keep2, owner2 = claim_scan(plain.upsample_slots(m) >= th, labels,
                               is_thing, valid, FRAC)
    assert torch.equal(keep, keep2) and torch.equal(owner, owner2)
    assert owner.max() >= 0


# ---- argmax_v3(top2=True) and hist_v3 ----

def _top2_case():
    """The case of tests/test_postprocess.py test_argmax_v3_top2_and_hist."""
    rng = np.random.default_rng(0)
    k, h, w = 13, 8, 32
    masks = rng.standard_normal((k, h, w)).astype(np.float32)
    kept = rng.random(k) > 0.3
    kept[0] = True
    is_thing = rng.random(k) > 0.5
    owner = rng.integers(-1, k, (4 * h, 4 * w)).astype(np.int8)
    return masks, kept, is_thing, owner


def test_argmax_top2_and_hist_match_jax():
    from slotvps_tpu.ops.pallas.postproc_v3 import (argmax_v3, from_blocked,
                                                    hist_v3, to_blocked)

    masks, kept, is_thing, owner = _top2_case()
    k = masks.shape[0]
    with pltpu.force_tpu_interpret_mode():
        m1_b, m2_b, areas = argmax_v3(
            jnp.asarray(masks), jnp.asarray(to_blocked(owner)),
            jnp.asarray(kept), jnp.asarray(is_thing), top2=True)
        jhist = hist_v3(m1_b, k)
    m1_j = np.asarray(from_blocked(m1_b))
    m2_j = np.asarray(from_blocked(m2_b))
    args = (torch.from_numpy(masks), torch.from_numpy(owner),
            torch.from_numpy(kept), torch.from_numpy(is_thing))
    m1, m2, areas_t = plain.argmax(*args, top2=True)
    np.testing.assert_array_equal(m1.numpy(), m1_j)
    np.testing.assert_array_equal(m2.numpy(), m2_j)
    np.testing.assert_array_equal(areas_t.sum(0).numpy(), np.asarray(areas))
    assert (m1 != m2).any() and m1.dtype == m2.dtype == torch.int32
    hist = plain.hist(m1, k)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jhist))
    assert hist.dtype == torch.int32 and int(hist.sum()) == m1.numel()
    # the wrappers run the plain versions on CPU tensors
    w1, w2, wa = hv3.argmax_hopper(*args, top2=True)
    assert torch.equal(w1, m1) and torch.equal(w2, m2) \
        and torch.equal(wa, areas_t)
    assert torch.equal(hv3.hist_hopper(m1, k), hist)
    # and the per-tile form is unchanged by the top2 pass
    p1, pa = plain.argmax(*args)
    assert torch.equal(p1, m1) and torch.equal(pa, areas_t)


def test_top2_names_the_winner_when_all_others_are_out():
    """Only slot 0 kept: the runner-up argmax sees -1e30 everywhere and
    takes the first index, the winner itself (argmax_v3's rule)."""
    masks, _, is_thing, owner = _top2_case()
    kept = np.zeros(masks.shape[0], bool)
    kept[0] = True
    m1, m2, _ = plain.argmax(torch.from_numpy(masks),
                             torch.from_numpy(owner), torch.from_numpy(kept),
                             torch.from_numpy(np.zeros_like(is_thing)),
                             top2=True)
    assert (m1 == 0).all() and (m2 == 0).all()


def test_hist_ignores_ids_outside_the_range():
    m_id = torch.tensor([[0, 3, 3, -1], [7, 2, 3, 9]], dtype=torch.int32)
    assert plain.hist(m_id, 4).tolist() == [1, 0, 1, 3]
    assert torch.equal(
        plain.hist(m_id.clamp(0, 3), 4),
        torch.bincount(m_id.clamp(0, 3).flatten().long(),
                       minlength=4).int())
