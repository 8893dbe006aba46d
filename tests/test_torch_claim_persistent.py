"""The persistent claim loop (``csrc/claim_loop.cuh``, run by the claim
scan and by the claim on planes binarized against theta) on the CPU.

* ``claim_geometry`` (``ops/cuda/claim_scan.py``): at the shapes the
  wrappers are given (a real 1024x2048 frame at B = 1, 2 and 4, the
  800x1600 crop, a small odd map), with the H100's 132 SMs and a 114-SM
  part, for the claim scan (no staging) and the theta claim (its row
  strips): every pixel of every video lies in exactly one block, there
  are no more blocks than SMs (one resident block an SM), a block's shared
  memory stays within 227 KB, the chunk width is 1..32 and the run a
  multiple of 16.
* A torch emulation of the kernel's schedule: the blocks' pixel runs,
  int32 bit words of up to 32 valid things built chunk by chunk, per-block
  partial counts summed into totals, each step's decision from the totals
  with one f32 division, the claim applied after the decision.  It is held
  against the plain ``claim_scan`` and the JAX package's
  ``claim_scan_pallas`` (Pallas interpret mode): more than 32 valid things
  with chunks of 32, 16 and 8 (ranges that cross chunk boundaries), all-0
  and all-1 planes, K = 127, B = 2 with different numbers of valid things
  and a slot range; and, for the theta form, against the plain ``claim``
  and the JAX ``claim_v3`` on planes ``up >= theta`` of small masks.
  keep and owner equal exactly.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from slotvps_tpu.ops.pallas import postproc_v3 as jv3
from slotvps_tpu_torch.ops import postproc_v3 as tv3
from slotvps_tpu_torch.ops.claim_scan import claim_scan
from slotvps_tpu_torch.ops.cuda.claim_scan import (
    ClaimGeometry, claim_geometry, claim_smem, word_bytes)
from slotvps_tpu_torch.ops.cuda.deform_conv import MAX_SMEM
from slotvps_tpu_torch.ops.cuda.postproc_v3 import CLAIM_STAGE
from test_torch_claim_scan import FRAC, _jax_claim, _random

SHAPES = [(1, 1024, 2048, 100), (2, 1024, 2048, 100), (4, 1024, 2048, 127),
          (1, 800, 1600, 64), (1, 37, 53, 5)]


@pytest.mark.parametrize("stage", [0, CLAIM_STAGE])
@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("b,h,w,k", SHAPES)
def test_claim_geometry(b, h, w, k, sms, stage):
    geo = claim_geometry(b, h, w, k, sms, stage=stage)
    hw = h * w
    assert 1 <= geo.blocks <= sms
    assert geo.run % 16 == 0
    assert 1 <= geo.chunk <= 32
    assert geo.group == b
    assert geo.smem == claim_smem(b, k, geo.run, geo.chunk, geo.own_smem,
                                  geo.bits_smem, stage) <= MAX_SMEM
    # every pixel of a video in exactly one block's run (the same runs in
    # every video)
    hits = np.zeros(hw, np.int32)
    for j in range(geo.blocks):
        hits[j * geo.run:min((j + 1) * geo.run, hw)] += 1
    assert (hits == 1).all()
    assert (geo.blocks - 1) * geo.run < hw <= geo.blocks * geo.run
    if (b, h, w) == (1, 1024, 2048):
        # the real frame: one block an SM, everything in shared memory
        assert geo.blocks == sms and geo.chunk == 32
        assert geo.own_smem and geo.bits_smem


@pytest.mark.parametrize("b,h,w,k", [(300, 37, 53, 127),
                                     (1000, 1024, 2048, 100)])
def test_claim_geometry_in_groups(b, h, w, k):
    """A batch whose per-video arrays exceed shared memory runs in groups:
    the most videos a pass that fit, with the tiles in device memory."""
    geo = claim_geometry(b, h, w, k, 132)
    assert 1 <= geo.group < b
    assert (geo.chunk, geo.own_smem, geo.bits_smem) == (32, False, False)
    assert geo.smem == claim_smem(geo.group, k, geo.run, 32, False,
                                  False) <= MAX_SMEM
    assert claim_smem(geo.group + 1, k, geo.run, 32, False,
                      False) > MAX_SMEM


def test_claim_geometry_past_shared_memory():
    """Larger batches first narrow the chunk, then move the owner tile and
    then the words to device memory; the layout always fits."""
    plans = [claim_geometry(b, 1024, 2048, 100, 132) for b in (2, 4, 8, 16)]
    assert [(g.chunk, g.own_smem, g.bits_smem) for g in plans] == [
        (32, True, True), (16, True, True), (8, False, True),
        (32, False, False)]
    assert all(g.smem <= MAX_SMEM and g.group == b
               for g, b in zip(plans, (2, 4, 8, 16)))
    assert word_bytes(8) == 1 and word_bytes(16) == 2 and word_bytes(32) == 4


def emulate(planes, labels, is_thing, valid, frac, geo, lo=0, hi=None):
    """keep [B, K] bool and owner [B, H, W] int8 of ``planes`` [B, K, H, W]
    bool by the kernel's schedule at geometry ``geo`` (its groups of
    videos in turn)."""
    b, k, h, w = planes.shape
    if geo.group < b:
        parts = [emulate(planes[g:g + geo.group], labels[g:g + geo.group],
                         is_thing[g:g + geo.group], valid[g:g + geo.group],
                         frac, geo._replace(group=b), lo, hi)
                 for g in range(0, b, geo.group)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    hw = h * w
    hi = k if hi is None else hi
    flat = planes.reshape(b, k, hw)
    things = valid & is_thing
    lists = [[s for s in torch.nonzero(things[v]).flatten().tolist()
              if lo <= s < hi] for v in range(b)]
    steps = max(len(x) for x in lists)
    runs = [(j * geo.run, min((j + 1) * geo.run, hw))
            for j in range(geo.blocks)]
    tiles = [[torch.full((q - p,), -1, dtype=torch.int8) for p, q in runs]
             for _ in range(b)]
    words = [[None] * len(runs) for _ in range(b)]
    n_tot = torch.zeros((b, k), dtype=torch.int64)
    o_tot = torch.zeros((b, k), dtype=torch.int64)
    keep = torch.zeros((b, k), dtype=torch.bool)
    pend = [-1] * b
    f32 = torch.float32

    def bit(word, t):
        return ((word >> t) & 1).bool()

    def claim(tp):
        for v in range(b):
            if pend[v] < 0:
                continue
            for tile, word in zip(tiles[v], words[v]):
                tile[bit(word, tp) & (tile < 0)] = pend[v]

    for st in range(steps):
        t = st % geo.chunk
        if t == 0:
            if st:
                claim(geo.chunk - 1)
            nbits = min(geo.chunk, steps - st)
            for v in range(b):
                for j, (p, q) in enumerate(runs):
                    word = torch.zeros(q - p, dtype=torch.int32)
                    for u in range(min(nbits, len(lists[v]) - st)):
                        one = -2 ** 31 if u == 31 else 1 << u
                        word |= flat[v, lists[v][st + u], p:q].int() * one
                    words[v][j] = word
                    for u in range(min(nbits, len(lists[v]) - st)):
                        n_tot[v, st + u] += int(bit(word, u).sum())
        elif any(x >= 0 for x in pend):
            claim(t - 1)
        for v in range(b):
            if st >= len(lists[v]):
                continue
            cls = labels[v, lists[v][st]]
            for tile, word in zip(tiles[v], words[v]):
                owned = tile >= 0
                same = owned & (labels[v][tile.long().clamp_min(0)] == cls)
                o_tot[v, st] += int((bit(word, t) & same).sum())
        # the grid barrier: every block reads the same totals
        for v in range(b):
            pend[v] = -1
            if st >= len(lists[v]):
                continue
            slot = lists[v][st]
            tn, to = int(n_tot[v, st]), int(o_tot[v, st])
            reject = tn in (0, hw) or bool(
                torch.tensor(to, dtype=f32)
                / torch.tensor(max(tn, 1), dtype=f32)
                > torch.tensor(frac, dtype=f32))
            keep[v, slot] = not reject
            pend[v] = -1 if reject else slot
    if steps:
        claim((steps - 1) % geo.chunk)
    owner = torch.stack([torch.cat(tiles[v]) for v in range(b)])
    return keep, owner.reshape(b, h, w)


def _geometries(b, h, w, k):
    """The wrapper's geometry, and runs of a fifth, an eighth and a
    fifteenth of the map (5-15 blocks) at chunk widths 32, 16 and 8, the
    last one video a pass."""
    hw = h * w
    real = claim_geometry(b, h, w, k, 132)
    runs = [(-(-hw // n) + 15) // 16 * 16 for n in (5, 8, 15)]
    small = [ClaimGeometry(-(-hw // run), run, chunk, True, True, group, 0)
             for run, chunk, group in zip(runs, (32, 16, 8), (b, b, 1))]
    return [real] + small


def _many_things(rng, k, h, w, n_things):
    """``_random`` planes whose first ``n_things`` slots are valid things
    and the rest stuff or invalid, so the valid things exceed a chunk."""
    planes, labels, is_thing, valid = _random(rng, k, h, w)
    labels[:n_things] = rng.integers(11, 14, n_things)
    labels[n_things:] = 4
    is_thing = labels > 10
    valid = np.ones(k, bool)
    valid[n_things + 1::3] = False
    planes[3] = False            # an all-0 thing
    planes[5] = True             # an all-1 thing
    return planes, labels.astype(np.int32), is_thing, valid


def _check(planes, labels, is_thing, valid, geos, jax_ref, lo=0, hi=None):
    t = [torch.from_numpy(np.asarray(a)) for a in
         (planes, labels, is_thing, valid)]
    batched = t[0].ndim == 4
    if not batched:
        t = [x[None] for x in t]
    keep_p, owner_p = claim_scan(*t, FRAC)
    for geo in geos:
        keep, owner = emulate(*t, FRAC, geo, lo, hi)
        assert torch.equal(keep, keep_p), geo
        assert torch.equal(owner, owner_p), geo
    jkeep, jowner = jax_ref
    if not batched:
        jkeep, jowner = jkeep[None], jowner[None]
    np.testing.assert_array_equal(keep_p.numpy(), jkeep)
    np.testing.assert_array_equal(owner_p.numpy(), jowner)
    return keep_p


@pytest.mark.parametrize("k,n_things", [(48, 40), (127, 100)])
def test_schedule_past_a_chunk_matches_plain_and_jax(k, n_things):
    """40 and 100 valid things: chunks of 32, 16 and 8 end inside the
    range; all-0 and all-1 things are rejected."""
    rng = np.random.default_rng(k)
    case = _many_things(rng, k, 12, 20, n_things)
    keep = _check(*case, _geometries(1, 12, 20, k), _jax_claim(*case))
    things = case[2] & case[3]
    assert not keep[0, 3] and not keep[0, 5]
    assert 0 < int(keep.sum()) < int(things.sum())
    assert int(things.sum()) > 32


def test_schedule_batched_with_different_ranges():
    """B = 2: 40 valid things in one video, 9 in the other (so the steps
    are the first video's), both within the slot range [2, 45)."""
    rng = np.random.default_rng(5)
    a = _many_things(rng, 48, 12, 20, 40)
    b = _random(rng, 48, 12, 20)
    b[1][2:11] = 12
    b[2][:] = b[1] > 10
    b[3][:] = False
    b[3][2:11] = True
    planes, labels, is_thing, valid = (np.stack(x) for x in zip(a, b))
    flags = valid & is_thing
    assert flags[0].sum() > 32 and flags[1].sum() == 9
    lo = int(np.nonzero(flags.any(0))[0].min())
    hi = int(np.nonzero(flags.any(0))[0].max()) + 1
    keep = _check(planes, labels, is_thing, valid,
                  _geometries(2, 12, 20, 48),
                  _jax_claim(planes, labels, is_thing, valid, batched=True),
                  lo, hi)
    assert keep[1].any() and keep[0].any()


@pytest.fixture(scope="module")
def theta_case():
    """Low-res masks [40, 8, 12] (a 32x48 full-res map) with 34 valid
    things, one copying another of its class (rejected for overlap), one
    with no pixel over theta; the JAX claim_v3 in interpret mode."""
    rng = np.random.default_rng(3)
    k, h, w = 40, 8, 12
    m = rng.standard_normal((k, h, w)).astype(np.float32) * 2
    for i in range(0, k, 2):
        y, x = rng.integers(0, h - 3), rng.integers(0, w - 4)
        m[i, y:y + 3, x:x + 4] += 6.0
    labels = rng.integers(11, 14, k).astype(np.int32)
    labels[:4] = 2
    valid = np.ones(k, bool)
    valid[[10, 20]] = False
    is_thing = labels > 10
    labels[9] = labels[8]
    m[9] = m[8] + 0.01
    m[12] = -20.0
    theta = tv3.theta(torch.from_numpy(m), torch.from_numpy(valid), 0.4)
    with pltpu.force_tpu_interpret_mode():
        jkeep, jowner = jax.jit(jv3.claim_v3, static_argnums=5)(
            m, jv3.to_blocked(theta.numpy()), labels, is_thing, valid, FRAC)
    return (m, theta, labels, is_thing, valid, np.asarray(jkeep),
            np.asarray(jv3.from_blocked(jowner)))


def test_schedule_theta_form_matches_claim_and_jax(theta_case):
    m, theta, labels, is_thing, valid, jkeep, jowner = theta_case
    t = [torch.from_numpy(a) for a in (m, labels, is_thing, valid)]
    keep_p, owner_p = tv3.claim(t[0], theta, *t[1:], FRAC)
    np.testing.assert_array_equal(keep_p.numpy(), jkeep)
    np.testing.assert_array_equal(owner_p.numpy(), jowner)
    planes = (tv3.upsample_slots(t[0]) >= theta)[None]
    for geo in _geometries(1, 32, 48, 40):
        keep, owner = emulate(planes, *(x[None] for x in t[1:]), FRAC, geo)
        assert torch.equal(keep[0], keep_p) and torch.equal(owner[0], owner_p)
    things = valid & is_thing
    assert things.sum() > 32
    assert not keep_p[9] and not keep_p[12] and keep_p[8]


def test_schedule_on_the_card_cases():
    """chip_smoke.py's claim_cases (without the batches past the shared-
    memory geometry) through the emulation: equal to the plain claim scan
    or claim, over the case's slot range."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    cases = chip_smoke.claim_cases(torch.device("cpu"), big=False)
    assert max(int((c[2][2] & c[2][3]).sum(-1).max()) for c in cases) > 32
    for label, kind, args, slots, _ in cases:
        if kind == "masks":
            m, *vecs = args
            theta = tv3.theta(m, vecs[2], 0.4)
            planes = (tv3.upsample_slots(m) >= theta)[None]
            vecs = [v[None] for v in vecs]
        else:
            planes, *vecs = args
        keep_p, owner_p = claim_scan(planes, *vecs, FRAC)
        b, k, h, w = planes.shape
        for geo in _geometries(b, h, w, k):
            keep, owner = emulate(planes, *vecs, FRAC, geo, *slots)
            assert torch.equal(keep, keep_p), (label, geo)
            assert torch.equal(owner, owner_p), (label, geo)
