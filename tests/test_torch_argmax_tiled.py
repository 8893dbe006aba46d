"""The schedule of the tiled argmax, repair and sseg kernels
(``slotvps_tpu_torch/csrc/postproc_v3.cu`` ``argmax_kernel``,
``sseg_kernel``) on the CPU, and their launch geometry.

The kernels do not visit the K slots of a pixel as the plain versions
(``ops/postproc_v3.py`` ``argmax``, ``repair``, ``sseg``) state them: argmax
visits the kept stuff slots only, listed in slot order, with a strict
``>`` from the first of them at -inf; then the few other candidates enter
by a total order (value, then lower index): the owner, where it is a kept
thing, with its upsampled value; the first kept thing that is not the
owner at 0.0; the first slot not kept at -1e30.  The runner-up keeps the
best two entries (the pass's two, the owner, the first two kept things
that are not the owner, the first two slots not kept) and takes the second
or the winner at -1e30, whichever comes first.  sseg visits every channel
from -inf.  ``_kernel_argmax`` / ``_kernel_sseg`` below are torch
models of that schedule (per pixel, vectorised over the map); they must
equal the plain versions bit for bit on chip_smoke.py's edge cases
(``ARGMAX_CASES``: no slot kept, only unowned things kept, every stuff
value negative, exact ties, things before stuff, owners that are stuff or
removed slots, values below -1e30, K = 1 and 127, row tiles of 1, 2, 4 and
8 rows, widths not a multiple of 32; ``SSEG_CASES``), which its
``phase_argmax_edges`` holds the kernels to on the card, and
on one case the JAX package's ``argmax_v3`` / ``repair_v3`` (Pallas
interpret mode).  ``tiled_geometry`` (``ops/cuda/postproc_v3.py``), which
the kernels' C entries mirror, puts each block in one row tile and covers
the map once.
"""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from chip_smoke import ARGMAX_CASES, SSEG_CASES, argmax_case, sseg_case
from slotvps_tpu.ops.pallas import postproc_v3 as jv3
from slotvps_tpu_torch.ops import postproc_v3 as plain
from slotvps_tpu_torch.ops.cuda.postproc_v3 import TILE_COLS, tiled_geometry

NEG = torch.tensor(-1e30, dtype=torch.float32)


def _before(v, i, bv, bi, k):
    """(v, i) ranks before (bv, bi): a higher value, or the same value at
    a lower index; bi == k is no entry yet."""
    return (bi == k) | (v > bv) | ((v == bv) & (i < bi))


def _kernel_argmax(m, owner, kept, is_thing, top2=False):
    """The kernel's schedule: (m_id, areas_tile) or, with ``top2``, (m_id,
    m2_id, areas_tile)."""
    k, h, _ = m.shape
    up = plain.upsample_slots(m)
    own = owner.long()
    stuff = [s for s in range(k) if kept[s] and not is_thing[s]]
    things = [s for s in range(k) if kept[s] and is_thing[s]] + [k] * 3
    out = [s for s in range(k) if not kept[s]] + [k] * 2
    shape = up.shape[1:]
    b1 = torch.full(shape, -float("inf"))
    b2 = torch.full(shape, -float("inf"))
    i1 = torch.full(shape, k if top2 or not stuff else stuff[0])
    i2 = torch.full(shape, k)
    # the pass over the kept stuff slots, in slot order
    for s in stuff:
        v = up[s]
        if top2:
            take1 = (i1 == k) | (v > b1)
            take2 = ~take1 & ((i2 == k) | (v > b2))
            b2 = torch.where(take1, b1, torch.where(take2, v, b2))
            i2 = torch.where(take1, i1, torch.where(take2, s, i2))
            b1 = torch.where(take1, v, b1)
            i1 = torch.where(take1, s, i1)
        else:
            take = v > b1
            b1 = torch.where(take, v, b1)
            i1 = torch.where(take, s, i1)

    def insert(cv, ci, where):
        nonlocal b1, i1, b2, i2
        cv = torch.as_tensor(cv, dtype=torch.float32).expand(shape)
        ci = torch.as_tensor(ci).expand(shape)
        first = where & _before(cv, ci, b1, i1, k)
        if top2:
            second = where & ~first & _before(cv, ci, b2, i2, k)
            b2 = torch.where(first, b1, torch.where(second, cv, b2))
            i2 = torch.where(first, i1, torch.where(second, ci, i2))
        b1 = torch.where(first, cv, b1)
        i1 = torch.where(first, ci, i1)

    # the owner, where it is a kept thing, with its upsampled value
    kept_thing = torch.cat([kept & is_thing, torch.zeros(1, dtype=bool)])
    slot = torch.where(own >= 0, own, k)
    up_o = up.gather(0, own.clamp(min=0)[None])[0]
    insert(up_o, own, kept_thing[slot])
    # the first (and second) kept thing that is not the owner, at 0.0
    f = torch.where(own == things[0], things[1], things[0])
    insert(0.0, f, f < k)
    if top2:
        g = torch.where((own == things[0]) | (own == things[1]), things[2],
                        things[1])
        insert(0.0, g, g < k)
    # the first (and second) slot not kept, at -1e30
    full = torch.ones(shape, dtype=torch.bool)
    insert(NEG, out[0], full & (out[0] < k))
    if top2:
        insert(NEG, out[1], full & (out[1] < k))
    m_id = i1
    areas = plain.tile_areas(m_id, k, plain.tile_rows(h))
    if not top2:
        return m_id.int(), areas
    m2_id = torch.where(_before(NEG, m_id, b2, i2, k), m_id, i2)
    return m_id.int(), m2_id.int(), areas


def _kernel_repair(m, owner, m1, kept, is_thing, dirty, areas_prev):
    """Dirty tiles take the kernel's argmax, clean ones copy m1 and their
    area row."""
    m_new, areas_new = _kernel_argmax(m, owner, kept, is_thing)
    rows = dirty.repeat_interleave(4 * plain.tile_rows(m.shape[1]))
    return (torch.where(rows[:, None], m_new, m1),
            torch.where(dirty[:, None], areas_new, areas_prev))


def _kernel_sseg(x):
    """Every channel in order from -inf, strict '>'."""
    up = plain.upsample_slots(x.permute(2, 0, 1))
    best = torch.full(up.shape[1:], -float("inf"))
    idx = torch.zeros(up.shape[1:], dtype=torch.long)
    for c in range(up.shape[0]):
        take = up[c] > best
        best = torch.where(take, up[c], best)
        idx = torch.where(take, c, idx)
    return idx


@pytest.mark.parametrize("name", list(ARGMAX_CASES))
def test_kernel_argmax_schedule_equals_plain(name):
    m, owner, kept, is_thing = argmax_case(name)
    m_id, areas = _kernel_argmax(m, owner, kept, is_thing)
    ref_id, ref_areas = plain.argmax(m, owner, kept, is_thing)
    assert torch.equal(m_id, ref_id) and torch.equal(areas, ref_areas)


@pytest.mark.parametrize("name", list(ARGMAX_CASES))
def test_kernel_top2_schedule_equals_plain(name):
    m, owner, kept, is_thing = argmax_case(name)
    got = _kernel_argmax(m, owner, kept, is_thing, top2=True)
    ref = plain.argmax(m, owner, kept, is_thing, top2=True)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", list(ARGMAX_CASES))
def test_kernel_repair_schedule_equals_plain(name):
    """Remove the kept slot that touches the fewest row tiles (as
    phase_argmax_edges does): dirty tiles recompute, clean ones copy."""
    m, owner, kept, is_thing = argmax_case(name)
    m1, areas = plain.argmax(m, owner, kept, is_thing)
    kept_n, dirty = chip_smoke._removal(areas, kept)
    got = _kernel_repair(m, owner, m1, kept_n, is_thing, dirty, areas)
    ref = plain.repair(m, owner, m1, kept_n, is_thing, dirty, areas)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    if kept_n.any():   # else every pixel names slot 0 (all at -1e30)
        removed = torch.nonzero(kept & ~kept_n).flatten()
        assert not torch.isin(got[0], removed).any()


@pytest.mark.parametrize("shape", SSEG_CASES)
def test_kernel_sseg_schedule_equals_plain(shape):
    """Ties (a copied channel, a block of equal logits), one channel, more
    channels than one staged chunk (20), -inf logits, a ragged map."""
    x = sseg_case(*shape)
    assert torch.equal(_kernel_sseg(x), plain.sseg(x))


def test_edge_cases_phase_runs_the_plain_versions_on_the_cpu():
    """chip_smoke.py's phase over the edge cases: on CPU tensors the
    wrappers run the plain versions (no launch), every case passes."""
    rows = chip_smoke.phase_argmax_edges(torch.device("cpu"))
    assert len(rows) == len(ARGMAX_CASES) + len(SSEG_CASES)


@pytest.fixture(scope="module")
def jax_oracle():
    """One case through the JAX package's argmax_v3 (per_tile) and
    repair_v3 in Pallas interpret mode."""
    m, owner, kept, is_thing = argmax_case("hb4", seed=1)
    owner_b = jv3.to_blocked(owner.numpy())
    with pltpu.force_tpu_interpret_mode():
        m_b, areas = jax.jit(jv3.argmax_v3, static_argnames="per_tile")(
            m.numpy(), owner_b, kept.numpy(), is_thing.numpy(),
            per_tile=True)
        m1 = np.array(jv3.from_blocked(m_b))
        areas = np.array(areas)[:, :m.shape[0]]
        n_tiles = (areas > 0).sum(0)
        cand = np.nonzero(kept.numpy() & (n_tiles > 0))[0]
        removed = np.zeros(m.shape[0], bool)
        removed[cand[np.argmin(n_tiles[cand])]] = True
        kept_n = kept.numpy() & ~removed
        dirty = ((areas > 0) & removed[None]).any(-1)
        r_b, r_areas = jax.jit(jv3.repair_v3)(
            m.numpy(), owner_b, m_b, kept_n, is_thing.numpy(), dirty,
            areas)
    return dict(case=(m, owner, kept, is_thing), m1=m1, areas=areas,
                kept_n=torch.from_numpy(kept_n),
                dirty=torch.from_numpy(dirty),
                repaired=np.asarray(jv3.from_blocked(r_b)),
                repaired_areas=np.asarray(r_areas)[:, :m.shape[0]])


def test_kernel_argmax_schedule_equals_jax(jax_oracle):
    m, owner, kept, is_thing = jax_oracle["case"]
    m_id, areas = _kernel_argmax(m, owner, kept, is_thing)
    np.testing.assert_array_equal(m_id.numpy(), jax_oracle["m1"])
    np.testing.assert_array_equal(areas.numpy(), jax_oracle["areas"])


def test_kernel_repair_schedule_equals_jax(jax_oracle):
    m, owner, _, is_thing = jax_oracle["case"]
    dirty = jax_oracle["dirty"]
    assert dirty.any() and not dirty.all()
    m1n, areas = _kernel_repair(
        m, owner, torch.from_numpy(jax_oracle["m1"]), jax_oracle["kept_n"],
        is_thing, dirty, torch.from_numpy(jax_oracle["areas"]))
    np.testing.assert_array_equal(m1n.numpy(), jax_oracle["repaired"])
    np.testing.assert_array_equal(areas.numpy(),
                                  jax_oracle["repaired_areas"])


@pytest.mark.parametrize("h,w", [(1, 1), (5, 33), (6, 64), (12, 20),
                                 (16, 31), (41, 70), (256, 512), (255, 7)])
@pytest.mark.parametrize("layout", ["slot_major", "whole_map"])
def test_tiled_geometry_puts_each_block_in_one_tile(h, w, layout):
    """Slot-major row tiles of gcd(8, h) rows, or the whole map as one tile
    (the K-minor entry and sseg): a block's rb <= 2 rows lie in one tile,
    rb is 2 wherever it divides the tile, and the grid covers each low-res
    row and column once."""
    hb = plain.tile_rows(h) if layout == "slot_major" else h
    rb, (gx, gy) = tiled_geometry(h, w, hb)
    assert rb in (1, 2) and hb % rb == 0
    assert rb == 2 or hb % 2 == 1
    assert gy * rb == h
    assert (gx - 1) * TILE_COLS < w <= gx * TILE_COLS
    starts = [by * rb for by in range(gy)]
    assert all(i0 // hb == (i0 + rb - 1) // hb for i0 in starts)
    assert [i0 + i for i0 in starts for i in range(rb)] == list(range(h))
