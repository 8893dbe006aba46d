"""The schedule of the hist kernel (``slotvps_tpu_torch/csrc/postproc_v3.cu``
``hist_kernel``) on the CPU, and the plain ``hist`` against the JAX
package's ``hist_v3``.

The kernel does not count ids one at a time as the plain version
(``ops/postproc_v3.py`` ``hist``) does: a thread owns 16 contiguous ids a
step (four 16-byte loads), ids outside [0, K) and the padding past n become
-1; a warp whose 32 threads each hold 16 copies of one id >= 0 adds 512 to
that id's count with one atomic; otherwise each thread adds the length of
each of its runs of equal ids >= 0; each block adds its counts to the
output.  The grid is at most one wave of blocks of 256 threads, looping
by the grid's width (``csrc/postproc_v3.cu`` ``hist_blocks``).
``_kernel_hist`` below is a torch model of that schedule (vectorised over
steps, blocks, warps and lanes) on a grid of a given number of blocks; it
must equal the plain version bit for bit on chip_smoke.py's edge cases
(``HIST_CASES``: one id everywhere, random ids, runs of 1-40 ids, ids
outside [0, K), K = 1 and 4096, n not a multiple of 4 or 16, 37 ids) and
on a real argmax map, on grids of 1, 3 and 6 blocks (several steps a
block, two steps, and one step: the grid the kernel launches for N ids on
a card that holds 6 blocks or more at once).  ``hold_hist_edges`` holds the kernel
itself to the same cases on the card.  Integer counts: every comparison
is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
import kernel_variants
from chip_smoke import HIST_CASES, hist_case
from slotvps_tpu.ops.pallas import postproc_v3 as jv3
from slotvps_tpu_torch.ops import postproc_v3 as plain

HIST_THREADS = 256   # the kernel's threads a block (csrc ``HT``)
HIST_IDS = 16        # its contiguous ids a thread a step (csrc ``HN``)
N = 5 * HIST_THREADS * HIST_IDS + 16   # ids of a case: 5 blocks and a bit
GRIDS = (1, 3, 6)


def _kernel_hist(ids, k, blocks):
    """The kernel's counts [k] int32 of the flat id map ``ids`` with a grid
    of ``blocks`` blocks."""
    n = ids.numel()
    width = blocks * HIST_THREADS * HIST_IDS       # ids a grid step
    steps = max(1, -(-n // width))
    pad = torch.full((steps * width,), -1, dtype=torch.int64)
    pad[:n] = ids.long()
    pad = torch.where((pad >= 0) & (pad < k), pad, -1)
    # [step, block, warp, lane, id of the thread]
    t = pad.reshape(steps, blocks, HIST_THREADS // 32, 32, HIST_IDS)
    same = (t == t[..., :1]).all(-1)
    v = torch.where(same, t[..., 0], -1)
    fast = (v == v[..., :1]).all(-1) & (v[..., 0] >= 0)   # [s, b, warp]
    counts = torch.zeros((blocks, k + 1), dtype=torch.int64)
    # one atomic of 32 * 16 for a warp on the fast path
    fb = fast.nonzero()
    counts.index_put_((fb[:, 1], v[fb[:, 0], fb[:, 1], fb[:, 2], 0]),
                      torch.full((len(fb),), 32 * HIST_IDS,
                                 dtype=torch.int64), accumulate=True)
    # one atomic a run of a thread otherwise
    slow = t[~fast]                                # [warps, 32, 16]
    block_of = (~fast).nonzero()[:, 1]
    start = torch.ones_like(slow, dtype=torch.bool)
    start[..., 1:] = slow[..., 1:] != slow[..., :-1]
    run = start.flatten().cumsum(0) - 1           # run index of each id
    run_id = slow.flatten()[start.flatten()]
    run_len = torch.bincount(run, minlength=len(run_id))
    run_block = block_of.repeat_interleave(32 * HIST_IDS)[start.flatten()]
    keep = run_id >= 0
    counts.index_put_((run_block[keep], run_id[keep]), run_len[keep],
                      accumulate=True)
    # each block's counts added to the output
    return counts[:, :k].sum(0).to(torch.int32)


def _argmax_map(seed=0):
    """The plain argmax map of chip_smoke.py's postprocess case at K = 24,
    24 x 40 low-res (a real id map: long runs, a few ids)."""
    cpu = torch.device("cpu")
    m, labels, valid, is_thing, _, _ = chip_smoke.postproc_case(
        cpu, 24, 24, 40, seed=seed, n_valid=12)
    th = plain.theta(m, valid, 0.4)
    keep, owner = plain.claim(m, th, labels, is_thing, valid, 0.03)
    kept = torch.where(is_thing, keep, valid)
    return plain.argmax(m, owner, kept, is_thing)[0], 24


@pytest.mark.parametrize("blocks", GRIDS)
@pytest.mark.parametrize("name", HIST_CASES)
def test_kernel_hist_schedule_equals_plain(name, blocks):
    ids, k = hist_case(name, N)
    assert torch.equal(_kernel_hist(ids, k, blocks), plain.hist(ids, k))


@pytest.mark.parametrize("blocks", GRIDS)
def test_kernel_hist_schedule_on_an_argmax_map(blocks):
    ids, k = _argmax_map()
    ids = ids.flatten()
    want = plain.hist(ids, k)
    assert int(want.sum()) == ids.numel() and (want > 0).sum() > 1
    assert torch.equal(_kernel_hist(ids, k, blocks), want)


def test_the_cases_take_both_paths():
    """The uniform case puts every warp on the one-atomic path, random ids
    none, runs some: the model's two paths are both exercised."""
    def fast_warps(ids):
        n = ids.numel() // (32 * HIST_IDS) * 32 * HIST_IDS
        t = ids[:n].reshape(-1, 32, HIST_IDS)
        return int(((t == t[:, :1, :1]).all(-1).all(-1)).sum()), len(t)

    uni = fast_warps(hist_case("uniform", N)[0])
    rnd = fast_warps(hist_case("random_ids", N)[0])
    runs = fast_warps(hist_case("runs", N)[0])
    assert uni[0] == uni[1] and rnd[0] == 0 and 0 <= runs[0] < runs[1]


def test_hist_edge_cases_hold_on_the_cpu():
    """chip_smoke.hold_hist_edges runs the plain version on CPU tensors
    (no launch counted) and checks it against itself: the phase's
    plumbing."""
    rows = chip_smoke.hold_hist_edges(torch.device("cpu"), N)
    assert [r["case"] for r in rows] == list(HIST_CASES)


def test_plain_hist_matches_jax_hist_v3():
    """plain.hist of an id map against the JAX package's hist_v3 on its
    phase-blocked form (Pallas interpret mode), K = 19 with ids in [0, 24):
    hist_v3 takes ids in [0, round8(K)) and counts those below K."""
    h, w, k = 8, 40, 19
    rng = np.random.default_rng(3)
    ids = np.repeat(rng.integers(0, 24, 16 * h * w // 5 + 1), 5)[
        :16 * h * w].reshape(4 * h, 4 * w).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.block_until_ready(
            jv3.hist_v3(jnp.asarray(jv3.to_blocked(ids)), k)))
    got = plain.hist(torch.from_numpy(ids), k)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        _kernel_hist(torch.from_numpy(ids).flatten(), k, 3).numpy(), want)


@pytest.mark.parametrize("kernel", sorted(kernel_variants.VARIANTS))
def test_kernel_variants_anchors_are_in_the_sources(kernel):
    """Every text that a kernel_variants.py variant replaces is in the
    source it edits (the script stops on a missing one, on the card)."""
    base = (kernel_variants.CSRC
            / f"{kernel_variants.SOURCE[kernel]}.cu").read_text()
    for name, reps in kernel_variants.VARIANTS[kernel].items():
        for rep in reps:
            where, old, _ = rep if len(rep) == 3 else (None, *rep)
            text = base if where is None else (
                kernel_variants.CSRC / where).read_text()
            assert old in text, (name, old[:60])
