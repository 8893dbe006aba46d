"""The port's tuned-vs-exact check (``slotvps_tpu_torch/utils/parity.py``)
against the JAX package's ``slotvps_tpu/utils/parity.py``.

* ``_match_relabel``, ``_kept_list``, ``compare_results`` and
  ``smooth_img`` equal the JAX functions on the same numpy inputs (the
  PostprocResults of both packages built from the same arrays).
* ``pipeline_configs`` is the JAX function's pair of configurations, field
  for field, with the one rename the port needs: the plain DCN route is
  ``dcn_impl="jax"`` in the port ("xla" in the JAX package, whose DCN block
  takes any other name for its plain route; the port's raises on it).
* ``tuned_vs_exact(device="cpu")`` runs both regimes at a small size (the
  kernel wrappers run their plain versions on CPU tensors) and returns the
  JAX report's keys; the trained regime raises when a measured DCN offset
  passes its level's halo.

The calibrated regime runs at 128x256: its calibration probe is the first
frame at quarter size, and below 32x64 the R50's stride-32 level no longer
halves the stride-16 one, so the FPN's top-down sum fails (in both
packages).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotvps_tpu.config import named_config as jax_named_config
from slotvps_tpu.models.postprocess import PostprocResult as JaxResult
from slotvps_tpu.utils import parity as jparity
from slotvps_tpu_torch.config import named_config
from slotvps_tpu_torch.models.postprocess import PostprocResult
from slotvps_tpu_torch.utils import diagnostics
from slotvps_tpu_torch.utils import parity as tparity

# the JAX report's keys (slotvps_tpu/utils/parity.py :109-119, :272-301)
REPORT_KEYS = {"config", "resolution", "n_frames", "threshold", "halos",
               "regime", "train_steps", "calib", "per_frame", "aggregate"}
FRAME_KEYS = {"sseg_agreement", "pan_agreement", "pan_agreement_matched",
              "n_kept_exact", "n_kept_tuned", "n_things_exact",
              "n_things_tuned", "kept_unmatched", "max_score_drift", "frame"}
AGG_KEYS = {"pan_agreement_matched_min", "pan_agreement_matched_mean",
            "sseg_agreement_min", "kept_unmatched_total",
            "n_kept_exact_total", "max_score_drift", "max_n_kept_delta"}
HALOS = (2, 3, 4, 6)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one CPU thread (small tensors; the test
    runner's parallel workers would oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blocky_ids(rng, h, w, hi):
    coarse = rng.integers(0, hi + 1, (h // 4, w // 4))
    return np.kron(coarse, np.ones((4, 4), np.int64)).astype(np.int32)


@pytest.mark.parametrize("seed", range(3))
def test_match_relabel_matches_jax(seed):
    """Segment ids up to 300 (past the base-256 packing chip_smoke used),
    renumbered by a permutation with 5 % of the pixels changed."""
    rng = np.random.default_rng(seed)
    pan_a = _blocky_ids(rng, 32, 48, 300)
    pan_b = rng.permutation(301).astype(np.int32)[pan_a]
    noise = rng.random(pan_b.shape) < 0.05
    pan_b[noise] = rng.integers(0, 301, int(noise.sum()))
    ours = tparity._match_relabel(pan_a, pan_b)
    ref = jparity._match_relabel(pan_a, pan_b)
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)
    assert (ours == pan_a).mean() > 0.9


def _arrays(rng, k=12, h=16, w=24):
    """The numpy fields of one PostprocResult: 5 stuff slots, 7 things."""
    labels = np.concatenate([rng.integers(0, 11, 5),
                             rng.integers(11, 19, k - 5)]).astype(np.int32)
    kept = rng.random(k) < 0.7
    is_thing = labels > 10
    rank = np.where(kept & is_thing, np.cumsum(kept & is_thing) - 1, -1)
    ids = np.where(is_thing, 11 + rank, labels)
    # every slot owns two 4x4 tiles
    owner = rng.permutation(np.arange(h * w // 16) % k).reshape(h // 4, -1)
    owner = np.kron(owner, np.ones((4, 4), np.int64))
    pan = np.where(kept[owner], ids[owner], 255).astype(np.int32)
    return dict(
        kept=kept, is_thing=is_thing, labels=labels,
        scores=rng.uniform(0.8, 1.0, k).astype(np.float32),
        embeddings=rng.standard_normal((k, 4)).astype(np.float32),
        thing_rank=rank.astype(np.int32), panoptic=pan,
        sseg=labels[owner].astype(np.int32),
        n_kept=int(kept.sum()), n_things=int((kept & is_thing).sum()),
        n_loop=1)


def _both(a):
    """(the port's PostprocResult, the JAX package's) of the same arrays."""
    ints = ("n_kept", "n_things", "n_loop")
    port = PostprocResult(
        **{f: torch.from_numpy(np.asarray(v)) for f, v in a.items()
           if f not in ints},
        n_kept=a["n_kept"], n_things=a["n_things"], n_loop=a["n_loop"],
        capacity=len(a["kept"]), n_claim=0)
    ref = JaxResult(**{f: jnp.asarray(v) for f, v in a.items()})
    return port, ref


def _renumbered(a):
    """``a`` with two kept things' ranks swapped: the same segments."""
    b = dict(a, panoptic=a["panoptic"].copy())
    pan = b["panoptic"]
    i, j = pan == 11, pan == 12
    pan[i], pan[j] = 12, 11
    return b


def _flipped(a, rng):
    """``a`` with its first kept thing dropped and its scores moved."""
    kept = a["kept"].copy()
    first = int(np.flatnonzero(kept & a["is_thing"])[0])
    kept[first] = False
    return dict(a, kept=kept, n_kept=int(kept.sum()),
                scores=(a["scores"] + rng.uniform(-0.02, 0.02, len(kept))
                        ).astype(np.float32))


@pytest.mark.parametrize("case", ["random", "kept_set", "renumbered"])
def test_kept_list_and_compare_results_match_jax(case):
    rng = np.random.default_rng(7)
    a = _arrays(rng)
    b = {"random": lambda: _arrays(rng), "kept_set": lambda: _flipped(a, rng),
         "renumbered": lambda: _renumbered(a)}[case]()
    (ta, ja), (tb, jb) = _both(a), _both(b)
    assert tparity._kept_list(ta) == jparity._kept_list(ja)
    assert tparity._kept_list(tb) == jparity._kept_list(jb)
    ours = tparity.compare_results(ta, tb)
    assert ours == jparity.compare_results(ja, jb)
    assert set(ours) == FRAME_KEYS - {"frame"}
    if case == "renumbered":
        assert ours["pan_agreement"] < 1.0
        assert ours["pan_agreement_matched"] == 1.0
        assert ours["kept_unmatched"] == 0
    if case == "kept_set":
        assert ours["kept_unmatched"] == 1
        assert 0.0 < ours["max_score_drift"] <= 0.04


@pytest.mark.parametrize("seed", [0, 3])
def test_smooth_img_matches_jax(seed):
    ours = tparity.smooth_img(np.random.default_rng(seed), 64, 128)
    ref = jparity.smooth_img(np.random.default_rng(seed), 64, 128)
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("halos", [HALOS, (1, 2, 3, 4, 5)])
def test_pipeline_configs_match_jax(halos):
    """The two configurations of ``slotvps_tpu/utils/parity.py:170-180``,
    written out on the JAX package's base, field for field the port's."""
    base = jax_named_config("r50_fpn_slotvps").model
    exact = dataclasses.replace(
        base, compute_dtype="float32",
        semantic_head=dataclasses.replace(
            base.semantic_head, dcn_impl="xla", fused_sseg=False),
        postprocess=dataclasses.replace(base.postprocess, impl="jax"))
    tuned = dataclasses.replace(
        base, compute_dtype="bfloat16",
        semantic_head=dataclasses.replace(
            base.semantic_head, dcn_impl="pallas", fused_sseg=True,
            dcn_halo=halos[:base.semantic_head.num_levels]),
        postprocess=dataclasses.replace(base.postprocess, impl="fused"))
    want_exact = dataclasses.asdict(exact)
    want_exact["semantic_head"]["dcn_impl"] = "jax"
    ours = tparity.pipeline_configs(named_config("r50_fpn_slotvps").model,
                                    halos)
    assert dataclasses.asdict(ours[0]) == want_exact
    assert dataclasses.asdict(ours[1]) == dataclasses.asdict(tuned)


def _check_report(report, regime, h, w, n_frames, steps):
    assert set(report) == REPORT_KEYS
    assert set(report["aggregate"]) == AGG_KEYS
    assert [set(m) for m in report["per_frame"]] == [FRAME_KEYS] * n_frames
    assert report["resolution"] == [h, w]
    assert report["regime"] == regime
    assert report["n_frames"] == n_frames
    assert report["train_steps"] == steps
    assert report["threshold"] == 0.85
    assert report["halos"] == list(HALOS)
    frames = report["per_frame"]
    agg = report["aggregate"]
    assert [m["frame"] for m in frames] == list(range(n_frames))
    assert agg["n_kept_exact_total"] == sum(m["n_kept_exact"]
                                            for m in frames)
    assert agg["pan_agreement_matched_min"] == min(
        m["pan_agreement_matched"] for m in frames)
    for m in frames:
        for key in ("sseg_agreement", "pan_agreement",
                    "pan_agreement_matched"):
            assert 0.0 <= m[key] <= 1.0
        assert m["pan_agreement_matched"] >= m["pan_agreement"]


def test_tuned_vs_exact_calibrated_cpu():
    report = tparity.tuned_vs_exact(h=128, w=256, n_frames=2, device="cpu")
    _check_report(report, "calibrated", 128, 256, 2, 0)
    assert set(report["calib"]) == {"scale", "n_valid_probe", "logit_std"}
    # the bisection packs ~target_valid slots at the keep rule
    assert report["calib"]["n_valid_probe"] == 48
    assert report["aggregate"]["n_kept_exact_total"] > 0


def test_tuned_vs_exact_trained_cpu():
    report = tparity.tuned_vs_exact(
        h=64, w=128, n_frames=2, device="cpu", regime="trained",
        train_steps=2, n_things=2, train_dcn_impl="jax")
    _check_report(report, "trained", 64, 128, 2, 2)
    calib = report["calib"]
    assert calib["scale"] == 1.0 and calib["n_valid_probe"] == -1
    assert len(calib["max_abs_offset"]) == 4
    assert all(0.0 <= v <= h for v, h in zip(calib["max_abs_offset"],
                                             HALOS))
    # the overfit ran with the trained regime's options (2 steps: no probe)
    assert calib["overfit"] == dict(tparity.TRAINED_OVERFIT, probe=None)


def test_trained_offset_past_halo_raises(monkeypatch):
    """A trained offset head whose offsets pass a level's halo would clamp
    samples on the tuned route only: the check raises instead."""
    monkeypatch.setattr(
        diagnostics, "measure_max_dcn_offset",
        lambda *a, **k: np.asarray([7.0, 0.5, 0.5, 0.5], np.float32))
    with pytest.raises(AssertionError, match="7.00 px at level P2"):
        tparity.tuned_vs_exact(h=64, w=128, n_frames=1, device="cpu",
                               regime="trained", train_steps=1, n_things=2,
                               train_dcn_impl="jax")


def test_tuned_vs_exact_runs_on_the_card_unless_asked():
    """The entry point's device is the card by default; without CUDA it
    raises rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tparity.tuned_vs_exact(h=128, w=256, n_frames=1)
    from slotvps_tpu_torch.cli import tuned_vs_exact as cli

    with pytest.raises(SystemExit):
        cli.main("unused.json", "calibrated")
