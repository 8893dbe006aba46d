"""Port parity of the f32 Pallas-Retriever path: the slot-attention kernel
route (``retriever_impl="pallas"``) in an f32 model.

The JAX package runs ``slot_attention_pallas`` in interpret mode; the
port's wrapper, given CPU tensors, runs its plain version
(``ops/slot_attention.py``), which is the f32 kernel's oracle on the card.

* The Retriever alone, L = 100 slots, P = 1200 pixels (not a multiple of
  the JAX kernel's 1024-pixel tile): within 1e-5 of max|ref| (f32 sums in
  another order; both lie ~2e-6 of max from a float64 evaluation, measured
  on the card).
* The whole slice at tiny depth (R18, 20 slots, 4 decoder stages, 64x128),
  f32 with the f32 DCN route and the Pallas Retriever, a calibrated 3-frame
  clip through both packages' ``InferencePipeline``: semantic map,
  panoptic map, kept thing classes and track ids equal; scores within 1e-4
  (as in tests/test_torch_slice.py).
* The wrapper's checks that run without a card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from slotvps_tpu import config as jconfig
from slotvps_tpu.config import Config
from slotvps_tpu.inference import InferencePipeline as JaxPipeline
from slotvps_tpu.ops.pallas.slot_attention import (
    retriever_attention_pallas as jax_retriever_pallas)
from slotvps_tpu.utils import calibration as jcal
from slotvps_tpu_torch import config as tconfig
from slotvps_tpu_torch.inference import InferencePipeline, run_video
from slotvps_tpu_torch.models import detector as tdet
from slotvps_tpu_torch.models import slot_head as tsh
from slotvps_tpu_torch.ops.cuda import slot_attention as csa
from slotvps_tpu_torch.ops.slot_attention import slot_attention
from tests.test_torch_models import doctored_params, port_model, tiny_model_cfg
from tests.test_torch_slice import _clip, _jax_probe_logits

RTOL = 1e-5


def _retriever_params(rng, d):
    """A Retriever's parameters in the JAX package's layout (numpy)."""
    def lin():
        return {"w": (rng.standard_normal((d, d)) / np.sqrt(d)).astype(
                    np.float32),
                "b": (0.1 * rng.standard_normal(d)).astype(np.float32)}

    def norm():
        return {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(
                    np.float32),
                "bias": (0.1 * rng.standard_normal(d)).astype(np.float32)}

    return {"to_q": lin(), "to_k": lin(), "to_v": lin(), "norm_q": norm(),
            "norm_k": norm(), "norm_v": norm(), "norm1": norm()}


def _port_retriever(params, d):
    ret = tsh.Retriever(torch.Generator().manual_seed(0), d)
    with torch.no_grad():
        for name, p in params.items():
            mod = getattr(ret, name)
            if "w" in p:
                mod.weight.copy_(torch.from_numpy(p["w"].T.copy()))
                mod.bias.copy_(torch.from_numpy(p["b"]))
            else:
                mod.weight.copy_(torch.from_numpy(p["scale"]))
                mod.bias.copy_(torch.from_numpy(p["bias"]))
    return ret


def test_f32_retriever_matches_jax_pallas():
    """``retriever_attention_pallas`` in f32 against the JAX package's, its
    kernel in interpret mode: L = 100, 24 x 50 = 1200 pixels."""
    d, n_slots, h, w = 256, 100, 24, 50
    rng = np.random.default_rng(0)
    params = _retriever_params(rng, d)
    slots = rng.standard_normal((1, n_slots, d)).astype(np.float32)
    feat = rng.standard_normal((1, h, w, d)).astype(np.float32)
    pos = rng.standard_normal((h, w, d)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_retriever_pallas(
            jax.tree.map(jnp.asarray, params), jnp.asarray(slots),
            jnp.asarray(feat), jnp.asarray(pos)))
    ret = _port_retriever(params, d)
    with torch.no_grad():
        ours = tsh.retriever_attention_pallas(
            ret, torch.from_numpy(slots), torch.from_numpy(feat),
            torch.from_numpy(pos))
    assert ours.dtype == torch.float32 and ours.shape == (1, n_slots, d)
    err = np.abs(ours.numpy() - ref).max()
    assert err <= RTOL * np.abs(ref).max(), err


def test_f32_activations_reach_the_kernel_uncast(monkeypatch):
    """In an f32 model the wrapper gets q, k and v in f32 (no bf16 cast)
    and its f32 output comes back without a cast."""
    seen = []

    def spy(q, k, v):
        seen.append((q.dtype, k.dtype, v.dtype))
        return csa.slot_attention_hopper(q, k, v)

    monkeypatch.setattr(tsh, "slot_attention_hopper", spy)
    rng = np.random.default_rng(1)
    ret = _port_retriever(_retriever_params(rng, 32), 32)
    with torch.no_grad():
        out = tsh.retriever_attention_pallas(
            ret, torch.randn(1, 5, 32), torch.randn(1, 3, 4, 32), None)
    assert seen == [(torch.float32,) * 3] and out.dtype == torch.float32


def test_wrapper_f32_on_cpu_is_the_plain_version():
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(s, generator=g)
               for s in ((2, 100, 256), (2, 777, 256), (2, 777, 256)))
    before = (csa.slot_attention_hopper.launches,
              csa.slot_attention_hopper.f32_launches)
    out = csa.slot_attention_hopper(q, k, v)
    assert torch.equal(out, slot_attention(q, k, v))
    # the plain version counts no launch
    assert before == (csa.slot_attention_hopper.launches,
                      csa.slot_attention_hopper.f32_launches)


@pytest.mark.parametrize("dtypes", [
    (torch.float32, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32, torch.float32),
    (torch.float32, torch.float32, torch.float16),
    (torch.float16, torch.float16, torch.float16)])
def test_wrapper_refuses_mixed_dtypes_off_the_cpu(dtypes):
    """Off the CPU (a meta tensor stands in for the card) q, k and v must be
    all bf16 or all f32: anything else raises before any launch."""
    q, k, v = (torch.empty(s, dtype=t, device="meta")
               for s, t in zip(((1, 100, 256), (1, 64, 256), (1, 64, 256)),
                               dtypes))
    with pytest.raises(TypeError, match="all bfloat16 or all float32"):
        csa.slot_attention_hopper(q, k, v)


def test_wrapper_f32_needs_the_card():
    q, k, v = (torch.empty(s, device="meta")
               for s in ((1, 100, 256), (1, 64, 256), (1, 64, 256)))
    with pytest.raises(ValueError, match="one CUDA device"):
        csa.slot_attention_hopper(q, k, v)


def test_f32_shared_memory_fits_a_block():
    """The f32 pass 1 holds its ring of q and k chunks, the v tile, p's two
    TF32 parts and the barriers at L's padded slot count (64, 104 or 128):
    within Hopper's 227 KB a block."""
    assert [csa.f32_slots(n) for n in (1, 64, 65, 100, 104, 105, 128)] == \
        [64, 64, 104, 104, 104, 128, 128]
    assert csa.f32_smem(64) == 198736
    assert csa.f32_smem(104) == 225344
    assert csa.f32_smem(128) == 215088
    assert max(csa.f32_smem(n) for n in (64, 104, 128)) <= 232448


@pytest.mark.parametrize("n_pix, n_sm, runs", [
    (131072, 132, 132), (2048, 132, 32), (1, 132, 1), (64, 132, 1),
    (65, 132, 2), (32768, 114, 114)])
def test_f32_grid_is_a_function_of_p_and_the_card(n_pix, n_sm, runs):
    """One block a run of 64-pixel tiles, at most one run an SM, one image
    per grid z: the runs, and so the partial sums and their order, do not
    depend on the batch."""
    for b in (1, 2, 5):
        assert csa.sa_f32_grid(b, n_pix, n_sm) == (runs, 1, b)


def _pallas_cfg(config, dcn_impl):
    cfg = tiny_model_cfg(dcn_impl, config)
    return dataclasses.replace(cfg, slot_head=dataclasses.replace(
        cfg.slot_head, retriever_impl="pallas"))


@pytest.fixture(scope="module")
def calibrated():
    """JAX init -> doctor -> class head calibrated on a probe frame outside
    the clip (~12 of 20 slots clear the 0.85 keep rule), with the plain
    Retriever; the clip then runs on the kernel route."""
    cfg = tiny_model_cfg()
    params = doctored_params(cfg)
    logits = _jax_probe_logits(params, cfg, _clip(99, 1)[0])
    params, _ = jcal.calibrate_class_head(
        params, logits, jax.random.PRNGKey(2), target_valid=12)
    return params


def test_f32_pallas_retriever_slice_matches_jax(calibrated):
    params = calibrated
    frames = _clip(0, 3)
    tcfg = tconfig.Config(model=_pallas_cfg(tconfig, "pallas_f32"))
    tdet.check_supported(tcfg.model)      # accepted in f32 now
    assert tcfg.model.compute_dtype == "float32"
    jp = JaxPipeline(params, Config(model=_pallas_cfg(jconfig, "jax")))
    with pltpu.force_tpu_interpret_mode():
        ref = [jp.process_frame(f, is_first=(t == 0))
               for t, f in enumerate(frames)]
    ours = run_video(InferencePipeline(port_model(params, tcfg.model), tcfg),
                     frames)
    assert sum(len(r.cls_inds) for r in ref) > 0
    for t, (a, b) in enumerate(zip(ref, ours)):
        np.testing.assert_array_equal(b.sseg, a.sseg, err_msg=f"frame {t}")
        np.testing.assert_array_equal(b.panoptic, a.panoptic,
                                      err_msg=f"frame {t}")
        assert b.cls_inds.tolist() == a.cls_inds.tolist(), t
        assert b.obj_ids.tolist() == a.obj_ids.tolist(), t
        np.testing.assert_allclose(b.cls_prob, a.cls_prob, rtol=0,
                                   atol=1e-4)
