"""Port parity in bf16: the plain versions of the three kernels of the
tuned stack against the JAX package's Pallas kernels (interpret mode), and
the port's bf16 modules against the JAX package at
``compute_dtype="bfloat16"``, on the same numpy inputs and the same
(converted) parameters, at a small size (R18, 20 slots, 64x128).  The
semantic head on the bf16 DCN route is held, inside extract_features, in
tests/test_torch_tuned.py, which shares the JAX side's interpret-mode
compile of the 12 DCN shapes with the slice test.

Tolerances, each with its reason:

* plain sseg vs ``sseg_v3``: equal (both rebuild the x4 upsample with the
  same roundings and take the first channel on ties);
* plain slot attention vs ``slot_attention_pallas``: rtol = atol = 2e-4
  (f32 sums in another order);
* plain bf16 DCN vs ``deform_conv2d_pallas(compute_dtype=bf16)``:
  <= 1e-2 * max|ref| (the same three bf16 rounding points; the f32 sums
  before each rounding are taken in another order, which moves a rounded
  value by one bf16 ulp, 2**-8 relative, now and then);
* bf16 modules: <= 2e-2 * max|ref| per output.  Torch eager rounds to bf16
  after every op; XLA on the CPU may keep a fused elementwise chain in f32
  and round once, so the two differ by an ulp here and there, which
  LayerNorm and the residual sums carry a few ulp further.  The decoder is
  held to it stage by stage, each stage fed the same inputs: over the whole
  decode the Retriever's softmax over slots of unscaled dot products of
  LayerNormed 256-d vectors (scores of order 100) turns those ulp into
  different winning slots, and the next stage's queries carry them on, so
  each package's bf16 decode lies ~0.1-0.3 * max|ref| from its own f32
  decode and from the other's.  The whole decode is held to 2e-2 with the
  Retriever's q and k LayerNorm scales quartered (scores of order 6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from slotvps_tpu import config as jconfig
from slotvps_tpu.models import detector as jdet
from slotvps_tpu.models import layers as JL
from slotvps_tpu.ops import interpolate as JI
from slotvps_tpu.ops.pallas import postproc_v3 as jv3
from slotvps_tpu_torch import config as tconfig
from slotvps_tpu_torch.models import detector as tdet
from slotvps_tpu_torch.models import layers as TL
from slotvps_tpu_torch.ops import interpolate as TI
from slotvps_tpu_torch.ops import postproc_v3 as tv3
from slotvps_tpu_torch.ops.deform_conv import deform_conv2d
from slotvps_tpu_torch.ops.slot_attention import slot_attention
from tests.test_torch_models import (doctored_params, port_model,
                                     tiny_model_cfg)

H, W = 64, 128
MODULE_RTOL = 2e-2
DCN_RTOL = 1e-2


def _np(a):
    """float32 numpy of a torch tensor or a JAX array of any dtype."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _bf(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _rel_err(ours, ref):
    ref = _np(ref)
    return float(np.abs(_np(ours) - ref).max() / np.abs(ref).max())


def _assert_module(ours, ref, rtol=MODULE_RTOL):
    assert _np(ours).shape == _np(ref).shape
    err = _rel_err(ours, ref)
    assert err <= rtol, f"max|d| {err:.3e} * max|ref| > {rtol}"


def _bf16_cfg(config, dcn_impl="pallas", retriever_impl="pallas",
              fused_sseg=True):
    cfg = tiny_model_cfg(dcn_impl, config)
    return dataclasses.replace(
        cfg, compute_dtype="bfloat16",
        semantic_head=dataclasses.replace(cfg.semantic_head,
                                          fused_sseg=fused_sseg),
        slot_head=dataclasses.replace(cfg.slot_head,
                                      retriever_impl=retriever_impl))


# ---- the plain versions of the three kernels vs the Pallas kernels ----

@pytest.mark.parametrize("shape,clamped", [
    # a width the Pallas wrapper takes as is; offsets of about +-halo:
    # clamped taps, taps leaving the image
    ((1, 8, 64, 32, 16, 4), True),
    # a width it pads (40 -> 64) and slices back; offsets inside the halo
    # (the padded kernel tests validity against the padded width, so a
    # tap beyond the right edge whose clamped position lands inside the
    # image is sampled there: ROADMAP Queue 3)
    ((1, 6, 40, 16, 8, 3), False),
])
def test_plain_bf16_dcn_matches_pallas_kernel(rng, shape, clamped):
    from slotvps_tpu.ops.pallas.deform_conv import deform_conv2d_pallas

    b, h, w, c, co, halo = shape
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    off = (halo * rng.standard_normal((b, h, w, 18))).astype(np.float32)
    if not clamped:
        off = np.clip(off, 0.9 - halo, halo - 0.9)
    wt = (rng.standard_normal((3, 3, c, co)) * 0.1).astype(np.float32)
    xb, offb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(off, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = deform_conv2d_pallas(xb, offb, jnp.asarray(wt), halo=halo)
    ours = deform_conv2d(_bf(x), _bf(off), torch.from_numpy(wt), padding=1,
                         max_displacement=halo,
                         compute_dtype=torch.bfloat16)
    assert ours.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    err = _rel_err(ours, ref)
    assert err <= DCN_RTOL, err
    # the rounding points matter: the f32 computation on the same bf16
    # inputs lies further from the kernel than the bf16 one
    f32 = deform_conv2d(_bf(x), _bf(off), torch.from_numpy(wt), padding=1,
                        max_displacement=halo)
    assert _rel_err(f32.float(), ref) > err


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_plain_slot_attention_matches_pallas_kernel(rng, dtype):
    """Ragged pixel tail: 1000 pixels in tiles of 256."""
    from slotvps_tpu.ops.pallas.slot_attention import slot_attention_pallas

    # inputs rounded to ``dtype``; the JAX wrapper casts its f32 output to
    # q's dtype, so it gets them as f32 arrays (the products of bf16 values
    # are exact in f32 either way) and the port as ``dtype`` tensors
    q, k, v = (_np(jnp.asarray(rng.standard_normal(shape), dtype))
               for shape in ((20, 64), (1000, 64), (1000, 64)))
    with pltpu.force_tpu_interpret_mode():
        ref = slot_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), tile=256)
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    ours = slot_attention(*(torch.from_numpy(a)[None].to(tdtype)
                            for a in (q, k, v)))[0]
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


def test_plain_sseg_matches_sseg_v3(rng):
    """h = 12 (not a multiple of 8), ties between channels: channel 7 is a
    copy of channel 3, and a block where every channel is equal."""
    h, w, c = 12, 20, 19
    x = rng.standard_normal((h, w, c)).astype(np.float32)
    x[..., 7] = x[..., 3]
    x[2:5, 4:9, :] = 0.5
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jv3.from_blocked(
            jv3.sseg_v3(jnp.asarray(x).transpose(2, 0, 1))))
    ours = tv3.sseg(torch.from_numpy(x))
    assert ours.shape == (4 * h, 4 * w) and ours.dtype == torch.int64
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert (ref == 0).any() and not (ref == 7).any()


# ---- bf16 layers and interpolation ----

def test_bf16_layers_match_jax(rng):
    x = rng.standard_normal((2, 6, 10, 64)).astype(np.float32) * 3 + 1
    w = rng.standard_normal((3, 3, 64, 32)).astype(np.float32) * 0.1
    b = rng.standard_normal(32).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    _assert_module(TL.conv2d(_bf(x), torch.from_numpy(w.transpose(3, 2, 0, 1)),
                             torch.from_numpy(b), padding=1),
                   JL.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)}, xj,
                             padding=1))
    lw = rng.standard_normal((64, 16)).astype(np.float32)
    _assert_module(TL.linear(_bf(x), torch.from_numpy(lw.T),
                             torch.from_numpy(b[:16])),
                   JL.linear({"w": jnp.asarray(lw), "b": jnp.asarray(b[:16])},
                             xj))
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    p = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    ts, tb = torch.from_numpy(scale), torch.from_numpy(bias)
    _assert_module(TL.layer_norm(_bf(x), ts, tb), JL.layer_norm(p, xj))
    _assert_module(TL.group_norm(_bf(x), ts, tb, num_groups=32),
                   JL.group_norm(p, xj, num_groups=32))
    mean = rng.standard_normal(64).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    _assert_module(
        TL.batch_norm_eval(_bf(x), ts, tb, torch.from_numpy(mean),
                           torch.from_numpy(var)),
        JL.batch_norm_eval(dict(p, mean=jnp.asarray(mean),
                                var=jnp.asarray(var)), xj))
    _assert_module(TL.gelu(_bf(x)), JL.gelu(xj))
    _assert_module(TL.relu(_bf(x)), JL.relu(xj))
    for t in (TL.layer_norm(_bf(x), ts, tb), TL.relu(_bf(x))):
        assert t.dtype == torch.bfloat16


def test_bf16_multi_head_attention_matches_jax(rng):
    d, heads = 32, 8
    q = rng.standard_normal((2, 5, d)).astype(np.float32)
    kv = rng.standard_normal((2, 7, d)).astype(np.float32)
    p = JL.init_mha(jax.random.PRNGKey(0), d)
    p["in_proj"]["b"] = jnp.asarray(rng.standard_normal(3 * d), jnp.float32)
    m = TL.MultiheadAttention(torch.Generator().manual_seed(0), d)
    m.load_state_dict({
        "in_proj_weight": torch.from_numpy(_np(p["in_proj"]["w"]).T),
        "in_proj_bias": torch.from_numpy(_np(p["in_proj"]["b"])),
        "out_proj.weight": torch.from_numpy(_np(p["out_proj"]["w"]).T),
        "out_proj.bias": torch.from_numpy(_np(p["out_proj"]["b"]))})
    qj, kvj = jnp.asarray(q, jnp.bfloat16), jnp.asarray(kv, jnp.bfloat16)
    with torch.no_grad():
        ours = m(_bf(q), _bf(kv), _bf(kv), heads)
    assert ours.dtype == torch.bfloat16
    _assert_module(ours, JL.multi_head_attention(p, qj, kvj, kvj, heads))


@pytest.mark.parametrize("s", [2, 4, 8])
def test_bf16_integer_upsample_matches_jax(rng, s):
    """The phase weights (2p+1-s)/(2s) are exact in bf16 for s = 2, 4, 8;
    what is left is where each framework rounds: torch rounds each product
    and the sum to bf16, XLA on the CPU may fuse the chain and round once.
    Measured: the two differ by at most one bf16 ulp of the value (2**-7
    relative, the ulp of the binade) on a few % of the elements."""
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    ours = _np(TI.upsample_int_bilinear(_bf(x), s))
    ref = _np(JI.upsample_int_bilinear(jnp.asarray(x, jnp.bfloat16), s))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert (np.abs(ours - ref) <= ulp).all()
    assert np.mean(ours != ref) < 0.1
    _assert_module(ours, ref)


# ---- bf16 backbone, FPN, semantic head, decoder ----

@pytest.fixture(scope="module")
def bf16_pair():
    cfg = _bf16_cfg(jconfig)
    params = doctored_params(cfg, fg_scale=0.1, fg_var=1.0)
    model = port_model(params, _bf16_cfg(tconfig))
    return cfg, params, model


def test_bf16_backbone_and_fpn_match_jax(bf16_pair):
    from slotvps_tpu.models.fpn import apply_fpn
    from slotvps_tpu.models.resnet import apply_resnet

    _, params, model = bf16_pair
    img = 0.25 * np.random.default_rng(0).standard_normal(
        (1, H, W, 3)).astype(np.float32)
    ref = jax.jit(lambda p, x: apply_fpn(
        p["fpn"], apply_resnet(p["backbone"], x, depth=18)))(
            params, jnp.asarray(img, jnp.bfloat16))
    with torch.no_grad():
        ours = model.fpn(model.backbone(_bf(img)))
    assert len(ours) == len(ref) == 5
    for a, b in zip(ours, ref):
        assert a.dtype == torch.bfloat16
        _assert_module(a, b)


def _decoder_inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, 4 * 2 ** i, 8 * 2 ** i, 128)).astype(
        np.float32) for i in range(4)]


def test_bf16_decoder_stages_match_jax(bf16_pair):
    """Each decoder stage with the Retriever on the slot-attention kernel
    route (JAX: ``retriever_attention_pallas`` in interpret mode; the port:
    its wrapper's plain version), fed the same bf16 features, slots and
    position embeddings: logits and next queries within 2e-2."""
    from slotvps_tpu.models import slot_head as JSH
    from slotvps_tpu.ops.pallas.slot_attention import (
        retriever_attention_pallas as jrap)
    from slotvps_tpu_torch.models import slot_head as TSH

    cfg, params, model = bf16_pair
    tcfg = _bf16_cfg(tconfig).slot_head
    rng = np.random.default_rng(2)
    for s in range(4):
        h, w = 4 * 2 ** s, 8 * 2 ** s
        feat = rng.standard_normal((1, h, w, 256)).astype(np.float32)
        slots = 3 * rng.standard_normal((1, 20, 256)).astype(np.float32)
        pos = rng.standard_normal((h, w, 256)).astype(np.float32)
        sp = params["slot_head"]["stages"][s]
        with pltpu.force_tpu_interpret_mode():
            jo = JSH._stage_till_ffn(sp, jnp.asarray(feat, jnp.bfloat16),
                                     jnp.asarray(slots, jnp.bfloat16),
                                     jnp.asarray(pos), cfg.slot_head, jrap)
            j_logits, j_embed = JSH._stage_after_ffn(sp, jo)
        tp = model.slot_head.stages[s]
        with torch.no_grad():
            to = TSH._stage_till_ffn(tp, _bf(feat), _bf(slots),
                                     torch.from_numpy(pos), tcfg,
                                     TSH.retriever_attention_pallas)
            t_logits, t_embed = TSH._stage_after_ffn(tp, to)
        assert t_embed.dtype == torch.bfloat16
        _assert_module(t_logits, j_logits)
        _assert_module(t_embed, j_embed)


def soften_retrievers(params, factor):
    """``params`` with every Retriever's q and k LayerNorm scales (stage and
    temporal ``inst_interact``) times ``factor``."""
    if isinstance(params, list):
        return [soften_retrievers(p, factor) for p in params]
    if not isinstance(params, dict):
        return params
    return {k: (dict(v, scale=v["scale"] * factor)
                if k in ("norm_q", "norm_k")
                else soften_retrievers(v, factor))
            for k, v in params.items()}


def test_bf16_decode_pair_matches_jax(bf16_pair):
    """The whole decode in bf16 (4 stages, kernel route, mask logits)
    within 2e-2, with the Retriever's q and k LayerNorm scales quartered.
    At their init value (the module docstring names the cause) each
    package's bf16 decode lies ~0.1-0.3 * max|ref| from its own f32 decode,
    and the port's from the JAX package's by as much; quartered, the
    scores are of order 6 and both lie within ~1.6e-2 of each other."""
    cfg, params, _ = bf16_pair
    params = soften_retrievers(params, 0.25)
    model = port_model(params, _bf16_cfg(tconfig))
    fcn = np.zeros((1, H // 4, W // 4, 19), np.float32)
    cur, ref = _decoder_inputs(3), _decoder_inputs(4)
    jax_feats = lambda xs: jdet.FrameFeatures(  # noqa: E731
        tuple(jnp.asarray(a, jnp.bfloat16) for a in xs), jnp.asarray(fcn))
    with pltpu.force_tpu_interpret_mode():
        jo = jax.jit(lambda p, r, c: jdet.decode_pair(p, cfg, r, c))(
            params, jax_feats(ref), jax_feats(cur))
    port_feats = lambda xs: tdet.FrameFeatures(  # noqa: E731
        tuple(_bf(a) for a in xs), torch.from_numpy(fcn))
    with torch.no_grad():
        to = tdet.decode_pair(model, _bf16_cfg(tconfig), port_feats(ref),
                              port_feats(cur))
    for name in ("pred_logits", "embeddings", "pred_masks"):
        ours = getattr(to, name)
        assert ours.dtype == torch.float32
        _assert_module(ours, getattr(jo, name))
