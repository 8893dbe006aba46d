"""Port parity: slotvps_tpu_torch layers and interpolation vs the JAX
package on the same numpy inputs (CPU).

Tolerance rtol = atol = 1e-4: both sides compute in f32 and differ only in
the order of their sums."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotvps_tpu.models import layers as JL
from slotvps_tpu.ops import interpolate as JI
from slotvps_tpu_torch.models import layers as TL
from slotvps_tpu_torch.ops import interpolate as TI

TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(ours, ref, **tol):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


@pytest.mark.parametrize("k,stride,pad,bias", [
    (1, 1, 0, True), (3, 1, 1, False), (3, 2, 1, False), (7, 2, 3, False)])
def test_conv2d(rng, k, stride, pad, bias):
    x = rng.standard_normal((2, 12, 16, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    jp = {"w": jnp.asarray(w)}
    if bias:
        jp["b"] = jnp.asarray(b)
    ref = JL.conv2d(jp, jnp.asarray(x), stride=stride, padding=pad)
    ours = TL.conv2d(_t(x), _t(w.transpose(3, 2, 0, 1)),
                     _t(b) if bias else None, stride=stride, padding=pad)
    _close(ours, ref)


def test_linear_and_activations(rng):
    x = rng.standard_normal((3, 7, 8)).astype(np.float32)
    w = rng.standard_normal((8, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    ref = JL.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                    jnp.asarray(x))
    _close(TL.linear(_t(x), _t(w.T), _t(b)), ref)
    _close(TL.gelu(_t(x)), JL.gelu(jnp.asarray(x)))
    _close(TL.relu(_t(x)), JL.relu(jnp.asarray(x)))


def test_layer_group_batch_norm(rng):
    x = rng.standard_normal((2, 6, 10, 64)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    p = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    _close(TL.layer_norm(_t(x), _t(scale), _t(bias)),
           JL.layer_norm(p, jnp.asarray(x)))
    _close(TL.group_norm(_t(x), _t(scale), _t(bias), num_groups=32),
           JL.group_norm(p, jnp.asarray(x), num_groups=32))
    mean = rng.standard_normal(64).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    bn = dict(p, mean=jnp.asarray(mean), var=jnp.asarray(var))
    _close(TL.batch_norm_eval(_t(x), _t(scale), _t(bias), _t(mean), _t(var)),
           JL.batch_norm_eval(bn, jnp.asarray(x)))
    # the module holders run the same functions
    fbn = TL.FrozenBatchNorm(64)
    fbn.load_state_dict({"weight": _t(scale), "bias": _t(bias),
                         "running_mean": _t(mean), "running_var": _t(var)})
    _close(fbn(_t(x)), JL.batch_norm_eval(bn, jnp.asarray(x)))


def test_multi_head_attention(rng):
    d, heads = 32, 8
    q = rng.standard_normal((2, 5, d)).astype(np.float32)
    kv = rng.standard_normal((2, 7, d)).astype(np.float32)
    p = JL.init_mha(jax.random.PRNGKey(0), d)
    p["in_proj"]["b"] = jnp.asarray(rng.standard_normal(3 * d), jnp.float32)
    p["out_proj"]["b"] = jnp.asarray(rng.standard_normal(d), jnp.float32)
    ref = JL.multi_head_attention(p, jnp.asarray(q), jnp.asarray(kv),
                                  jnp.asarray(kv), heads)
    m = TL.MultiheadAttention(torch.Generator().manual_seed(0), d)
    m.load_state_dict({
        "in_proj_weight": _t(np.asarray(p["in_proj"]["w"]).T),
        "in_proj_bias": _t(p["in_proj"]["b"]),
        "out_proj.weight": _t(np.asarray(p["out_proj"]["w"]).T),
        "out_proj.bias": _t(p["out_proj"]["b"])})
    with torch.no_grad():
        _close(m(_t(q), _t(kv), _t(kv), heads), ref)
    # ... and it is torch's own nn.MultiheadAttention
    tm = torch.nn.MultiheadAttention(d, heads, batch_first=True)
    tm.load_state_dict(m.state_dict())
    with torch.no_grad():
        _close(tm(_t(q), _t(kv), _t(kv), need_weights=False)[0], ref)


def test_init_helpers_follow_the_recipes():
    g = torch.Generator().manual_seed(0)
    conv = TL.init_conv(g, 3, 3, 64, 128, init="kaiming")
    w = conv.weight.detach()
    assert w.shape == (128, 64, 3, 3)
    assert abs(float(w.std()) - (2.0 / (9 * 64)) ** 0.5) < 3e-3
    assert float(conv.bias.detach().abs().max()) == 0.0
    lin = TL.init_linear(g, 64, 32).weight.detach()
    bound = (6.0 / (64 + 32)) ** 0.5
    assert lin.shape == (32, 64)
    assert bound * 0.9 < float(lin.abs().max()) <= bound
    # the generator, and nothing else, decides the values
    a = TL.init_conv(torch.Generator().manual_seed(5), 1, 1, 4, 4).weight
    b = TL.init_conv(torch.Generator().manual_seed(5), 1, 1, 4, 4).weight
    assert torch.equal(a, b)


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("size", [(9, 13), (20, 34), (5, 8)])
def test_interpolate_bilinear(rng, align, size):
    x = rng.standard_normal((2, 10, 17, 3)).astype(np.float32)
    ref = JI.interpolate_bilinear(jnp.asarray(x), size, align_corners=align)
    _close(TI.interpolate_bilinear(_t(x), size, align_corners=align), ref)
    # and torch's own F.interpolate, which both reproduce
    tf = torch.nn.functional.interpolate(
        _t(x).permute(0, 3, 1, 2), size=size, mode="bilinear",
        align_corners=align).permute(0, 2, 3, 1)
    _close(TI.interpolate_bilinear(_t(x), size, align_corners=align), tf)


@pytest.mark.parametrize("s", [2, 4, 8])
def test_integer_upsamples(rng, s):
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    _close(TI.upsample_int_bilinear(_t(x), s),
           JI.upsample_int_bilinear(jnp.asarray(x), s))
    _close(TI.upsample_x4_bilinear(_t(x)),
           JI.upsample_x4_bilinear(jnp.asarray(x)))
    np.testing.assert_array_equal(
        TI.upsample_x2_nearest(_t(x)).numpy(),
        np.asarray(JI.upsample_x2_nearest(jnp.asarray(x))))
