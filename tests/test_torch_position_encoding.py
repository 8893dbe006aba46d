"""The position-encoding variants of the port against the JAX package's,
on the CPU: ``sine_position_embedding_v2`` and the relative-position
modules ``FullRelPos``, ``SwinRelPos``, ``RelPos`` and ``DPSConvPos``.

Each module takes the JAX init's parameters through
``utils/convert.from_jax_module`` and the same seeded numpy inputs (q
[B, h*w, P, G, 2c], attn [B, G, h*w, kh*kw, P], v [B, h*w, C]); outputs
agree within RTOL of their largest magnitude.  The port's own init
(a ``torch.Generator``) has the JAX init's shapes; the truncated normals
lie in [-2 std, 2 std] with std 0.02, the depthwise weight in the
kaiming-uniform bound sqrt(3 / k^2), each spread over its range.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotvps_tpu.models import position_encoding as jpe
from slotvps_tpu_torch.models import position_encoding as tpe
from slotvps_tpu_torch.utils.convert import from_jax_module

RTOL = 1e-6
STD = 0.02


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(ours, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours.detach().numpy(), ref, rtol=0,
                               atol=RTOL * np.abs(ref).max())


def _loaded(module, params):
    module.load_state_dict(from_jax_module(
        jax.tree.map(np.asarray, params), module), strict=True)
    return module


def _qa(rng, b, hw, p, g, c2, kk):
    q = rng.standard_normal((b, hw, p, g, c2)).astype(np.float32)
    attn = rng.standard_normal((b, g, hw, kk, p)).astype(np.float32)
    return q, attn


@pytest.mark.parametrize("h,w,normalize", [(5, 7, False), (4, 6, True)])
def test_sine_v2_matches_jax(h, w, normalize):
    ours = tpe.sine_position_embedding_v2(h, w, 16, normalize=normalize)
    ref = jpe.sine_position_embedding_v2(h, w, 16, normalize=normalize)
    assert ours.shape == (h * w, 32)
    _close(ours, ref)


def test_full_rel_pos_matches_jax(rng):
    h, w, dim = 3, 4, 8
    params = jpe.init_full_rel_pos(jax.random.PRNGKey(1), h, w, dim)
    mod = _loaded(tpe.FullRelPos(torch.Generator().manual_seed(0), h, w,
                                 dim), params)
    q, attn = _qa(rng, 2, h * w, 3, 2, dim, h * w)
    ours = mod(torch.from_numpy(q), torch.from_numpy(attn))
    _close(ours, jpe.full_rel_pos_attn(params, jnp.asarray(q),
                                       jnp.asarray(attn), h, w))


def test_swin_rel_pos_matches_jax():
    h, w, heads = 3, 5, 2
    params = jpe.init_swin_rel_pos(jax.random.PRNGKey(2), h, w, heads)
    mod = _loaded(tpe.SwinRelPos(torch.Generator().manual_seed(0), h, w,
                                 heads), params)
    ours = mod()
    assert ours.shape == (1, heads, h * w, h * w, 1)
    _close(ours, jpe.swin_rel_pos_bias(params, h, w))


@pytest.mark.parametrize("win_len", [1, 2])
def test_rel_pos_matches_jax(rng, win_len):
    q_len, k_len, dim = 3, 4, 8
    params = jpe.init_rel_pos(jax.random.PRNGKey(3), dim, win_len)
    mod = _loaded(tpe.RelPos(torch.Generator().manual_seed(0), dim,
                             win_len), params)
    q, attn = _qa(rng, 2, q_len * q_len, 2, 2, dim, k_len * k_len)
    ours = mod(torch.from_numpy(q), torch.from_numpy(attn), q_len, k_len)
    _close(ours, jpe.rel_pos_attn(params, jnp.asarray(q), jnp.asarray(attn),
                                  q_len, k_len, win_len))


@pytest.mark.parametrize("k", [3, 4])
def test_dps_conv_pos_matches_jax(rng, k):
    h, w, dim = 5, 6, 8
    params = jpe.init_dps_conv_pos(jax.random.PRNGKey(4), dim, k)
    mod = _loaded(tpe.DPSConvPos(torch.Generator().manual_seed(0), dim, k),
                  params)
    np.testing.assert_array_equal(
        mod.weight.detach().numpy(),
        np.asarray(params["w"]).transpose(3, 2, 0, 1))
    v = rng.standard_normal((2, h * w, dim)).astype(np.float32)
    _close(mod(torch.from_numpy(v), h),
           jpe.dps_conv_pos(params, jnp.asarray(v), h))


def test_init_shapes_and_bounds():
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    pairs = [
        (tpe.FullRelPos(gen, 6, 9, 64), jpe.init_full_rel_pos(key, 6, 9, 64)),
        (tpe.SwinRelPos(gen, 6, 9, 4), jpe.init_swin_rel_pos(key, 6, 9, 4)),
        (tpe.RelPos(gen, 64, 3), jpe.init_rel_pos(key, 64, 3)),
        (tpe.DPSConvPos(gen, 64, 5), jpe.init_dps_conv_pos(key, 64, 5))]
    for mod, params in pairs:
        from_jax_module(jax.tree.map(np.asarray, params), mod)  # shapes
        for name, t in mod.state_dict().items():
            x = t.numpy()
            if name == "weight":
                bound = np.sqrt(3.0 / 25)
                assert np.abs(x).max() <= bound
                assert np.abs(x).max() > 0.9 * bound
                assert abs(x.mean()) < 0.1 * bound
            else:
                assert np.abs(x).max() <= 2 * STD
                assert np.abs(x).max() > 1.8 * STD
                # the normal on [-2, 2] has std 0.880 of its parent's
                assert 0.8 * STD < x.std() < 0.95 * STD
