"""Stochastic depth of the port's Swin (``models/swin.py``) against the JAX
package's on the CPU.

* ``drop_path`` given the JAX ``_drop_path``'s keep mask (read back from
  ``x = ones``) equals its output within an ulp, in f32 and bf16.
* A Swin with Swin-L's depths (2, 2, 18, 2) and drop-path rate at narrow
  width (embed 16), B = 2 images of 64x64: ``apply_swin`` with a
  ``drop_path_key`` draws its masks (recorded by a wrapper of
  ``_drop_path``); the port's forward with a generator, each draw replaced
  by JAX's mask in order, makes the same draws at the same rates (two a
  block, every block of the scanned stage 2 at its rate, rate 0 included,
  the other stages only where the rate is > 0) and gives the same levels
  within 1e-5 * max|ref| (f32 sums in another order).
* ``generator=None`` and rate 0 are the identity; two forwards from equal
  seeds are equal, from other seeds not.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotvps_tpu import config as jconfig
from slotvps_tpu.models import swin as jswin
from slotvps_tpu_torch import config as tconfig
from slotvps_tpu_torch.models import swin as tswin
from tests.test_torch_swin import jax_params_of

NARROW = dict(embed_dim=16, depths=(2, 2, 18, 2), num_heads=(1, 1, 2, 2),
              window_size=7)
RTOL = 1e-5
ULP = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -8}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.25, 0.5])
def test_drop_path_matches_jax(monkeypatch, dtype, rate):
    x = np.random.default_rng(0).standard_normal((8, 3, 5, 4)).astype(
        np.float32)
    key = jax.random.PRNGKey(7)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    ref = jax.jit(jswin._drop_path, static_argnums=2)(key, jx, rate)
    mask = np.asarray(jax.jit(jswin._drop_path, static_argnums=2)(
        key, jnp.ones_like(jx), rate).astype(jnp.float32)) > 0
    assert 0 < mask.sum() < mask.size
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    monkeypatch.setattr(tswin, "drop_path_mask",
                        lambda x, r, g: torch.from_numpy(mask).to(x.dtype))
    ours = tswin.drop_path(tx, rate, torch.Generator())
    assert ours.dtype == tx.dtype
    # within an ulp: XLA may fold the division by keep into a product
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=ULP[dtype], atol=0)


def _narrow():
    tcfg = tconfig.SwinConfig(**NARROW)
    gen = torch.Generator().manual_seed(0)
    return tcfg, tswin.SwinTransformer(gen, tcfg).eval()


def test_swin_forward_with_drop_path_matches_jax(monkeypatch):
    jcfg = jconfig.SwinConfig(**NARROW)
    tcfg, backbone = _narrow()
    assert jcfg.drop_path_rate == tcfg.drop_path_rate == 0.5
    params = jax_params_of(backbone, lambda k: jswin.init_swin(k, jcfg))
    img = np.random.default_rng(1).standard_normal((2, 64, 64, 3)).astype(
        np.float32)

    drawn = []
    real = jswin._drop_path

    def recording(key, x, rate):
        mask = jax.random.bernoulli(key, 1.0 - rate,
                                    (x.shape[0],) + (1,) * (x.ndim - 1))
        jax.debug.callback(lambda r, m: drawn.append((float(r),
                                                      np.asarray(m))),
                           rate, mask, ordered=True)
        return real(key, x, rate)

    monkeypatch.setattr(jswin, "_drop_path", recording)
    ref = jax.jit(lambda p, x, k: jswin.apply_swin(p, x, jcfg, k))(
        params, jnp.asarray(img), jax.random.PRNGKey(3))
    ref = [np.asarray(r) for r in ref]

    rates = tswin.drop_path_rates(tcfg)
    # JAX's draws: block i's two at rate i / 23 * 0.5, stage 2 (blocks
    # 4..21, scanned) at every rate, the others only where it is > 0
    want_rates = [r for i, r in enumerate(rates)
                  for _ in range(2) if r > 0 or 4 <= i < 22]
    assert [r for r, _ in drawn] == pytest.approx(want_rates, rel=1e-6)
    assert any(not m.all() for _, m in drawn)

    used = []

    def jax_mask(x, rate, generator):
        r, m = drawn[len(used)]
        used.append(rate)
        return torch.from_numpy(m.astype(np.float32)).to(x.dtype)

    monkeypatch.setattr(tswin, "drop_path_mask", jax_mask)
    with torch.no_grad():
        ours = backbone(torch.from_numpy(img), torch.Generator())
    assert used == pytest.approx([r for r, _ in drawn], rel=1e-6)
    for a, b in zip(ours, ref):
        err = np.abs(a.numpy() - b).max()
        assert err <= RTOL * np.abs(b).max(), (a.shape, err)


def test_drop_path_identity_and_seeds():
    tcfg, backbone = _narrow()
    img = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 32, 32, 3)).astype(np.float32))
    x = img[..., :1].repeat(1, 1, 1, 8)
    assert torch.equal(tswin.drop_path(x, 0.0, torch.Generator()), x)
    # the same weights at drop-path rate 0: every block of stage 2 draws,
    # the others do not, and the output is the inference forward's
    zero = tswin.SwinTransformer(torch.Generator().manual_seed(0),
                                 dataclasses.replace(tcfg,
                                                     drop_path_rate=0.0))
    with torch.no_grad():
        plain = backbone(img)
        assert all(torch.equal(a, b) for a, b in zip(
            plain, zero(img, torch.Generator())))
        runs = [backbone(img, torch.Generator().manual_seed(s))
                for s in (5, 5, 6)]
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert any(not torch.equal(a, b) for a, b in zip(runs[0], runs[2]))
    assert any(not torch.equal(a, b) for a, b in zip(plain, runs[0]))
