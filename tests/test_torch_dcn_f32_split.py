"""The arithmetic of the f32 DCN kernels' split-TF32 products, on the CPU.

``csrc/deform_conv.cu`` runs every f32 product of the DCN forward and
backward on the tensor cores as three TF32 products of split operands:
a = hi + lo with hi = tf32(a) and lo = tf32(a - hi), where tf32() is
``cvt.rna.tf32.f32`` (round to 10 mantissa bits, to nearest, ties away from
zero), and A.B = Ahi.Bhi + Ahi.Blo + Alo.Bhi with f32 sums.  A torch
emulation of that arithmetic is held here:

* the rounding keeps 10 mantissa bits (the low 13 bits of hi are 0) and
  rounds ties away from zero; hi + lo is a to 2**-21 of |a| wherever lo is
  a normal number, and to 2**-137 (half of lo's spacing there) below;
* the emulated three-pass forward product (the plain version's samples,
  then the split product) lies within chip_smoke's DCN_RTOL in f32 (1e-4
  of max|ref|) of a float64 product and of the JAX package's
  ``deform_conv2d_pallas(compute_dtype=float32)`` (Precision.HIGHEST) in
  interpret mode; one TF32 pass does not;
* the backward's two products, dsample = g . W_k^T and dW_k = samples_k^T
  . g, split the same way, lie within 1e-4 of max|ref| of float64
  products, and the dx, doff and dW they give within 1e-4 of the JAX
  package's custom VJP (the Pallas backward, interpret mode).

Inputs are made with numpy from a seed: 1 x 6 x 8 pixels, 16 -> 24
channels, halo 2, offsets that clamp some taps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from slotvps_tpu.ops.pallas.deform_conv import deform_conv2d_pallas
from slotvps_tpu_torch.ops.deform_conv import deform_conv2d

DCN_RTOL = 1e-4
B, H, W, CIN, COUT, HALO = 1, 6, 8, 16, 24, 2


def tf32(a: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on f32 bits: add half of the 13 dropped bits to the
    magnitude (the sign bit is apart, so this rounds ties away from zero)
    and clear them."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(a: torch.Tensor):
    hi = tf32(a)
    return hi, tf32(a - hi)


def split_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernels' product: Ahi.Bhi + Ahi.Blo + Alo.Bhi, each product
    exact in f32 (11-bit significands), the sums in f32."""
    ah, al = split(a.float())
    bh, bl = split(b.float())
    return ah @ bh + ah @ bl + al @ bh


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, H, W, CIN)).astype(np.float32)
    off = (1.2 * rng.standard_normal((B, H, W, 18))).astype(np.float32)
    wt = (rng.standard_normal((3, 3, CIN, COUT)) / 12).astype(np.float32)
    g = rng.standard_normal((B, H, W, COUT)).astype(np.float32)
    return x, off, wt, g


@pytest.fixture(scope="module")
def samples(case):
    """The plain version's f32 samples [B*H*W, 9*Cin] (tap-major), through
    identity weights: column k*Cin + c of the output is sample_k[c]."""
    x, off, _, _ = case
    return deform_conv2d(torch.from_numpy(x), torch.from_numpy(off),
                         _eye(), padding=1, max_displacement=HALO).reshape(
        B * H * W, 9 * CIN)


def _eye():
    eye = torch.zeros((3, 3, CIN, 9 * CIN))
    for k in range(9):
        eye[k // 3, k % 3, :, k * CIN:(k + 1) * CIN] = torch.eye(CIN)
    return eye


@pytest.fixture(scope="module")
def pallas_vjp(case):
    """The JAX package's f32 Pallas forward and its custom VJP (dx, doff,
    dW), interpret mode, on the same numpy inputs."""
    x, off, wt, g = case
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(
            lambda a, o, k: deform_conv2d_pallas(
                a, o, k, halo=HALO, compute_dtype=jnp.float32),
            jnp.asarray(x), jnp.asarray(off), jnp.asarray(wt))
        grads = vjp(jnp.asarray(g))
    return np.asarray(out), [np.asarray(a) for a in grads]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    one = 1.0 + 2.0 ** -11           # halfway between two TF32 values
    a = torch.tensor([one, -one, 1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -12,
                      0.0, -0.0, 1e30, -3e38, 1.5e-40, 2.0 ** -149],
                     dtype=torch.float32)
    hi = tf32(a)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    want = [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 1.0 + 2.0 ** -10]
    assert hi[:4].tolist() == pytest.approx(want, rel=0, abs=0)
    assert torch.equal(hi[4:6].view(torch.int32), a[4:6].view(torch.int32))
    rng = np.random.default_rng(3)
    r = torch.from_numpy((rng.standard_normal(100_000)
                          * np.exp2(rng.uniform(-60, 60, 100_000)))
                         .astype(np.float32))
    h = tf32(r)
    # hi is the nearest TF32 value: within half of its spacing, 2**-11 of
    # the magnitude's binade
    assert bool(((r - h).abs() <= r.abs() * 2.0 ** -11).all())


def test_split_parts_sum_back_to_a():
    rng = np.random.default_rng(4)
    normal = np.concatenate([
        rng.standard_normal(200_000) * np.exp2(rng.uniform(-100, 100,
                                                           200_000)),
        [1.0, -1.0, 1.0 + 2.0 ** -11, 3e38, -1e30, 2.0 ** -100, 1 / 3]])
    a = torch.from_numpy(normal.astype(np.float32))
    hi, lo = split(a)
    err = (a.double() - hi.double() - lo.double()).abs()
    assert bool((err <= a.double().abs() * 2.0 ** -21).all())
    assert bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
    # subnormals and zeros: lo's spacing is 2**-136 there
    tiny = torch.tensor([0.0, -0.0, 2.0 ** -149, -2.0 ** -140, 1.2e-38,
                         -3e-39, 2.0 ** -126], dtype=torch.float32)
    hi, lo = split(tiny)
    err = (tiny.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -137).all())
    assert float(err[:2].max()) == 0.0


def test_split_forward_product_matches_float64_and_pallas(case, samples,
                                                          pallas_vjp):
    _, _, wt, _ = case
    w = torch.from_numpy(wt).reshape(9 * CIN, COUT)
    ours = split_mm(samples, w)
    ref = samples.double() @ w.double()
    scale = float(ref.abs().max())
    assert float((ours.double() - ref).abs().max()) <= DCN_RTOL * scale
    jax_out = pallas_vjp[0].reshape(B * H * W, COUT)
    assert float(np.abs(ours.numpy() - jax_out).max()) <= DCN_RTOL * scale
    # one TF32 pass (operands rounded once) misses the f32 tolerance
    one = tf32(samples) @ tf32(w)
    assert float((one.double() - ref).abs().max()) > DCN_RTOL * scale


def test_split_backward_products_match_float64_and_pallas(case, samples,
                                                          pallas_vjp):
    x, off, wt, g = case
    gt = torch.from_numpy(g).reshape(B * H * W, COUT)
    w = torch.from_numpy(wt).reshape(9, CIN, COUT)
    # dsample_k = g . W_k^T and dW_k = samples_k^T . g, split-TF32
    ds = torch.cat([split_mm(gt, w[k].T) for k in range(9)], dim=1)
    ds_ref = torch.cat([gt.double() @ w[k].double().T for k in range(9)], 1)
    dw = torch.stack([split_mm(samples[:, k * CIN:(k + 1) * CIN].T, gt)
                      for k in range(9)])
    dw_ref = torch.stack([samples[:, k * CIN:(k + 1) * CIN].double().T
                          @ gt.double() for k in range(9)])
    for ours, ref in ((ds, ds_ref), (dw, dw_ref)):
        err = float((ours.double() - ref).abs().max())
        assert err <= DCN_RTOL * float(ref.abs().max())
    # dx and doff from that dsample: the transpose of the sampling, by
    # autograd of the plain f32 DCN with identity weights
    xt = torch.from_numpy(x).requires_grad_()
    ot = torch.from_numpy(off).requires_grad_()
    deform_conv2d(xt, ot, _eye(), padding=1, max_displacement=HALO).backward(
        ds.reshape(B, H, W, 9 * CIN))
    jax_dx, jax_doff, jax_dw = pallas_vjp[1]
    for name, ours, ref in (("dx", xt.grad, jax_dx),
                            ("doff", ot.grad, jax_doff),
                            ("dW", dw.reshape(3, 3, CIN, COUT), jax_dw)):
        err = float(np.abs(ours.detach().numpy() - ref).max())
        assert err <= DCN_RTOL * float(np.abs(ref).max()), name
    # the regime: some taps clamp (their offsets get no gradient on that
    # axis)
    assert float((ot.grad == 0).float().mean()) > 0.02
