"""Port parity of the DCN backward on the CPU: autograd through the plain
f32 DCN against ``jax.grad`` of the JAX package's XLA path (clamped and
invalid taps included); the plain ``deform_conv2d_backward`` against the
Pallas backward kernel (interpret mode) in f32 and in bf16 and against
autograd; and the autograd Function of the kernel wrapper on CPU tensors
against the plain backward.  The semantic tower's DCN block on the kernel
routes, forward and gradients, is held against the JAX package's in
tests/test_torch_deform_conv.py; the kernel itself against the plain
backward on the card in tests/test_torch_kernels_cuda.py.

Tolerances, relative to max|ref| of each gradient: 1e-5 in f32 (sums in
another order); 1e-2 in bf16 (the same rounding points: a sum taken in
another order moves a rounded dsample or sample by one bf16 ulp, 2**-8,
now and then)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from slotvps_tpu.ops.deform_conv import deform_conv2d as jax_dcn
from slotvps_tpu.ops.pallas.deform_conv import deform_conv2d_pallas
from slotvps_tpu_torch.ops.cuda.deform_conv import (dcn_backward_hopper,
                                                    deform_conv2d_hopper)
from slotvps_tpu_torch.ops.deform_conv import (deform_conv2d,
                                               deform_conv2d_backward)

F32_RTOL = 1e-5
BF16_RTOL = 1e-2


def _rel(ours, ref):
    ours = np.asarray(ours.detach().float() if isinstance(ours, torch.Tensor)
                      else ours, np.float32)
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def _case(rng, b, h, w, c, co, off_scale):
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    off = (off_scale * rng.standard_normal((b, h, w, 18))).astype(np.float32)
    wt = (rng.standard_normal((3, 3, c, co)) * 0.1).astype(np.float32)
    g = rng.standard_normal((b, h, w, co)).astype(np.float32)
    return x, off, wt, g


def _t(a, requires_grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(requires_grad)


def _jax_grads(fn, x, off, wt, g):
    _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(off), jnp.asarray(wt))
    return [np.asarray(a, np.float32) for a in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("halo,off_scale", [(2, 1.0), (3, 3.0)])
def test_plain_autograd_matches_jax_grad(rng, halo, off_scale):
    """f32 autograd through the plain DCN = jax.grad of the XLA path:
    offsets of about +-halo clamp some taps and take border taps out of
    the image (zero offset gradient on a clamped axis, on an invalid
    tap)."""
    x, off, wt, g = _case(rng, 2, 7, 12, 6, 5, off_scale)
    ref = _jax_grads(lambda a, o, w: jax_dcn(a, o, w, padding=1,
                                             max_displacement=halo),
                     x, off, wt, g)
    xt, ot, wtt = _t(x, True), _t(off, True), _t(wt, True)
    out = deform_conv2d(xt, ot, wtt, padding=1, max_displacement=halo)
    out.backward(_t(g))
    for ours, want in zip((xt.grad, ot.grad, wtt.grad), ref):
        assert _rel(ours, want) <= F32_RTOL
    # the regime: some taps clamp and some leave the image
    o = np.abs(off)
    assert (o > halo).mean() > 0.02
    assert (ot.grad.numpy() == 0).mean() > 0.02


@pytest.mark.parametrize("halo,off_scale", [(2, 1.0), (4, 4.0)])
def test_plain_backward_f32_matches_autograd(rng, halo, off_scale):
    x, off, wt, g = _case(rng, 1, 6, 9, 7, 4, off_scale)
    xt, ot, wtt = _t(x, True), _t(off, True), _t(wt, True)
    deform_conv2d(xt, ot, wtt, padding=1, max_displacement=halo).backward(
        _t(g))
    dx, doff, dw = deform_conv2d_backward(_t(x), _t(off), _t(wt), _t(g),
                                          halo)
    assert dx.dtype == doff.dtype == dw.dtype == torch.float32
    for ours, want in zip((dx, doff, dw), (xt.grad, ot.grad, wtt.grad)):
        assert _rel(ours, want.numpy()) <= F32_RTOL


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, F32_RTOL),
                                        (torch.bfloat16, BF16_RTOL)])
@pytest.mark.parametrize("shape,off_scale", [
    # batch of 2, clamped taps, taps leaving the image
    ((2, 2, 32, 32, 16, 4), 4.0),
])
def test_plain_backward_matches_pallas_backward(rng, dtype, rtol, shape,
                                                off_scale):
    """The Pallas backward (the custom VJP of deform_conv2d_pallas, interpret
    mode) at widths it takes without padding."""
    b, h, w, c, co, halo = shape
    x, off, wt, g = _case(rng, b, h, w, c, co, off_scale)
    cd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    with pltpu.force_tpu_interpret_mode():
        ref = _jax_grads(lambda a, o, k: deform_conv2d_pallas(
            a, o, k, halo=halo, compute_dtype=cd), x, off, wt, g)
    ours = deform_conv2d_backward(_t(x), _t(off), _t(wt), _t(g), halo,
                                  compute_dtype=dtype)
    for name, a, want in zip(("dx", "doff", "dW"), ours, ref):
        assert _rel(a, want) <= rtol, name
    if dtype == torch.bfloat16:
        # the rounding points matter: the f32 backward lies further from
        # the bf16 kernel
        f32 = deform_conv2d_backward(_t(x), _t(off), _t(wt), _t(g), halo)
        assert _rel(f32[2], ref[2]) > _rel(ours[2], ref[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_on_cpu_runs_the_plain_versions(rng, dtype):
    """The wrapper's autograd Function on CPU tensors: forward = plain DCN,
    backward = the plain backward, gradients back in the inputs' dtypes; no
    kernel launch is counted."""
    x, off, wt, g = _case(rng, 1, 5, 8, 4, 8, 2.0)
    before = (dict(deform_conv2d_hopper.launches),
              dict(dcn_backward_hopper.launches))
    xt, ot, wtt = _t(x, True), _t(off, True), _t(wt, True)
    out = deform_conv2d_hopper(xt, ot, wtt, 3, compute_dtype=dtype)
    assert out.dtype == torch.float32
    out.backward(_t(g))
    with torch.no_grad():
        want_out = deform_conv2d(_t(x), _t(off), _t(wt), padding=1,
                                 max_displacement=3, compute_dtype=dtype)
    want = deform_conv2d_backward(_t(x), _t(off), _t(wt), _t(g), 3, dtype)
    assert torch.equal(out, want_out)
    for ours, ref in zip((xt.grad, ot.grad, wtt.grad), want):
        assert ours.dtype == torch.float32 and torch.equal(ours, ref)
    # the direct wrapper of the backward, on CPU tensors
    for ours, ref in zip(dcn_backward_hopper(_t(x), _t(off), _t(wt), _t(g),
                                             3, dtype), want):
        assert torch.equal(ours, ref)
    assert (dict(deform_conv2d_hopper.launches),
            dict(dcn_backward_hopper.launches)) == before
