"""Port parity: the plain PyTorch DCN (slotvps_tpu_torch/ops/deform_conv.py)
against the JAX package's XLA ``deform_conv2d`` at the tuned halos, the
unbounded numpy reference inside the halo, and the Pallas kernel in f32
(interpret mode); and the Hopper kernel wrapper's dispatch rules.  The
kernel itself is held against the plain version on the card in
tests/test_torch_kernels_cuda.py.

Tolerance rtol = atol = 1e-4 (f32 sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotvps_tpu.ops.deform_conv import (deform_conv2d as jax_dcn,
                                         deform_conv2d_reference)
from slotvps_tpu_torch.ops.cuda.deform_conv import deform_conv2d_hopper
from slotvps_tpu_torch.ops.deform_conv import deform_conv2d

TOL = dict(rtol=1e-4, atol=1e-4)


def _case(rng, b, h, w, c, co, off_scale=1.0, bias=0.0):
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    off = (bias + off_scale * rng.standard_normal((b, h, w, 18))
           ).astype(np.float32)
    wt = (rng.standard_normal((3, 3, c, co)) * 0.05).astype(np.float32)
    return x, off, wt


def _port(x, off, wt, halo):
    return deform_conv2d(torch.from_numpy(x), torch.from_numpy(off),
                         torch.from_numpy(wt), padding=1,
                         max_displacement=halo).numpy()


@pytest.mark.parametrize("halo", [2, 3, 4, 6])
def test_matches_jax_at_tuned_halos(rng, halo):
    # offsets of about +-halo: many taps clamp, border taps leave the image
    x, off, wt = _case(rng, 2, 9, 14, 8, 6, off_scale=halo)
    ref = np.asarray(jax_dcn(jnp.asarray(x), jnp.asarray(off),
                             jnp.asarray(wt), padding=1,
                             max_displacement=halo))
    np.testing.assert_allclose(_port(x, off, wt, halo), ref, **TOL)


@pytest.mark.parametrize("bias,inside", [(3.5, True), (4.5, False),
                                         (5.0, False)])
def test_halo_boundary_clamp_semantics(rng, bias, inside):
    """Offsets straddling the +-4 halo (as tests/test_pallas_deform_conv.py):
    validity at the unclamped position, sampling at the clamped one."""
    x, off, wt = _case(rng, 1, 32, 40, 8, 4, off_scale=0.1, bias=bias)
    ours = _port(x, off, wt, 4)
    ref = np.asarray(jax_dcn(jnp.asarray(x), jnp.asarray(off),
                             jnp.asarray(wt), padding=1, max_displacement=4))
    np.testing.assert_allclose(ours, ref, **TOL)
    unclamped = deform_conv2d_reference(x, off, wt)
    if inside:
        np.testing.assert_allclose(ours, unclamped, **TOL)
    else:
        clamped = deform_conv2d_reference(x, np.clip(off, -4, 4), wt)
        m = 7
        np.testing.assert_allclose(ours[:, m:-m, m:-m],
                                   clamped[:, m:-m, m:-m], **TOL)
        assert np.abs(unclamped - ours).max() > 1e-3
        np.testing.assert_allclose(_port(x, off, wt, 8), unclamped, **TOL)


def test_border_validity_uses_unclamped_position(rng):
    """A tap whose true position leaves the image contributes 0 even where
    the clamped position lies inside it (CUDA deformable_im2col rule)."""
    x, _, wt = _case(rng, 1, 6, 8, 4, 3)
    off = np.zeros((1, 6, 8, 18), np.float32)
    off[0, 0, :, 0::2] = -9.0    # every tap of row 0 points 9 rows up
    ours = _port(x, off, wt, 2)
    ref = np.asarray(jax_dcn(jnp.asarray(x), jnp.asarray(off),
                             jnp.asarray(wt), padding=1, max_displacement=2))
    np.testing.assert_allclose(ours, ref, **TOL)
    np.testing.assert_array_equal(ours[0, 0], 0.0)
    assert np.abs(ours[0, 1:]).max() > 0


def test_matches_numpy_reference_inside_halo(rng):
    x, off, wt = _case(rng, 1, 7, 9, 5, 4, off_scale=0.9)
    off = np.clip(off, -2.9, 2.9)
    np.testing.assert_allclose(_port(x, off, wt, 3),
                               deform_conv2d_reference(x, off, wt), **TOL)


def test_matches_pallas_f32_interpret(rng):
    """The Pallas kernel the Hopper kernel replaces, at one tiny shape."""
    from jax.experimental.pallas import tpu as pltpu

    from slotvps_tpu.ops.pallas.deform_conv import deform_conv2d_pallas

    x, off, wt = _case(rng, 1, 8, 64, 16, 8, off_scale=1.5)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(deform_conv2d_pallas(
            jnp.asarray(x), jnp.asarray(off), jnp.asarray(wt), halo=4,
            compute_dtype=jnp.float32))
    np.testing.assert_allclose(_port(x, off, wt, 4), ref, **TOL)


def test_zero_offsets_is_plain_conv(rng):
    x, _, wt = _case(rng, 1, 8, 12, 6, 5)
    off = np.zeros((1, 8, 12, 18), np.float32)
    conv = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(wt).permute(3, 2, 0, 1), padding=1)
    np.testing.assert_allclose(_port(x, off, wt, 2),
                               conv.permute(0, 2, 3, 1).numpy(), **TOL)


def test_wrapper_runs_plain_version_on_cpu(rng):
    x, off, wt = _case(rng, 1, 6, 10, 4, 8, off_scale=2.0)
    before = dict(deform_conv2d_hopper.launches)
    with torch.no_grad():
        out = deform_conv2d_hopper(torch.from_numpy(x), torch.from_numpy(off),
                                   torch.from_numpy(wt), 3)
        out16 = deform_conv2d_hopper(
            *(torch.from_numpy(a).to(torch.bfloat16) for a in (x, off, wt)),
            3)
    np.testing.assert_array_equal(out.numpy(), _port(x, off, wt, 3))
    # in bf16: the plain version at compute_dtype=bfloat16
    ref16 = deform_conv2d(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (x, off, wt)),
        padding=1, max_displacement=3, compute_dtype=torch.bfloat16)
    assert out16.dtype == torch.bfloat16 and torch.equal(out16, ref16)
    assert deform_conv2d_hopper.launches == before   # no kernel launched


def test_wrapper_is_forward_only(rng):
    x, off, wt = _case(rng, 1, 4, 4, 4, 4)
    wt_t = torch.from_numpy(wt).requires_grad_()
    with pytest.raises(NotImplementedError, match="forward-only"):
        deform_conv2d_hopper(torch.from_numpy(x), torch.from_numpy(off),
                             wt_t, 2)
    with torch.no_grad():
        deform_conv2d_hopper(torch.from_numpy(x), torch.from_numpy(off),
                             wt_t, 2)


def test_semantic_head_dcn_impl_strings(rng):
    """'jax' = plain, 'pallas_f32' = the kernel's wrapper in f32, 'pallas'
    = the wrapper in bf16 (the plain bf16 DCN on CPU tensors), with the
    offsets rounded to bf16 as a bf16 offset conv gives them."""
    from slotvps_tpu_torch.models.semantic_head import DCNBlock

    blk = DCNBlock(torch.Generator().manual_seed(0), 32, 32)
    with torch.no_grad():
        blk.offset.bias.uniform_(-1.5, 1.5)
    x = torch.from_numpy(rng.standard_normal((1, 6, 8, 32)).astype(
        np.float32))
    with torch.no_grad():
        a = blk(x, 32, impl="jax", halo=3)
        b = blk(x, 32, impl="pallas_f32", halo=3)
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        c = blk(x, 32, impl="pallas", halo=3)
        assert c.dtype == torch.float32
        off = blk.offset(x, padding=1).to(torch.bfloat16)
        dcn = deform_conv2d(x.to(torch.bfloat16), off,
                            blk.conv.weight.permute(2, 3, 1, 0),
                            max_displacement=3,
                            compute_dtype=torch.bfloat16).float()
        from slotvps_tpu_torch.models import layers as L
        want = L.relu(L.group_norm(dcn, blk.gn.weight, blk.gn.bias, 32))
        np.testing.assert_array_equal(c.numpy(), want.numpy())
        with pytest.raises(ValueError, match="unknown dcn_impl"):
            blk(x, 32, impl="cuda", halo=3)
