"""Port parity: the plain PyTorch DCN (slotvps_tpu_torch/ops/deform_conv.py)
against the JAX package's XLA ``deform_conv2d`` at the tuned halos, the
unbounded numpy reference inside the halo, and the Pallas kernel in f32
(interpret mode); the Hopper kernel wrapper's dispatch rules; and the
semantic tower's DCN block on the kernel routes against the JAX package's
``_dcn_block``, forward and gradients.  The
kernel itself is held against the plain version on the card in
tests/test_torch_kernels_cuda.py.

Tolerance rtol = atol = 1e-4 (f32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from slotvps_tpu.ops.deform_conv import (deform_conv2d as jax_dcn,
                                         deform_conv2d_reference)
from slotvps_tpu_torch.ops.cuda.deform_conv import deform_conv2d_hopper
from slotvps_tpu_torch.ops.deform_conv import deform_conv2d

TOL = dict(rtol=1e-4, atol=1e-4)
# the DCN block against the JAX package's, relative to max|ref|: f32 sums
# in another order; in bf16 one bf16 ulp (2**-8) of a rounded value
F32_RTOL = 1e-5
BF16_RTOL = 1e-2


def _t(a, requires_grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(requires_grad)


def _rel(ours, ref):
    ours = ours.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


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


def test_wrapper_backward_route_on_cpu(rng):
    """The wrapper is differentiable: on CPU tensors its autograd Function
    runs the plain backward (tests/test_torch_dcn_backward.py holds it
    against the Pallas backward), and under no_grad it is the forward."""
    from slotvps_tpu_torch.ops.deform_conv import deform_conv2d_backward

    x, off, wt = _case(rng, 1, 4, 4, 4, 4)
    wt_t = torch.from_numpy(wt).requires_grad_()
    out = deform_conv2d_hopper(torch.from_numpy(x), torch.from_numpy(off),
                               wt_t, 2)
    assert out.requires_grad
    out.sum().backward()
    _, _, dw = deform_conv2d_backward(
        torch.from_numpy(x), torch.from_numpy(off), torch.from_numpy(wt),
        torch.ones_like(out), 2)
    assert torch.equal(wt_t.grad, dw)
    with torch.no_grad():
        again = deform_conv2d_hopper(torch.from_numpy(x),
                                     torch.from_numpy(off), wt_t, 2)
    assert not again.requires_grad and torch.equal(again, out.detach())


def _jax_block(rng, c_in, c_out):
    """JAX params of one tower block: small random offset conv (offsets
    well inside the halo) and its torch-layout copy."""
    from slotvps_tpu.models.semantic_head import _init_dcn_block

    p = _init_dcn_block(jax.random.PRNGKey(0), c_in, c_out)
    p = jax.tree.map(np.asarray, p)
    p["offset"]["w"] = (0.01 * rng.standard_normal(
        p["offset"]["w"].shape)).astype(np.float32)
    p["offset"]["b"] = rng.uniform(-1.0, 1.0, 18).astype(np.float32)
    p["gn"]["scale"] = rng.uniform(0.5, 1.5, c_out).astype(np.float32)
    p["gn"]["bias"] = (0.1 * rng.standard_normal(c_out)).astype(np.float32)
    return p


def _port_block(p, c_in, c_out):
    from slotvps_tpu_torch.models.semantic_head import DCNBlock

    blk = DCNBlock(torch.Generator().manual_seed(0), c_in, c_out)
    hwio = lambda a: torch.from_numpy(np.array(a).transpose(3, 2, 0, 1))
    blk.load_state_dict({
        "offset.weight": hwio(p["offset"]["w"]),
        "offset.bias": torch.from_numpy(p["offset"]["b"]),
        "conv.weight": hwio(p["conv"]["w"]),
        "gn.weight": torch.from_numpy(p["gn"]["scale"]),
        "gn.bias": torch.from_numpy(p["gn"]["bias"])})
    return blk


@pytest.mark.parametrize("impl", ["pallas", "pallas_f32"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_semantic_head_dcn_impl_strings(rng, impl, dtype):
    """DCNBlock on the kernel routes against the JAX package's _dcn_block
    (Pallas in interpret mode) in an f32 and a bf16 model: the offsets go
    to the kernel in f32 and the output comes back in the activations'
    dtype (an f32 model's "pallas" computes in bf16 and returns f32
    unrounded).  B=1, 4x32 (no padding), C=32, halo 3, offsets inside the
    halo.  Also the gradients of the f32 model's block (the JAX custom VJP
    against the port's autograd Function)."""
    from slotvps_tpu.models.semantic_head import _dcn_block

    c = 32
    p = _jax_block(rng, c, c)
    blk = _port_block(p, c, c)
    x = rng.standard_normal((1, 4, 32, c)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)

    def jfwd(params, xx):
        return _dcn_block(params, xx, 32, impl=impl, halo=3)

    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(jfwd, p, jnp.asarray(x, jdt))
    xt = _t(x).to(tdt)
    out = blk(xt, 32, impl=impl, halo=3)
    assert out.dtype == tdt and ref.dtype == jdt
    ref_scale = np.abs(np.asarray(ref, np.float32)).max()
    err = _rel(out, np.asarray(ref, np.float32))
    if dtype == "float32":
        assert err <= F32_RTOL, err
        # the repaired route: no bf16 rounding of the offsets or the output
        off = blk.offset(xt, padding=1)
        dcn = deform_conv2d(xt, off, blk.conv.weight.permute(2, 3, 1, 0),
                            max_displacement=3,
                            compute_dtype=(torch.bfloat16 if impl == "pallas"
                                           else torch.float32))
        from slotvps_tpu_torch.models import layers as L
        want = L.relu(L.group_norm(dcn, blk.gn.weight, blk.gn.bias, 32))
        assert torch.equal(out, want)
    else:
        assert err <= 2e-2, err
    assert ref_scale > 0.5
    with pytest.raises(ValueError, match="unknown dcn_impl"):
        blk(xt, 32, impl="cuda", halo=3)

    if dtype != "float32":
        return
    r = rng.standard_normal(out.shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jg = vjp(jnp.asarray(r))
    xg = _t(x, True)
    (blk(xg, 32, impl=impl, halo=3) * _t(r)).sum().backward()
    rtol = F32_RTOL if impl == "pallas_f32" else BF16_RTOL
    hwio = lambda a: np.asarray(a).transpose(3, 2, 0, 1)
    pairs = [(xg.grad, jg[1]),
             (blk.offset.weight.grad, hwio(jg[0]["offset"]["w"])),
             (blk.offset.bias.grad, jg[0]["offset"]["b"]),
             (blk.conv.weight.grad, hwio(jg[0]["conv"]["w"])),
             (blk.gn.weight.grad, jg[0]["gn"]["scale"]),
             (blk.gn.bias.grad, jg[0]["gn"]["bias"])]
    for ours, want in pairs:
        assert _rel(ours, want) <= rtol
