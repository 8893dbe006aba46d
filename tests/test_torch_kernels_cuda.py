"""The Hopper kernels against their plain PyTorch versions, on the card:
the DCN kernel in f32 and bf16 (forward, the bf16 forward's f32 output,
the backward and its autograd Function; the forward at the largest level
and its batch invariance, in both dtypes; the backward's wgmma passes at
B = 2 with ragged channels and widths, and its dW for a one-hot g: bit for
bit the rounded samples in bf16, the samples to the split-TF32 product's
precision in f32), the five fused-postprocess
kernels (theta, claim, argmax with and without its runner-up map, repair,
hist, sseg), their K-minor entries (theta, claim and argmax-areas on
[h, w, K] masks), the claim-scan kernel (and both claim loops on
chip_smoke.py's edge cases) and the slot-attention kernel in bf16 and in
f32 (and its batch invariance); and BatchedVideoPipeline against streaming
on the bf16 kernel path.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the tests' conftest helpers, so it also runs on a
machine without JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: DCN max |kernel - plain| <= 1e-4 * max |plain| in f32 (sums
taken in another order, each f32 product as three TF32 products: ~2**-21
of a product) and <= 1e-2 * max |plain| in bf16 (the same three
bf16 rounding points; a sum in another order moves a rounded value by one
bf16 ulp now and then), for each of the backward's dx, doff and dW too
(each summed in a fixed order: equal from run to run); slot attention
<= 1e-4 * max |plain| in bf16 and <= 1e-5 in f32 (f32 sums in another
order); theta within 1e-5 * max(1, |theta|) (the sum of exp in another
order); the integer outputs of
claim, argmax (top2 too), repair, hist, sseg, the K-minor entries and the
claim scan are bit-identical, given identical inputs; the batched
pipeline's results equal streaming's bit for bit."""

import sys
from pathlib import Path

import pytest
import torch

from slotvps_tpu_torch.ops import postproc_fused as plain_fused
from slotvps_tpu_torch.ops import postproc_v3 as plain
from slotvps_tpu_torch.ops.claim_scan import claim_scan
from slotvps_tpu_torch.ops.cuda.claim_scan import claim_scan_hopper
from slotvps_tpu_torch.ops.cuda import postproc_fused as hfused
from slotvps_tpu_torch.ops.cuda import postproc_v3 as hv3
from slotvps_tpu_torch.ops.cuda.deform_conv import (dcn_backward_hopper,
                                                    deform_conv2d_hopper)
from slotvps_tpu_torch.ops.cuda.slot_attention import slot_attention_hopper
from slotvps_tpu_torch.ops.deform_conv import (deform_conv2d,
                                               deform_conv2d_backward)
from slotvps_tpu_torch.ops.slot_attention import slot_attention
from slotvps_tpu_torch.utils.precision import setup_precision

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the repository root's script)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    setup_precision()
    return torch.device("cuda")


def _case(dev, b, h, w, c, co, halo):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((b, h, w, c), generator=g, device=dev)
    off = torch.randn((b, h, w, 18), generator=g, device=dev) * halo
    wt = torch.randn((3, 3, c, co), generator=g, device=dev) * 0.05
    return x, off, wt


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 32, 64, 256, 256, 6),    # P5 of a 1024x2048 frame
    (2, 13, 70, 128, 128, 2),    # ragged pixel strip, batch of 2
    (1, 9, 40, 20, 20, 3),       # Cin not a multiple of the chunk
    (1, 5, 7, 8, 4, 0),          # halo 0: integer-only sampling
])
def test_kernel_matches_plain(cuda_device, shape):
    b, h, w, c, co, halo = shape
    x, off, wt = _case(cuda_device, b, h, w, c, co, halo or 1)
    before = deform_conv2d_hopper.launches["float32"]
    with torch.no_grad():
        out = deform_conv2d_hopper(x, off, wt, halo)
        ref = deform_conv2d(x, off, wt, padding=1, max_displacement=halo)
    torch.cuda.synchronize()
    assert deform_conv2d_hopper.launches["float32"] == before + 1
    err = float((out - ref).abs().max())
    assert err <= 1e-4 * float(ref.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 32, 64, 256, 256, 6),    # P5 of a 1024x2048 frame
    (1, 64, 128, 256, 128, 4),   # P4, 256 -> 128
    (2, 13, 70, 128, 128, 2),    # ragged pixel strip, batch of 2
    (1, 9, 40, 20, 20, 3),       # Cin, Cout not multiples of the tiles
    (1, 5, 7, 8, 6, 0),          # halo 0: integer-only sampling
])
def test_bf16_kernel_matches_plain(cuda_device, shape):
    b, h, w, c, co, halo = shape
    x, off, wt = (t.to(torch.bfloat16) for t in
                  _case(cuda_device, b, h, w, c, co, halo or 1))
    before = dict(deform_conv2d_hopper.launches)
    with torch.no_grad():
        out = deform_conv2d_hopper(x, off, wt, halo)
        ref = deform_conv2d(x, off, wt, padding=1, max_displacement=halo,
                            compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    assert deform_conv2d_hopper.launches == dict(
        before, bfloat16=before["bfloat16"] + 1)
    err = float((out.float() - ref.float()).abs().max())
    assert err <= 1e-2 * float(ref.float().abs().max()), err


@pytest.mark.cuda
def test_bf16_kernel_at_the_largest_level(cuda_device):
    """P2 of a 1024x2048 frame, 256 -> 256, the whole 256x512 level at
    B = 1: the 64-pixel tile with all 256 output channels per block."""
    x, off, wt = (t.to(torch.bfloat16) for t in
                  _case(cuda_device, 1, 256, 512, 256, 256, 2))
    with torch.no_grad():
        out = deform_conv2d_hopper(x, off, wt, 2)
        ref = deform_conv2d(x, off, wt, padding=1, max_displacement=2,
                            compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    assert err <= 1e-2 * float(ref.float().abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("io_dtype", [torch.bfloat16, torch.float32])
def test_bf16_kernel_is_batch_invariant(cuda_device, io_dtype):
    """At a ragged shape (13x70 pixels, Cin and Cout 20), in both output
    types: each image of a batch of 2 gets the bits it gets alone, and two
    runs are equal."""
    x, off, wt = (t.to(io_dtype) for t in
                  _case(cuda_device, 2, 13, 70, 20, 20, 3))

    def kern(xs, offs):
        return deform_conv2d_hopper(xs, offs, wt, 3,
                                    compute_dtype=torch.bfloat16)

    with torch.no_grad():
        both, again = kern(x, off), kern(x, off)
        alone = [kern(x[i:i + 1].contiguous(), off[i:i + 1].contiguous())
                 for i in range(2)]
    torch.cuda.synchronize()
    assert both.dtype == io_dtype
    assert torch.equal(both, again)
    for i in range(2):
        assert torch.equal(both[i:i + 1], alone[i])


@pytest.mark.cuda
def test_bf16_kernel_is_the_same_under_another_tile(cuda_device,
                                                    monkeypatch):
    """The sum order of an output does not depend on the block that
    computes it: a 64x128 image, 256 -> 256, at its own tile (4x8 pixels,
    all 256 channels a block) and at 2x8 pixels with 64 channels a block
    gives the same bits."""
    from slotvps_tpu_torch.ops.cuda import deform_conv as hdc

    x, off, wt = (t.to(torch.bfloat16) for t in
                  _case(cuda_device, 1, 64, 128, 256, 256, 4))
    with torch.no_grad():
        own = deform_conv2d_hopper(x, off, wt, 4)
        monkeypatch.setattr(
            hdc, "bf16_forward_geometry",
            lambda h, w, c_out, n_sm: hdc.FwdGeometry(
                2, 8, 64, -(-c_out // 64), 0))
        other = deform_conv2d_hopper(x, off, wt, 4)
    torch.cuda.synchronize()
    assert hdc.bf16_forward_geometry(64, 128, 256, 132).n_tile == 64
    assert torch.equal(own, other)


def _corner_ordered_samples(x, off, halo):
    """Every tap's bf16 samples as the bf16 kernels define them: the f32
    sum, in corner order 0..3, of bf16(corner weight) x bf16 input (each
    product exact in f32), rounded to bf16.  Returns [B, H, W, 9, Cin]."""
    from slotvps_tpu_torch.ops.deform_conv import _tap_geometry

    b, h, w, c = x.shape
    flat = x.to(torch.bfloat16).float().reshape(b, h * w, c)
    taps = []
    for k in range(9):
        y0, x0, fy, fx, valid, _, _ = _tap_geometry(off, k, h, w, halo)
        v = torch.zeros((b, h, w, c), device=x.device)
        for j in range(4):
            cy, cx = y0 + (j >> 1), x0 + (j & 1)
            inside = valid & (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
            m = (fy if j >> 1 else 1 - fy) * (fx if j & 1 else 1 - fx)
            m = torch.where(inside, m, 0.0).to(torch.bfloat16).float()
            idx = (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).reshape(
                b, h * w, 1).expand(-1, -1, c)
            vals = torch.gather(flat, 1, idx).reshape(b, h, w, c)
            v = v + m[..., None] * torch.where(inside[..., None], vals, 0.0)
        taps.append(v.to(torch.bfloat16))
    return torch.stack(taps, dim=3)


@pytest.mark.cuda
@pytest.mark.parametrize("c_in", [16, 20])   # 16-byte corner loads, and not
def test_bf16_samples_are_corner_ordered_sums(cuda_device, c_in):
    """With weights that copy sample (tap k, channel c) to output channel
    k*Cin + c, the bf16 forward's output is its samples: equal bit for bit
    to the corner-ordered f32 sums, rounded to bf16."""
    x, off, _ = _case(cuda_device, 2, 13, 70, c_in, 1, 3)
    wt = torch.zeros((3, 3, c_in, 9 * c_in), device=cuda_device)
    for k in range(9):
        wt[k // 3, k % 3, :, k * c_in:(k + 1) * c_in] = torch.eye(
            c_in, device=cuda_device)
    xb = x.to(torch.bfloat16)
    with torch.no_grad():
        out = deform_conv2d_hopper(xb, off, wt.to(torch.bfloat16), 3)
    ref = _corner_ordered_samples(xb, off, 3)
    torch.cuda.synchronize()
    assert torch.equal(out.reshape(ref.shape), ref)


@pytest.mark.cuda
def test_bf16_kernel_f32_output(cuda_device):
    """An f32 model's bf16 route: f32 x and offsets, bf16 compute, the
    output in f32 without a final rounding (the plain version called the
    same way)."""
    x, off, wt = _case(cuda_device, 2, 25, 50, 128, 128, 6)
    before = dict(deform_conv2d_hopper.launches)
    with torch.no_grad():
        out = deform_conv2d_hopper(x, off, wt, 6,
                                   compute_dtype=torch.bfloat16)
        ref = deform_conv2d(x, off, wt, padding=1, max_displacement=6,
                            compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    assert deform_conv2d_hopper.launches == dict(
        before, bfloat16_f32=before["bfloat16_f32"] + 1)
    assert float((out - ref).abs().max()) <= 1e-2 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 25, 50, 128, 128, 6),    # P5 of the 800x1600 training crop, B=2
    (1, 13, 70, 256, 256, 2),    # ragged width, 256 -> 256
    (1, 9, 40, 20, 24, 3),       # Cin, Cout not multiples of the tiles
    (1, 5, 7, 8, 4, 0),          # halo 0: integer-only sampling
])
def test_backward_kernel_matches_plain(cuda_device, dtype, shape):
    b, h, w, c, co, halo = shape
    x, off, wt = _case(cuda_device, b, h, w, c, co, halo or 1)
    g = torch.randn((b, h, w, co), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(1))
    before = dict(dcn_backward_hopper.launches)
    out = dcn_backward_hopper(x, off, wt, g, halo, dtype)
    again = dcn_backward_hopper(x, off, wt, g, halo, dtype)
    ref = deform_conv2d_backward(x, off, wt, g, halo, dtype)
    torch.cuda.synchronize()
    key = "float32" if dtype == torch.float32 else "bfloat16"
    assert dcn_backward_hopper.launches == dict(before,
                                                **{key: before[key] + 2})
    rtol = 1e-4 if dtype == torch.float32 else 1e-2
    for name, a, r in zip(("dx", "doff", "dW"), out, ref):
        assert a.dtype == torch.float32 and a.shape == r.shape, name
        err = float((a - r).abs().max())
        assert err <= rtol * float(r.abs().max()), (name, err)
    for a, b in zip(out, again):             # a fixed order of sums
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_dx_is_the_same_on_every_run(cuda_device, dtype):
    """P2 of the 800x1600 training crop (B=2, 256 -> 256, halo 2), the
    training step's largest shape: dx, doff and dW equal in two runs."""
    x, off, wt = _case(cuda_device, 2, 200, 400, 256, 256, 2)
    g = torch.randn((2, 200, 400, 256), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(2))
    out = dcn_backward_hopper(x, off, wt, g, 2, dtype)
    again = dcn_backward_hopper(x, off, wt, g, 2, dtype)
    torch.cuda.synchronize()
    assert float(out[0].abs().max()) > 0
    for a, b in zip(out, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 9, 40, 20, 24, 3),       # ragged Cin and Cout: partial chunks, no
                                 # 16-byte x or ds access
    (2, 13, 70, 256, 256, 2),    # ragged width: edge tiles of both passes
    (2, 6, 9, 24, 20, 1),        # Cout not a multiple of 8: g padded
])
def test_bf16_backward_at_batch_two(cuda_device, shape):
    """The wgmma backward at B = 2 against the plain bf16 backward (dx, doff
    and dW within 1e-2 of max|ref|), equal in two runs."""
    b, h, w, c, co, halo = shape
    x, off, wt = _case(cuda_device, b, h, w, c, co, halo)
    g = torch.randn((b, h, w, co), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(3))
    out = dcn_backward_hopper(x, off, wt, g, halo, torch.bfloat16)
    again = dcn_backward_hopper(x, off, wt, g, halo, torch.bfloat16)
    ref = deform_conv2d_backward(x, off, wt, g, halo, torch.bfloat16)
    torch.cuda.synchronize()
    for name, a, r in zip(("dx", "doff", "dW"), out, ref):
        err = float((a - r).abs().max())
        assert err <= 1e-2 * float(r.abs().max()), (name, err)
    for a, b_ in zip(out, again):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out", [(20, 24), (256, 256)])
def test_bf16_backward_dw_of_a_one_hot_g(cuda_device, c_in, c_out):
    """With g one-hot at one (pixel, output channel), dW's column of that
    channel is the pixel's 9 x Cin rounded samples times 1 and every other
    column is 0: the kernel's dW equals the plain backward's and the
    corner-ordered samples bit for bit (a transposed operand would move
    the samples to other rows or columns)."""
    b, h, w, halo = 2, 11, 37, 3
    x, off, wt = _case(cuda_device, b, h, w, c_in, c_out, halo)
    g = torch.zeros((b, h, w, c_out), device=cuda_device)
    at, co = (1, 5, 21), c_out - 3
    g[at + (co,)] = 1.0
    dw = dcn_backward_hopper(x, off, wt, g, halo, torch.bfloat16)[2]
    ref = deform_conv2d_backward(x, off, wt, g, halo, torch.bfloat16)[2]
    samples = _corner_ordered_samples(x.to(torch.bfloat16), off, halo)
    torch.cuda.synchronize()
    assert torch.equal(dw, ref)
    assert torch.equal(dw[..., co].reshape(9, c_in),
                       samples[at].float().reshape(9, c_in))
    others = torch.ones(c_out, dtype=torch.bool, device=cuda_device)
    others[co] = False
    assert float(dw[..., others].abs().max()) == 0.0
    assert float(dw[..., co].abs().max()) > 0


@pytest.mark.cuda
def test_f32_kernel_at_the_largest_level(cuda_device):
    """P2 of a 1024x2048 frame, 256 -> 256, at B = 1: the 64-pixel tile
    with all 256 output channels a block (two consumer warpgroups)."""
    x, off, wt = _case(cuda_device, 1, 256, 512, 256, 256, 2)
    with torch.no_grad():
        out = deform_conv2d_hopper(x, off, wt, 2)
        ref = deform_conv2d(x, off, wt, padding=1, max_displacement=2)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    assert err <= 1e-4 * float(ref.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out", [(20, 24), (24, 20), (256, 256)])
def test_f32_kernel_is_batch_invariant(cuda_device, c_in, c_out):
    """At ragged and full widths (13x70 pixels): each image of a batch of
    2 gets the bits it gets alone, two runs are equal, and the batch is
    within 1e-4 of the plain version."""
    x, off, wt = _case(cuda_device, 2, 13, 70, c_in, c_out, 3)
    with torch.no_grad():
        both, again = (deform_conv2d_hopper(x, off, wt, 3) for _ in "ab")
        alone = [deform_conv2d_hopper(x[i:i + 1].contiguous(),
                                      off[i:i + 1].contiguous(), wt, 3)
                 for i in range(2)]
        ref = deform_conv2d(x, off, wt, padding=1, max_displacement=3)
    torch.cuda.synchronize()
    assert torch.equal(both, again)
    for i in range(2):
        assert torch.equal(both[i:i + 1], alone[i])
    assert float((both - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
def test_f32_kernel_is_the_same_under_another_tile(cuda_device,
                                                   monkeypatch):
    """A 64x128 image, 256 -> 256, at its own tile (4x8 pixels, all 256
    channels a block: two consumer warpgroups) and at 2x8 pixels with 64
    channels a block (one): the same bits."""
    from slotvps_tpu_torch.ops.cuda import deform_conv as hdc

    x, off, wt = _case(cuda_device, 1, 64, 128, 256, 256, 4)
    with torch.no_grad():
        own = deform_conv2d_hopper(x, off, wt, 4)
        monkeypatch.setattr(
            hdc, "f32_forward_geometry",
            lambda h, w, c_out, n_sm: hdc.FwdGeometry(
                2, 8, 64, -(-c_out // 64), 0, 32, 2))
        other = deform_conv2d_hopper(x, off, wt, 4)
    torch.cuda.synchronize()
    assert hdc.f32_forward_geometry(64, 128, 256, 132).n_tile == 64
    assert torch.equal(own, other)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 9, 40, 20, 24, 3),       # ragged Cin and Cout: partial chunks, no
                                 # 16-byte x or ds access
    (2, 13, 70, 256, 256, 2),    # ragged width: edge tiles and runs
    (2, 6, 9, 24, 20, 1),        # 24 -> 20; H*W = 54: g^T rows padded
    (2, 5, 7, 8, 6, 2),          # Cout not a multiple of 4: g padded
])
def test_f32_backward_at_batch_two(cuda_device, shape):
    """The split-TF32 backward at B = 2 against the plain f32 backward (dx,
    doff and dW within 1e-4 of max|ref|), equal in two runs."""
    b, h, w, c, co, halo = shape
    x, off, wt = _case(cuda_device, b, h, w, c, co, halo)
    g = torch.randn((b, h, w, co), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(3))
    out = dcn_backward_hopper(x, off, wt, g, halo, torch.float32)
    again = dcn_backward_hopper(x, off, wt, g, halo, torch.float32)
    ref = deform_conv2d_backward(x, off, wt, g, halo, torch.float32)
    torch.cuda.synchronize()
    for name, a, r in zip(("dx", "doff", "dW"), out, ref):
        err = float((a - r).abs().max())
        assert err <= 1e-4 * float(r.abs().max()), (name, err)
    for a, b_ in zip(out, again):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out", [(20, 24), (256, 256)])
def test_f32_backward_dw_of_a_one_hot_g(cuda_device, c_in, c_out):
    """With g one-hot at one (pixel, output channel), dW's column of that
    channel is the pixel's 9 x Cin samples (times 1: hi + lo of each
    sample, within 2**-21 of it) and every other column is exactly 0: the
    kernel's dW equals the plain backward's to 1e-6 of its max (a
    transposed operand would move the samples to other rows or
    columns)."""
    b, h, w, halo = 2, 11, 37, 3
    x, off, wt = _case(cuda_device, b, h, w, c_in, c_out, halo)
    g = torch.zeros((b, h, w, c_out), device=cuda_device)
    at, co = (1, 5, 21), c_out - 3
    g[at + (co,)] = 1.0
    dw = dcn_backward_hopper(x, off, wt, g, halo, torch.float32)[2]
    ref = deform_conv2d_backward(x, off, wt, g, halo, torch.float32)[2]
    torch.cuda.synchronize()
    others = torch.ones(c_out, dtype=torch.bool, device=cuda_device)
    others[co] = False
    assert float(dw[..., others].abs().max()) == 0.0
    scale = float(ref[..., co].abs().max())
    assert scale > 0
    assert float((dw - ref).abs().max()) <= 1e-6 * scale


@pytest.mark.cuda
def test_autograd_function_runs_the_backward_kernel(cuda_device):
    """deform_conv2d_hopper with gradients on the card: one forward and
    one backward launch, gradients as the backward wrapper gives them, in
    the inputs' dtypes (the f32 model's bf16 route)."""
    x, off, wt = _case(cuda_device, 1, 16, 40, 32, 32, 3)
    x, off, wt = (t.requires_grad_() for t in (x, off, wt))
    fwd, bwd = (dict(deform_conv2d_hopper.launches),
                dict(dcn_backward_hopper.launches))
    out = deform_conv2d_hopper(x, off, wt, 3, compute_dtype=torch.bfloat16)
    g = torch.randn_like(out)
    out.backward(g)
    torch.cuda.synchronize()
    assert deform_conv2d_hopper.launches == dict(
        fwd, bfloat16_f32=fwd["bfloat16_f32"] + 1)
    assert dcn_backward_hopper.launches == dict(
        bwd, bfloat16=bwd["bfloat16"] + 1)
    dx, doff, dw = dcn_backward_hopper(x.detach(), off.detach(),
                                       wt.detach(), g, 3, torch.bfloat16)
    assert torch.equal(off.grad, doff) and torch.equal(wt.grad, dw)
    assert float((x.grad - dx).abs().max()) <= 1e-5 * float(dx.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 100, 2048), (1, 100, 8192),
                                   (2, 20, 1000), (1, 128, 33), (1, 1, 64)])
def test_slot_attention_kernel_matches_plain(cuda_device, shape):
    b, n_slots, n_pix = shape
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(s, generator=g, device=cuda_device)
               .to(torch.bfloat16) for s in ((b, n_slots, 256),
                                             (b, n_pix, 256),
                                             (b, n_pix, 256)))
    before = slot_attention_hopper.launches
    out = slot_attention_hopper(q, k, v)
    ref = slot_attention(q, k, v)
    again = slot_attention_hopper(q, k, v)
    torch.cuda.synchronize()
    assert slot_attention_hopper.launches == before + 2
    assert out.dtype == torch.float32 and out.shape == (b, n_slots, 256)
    err = float((out - ref).abs().max())
    assert err <= 1e-4 * float(ref.abs().max()), err
    assert torch.equal(out, again)   # a fixed order of sums


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 100, 2048), (2, 100, 4133),
                                   (2, 20, 1000), (1, 128, 33), (1, 1, 64),
                                   (1, 64, 777), (1, 65, 64), (2, 100, 1),
                                   (1, 104, 777), (2, 105, 4133),
                                   (1, 1, 4133), (2, 128, 4133)])
def test_slot_attention_f32_kernel_matches_plain(cuda_device, shape):
    """The f32 kernel (f32 q, k and v, split-TF32 products on wgmma; its
    instances pad L to 64, 104 and 128 slots): within 1e-5 of max of the
    plain version, one f32 launch a call, equal in two runs, and each
    batch element's output the bits it gets alone."""
    b, n_slots, n_pix = shape
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn(s, generator=g, device=cuda_device)
               for s in ((b, n_slots, 256), (b, n_pix, 256), (b, n_pix, 256)))
    before = (slot_attention_hopper.launches,
              slot_attention_hopper.f32_launches)
    out = slot_attention_hopper(q, k, v)
    ref = slot_attention(q, k, v)
    again = slot_attention_hopper(q, k, v)
    alone = [slot_attention_hopper(q[i:i + 1].contiguous(),
                                   k[i:i + 1].contiguous(),
                                   v[i:i + 1].contiguous()) for i in range(b)]
    torch.cuda.synchronize()
    assert (slot_attention_hopper.launches,
            slot_attention_hopper.f32_launches) == (before[0],
                                                    before[1] + 2 + b)
    assert out.dtype == torch.float32 and out.shape == (b, n_slots, 256)
    err = float((out - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max()), err
    assert torch.equal(out, again)
    assert all(torch.equal(out[i:i + 1], alone[i]) for i in range(b))


@pytest.mark.cuda
def test_slot_attention_refuses_mixed_dtypes_on_the_card(cuda_device):
    q, k, v = (torch.randn(s, device=cuda_device)
               for s in ((1, 100, 256), (1, 64, 256), (1, 64, 256)))
    with pytest.raises(TypeError, match="all bfloat16 or all float32"):
        slot_attention_hopper(q, k.to(torch.bfloat16), v)


@pytest.mark.cuda
@pytest.mark.parametrize("n_pix", [4096, 4133])   # 64-pixel tiles, and not
@pytest.mark.parametrize("n_slots", [100, 128])
def test_slot_attention_tiles_and_batch(cuda_device, n_slots, n_pix):
    """L = 100 and 128 with P a multiple of the kernel's pixel tile and
    not, at B = 2: within 1e-4 of the plain version, and each batch
    element's output the bits it gets alone."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn(s, generator=g, device=cuda_device)
               .to(torch.bfloat16) for s in ((2, n_slots, 256),
                                             (2, n_pix, 256),
                                             (2, n_pix, 256)))
    out = slot_attention_hopper(q, k, v)
    ref = slot_attention(q, k, v)
    alone = [slot_attention_hopper(q[i:i + 1].contiguous(),
                                   k[i:i + 1].contiguous(),
                                   v[i:i + 1].contiguous()) for i in range(2)]
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    assert err <= 1e-4 * float(ref.abs().max()), err
    for i in range(2):
        assert torch.equal(out[i:i + 1], alone[i])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 512, 19), (12, 20, 19), (7, 33, 3),
                                   (45, 70, 19), (4, 12, 21), (5, 8, 1)])
def test_sseg_kernel_matches_plain(cuda_device, shape):
    h, w, c = shape
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((h, w, c), generator=g, device=cuda_device)
    x[..., c // 2] = x[..., 0]               # ties: the first channel wins
    x[: h // 2, : w // 3, :] = 0.25
    before = hv3.sseg_hopper.launches
    out = hv3.sseg_hopper(x)
    ref = plain.sseg(x)
    torch.cuda.synchronize()
    assert hv3.sseg_hopper.launches == before + 1
    assert out.dtype == torch.int64 and torch.equal(out, ref)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    x, off, wt = _case(cuda_device, 1, 6, 8, 16, 8, 2)
    with torch.no_grad():
        with pytest.raises(ValueError, match="contiguous"):
            deform_conv2d_hopper(x.transpose(1, 2), off.transpose(1, 2),
                                 wt, 2)
        with pytest.raises(TypeError, match="bfloat16"):
            deform_conv2d_hopper(x.half(), off, wt, 2)
        with pytest.raises(TypeError, match="compute_dtype"):
            deform_conv2d_hopper(x, off, wt, 2, compute_dtype=torch.half)
        with pytest.raises(ValueError, match="one CUDA device"):
            deform_conv2d_hopper(x, off.cpu(), wt, 2)
        with pytest.raises(ValueError, match="g "):
            dcn_backward_hopper(x, off, wt, x, 2)
        with pytest.raises(ValueError, match="Cin, Cout <= 256"):
            wide = torch.zeros((1, 6, 8, 300), device=cuda_device)
            dcn_backward_hopper(wide, off, torch.zeros(
                (3, 3, 300, 8), device=cuda_device), x[..., :8].contiguous(),
                2)


def _postproc_case(dev, k, h, w, seed=0):
    """Blob masks, ~2/3 valid slots, things and stuff, and two thing slots
    of one class that overlap (one is rejected by the claim loop)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    m = torch.randn((k, h, w), generator=g, device=dev) * 2
    for i in range(0, k, 3):
        y = int(torch.randint(0, max(h - 6, 1), (1,), generator=g,
                              device=dev))
        x = int(torch.randint(0, max(w - 8, 1), (1,), generator=g,
                              device=dev))
        m[i, y:y + 6, x:x + 8] += 6.0
    labels = torch.randint(0, 19, (k,), generator=g, device=dev)
    valid = torch.rand((k,), generator=g, device=dev) < 0.7
    labels[[1, 4]] = 13
    valid[[1, 4]] = True
    m[4] = m[1] + 0.01
    return m.contiguous(), labels, valid, labels > 10


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(24, 16, 24), (100, 40, 70),
                                   (64, 256, 512), (64, 41, 70),
                                   (48, 45, 70)])
def test_postproc_kernels_match_plain(cuda_device, shape):
    k, h, w = shape
    m, labels, valid, is_thing = _postproc_case(cuda_device, k, h, w)
    fns = (hv3.theta_hopper, hv3.claim_hopper, hv3.argmax_hopper,
           hv3.repair_hopper)
    before = [f.launches for f in fns]

    th = hv3.theta_hopper(m, valid, 0.4)
    th_ref = plain.theta(m, valid, 0.4)
    torch.cuda.synchronize()
    assert float(((th - th_ref).abs()
                  / th_ref.abs().clamp_min(1.0)).max()) <= 1e-5

    keep, owner = hv3.claim_hopper(m, th_ref, labels, is_thing, valid, 0.03)
    keep_ref, owner_ref = plain.claim(m, th_ref, labels, is_thing, valid,
                                      0.03)
    assert torch.equal(keep, keep_ref) and torch.equal(owner, owner_ref)
    assert 0 < int(keep.sum()) < int((valid & is_thing).sum())

    kept = torch.where(is_thing, keep_ref, valid)
    m1, areas = hv3.argmax_hopper(m, owner_ref, kept, is_thing)
    m1_ref, areas_ref = plain.argmax(m, owner_ref, kept, is_thing)
    assert torch.equal(m1, m1_ref) and torch.equal(areas, areas_ref)

    # remove the kept slot touching the fewest row tiles: dirty tiles
    n_tiles = (areas_ref > 0).sum(0)
    cand = torch.nonzero(kept & (n_tiles > 0)).flatten()
    gone = cand[n_tiles[cand].argmin()]
    removed = torch.zeros_like(kept)
    removed[gone] = True
    kept_n = kept & ~removed
    dirty = ((areas_ref > 0) & removed[None]).any(-1)
    m2, a2 = hv3.repair_hopper(m, owner_ref, m1_ref, kept_n, is_thing, dirty,
                               areas_ref)
    m2_ref, a2_ref = plain.repair(m, owner_ref, m1_ref, kept_n, is_thing,
                                  dirty, areas_ref)
    torch.cuda.synchronize()
    assert torch.equal(m2, m2_ref) and torch.equal(a2, a2_ref)
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 1, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("k_minor", [False, True])
@pytest.mark.parametrize("valid_set", ["none", "one", "first40", "all"])
def test_theta_kernel_on_valid_sets(cuda_device, k_minor, valid_set):
    """theta over no valid slot, one (slot 5), the first 40 and all 64
    slots of 41 x 70 masks (ragged blocks in both directions), slot-major
    and K-minor: within 1e-5 * max(1, |theta|) of the plain version, the
    two layouts equal bit for bit, one launch each."""
    k, h, w = 64, 41, 70
    m, _, _, _ = _postproc_case(cuda_device, k, h, w)
    valid = torch.zeros((k,), dtype=torch.bool, device=cuda_device)
    valid[{"none": [], "one": [5], "first40": list(range(40)),
           "all": list(range(k))}[valid_set]] = True
    before = (hv3.theta_hopper.launches, hfused.theta_fused_hopper.launches)
    if k_minor:
        th = hfused.theta_fused_hopper(m.permute(1, 2, 0).contiguous(),
                                       valid, 0.4)
    else:
        th = hv3.theta_hopper(m, valid, 0.4)
    other = hv3.theta_hopper(m, valid, 0.4) if k_minor else \
        hfused.theta_fused_hopper(m.permute(1, 2, 0).contiguous(), valid,
                                  0.4)
    ref = plain.theta(m, valid, 0.4)
    torch.cuda.synchronize()
    assert float(((th - ref).abs() / ref.abs().clamp_min(1.0)).max()) <= 1e-5
    assert torch.equal(th, other)
    assert (hv3.theta_hopper.launches - before[0],
            hfused.theta_fused_hopper.launches - before[1]) == (1, 1)


@pytest.mark.cuda
def test_claim_over_a_slot_range(cuda_device):
    """The claim loop over a range that holds every valid thing slot gives
    the same result as over all slots, in one launch."""
    m, labels, valid, is_thing = _postproc_case(cuda_device, 32, 16, 24)
    th = plain.theta(m, valid, 0.4)
    things = torch.nonzero(valid & is_thing).flatten().tolist()
    lo, hi = things[0], things[-1] + 1
    before = hv3.claim_hopper.launches
    ranged = hv3.claim_hopper(m, th, labels, is_thing, valid, 0.03,
                              slots=(lo, hi))
    assert hv3.claim_hopper.launches == before + 1
    full = hv3.claim_hopper(m, th, labels, is_thing, valid, 0.03)
    assert torch.equal(ranged[0], full[0]) and torch.equal(ranged[1], full[1])


@pytest.mark.cuda
def test_postproc_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    m, labels, valid, is_thing = _postproc_case(cuda_device, 24, 16, 24)
    th = plain.theta(m, valid, 0.4)
    with pytest.raises(TypeError, match="float32"):
        hv3.theta_hopper(m.double(), valid, 0.4)
    with pytest.raises(TypeError, match="contiguous"):
        hv3.theta_hopper(m.transpose(1, 2), valid, 0.4)
    with pytest.raises(ValueError, match="one CUDA device"):
        hv3.theta_hopper(m, valid.cpu(), 0.4)
    with pytest.raises(ValueError, match="int8 owner"):
        big = torch.zeros((128, 16, 24), device=cuda_device)
        hv3.theta_hopper(big, torch.ones(128, dtype=torch.bool,
                                         device=cuda_device), 0.4)
    with pytest.raises(ValueError, match="theta"):
        hv3.claim_hopper(m, th[:, :-1], labels, is_thing, valid, 0.03)
    with pytest.raises(ValueError, match="owner"):
        hv3.argmax_hopper(m, th, valid, is_thing)
    with pytest.raises(TypeError, match="float32"):
        hv3.sseg_hopper(m.permute(1, 2, 0).contiguous().double())
    q = torch.zeros((1, 129, 256), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="L <= 128"):
        slot_attention_hopper(q, q, q)
    # bf16 and f32 are taken; mixed dtypes and others are not
    with pytest.raises(TypeError, match="bfloat16"):
        slot_attention_hopper(q[:, :8].float(), q, q)
    with pytest.raises(TypeError, match="bfloat16"):
        slot_attention_hopper(q[:, :8].half(), q.half(), q.half())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(24, 16, 24), (100, 40, 70),
                                   (100, 256, 512), (64, 41, 70)])
def test_k_minor_postproc_kernels_match_plain(cuda_device, shape):
    """theta, claim and argmax-areas on K-minor masks against their plain
    versions (and the v3 kernels on the same masks slot-major): each
    launches once."""
    k, h, w = shape
    m_khw, labels, valid, is_thing = _postproc_case(cuda_device, k, h, w)
    m = m_khw.permute(1, 2, 0).contiguous()
    fns = (hfused.theta_fused_hopper, hfused.claim_scan_fused_hopper,
           hfused.argmax_areas_hopper)
    before = [f.launches for f in fns]
    th = hfused.theta_fused_hopper(m, valid, 0.4)
    th_ref = plain_fused.theta_fused(m, valid, 0.4)
    th3 = hv3.theta_hopper(m_khw, valid, 0.4)
    torch.cuda.synchronize()
    assert float(((th - th_ref).abs()
                  / th_ref.abs().clamp_min(1.0)).max()) <= 1e-5
    assert torch.equal(th, th3)
    keep, owner = hfused.claim_scan_fused_hopper(m, th_ref, labels, is_thing,
                                                 valid, 0.03)
    keep_ref, owner_ref = plain_fused.claim_scan_fused(
        m, th_ref, labels, is_thing, valid, 0.03)
    assert torch.equal(keep, keep_ref) and torch.equal(owner, owner_ref)
    assert 0 < int(keep.sum()) < int((valid & is_thing).sum())
    kept = torch.where(is_thing, keep_ref, valid)
    m_id, areas = hfused.argmax_areas_hopper(m, owner_ref, kept, is_thing)
    m_ref, areas_ref = plain_fused.argmax_areas(m, owner_ref, kept,
                                                is_thing)
    m3, areas_t = hv3.argmax_hopper(m_khw, owner_ref, kept, is_thing)
    torch.cuda.synchronize()
    assert torch.equal(m_id, m_ref) and torch.equal(areas, areas_ref)
    assert torch.equal(m_id, m3) and torch.equal(areas, areas_t.sum(0).int())
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 1, 1]


@pytest.mark.cuda
def test_k_minor_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    m_khw, labels, valid, is_thing = _postproc_case(cuda_device, 24, 16, 24)
    m = m_khw.permute(1, 2, 0).contiguous()
    th = plain_fused.theta_fused(m, valid, 0.4)
    with pytest.raises(TypeError, match=r"\[h, w, K\]"):
        hfused.theta_fused_hopper(m.double(), valid, 0.4)
    with pytest.raises(TypeError, match="contiguous"):
        hfused.theta_fused_hopper(m_khw.permute(1, 2, 0), valid, 0.4)
    with pytest.raises(ValueError, match="one CUDA device"):
        hfused.claim_scan_fused_hopper(m, th, labels.cpu(), is_thing, valid,
                                       0.03)
    with pytest.raises(ValueError, match="int8 owner"):
        big = torch.zeros((16, 24, 128), device=cuda_device)
        hfused.theta_fused_hopper(big, torch.ones(128, dtype=torch.bool,
                                                  device=cuda_device), 0.4)
    with pytest.raises(ValueError, match="theta"):
        hfused.claim_scan_fused_hopper(m, th[:, :-1], labels, is_thing,
                                       valid, 0.03)
    with pytest.raises(ValueError, match="owner"):
        hfused.argmax_areas_hopper(m, th, valid, is_thing)
    with pytest.raises(ValueError, match="valid"):
        hfused.theta_fused_hopper(m, valid[:-1], 0.4)


def _planes(dev, b, k, h, w, seed=0):
    """Binarized [B, K, H, W] planes of the postprocess case (up >= theta)
    with its slot vectors, one set per video."""
    cases = [_postproc_case(dev, k, h // 4, w // 4, seed=seed + i)
             for i in range(b)]
    planes = torch.stack([plain.upsample_slots(m) >= plain.theta(m, v, 0.4)
                          for m, _, v, _ in cases])
    labels, valid, is_thing = (torch.stack([c[i] for c in cases])
                               for i in (1, 2, 3))
    return planes, labels, is_thing, valid


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,h,w", [(1, 24, 64, 96), (2, 100, 160, 280),
                                     (3, 127, 36, 52)])
def test_claim_scan_kernel_matches_plain(cuda_device, b, k, h, w):
    planes, labels, is_thing, valid = _planes(cuda_device, b, k, h, w)
    keep_ref, owner_ref = claim_scan(planes, labels, is_thing, valid, 0.03)
    before = claim_scan_hopper.launches
    keep, owner = claim_scan_hopper(planes, labels, is_thing, valid, 0.03)
    torch.cuda.synchronize()
    assert claim_scan_hopper.launches == before + 1
    assert torch.equal(keep, keep_ref) and torch.equal(owner, owner_ref)
    assert 0 < int(keep.sum()) < int((valid & is_thing).sum())
    # the K-minor stack ([H, W, K] permuted), int8 planes, and one video
    hwk = planes.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    keep2, owner2 = claim_scan_hopper(hwk, labels, is_thing, valid, 0.03)
    keep3, owner3 = claim_scan_hopper(planes[-1].to(torch.int8), labels[-1],
                                      is_thing[-1], valid[-1], 0.03)
    torch.cuda.synchronize()
    assert torch.equal(keep2, keep_ref) and torch.equal(owner2, owner_ref)
    assert torch.equal(keep3, keep_ref[-1]) \
        and torch.equal(owner3, owner_ref[-1])


@pytest.mark.cuda
def test_claim_scan_at_the_rule_and_over_a_slot_range(cuda_device):
    """Overlaps of 3/100 (kept), 4/100 and 1/33 (rejected), all-0 and all-1
    planes; a range holding every valid thing slot gives the full result."""
    h, w = 16, 32
    sets = [range(0, 100), range(97, 197), [5, *range(300, 332)],
            [10, 11, 12, 13, *range(350, 446)], [], range(h * w)]
    planes = torch.zeros((8, h * w), dtype=torch.bool)
    for i, px in enumerate(sets):
        planes[i + 1, list(px)] = True
    planes = planes.reshape(8, h, w).to(cuda_device)
    labels = torch.full((8,), 11, device=cuda_device)
    labels[0] = 3
    valid = torch.ones(8, dtype=torch.bool, device=cuda_device)
    valid[7] = False
    is_thing = labels > 10
    keep, owner = claim_scan_hopper(planes, labels, is_thing, valid, 0.03,
                                    slots=(1, 7))
    keep_ref, owner_ref = claim_scan(planes, labels, is_thing, valid, 0.03)
    torch.cuda.synchronize()
    assert keep.tolist() == [False, True, True, False, False, False, False,
                             False]
    assert torch.equal(keep, keep_ref) and torch.equal(owner, owner_ref)


@pytest.mark.cuda
def test_claim_kernels_on_the_edge_cases(cuda_device):
    """chip_smoke.py's claim cases (phase_claim_edges): more than 32 valid
    things, K = 127, all-0 and all-1 planes, a copied thing, B = 2 with 40
    and 9 valid things, and batches and maps past the shared-memory
    geometry (B = 300 in groups of videos); the claim scan on contiguous
    and K-minor planes, the theta
    claim on slot-major and K-minor masks, each equal to its plain version
    and to its own second run, one launch a call."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    rows = chip_smoke.phase_claim_edges(cuda_device)
    plans = [r["plan"] for r in rows]
    assert max(max(r["things"]) for r in rows) > 32
    assert any(not p["own_smem"] and p["bits_smem"] for p in plans)
    assert any(not p["bits_smem"] for p in plans)
    assert any(r["plan"]["group"] < r["shape"][0] for r in rows)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(chip_smoke.ARGMAX_CASES))
def test_argmax_kernels_on_the_edge_cases(cuda_device, name):
    """chip_smoke.py's edge cases of the argmax kernel: argmax, top2, one
    repair and the K-minor argmax-areas, each bit-identical to its plain
    version in one launch (hold_argmax_edge raises otherwise)."""
    row = chip_smoke.hold_argmax_edge(cuda_device, name)
    assert row["case"] == name


@pytest.mark.cuda
@pytest.mark.parametrize("shape", chip_smoke.SSEG_CASES)
def test_sseg_kernel_on_the_edge_cases(cuda_device, shape):
    chip_smoke.hold_sseg_edge(cuda_device, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(13, 8, 32), (64, 64, 128),
                                   (48, 45, 70)])
def test_argmax_top2_and_hist_kernels_match_plain(cuda_device, shape):
    k, h, w = shape
    m, labels, valid, is_thing = _postproc_case(cuda_device, k, h, w)
    th = plain.theta(m, valid, 0.4)
    keep, owner = plain.claim(m, th, labels, is_thing, valid, 0.03)
    kept = torch.where(is_thing, keep, valid)
    before = (hv3.argmax_hopper.launches, hv3.argmax_hopper.top2_launches,
              hv3.hist_hopper.launches)
    m1, m2, areas = hv3.argmax_hopper(m, owner, kept, is_thing, top2=True)
    r1, r2, r_areas = plain.argmax(m, owner, kept, is_thing, top2=True)
    hist = hv3.hist_hopper(r1, k)
    tail = r1.flatten()[4:-2].clone()     # a length not a multiple of 4
    odd = hv3.hist_hopper(tail, k + 3)
    torch.cuda.synchronize()
    assert torch.equal(m1, r1) and torch.equal(m2, r2) \
        and torch.equal(areas, r_areas)
    assert (m1 != m2).any()
    assert torch.equal(hist, plain.hist(r1, k))
    assert torch.equal(hist, torch.bincount(r1.flatten().long(),
                                            minlength=k).int())
    assert torch.equal(odd, plain.hist(tail, k + 3))
    assert (hv3.argmax_hopper.launches, hv3.argmax_hopper.top2_launches,
            hv3.hist_hopper.launches) == (before[0], before[1] + 1,
                                          before[2] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("name", chip_smoke.HIST_CASES)
def test_hist_kernel_on_the_edge_cases(cuda_device, name):
    """chip_smoke.py's edge cases of the hist kernel at 1024x2048 ids, each
    bit-identical to the plain version in one launch (hold_hist_edge
    raises otherwise)."""
    assert chip_smoke.hold_hist_edge(cuda_device, name)["case"] == name


@pytest.mark.cuda
def test_claim_scan_and_hist_wrappers_reject_what_they_do_not_take(
        cuda_device):
    planes, labels, is_thing, valid = _planes(cuda_device, 1, 24, 32, 48)
    with pytest.raises(TypeError, match="1-byte"):
        claim_scan_hopper(planes.float(), labels, is_thing, valid, 0.03)
    with pytest.raises(ValueError, match="one CUDA device"):
        claim_scan_hopper(planes, labels.cpu(), is_thing, valid, 0.03)
    with pytest.raises(ValueError, match="one stride"):
        claim_scan_hopper(planes.transpose(2, 3), labels, is_thing, valid,
                          0.03)
    with pytest.raises(ValueError, match="int8 owner"):
        claim_scan_hopper(torch.zeros((128, 4, 4), dtype=torch.bool,
                                      device=cuda_device),
                          torch.zeros(128, device=cuda_device),
                          torch.ones(128, dtype=torch.bool,
                                     device=cuda_device),
                          torch.ones(128, dtype=torch.bool,
                                     device=cuda_device), 0.03)
    with pytest.raises(ValueError, match="slots"):
        claim_scan_hopper(planes, labels, is_thing, valid, 0.03,
                          slots=(0, 25))
    m_id = torch.zeros((8, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError, match="int32"):
        hv3.hist_hopper(m_id.long(), 4)
    with pytest.raises(TypeError, match="aligned"):
        hv3.hist_hopper(m_id.flatten()[1:], 4)
    with pytest.raises(ValueError, match="4096"):
        hv3.hist_hopper(m_id, 4097)


@pytest.mark.cuda
def test_batched_pipeline_equals_streaming_bf16(cuda_device):
    """BatchedVideoPipeline (B = 2) on the bf16 kernel path of the tuned
    r50_fpn_slotvps (bf16 DCN, slot attention, fused postprocess and sseg)
    at 128x256, seeded weights calibrated so that things are kept: each
    video's maps, classes, scores and ids equal its streaming run's bit for
    bit."""
    import dataclasses

    import numpy as np

    from slotvps_tpu_torch.cli.test_eval_vpq import tune_config
    from slotvps_tpu_torch.config import named_config
    from slotvps_tpu_torch.inference import (BatchedVideoPipeline,
                                             InferencePipeline,
                                             _device_normalize, run_video)
    from slotvps_tpu_torch.models.detector import (decode_pair,
                                                   extract_features,
                                                   init_model)
    from slotvps_tpu_torch.utils.calibration import (calibrate_class_head,
                                                     doctor_params)

    cfg = tune_config(named_config("r50_fpn_slotvps"))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, slot_head=dataclasses.replace(cfg.model.slot_head,
                                                 retriever_impl="pallas")))
    rng = np.random.default_rng(0)
    blocks = rng.integers(0, 256, (4, 8, 3), dtype=np.uint8)
    base = np.repeat(np.repeat(blocks, 32, axis=0), 32, axis=1)
    clips = [[np.clip(np.roll(base, 8 * t + 40 * v, axis=1)
                      + rng.integers(-12, 13, base.shape), 0, 255)
              .astype(np.uint8)[None] for t in range(3)] for v in range(2)]
    model = init_model(torch.Generator().manual_seed(0), cfg.model,
                       device=cuda_device)
    doctor_params(model, torch.Generator().manual_seed(1))
    with torch.inference_mode():
        img = _device_normalize(torch.from_numpy(clips[0][0]).to(
            cuda_device), cfg.data)
        f = extract_features(model, cfg.model, img)
        logits = decode_pair(model, cfg.model, f, f).pred_logits[0]
    model, _ = calibrate_class_head(
        model, logits, torch.Generator().manual_seed(2), target_valid=12,
        threshold=cfg.model.postprocess.threshold)
    size = (128, 256)
    streams = [run_video(InferencePipeline(model, cfg, image_size=size), c)
               for c in clips]
    batched = BatchedVideoPipeline(model, cfg, 2,
                                   image_size=size).run_videos(clips)
    assert any(len(r.cls_inds) for s in streams for r in s)
    for ref, got in zip(streams, batched):
        for a, b in zip(ref, got):
            for name in ("sseg", "panoptic", "cls_inds", "obj_ids",
                         "cls_prob"):
                assert np.array_equal(getattr(a, name), getattr(b, name)), \
                    name
