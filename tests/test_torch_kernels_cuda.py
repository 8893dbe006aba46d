"""The Hopper DCN kernel against its plain PyTorch version, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the tests' conftest helpers, so it also runs on a
machine without JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerance: max |kernel - plain| <= 1e-4 * max |plain| (f32 sums taken in
another order)."""

import pytest
import torch

from slotvps_tpu_torch.ops.cuda.deform_conv import deform_conv2d_hopper
from slotvps_tpu_torch.ops.deform_conv import deform_conv2d


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the DCN kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    before = deform_conv2d_hopper.launches
    with torch.no_grad():
        out = deform_conv2d_hopper(x, off, wt, halo)
        ref = deform_conv2d(x, off, wt, padding=1, max_displacement=halo)
    torch.cuda.synchronize()
    assert deform_conv2d_hopper.launches == before + 1
    err = float((out - ref).abs().max())
    assert err <= 1e-4 * float(ref.abs().max()), err


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    x, off, wt = _case(cuda_device, 1, 6, 8, 16, 8, 2)
    with torch.no_grad():
        with pytest.raises(ValueError, match="contiguous"):
            deform_conv2d_hopper(x.transpose(1, 2), off.transpose(1, 2),
                                 wt, 2)
        with pytest.raises(TypeError, match="float32"):
            deform_conv2d_hopper(x.half(), off, wt, 2)
        with pytest.raises(ValueError, match="one CUDA device"):
            deform_conv2d_hopper(x, off.cpu(), wt, 2)
        with pytest.raises(ValueError, match="multiple of 4"):
            deform_conv2d_hopper(x, off, wt[..., :6].contiguous(), 2)
