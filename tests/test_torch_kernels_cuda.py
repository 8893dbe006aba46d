"""The Hopper kernels against their plain PyTorch versions, on the card:
the DCN kernel and the four fused-postprocess kernels (theta, claim,
argmax, repair).

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the tests' conftest helpers, so it also runs on a
machine without JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: DCN max |kernel - plain| <= 1e-4 * max |plain| (f32 sums taken
in another order); theta within 1e-5 * max(1, |theta|) (the sum of exp in
another order); the integer outputs of claim, argmax and repair are
bit-identical, given identical inputs."""

import pytest
import torch

from slotvps_tpu_torch.ops import postproc_v3 as plain
from slotvps_tpu_torch.ops.cuda import postproc_v3 as hv3
from slotvps_tpu_torch.ops.cuda.deform_conv import deform_conv2d_hopper
from slotvps_tpu_torch.ops.deform_conv import deform_conv2d


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
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
                                   (64, 256, 512)])
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
    assert [f.launches - b for f, b in zip(fns, before)] == [1, k + 1, 1, 1]


@pytest.mark.cuda
def test_claim_over_a_slot_range(cuda_device):
    """The claim loop launched over a range that holds every valid thing
    slot gives the same result as over all slots."""
    m, labels, valid, is_thing = _postproc_case(cuda_device, 32, 16, 24)
    th = plain.theta(m, valid, 0.4)
    things = torch.nonzero(valid & is_thing).flatten().tolist()
    lo, hi = things[0], things[-1] + 1
    before = hv3.claim_hopper.launches
    ranged = hv3.claim_hopper(m, th, labels, is_thing, valid, 0.03,
                              slots=(lo, hi))
    assert hv3.claim_hopper.launches == before + hi - lo + 1
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
