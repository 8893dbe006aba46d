"""The port's plain ops that no entry point calls, against the JAX
package's on seeded inputs: ``interpolate_nearest`` and
``upsample_x2_bilinear`` (``ops/interpolate.py``), ``deform_roi_pooling``
(``ops/deform_pool.py``) and the float64 oracle ``deform_conv2d_reference``
(``ops/deform_conv.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotvps_tpu.ops import deform_conv as jdc
from slotvps_tpu.ops import deform_pool as jdp
from slotvps_tpu.ops import interpolate as jint
from slotvps_tpu_torch import ops as tops
from slotvps_tpu_torch.ops import deform_conv as tdc
from slotvps_tpu_torch.ops import deform_pool as tdp


@pytest.mark.parametrize("src,dst", [
    ((5, 7), (10, 14)), ((4, 6), (12, 18)),     # upscale
    ((10, 14), (5, 7)), ((9, 13), (4, 5)),      # downscale
    ((6, 8), (9, 11)), ((7, 5), (10, 3)),       # non-integer ratios
    ((6, 8), (6, 8))])                          # unchanged
def test_interpolate_nearest_matches_jax(src, dst):
    x = np.random.default_rng(0).standard_normal((2, *src, 3)) \
        .astype(np.float32)
    ours = tops.interpolate_nearest(torch.from_numpy(x), dst)
    ref = np.asarray(jint.interpolate_nearest(jnp.asarray(x), dst))
    assert tuple(ours.shape) == ref.shape == (2, *dst, 3)
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("align_corners", [False, True])
def test_upsample_x2_bilinear_matches_jax(align_corners):
    x = np.random.default_rng(1).standard_normal((2, 5, 7, 3)) \
        .astype(np.float32)
    ours = tops.upsample_x2_bilinear(torch.from_numpy(x), align_corners)
    ref = np.asarray(jint.upsample_x2_bilinear(jnp.asarray(x),
                                               align_corners))
    assert tuple(ours.shape) == ref.shape == (2, 10, 14, 3)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-6)


# (x1, y1, x2, y2) in image coords of a 24x32 image at spatial_scale 0.5
# (a 12x16 feature map): inside, across each border, past the image,
# degenerate (x2 < x1), a single pixel
ROIS = np.asarray([[2.0, 3.0, 17.0, 15.0], [-6.0, -4.0, 9.0, 7.0],
                   [20.0, 14.0, 40.0, 30.0], [0.0, 0.0, 31.0, 23.0],
                   [35.0, 26.0, 50.0, 40.0], [10.0, 8.0, 6.0, 5.0],
                   [5.0, 5.0, 5.0, 5.0]], np.float32)


@pytest.mark.parametrize("with_offset", [False, True])
@pytest.mark.parametrize("out_size,samples", [(3, 4), (4, 2)])
def test_deform_roi_pooling_matches_jax(with_offset, out_size, samples):
    rng = np.random.default_rng(out_size)
    x = rng.standard_normal((12, 16, 5)).astype(np.float32)
    offset = (rng.standard_normal((len(ROIS), out_size, out_size, 2)) * 2
              ).astype(np.float32) if with_offset else None
    ours = tdp.deform_roi_pooling(
        torch.from_numpy(x), torch.from_numpy(ROIS),
        None if offset is None else torch.from_numpy(offset), 0.5,
        out_size, sample_per_part=samples)
    ref = np.asarray(jdp.deform_roi_pooling(
        jnp.asarray(x), jnp.asarray(ROIS),
        None if offset is None else jnp.asarray(offset), 0.5, out_size,
        sample_per_part=samples))
    assert tuple(ours.shape) == ref.shape == (len(ROIS), out_size,
                                              out_size, 5)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)
    # the roi past the image has no valid sample
    if not with_offset:
        assert not ours[4].any()


@pytest.mark.parametrize("masked,stride,padding,dilation", [
    (True, 1, 1, 1), (False, 2, 1, 1), (False, 1, 2, 2), (True, 2, 2, 2)])
def test_deform_conv2d_reference_matches_jax(masked, stride, padding,
                                             dilation):
    rng = np.random.default_rng(stride * 10 + dilation)
    b, h, w, c_in, c_out = 2, 7, 9, 3, 4
    ho = (h + 2 * padding - 2 * dilation - 1) // stride + 1
    wo = (w + 2 * padding - 2 * dilation - 1) // stride + 1
    x = rng.standard_normal((b, h, w, c_in)).astype(np.float32)
    offset = (rng.standard_normal((b, ho, wo, 18)) * 2).astype(np.float32)
    weight = rng.standard_normal((3, 3, c_in, c_out)).astype(np.float32)
    mask = rng.uniform(0, 1, (b, ho, wo, 9)).astype(np.float32) \
        if masked else None
    ours = tdc.deform_conv2d_reference(
        torch.from_numpy(x), torch.from_numpy(offset), weight,
        mask=None if mask is None else torch.from_numpy(mask),
        stride=stride, padding=padding, dilation=dilation)
    # numpy inputs: a jnp mask would turn the oracle's float64 samples into
    # float32 arrays after the mask product
    ref = jdc.deform_conv2d_reference(x, offset, weight, mask=mask,
                                      stride=stride, padding=padding,
                                      dilation=dilation)
    assert ours.dtype == np.float64 and ours.shape == (b, ho, wo, c_out)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-9)
