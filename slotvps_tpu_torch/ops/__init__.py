"""Core numeric ops with exact reference (PyTorch) semantics, NHWC: the
plain versions of the JAX package's ``slotvps_tpu/ops/`` (the hot ones
also have Hopper kernels under ``ops/cuda/``)."""

from slotvps_tpu_torch.ops.interpolate import (  # noqa: F401
    interpolate_bilinear, interpolate_nearest, upsample_x2_bilinear)
from slotvps_tpu_torch.ops.deform_conv import deform_conv2d  # noqa: F401
from slotvps_tpu_torch.ops.focal_loss import sigmoid_focal_loss  # noqa: F401
