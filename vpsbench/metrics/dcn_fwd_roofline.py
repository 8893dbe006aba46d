"""The bf16 DCN forward kernel's share of its roofline: the least time of
the frame's 12 deformable convolutions (``vpsbench/cost`` formulas at the
cell's shapes), times the profiled frames, over the device time of the
forward's kernels (``dcn_fwd_*`` and the weight image ``dcn_wimg_*``)."""

from vpsbench.metrics import roofline


def read(record):
    return roofline(record, "dcn", r"dcn_(fwd|wimg)")
