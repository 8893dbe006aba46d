"""The slot-attention kernel's share of its roofline: the least time of
the frame's 14 Retriever cores, times the profiled frames, over the device
time of ``slot_attn_*`` and ``sa_*`` kernels."""

from vpsbench.metrics import roofline


def read(record):
    return roofline(record, "slot_attention", r"slot_attn_|sa_qsplit")
