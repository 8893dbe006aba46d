"""The frame step's share (%) of the card's tensor-core peak: the profiled
frames times one frame's counted flops (``vpsbench/cost`` on the
reference), over the profiled steps' time, over the configuration's peak."""


def read(record):
    t, w = record.get("trace"), record.get("work")
    if not t or not w or t["window_s"] <= 0:
        return None
    return 100.0 * t["frames"] * w["flops"] / t["window_s"] \
        / record["peaks"]["products_flops"]
