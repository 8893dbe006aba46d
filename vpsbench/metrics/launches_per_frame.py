"""Kernel launches on the card in the profiled steps over their frames."""


def read(record):
    t = record.get("trace")
    if not t or not t["frames"]:
        return None
    return t["launches"] / t["frames"]
