"""The forward blend kernel's share of its least time (roofline.py), in %."""

from benchmark.metrics import _read


def read(record):
    return _read.roofline(record, "blend_fwd")
