"""The backward blend kernels' (walk + segment sum) share of their least time, in %."""

from benchmark.metrics import _read


def read(record):
    return _read.roofline(record, "blend_bwd")
