"""Median ms of the appearance network's backward (CUDA-event marks from
the multiplier's gradient, ``appearance.bwd_start``, to the network
input's, ``appearance.bwd``)."""

from benchmark.metrics import _read


def read(record):
    return _read.stage(record, "appearance_bwd")
