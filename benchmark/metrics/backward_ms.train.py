"""Median ms of the backward stage (autograd and the blend's backward)."""

from benchmark.metrics import _read


def read(record):
    return _read.stage(record, "backward")
