"""Median ms of the binning stage, its host sync included (CUDA-event marks)."""

from benchmark.metrics import _read


def read(record):
    return _read.stage(record, "binning")
