"""Median ms of the preprocess stage (CUDA-event marks)."""

from benchmark.metrics import _read


def read(record):
    return _read.stage(record, "preprocess")
