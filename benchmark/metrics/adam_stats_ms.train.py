"""Median ms of Adam and the densification statistics."""

from benchmark.metrics import _read


def read(record):
    return _read.stage(record, "adam_stats")
