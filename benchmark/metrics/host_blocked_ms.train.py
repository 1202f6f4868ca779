"""Median host ms per traced step spent inside the program's ``trace.sync``
sites (reads that wait for the device)."""

from benchmark.metrics import _trace


def read(record):
    return _trace.unit_median("step", "blocked_ms")
