"""Median host ms per traced view spent inside the program's ``trace.sync``
sites (reads that wait for the device)."""

from benchmark.metrics import _trace


def read(record):
    return _trace.unit_median("view", "blocked_ms")
