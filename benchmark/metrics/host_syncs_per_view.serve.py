"""Median count per traced view of the host syncs the program's
``trace.sync`` sites crossed."""

from benchmark.metrics import _trace


def read(record):
    return _trace.unit_median("view", "syncs")
