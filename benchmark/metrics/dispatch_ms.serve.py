"""Median host ms per traced view of the program's ``view`` span, less the ms
it spent blocked in ``trace.sync``: the view's dispatch."""

from benchmark.metrics import _trace


def read(record):
    return _trace.unit_median("view", "dispatch_ms")
