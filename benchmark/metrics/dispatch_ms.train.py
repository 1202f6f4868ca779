"""Median host ms per traced step of the program's ``step`` span, less the ms
it spent blocked in ``trace.sync``: the step's dispatch."""

from benchmark.metrics import _trace


def read(record):
    return _trace.unit_median("step", "dispatch_ms")
