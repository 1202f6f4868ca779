"""Median per traced step of the caching allocator's device allocations and
frees (``num_device_alloc`` + ``num_device_free``), read by the program's
tracer at the step's start and end."""

from benchmark.metrics import _trace


def read(record):
    return _trace.unit_median("step", "allocs")
