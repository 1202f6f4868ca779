"""Median over the window's events of the device ms from the step's last
mark to the event's ``densify`` mark (CUDA-event marks)."""

from benchmark.metrics import _densify


def read(record):
    return _densify.median_of(record, lambda e: e.get("densify_ms"))
