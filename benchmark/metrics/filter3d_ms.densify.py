"""Median over the window's events of the device ms of the 3D filter
refresh, between the event's ``densify.prune`` and ``densify.filter3d``
marks."""

from benchmark.metrics import _densify


def read(record):
    return _densify.median_of(record, lambda e: e.get("filter3d_ms"))
