"""Median over the window's events of the event's least time (its bytes at
the HBM peak, ``benchmark/densify_bytes.py``) over its device time, in %."""

from benchmark.metrics import _densify


def read(record):
    def share(e):
        ms = e.get("densify_ms")
        return 100.0 * e["least_s"] / (ms * 1e-3) if ms else None

    return _densify.median_of(record, share)
