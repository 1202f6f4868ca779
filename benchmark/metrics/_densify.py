"""Shared reading of a densify run's events: the record's ``events`` (each
traced window event's device ms from the program's CUDA-event marks and
its least time, ``benchmark/densify_bytes.py``) and the program's
``densify.*`` gauges, which its tracer sets once an event in a unit of
kind ``train.densify``. None where the run traced no event."""

from __future__ import annotations

import statistics


def median_of(record, fn):
    vals = [v for v in (fn(e) for e in record.get("events", [])) if v is not None]
    return statistics.median(vals) if vals else None


def gauged_events() -> list:
    """The gauges of each traced event unit, in order."""
    try:
        from radegs_torch.utils import trace
    except ImportError:
        return []
    return [u["gauges"] for u in trace.units() if u["kind"] == "train.densify"]
