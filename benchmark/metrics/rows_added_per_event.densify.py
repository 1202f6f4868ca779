"""Median over the traced events of the rows each added (the program's
``densify.active`` gauge less ``densify.active_before``), in millions."""

import statistics

from benchmark.metrics import _densify


def read(record):
    added = [g["densify.active"] - g["densify.active_before"]
             for g in _densify.gauged_events()
             if "densify.active" in g and "densify.active_before" in g]
    return statistics.median(added) / 1e6 if added else None
