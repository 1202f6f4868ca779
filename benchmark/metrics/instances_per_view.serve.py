"""Median per traced view of the (Gaussian, tile) instances the view's
binning met before the instance budget, in millions: the program's
``binning.instances`` gauge, read at its existing ``binning.total``
sync. None where the program has no such gauge."""

from benchmark.metrics import _trace


def read(record):
    gauges = _trace.unit_median("view", "gauges")
    n = None if gauges is None else gauges.get("binning.instances")
    return None if n is None else n / 1e6
