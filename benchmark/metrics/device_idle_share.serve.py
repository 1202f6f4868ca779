"""The share of the traced span in which no device op ran, in %."""

from benchmark.metrics import _read


def read(record):
    return _read.idle_share(record)
