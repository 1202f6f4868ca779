"""Median ms of the appearance Adam (``train/optim.appearance_adam``:
CUDA-event marks from ``stats`` to ``adam.appearance``)."""

from benchmark.metrics import _read


def read(record):
    return _read.stage(record, "appearance_adam")
