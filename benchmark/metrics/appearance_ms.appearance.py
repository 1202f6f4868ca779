"""Median ms of the appearance forward: the crop, its downsample, the
view's embedding, the network and the multiply (CUDA-event marks, from the
render's ``render`` mark to ``appearance``)."""

from benchmark.metrics import _read


def read(record):
    return _read.stage(record, "appearance")
