"""Median ms from the blend's end to the loss (normalisation, L1, SSIM, depth-normal term)."""

from benchmark.metrics import _read


def read(record):
    return _read.stage(record, "loss_tail")
