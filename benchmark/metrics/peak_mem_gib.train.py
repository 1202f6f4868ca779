"""The window's peak of torch.cuda.max_memory_allocated, in GiB."""

from benchmark.metrics import _read


def read(record):
    return _read.peak_gib(record)
