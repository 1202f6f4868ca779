"""aten:: op calls per traced view, from the profiler's host ops."""


def read(record):
    return record.get("aten_ops_per_step")
