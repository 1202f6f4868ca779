"""Shared arithmetic of the per-layer readers. Each reader, ``<metric>.py``
beside this file, has ``read(record) -> float | None`` over a traced run's
record (``jobs.py``): the program's stage marks (``stages``, median ms),
the reduced profiler trace (``busy_s``, ``window_s``, ``kernels``,
``aten_ops_per_step``), the least times of the traced views (``least``) and
the window's peak (``peak_window_bytes``). A reader that finds nothing
returns None, and the metric is left out of the line.
"""

from __future__ import annotations

from benchmark import tracing

# the device ops of each kernel, by the kernels' names in csrc/
KERNEL_NAMES = {"blend_fwd": ("blend_fwd_kernel",),
                "blend_bwd": ("blend_bwd_kernel", "grad_segment_sum")}


def stage(record, name):
    return record.get("stages", {}).get(name)


def roofline(record, kernel):
    """100 x the traced views' least time over the kernel's device time."""
    t = tracing.kernel_seconds(record.get("kernels", {}), *KERNEL_NAMES[kernel])
    least = record.get("least", {}).get(kernel)
    if not t or least is None:
        return None
    return 100.0 * least / t


def idle_share(record):
    w = record.get("window_s")
    return 100.0 * (1.0 - record["busy_s"] / w) if w else None


def peak_gib(record):
    b = record.get("peak_window_bytes")
    return b / 2 ** 30 if b else None
