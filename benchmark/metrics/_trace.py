"""Shared reading of the program's own tracer (``radegs_torch.utils.trace``)
for the per-layer readers of its spans and counters. ``summary()`` covers
the units the process traced: in a ``--trace 1`` run, the steps or views of
the window, which pass ``events=``. A program without the tracer, or a run
that traced no unit of the kind, gives None.
"""

from __future__ import annotations


def unit_median(kind: str, key: str):
    """The median per unit ``kind`` (``step``, ``view``) of the summary's
    ``key``, or None."""
    try:
        from radegs_torch.utils import trace
    except ImportError:
        return None
    u = trace.summary().get("units", {}).get(kind)
    return None if u is None else u.get(key)
