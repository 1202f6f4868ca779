"""The least time a densification event could take, from its row counts
alone: the bytes it has to move at the H100's HBM3 peak
(``roofline.PEAK_BYTES``). A lower bound, so its share of an event's
device time cannot pass 100%:

- each active row before the event read once: its parameters, both Adam
  moments and its five statistics;
- each active row after it written once: its parameters, moments and
  statistics;
- the filter refresh: each row's position read once and its filter written
  once, not once a camera.

The capacity's padding and the inactive rows are not counted.
"""

from __future__ import annotations

from benchmark.roofline import PEAK_BYTES

N_STATS = 5


def param_floats(sh_degree: int) -> int:
    """Floats of a row's parameters: xyz, the SH coefficients, scaling,
    rotation, opacity."""
    return 3 + 3 * (sh_degree + 1) ** 2 + 3 + 4 + 1


def least_bytes(n_before: int, n_after: int, sh_degree: int) -> int:
    row = 3 * param_floats(sh_degree) + N_STATS
    return 4 * (row * n_before + row * n_after + (3 + 1) * n_after)


def least_s(n_before: int, n_after: int, sh_degree: int) -> float:
    return least_bytes(n_before, n_after, sh_degree) / PEAK_BYTES
