"""The strided layout of the Gaussian state for multi-rank training (port
of ``radegs_tpu/parallel/rebalance.py``).

Densification compacts the active Gaussians to the front of the canonical
(C,) layout, so cutting that layout into contiguous rank blocks puts every
active Gaussian on the first ranks. The strided layout spreads them:
canonical index ``i`` lives on rank ``i mod n`` at position ``i div n``, so
any canonical prefix is split evenly, and the per-rank gather cap
(``PipelineConfig.vis_capacity``) can be sized for ~n_vis / n.

Canonical order stays the order of meaning: densify's draws and
compaction, checkpoints and PLY files are defined on it, so the training
loop converts to canonical around each densification and returns the
canonical state. Between densifications the state stays strided; every
per-Gaussian operation of the step is order-free.
"""

from __future__ import annotations

import torch

from radegs_torch.models import gaussian_model as gm


def strided_perm(capacity: int, n: int, device=None):
    """``perm`` with strided[j] = canonical[perm[j]]: rank s, slot k holds
    canonical index k * n + s (j = s * (C / n) + k)."""
    cn = capacity // n
    j = torch.arange(capacity, dtype=torch.int64, device=device)
    return (j % cn) * n + (j // cn)


def inverse_perm(perm):
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel(), dtype=perm.dtype, device=perm.device)
    return inv


def _check(state: gm.GaussianState, n: int):
    if state.capacity % n:
        raise ValueError(f"capacity {state.capacity} is not a multiple of the world size {n}")


def to_strided(state: gm.GaussianState, n: int) -> gm.GaussianState:
    """Canonical -> strided layout (``n`` must divide the capacity; capacities
    are powers of two, so any power-of-two world does)."""
    _check(state, n)
    perm = strided_perm(state.capacity, n, state.device)
    return gm.per_slot(state, lambda x: x[perm])


def to_canonical(state: gm.GaussianState, n: int) -> gm.GaussianState:
    """Strided -> canonical layout (the inverse of ``to_strided``)."""
    _check(state, n)
    inv = inverse_perm(strided_perm(state.capacity, n, state.device))
    return gm.per_slot(state, lambda x: x[inv])
