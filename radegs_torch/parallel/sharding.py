"""Rank-local placement of the training state (port of
``radegs_tpu/parallel/sharding.py``).

Every rank holds the rows ``[r C/n, (r+1) C/n)`` of each per-Gaussian
(C, ...) tensor: parameters, Adam moments, densification statistics. The
update of a Gaussian is then local to the rank that holds it (model
parallelism over the particle axis, a fully sharded optimiser). Scalars
and the appearance network are replicated.

The JAX package also builds a 2-D (gaussians x tiles) GSPMD mesh, where XLA
inserts the collectives from sharding annotations. PyTorch has no such
compiler pass; the explicit step (``parallel/step.py``) carries the same
purpose with hand-placed collectives, so ``make_mesh`` takes
``tile_parallel=1`` only.
"""

from __future__ import annotations

import math

import torch

from radegs_torch.models import gaussian_model as gm
from radegs_torch.parallel.comm import Mesh1D, all_gather, make_mesh_1d


def make_mesh(tile_parallel: int = 1, backend: str | None = None, device=None) -> Mesh1D:
    """This rank's mesh (``make_mesh_1d``); every rank shards Gaussians and
    renders its own band of tiles, so there is no separate tile axis."""
    if tile_parallel != 1:
        raise ValueError("tile_parallel must be 1: the 2-D GSPMD mesh has no torch "
                         "counterpart; parallel.step bands the tiles over the ranks")
    return make_mesh_1d(backend, device)


def _block(capacity: int, mesh: Mesh1D) -> int:
    if capacity % mesh.world:
        raise ValueError(f"capacity {capacity} is not a multiple of the world size "
                         f"{mesh.world}")
    return capacity // mesh.world


def shard_gaussian_state(state: gm.GaussianState, mesh: Mesh1D) -> gm.GaussianState:
    """This rank's block of a full state: rows [r C/n, (r+1) C/n) of every
    per-slot tensor (copies, so the full state can be freed)."""
    cn = _block(state.capacity, mesh)
    lo = mesh.rank * cn
    return gm.per_slot(state, lambda x: x[lo:lo + cn].clone())


def gather_gaussian_state(state: gm.GaussianState, mesh: Mesh1D) -> gm.GaussianState:
    """The full state from every rank's block (the inverse of
    ``shard_gaussian_state``), on every rank: the per-slot tensors packed
    into one float32 matrix and moved by one ``all_gather``."""
    if mesh.world == 1:
        return state
    parts = []
    gm.per_slot(state, lambda x: parts.append(x) or x)
    cn = state.capacity
    widths = [math.prod(x.shape[1:]) for x in parts]
    packed = torch.cat([x.reshape(cn, w).to(torch.float32) for x, w in zip(parts, widths)],
                       dim=1)
    full = torch.cat(all_gather(packed, mesh))
    ends = iter(torch.tensor(widths).cumsum(0).tolist())
    start = [0]

    def unpack(x):
        a, b = start[0], next(ends)
        start[0] = b
        return full[:, a:b].reshape((full.shape[0],) + x.shape[1:]).to(x.dtype).contiguous()

    return gm.per_slot(state, unpack)


def shard_train_state(ts, mesh: Mesh1D):
    """A ``TrainState`` with this rank's block of the Gaussians (appearance
    parameters and scalars replicated)."""
    return ts.replace(gaussians=shard_gaussian_state(ts.gaussians, mesh))


def gather_train_state(ts, mesh: Mesh1D):
    """A ``TrainState`` with the full Gaussian state, in the layout the ranks
    hold it (strided during training: ``rebalance.to_canonical`` after)."""
    return ts.replace(gaussians=gather_gaussian_state(ts.gaussians, mesh))
