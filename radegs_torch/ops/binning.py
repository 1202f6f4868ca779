"""Tile binning (port of ``radegs_tpu/ops/binning.py``), in the GPU design of
the reference scheduler (rasterizer_impl.cu:70-173, 350-391):

1. ``duplicate``: every Gaussian owns a run of ``tiles_touched`` slots, runs
   laid out in DEPTH order (exclusive prefix sum of tile-rect areas over the
   stable depth argsort). Only min(total, instance_budget) slots are
   allocated: when the budget is short, the slots that survive are the first
   ``instance_budget`` of that depth-ordered expansion, so the farthest
   Gaussians lose their trailing tiles (and ``n_overflow`` says how many).
   A slot's offset inside its run enumerates the rect's tiles row-major.
2. ``sort``: one stable ``torch.sort`` of the 64-bit key
   ``tile << 32 | float-bits(depth)`` (rasterizer_impl.cu:102-107); equal
   depths keep the expansion order, i.e. gaussian-id order.
3. ``ranges``: per-tile [start, count) by binary search of the sorted tile
   ids (identifyTileRanges, rasterizer_impl.cu:151-173; a histogram's atomics
   were slower on the card), each run cut to ``max_per_tile``
   (``tile_overflow`` counts the cut).

The JAX package's owner merge, sort sentinels and feature riding exist only
because XLA needs static shapes; they have no counterpart here. The layout
differs in one way: the JAX ``tile_start`` also counts one sort sentinel per
earlier tile.

With the 2D conic and opacity given, two exact work cuts are applied (the
blend skips contributors with alpha < 1/255, so a tile whose best pixel is
below that renders identically without them):

- **opacity-aware ellipse AABB**: the alpha >= 1/255 level set Q(d) <= tau,
  tau = 2 ln(255 op), has axis extents sqrt(tau * cov_kk), intersected with
  the reference's 3-sigma radius;
- **exact per-tile test**: a tile is kept only if min_{d in tile} Q(d) <= tau
  (the minimum of a convex quadratic over a rectangle is at the centre or on
  one of the 4 edges).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

TILE = 16
ALPHA_EPS = 1.0 / 255.0


class TileBinning(NamedTuple):
    gauss_id: torch.Tensor  # (N,) int32 gaussian ids sorted by (tile, depth)
    tile_id: torch.Tensor  # (N,) int32
    tile_start: torch.Tensor  # (T,) int32 first instance of each tile
    tile_count: torch.Tensor  # (T,) int32 instances per tile (<= max_per_tile)
    tile_gauss: torch.Tensor | None  # (T, K') int32 front-to-back, -1 padded
    n_instances: torch.Tensor  # () true duplicate count (pre-budget, pre-cull)
    n_overflow: torch.Tensor  # () instances dropped by the instance budget
    tile_overflow: torch.Tensor  # () instances dropped by the max_per_tile cut
    max_tile_count: torch.Tensor  # () largest per-tile count before the cut
    n_culled: torch.Tensor  # () instances removed by the exact tile test


def tile_grid(width: int, height: int, tile: int = TILE):
    return (width + tile - 1) // tile, (height + tile - 1) // tile


def gaussian_rects(xy, radius, tiles_x: int, tiles_y: int, tile: int = TILE,
                   extent_x=None, extent_y=None):
    """Per-Gaussian tile rect [min, max) and touched count (auxiliary.h:62-72,
    forward.cu:399-403). ``extent_x/y`` override the circular radius with
    per-axis ellipse extents (already min'd with radius by the caller)."""
    ex = radius if extent_x is None else extent_x
    ey = radius if extent_y is None else extent_y

    def clip(v, hi):
        return torch.clamp(v, 0, hi).to(torch.int32)

    rx_min = clip(torch.floor((xy[:, 0] - ex) / tile), tiles_x)
    ry_min = clip(torch.floor((xy[:, 1] - ey) / tile), tiles_y)
    # exclusive max = tile of the last covered coordinate + 1
    rx_max = clip(torch.floor((xy[:, 0] + ex) / tile) + 1, tiles_x)
    ry_max = clip(torch.floor((xy[:, 1] + ey) / tile) + 1, tiles_y)
    w = torch.clamp_min(rx_max - rx_min, 0)
    h = torch.clamp_min(ry_max - ry_min, 0)
    return rx_min, ry_min, w, h, w * h


def _q_min_over_rect(cx, cy, a, b, c, x0, x1, y0, y1):
    """min over [x0,x1]x[y0,y1] of Q(d) = a dx^2 + 2 b dx dy + c dy^2 with
    d = p - (cx, cy): 0 if the centre is inside, else the least of the four
    edge minima (each 1D minimiser has a closed form)."""
    dx0, dx1 = x0 - cx, x1 - cx
    dy0, dy1 = y0 - cy, y1 - cy
    a_s = torch.clamp_min(a, 1e-12)
    c_s = torch.clamp_min(c, 1e-12)

    def q(dx, dy):
        return a * dx * dx + 2.0 * b * dx * dy + c * dy * dy

    def edge_x(dxe):  # dx fixed at an x-edge, minimise over dy
        return q(dxe, torch.clamp(-b * dxe / c_s, dy0, dy1))

    def edge_y(dye):
        return q(torch.clamp(-b * dye / a_s, dx0, dx1), dye)

    qmin = torch.minimum(torch.minimum(edge_x(dx0), edge_x(dx1)),
                         torch.minimum(edge_y(dy0), edge_y(dy1)))
    inside = (dx0 <= 0) & (dx1 >= 0) & (dy0 <= 0) & (dy1 >= 0)
    return torch.where(inside, 0.0, qmin)


def _depth_bits(depth):
    """float32 -> int64 in [0, 2^32) with the same order (-0.0 == 0.0)."""
    bits = (depth + 0.0).view(torch.int32).to(torch.int64)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF) + (1 << 31)


def bin_gaussians(
    xy,
    radius,
    depth,
    valid,
    width: int,
    height: int,
    instance_budget: int,
    max_per_tile: int,
    tile: int = TILE,
    conic=None,
    opacity=None,
    need_tile_gauss: bool = False,
) -> TileBinning:
    """Build the tile work lists.

    xy, radius, depth, valid: (P,) preprocess outputs; ``instance_budget``
    caps the (gaussian, tile) pairs, ``max_per_tile`` each tile's run.
    ``conic`` (P,3) and ``opacity`` (P,) enable the exact work cuts.
    ``need_tile_gauss`` builds the rectangular (T, K') layout the plain blend
    walks, K' = the longest run after the cut."""
    dev = xy.device
    tiles_x, tiles_y = tile_grid(width, height, tile)
    num_tiles = tiles_x * tiles_y

    precise = conic is not None and opacity is not None
    if precise:
        op = opacity[:, 0] if opacity.dim() == 2 else opacity
        tau = torch.clamp_min(2.0 * torch.log(torch.clamp_min(op, 1e-12) / ALPHA_EPS), 0.0)
        a, b, c = conic[:, 0], conic[:, 1], conic[:, 2]
        det = torch.clamp_min(a * c - b * b, 1e-24)
        # cov = conic^-1: cov00 = c/det, cov11 = a/det
        ex = torch.minimum(torch.sqrt(tau * c / det), radius)
        ey = torch.minimum(torch.sqrt(tau * a / det), radius)
        rx_min, ry_min, w, h, touched = gaussian_rects(
            xy, radius, tiles_x, tiles_y, tile, extent_x=ex, extent_y=ey)
    else:
        rx_min, ry_min, w, h, touched = gaussian_rects(xy, radius, tiles_x, tiles_y, tile)
    alive = valid & (radius > 0) & (touched > 0)
    touched = torch.where(alive, touched, 0).to(torch.int64)

    # --- duplicate: runs in depth order (dead gaussians last, zero-length) ---
    depth_key = torch.where(alive, depth, torch.inf)
    perm = torch.sort(depth_key, stable=True).indices
    run_end = torch.cumsum(touched[perm], 0)  # inclusive
    total = run_end[-1] if run_end.numel() else torch.zeros((), dtype=torch.int64, device=dev)
    n_slots = min(int(total), instance_budget)  # the one host sync of binning

    slot = torch.arange(n_slots, dtype=torch.int64, device=dev)
    run = torch.searchsorted(run_end, slot, right=True)  # owning run per slot
    g = perm[run]
    within = slot - (run_end[run] - touched[g])
    wg = torch.clamp_min(w, 1)[g].to(torch.int64)
    qd = torch.div(within, wg, rounding_mode="floor")
    ty = ry_min[g].to(torch.int64) + qd
    tx = rx_min[g].to(torch.int64) + within - qd * wg
    keep = torch.ones_like(slot, dtype=torch.bool)
    if precise:
        x0 = (tx * tile).to(torch.float32)
        y0 = (ty * tile).to(torch.float32)
        qmin = _q_min_over_rect(xy[g, 0], xy[g, 1], a[g], b[g], c[g],
                                x0, x0 + (tile - 1), y0, y0 + (tile - 1))
        # tiny slack so borderline alpha ~ 1/255 contributors never flip
        # between binning (f32) and the blend's threshold test
        keep = qmin <= tau[g] * (1.0 + 1e-5) + 1e-6
    n_culled = (~keep).sum()

    # --- sort by the 64-bit [tile | depth] key ---
    g, tile_k = g[keep], (ty * tiles_x + tx)[keep]
    key = (tile_k << 32) | _depth_bits(depth[g])
    order = torch.sort(key, stable=True).indices
    gauss_id = g[order].to(torch.int32)
    tile_id = tile_k[order].to(torch.int32)

    # --- per-tile ranges: the sorted tile ids' boundaries ---
    bounds = torch.searchsorted(
        tile_id, torch.arange(num_tiles + 1, dtype=torch.int32, device=dev))
    tile_start = bounds[:-1].to(torch.int32)
    count_full = bounds[1:] - bounds[:-1]
    tile_count = torch.clamp_max(count_full, max_per_tile).to(torch.int32)

    tile_gauss = None
    if need_tile_gauss:
        K = int(tile_count.max()) if num_tiles else 0
        cols = torch.arange(K, dtype=torch.int64, device=dev)
        idx = tile_start.to(torch.int64)[:, None] + cols[None, :]
        ok = cols[None, :] < tile_count[:, None]
        src = gauss_id[idx.clamp_max(max(gauss_id.numel() - 1, 0))]  # (T, K)
        tile_gauss = torch.where(ok, src, -1).to(torch.int32)

    return TileBinning(
        gauss_id=gauss_id,
        tile_id=tile_id,
        tile_start=tile_start,
        tile_count=tile_count,
        tile_gauss=tile_gauss,
        n_instances=total,
        n_overflow=torch.clamp_min(total - instance_budget, 0),
        tile_overflow=(count_full - tile_count).sum(),
        max_tile_count=count_full.max(),
        n_culled=n_culled,
    )


def default_instance_budget(num_points: int, multiplier: int = 8, minimum: int = 1 << 14) -> int:
    """Heuristic budget: ~multiplier tiles per Gaussian, padded to a power of two."""
    b = max(minimum, num_points * multiplier)
    return 1 << (b - 1).bit_length()


BUDGET_SEG = 1 << 21  # segment granularity of the JAX package's budget buckets
MAX_INSTANCE_BUDGET = 1 << 24
MAX_PER_TILE_CAP = 1 << 14  # the largest max_per_tile the work-buffer policies grow to


def round_budget(need: int, minimum: int = 1 << 14) -> int:
    """Round a measured instance demand up to the JAX package's budget
    buckets: powers of two up to one 2M segment, 2M multiples above, capped
    at 2^24."""
    need = max(int(need), minimum)
    if need <= BUDGET_SEG:
        return 1 << (need - 1).bit_length()
    segs = -(-need // BUDGET_SEG)
    return min(segs * BUDGET_SEG, MAX_INSTANCE_BUDGET)
