"""Tile binning (port of ``radegs_tpu/ops/binning.py``), in the GPU design of
the reference scheduler (rasterizer_impl.cu:70-173, 350-391). The plain
version (``bin_gaussians_torch``, the CPU's path):

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

On a card (``bin_gaussians_kernel``, ``csrc/binning.cu``) a kernel counts
each row's kept tiles, their scan gives each row its offset, and one host
read of the totals sizes the lists. A kernel writes the keys in row order,
one stable sort orders them and a ranges kernel cuts the runs: within a
tile a row appears once and equal keys are equal depths, which both orders
leave in row order, so the lists are the plain version's. Where the budget
would cut, the depth order of the rows says which of each row's tiles
survive (``budget_allow``), and the count and duplicate kernels walk only
those.

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

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from radegs_torch.native import build
from radegs_torch.utils import trace
from radegs_torch.utils.device import on_device

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
    walks, K' = the longest run after the cut.

    On a card the kernels of ``csrc/binning.cu`` (``bin_gaussians_kernel``);
    on the CPU the plain version (``bin_gaussians_torch``). Both give the
    same lists."""
    fn = bin_gaussians_kernel if xy.device.type == "cuda" else bin_gaussians_torch
    return fn(xy, radius, depth, valid, width, height, instance_budget, max_per_tile, tile,
              conic, opacity, need_tile_gauss)


def _tile_gauss(tile_start, tile_count, gauss_id):
    """The (T, K') layout of the lists, K' the longest run after the cut,
    -1 padded (one host sync: K')."""
    dev = tile_count.device
    with trace.sync("binning.max_tile_count"):
        K = int(tile_count.max()) if tile_count.numel() else 0
    cols = torch.arange(K, dtype=torch.int64, device=dev)
    idx = tile_start.to(torch.int64)[:, None] + cols[None, :]
    ok = cols[None, :] < tile_count[:, None]
    src = gauss_id[idx.clamp_max(max(gauss_id.numel() - 1, 0))]  # (T, K)
    return torch.where(ok, src, -1).to(torch.int32)


def bin_gaussians_torch(xy, radius, depth, valid, width: int, height: int,
                        instance_budget: int, max_per_tile: int, tile: int = TILE, conic=None,
                        opacity=None, need_tile_gauss: bool = False) -> TileBinning:
    """``bin_gaussians`` as the plain version, on any device: the runs laid
    out in depth order, so a short budget cuts the farthest Gaussians'
    trailing tiles."""
    with trace.span("binning"):
        dev = xy.device
        tiles_x, tiles_y = tile_grid(width, height, tile)
        num_tiles = tiles_x * tiles_y

        # --- depth order of the live Gaussians, and their runs' ends ---
        with trace.span("binning.depth_sort"):
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
            depth_key = torch.where(alive, depth, torch.inf)
            perm = torch.sort(depth_key, stable=True).indices
            run_end = torch.cumsum(touched[perm], 0)  # inclusive
            total = (run_end[-1] if run_end.numel()
                     else torch.zeros((), dtype=torch.int64, device=dev))

        # --- duplicate: runs in depth order (dead gaussians last, zero-length) ---
        with trace.span("binning.duplicate"):
            # the first of the plain version's host syncs (and, with tile_gauss,
            # the longest run): the slot count sizes the buffers
            with trace.sync("binning.total"):
                n_total = int(total)
            n_slots = min(n_total, instance_budget)
            trace.gauge("binning", "instances", n_total)  # the view's demand
            trace.gauge("binning", "budget_cut", n_total - n_slots)
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
        with trace.span("binning.sort"):
            with trace.sync("binning.keep", 2):  # each boolean index is a nonzero
                g, tile_k = g[keep], (ty * tiles_x + tx)[keep]
            key = (tile_k << 32) | _depth_bits(depth[g])
            order = torch.sort(key, stable=True).indices
            gauss_id = g[order].to(torch.int32)
            tile_id = tile_k[order].to(torch.int32)

        # --- per-tile ranges: the sorted tile ids' boundaries ---
        with trace.span("binning.ranges"):
            bounds = torch.searchsorted(
                tile_id, torch.arange(num_tiles + 1, dtype=torch.int32, device=dev))
            tile_start = bounds[:-1].to(torch.int32)
            count_full = bounds[1:] - bounds[:-1]
            tile_count = torch.clamp_max(count_full, max_per_tile).to(torch.int32)
            tile_gauss = _tile_gauss(tile_start, tile_count, gauss_id) if need_tile_gauss else None

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


# launches of csrc/binning.cu's C entry by stage, counted where the wrapper
# launches it (the tracer's group "launches.binning"); "binning.budget_path"
# counts the card's views whose demand passed the instance budget (their
# count kernel runs twice, the second time cut to ``budget_allow``)
STAGES = ("binning_count", "binning_duplicate", "binning_ranges")
LAUNCHES = trace.counters("launches.binning", STAGES)
BUDGET_PATH = trace.counters("binning", ("budget_path",))
# PyTorch's CUDA ``tensor / float``: a product with the float32 reciprocal
INV_ALPHA = float(np.float32(1.0) / np.float32(ALPHA_EPS))
N_PTR = 19  # the C entry's pointer table


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    BUDGET_PATH["budget_path"] = 0


def _entry():
    return build.entry("binning", 1, 15, 2)


def _row_args(xy, radius, depth, valid, conic, opacity):
    """The kernels' row inputs, checked: their pointers (conic and opacity
    None without the exact cuts) and element strides, in the C entry's
    order. Any stride is taken, so the table's columns go as they are."""
    dev, P, f32 = xy.device, xy.shape[0], torch.float32
    if conic is None or opacity is None:
        conic = opacity = None
    elif opacity.dim() == 2:
        opacity = opacity[:, 0]
    for name, x, dtype, shape in (("xy", xy, f32, (P, 2)), ("radius", radius, f32, (P,)),
                                  ("depth", depth, f32, (P,)),
                                  ("valid", valid, torch.bool, (P,)),
                                  ("conic", conic, f32, (P, 3)), ("opacity", opacity, f32, (P,))):
        if x is not None and (x.device != dev or x.dtype != dtype or tuple(x.shape) != shape):
            raise ValueError(f"binning kernel input {name} must be a {dtype} tensor of shape "
                             f"{shape} on {dev}; got {x.dtype} {tuple(x.shape)} on {x.device}")
    ptrs = [None if x is None else x.data_ptr()
            for x in (xy, radius, depth, valid, conic, opacity)]
    strides = (*xy.stride(), radius.stride(0), depth.stride(0), valid.stride(0),
               *(conic.stride() if conic is not None else (0, 0)),
               opacity.stride(0) if opacity is not None else 0)
    return ptrs, strides


class _Pass(NamedTuple):
    """A view's binning on the card between its stages: the C entry's
    pointer table (slot -> pointer), its row strides and geometry, and the
    tensors it points to that the count stage made or took (held here until
    the last stage is launched)."""
    ptrs: dict
    P: int
    T: int
    strides: tuple
    geometry: tuple  # tiles_x, tiles_y, tile, max_per_tile
    inv_tile: float
    counters: torch.Tensor  # (6,) int64, the entry's counters
    kept: torch.Tensor  # (P,) int32 kept tiles a row
    incl: torch.Tensor  # (P,) int32 their inclusive scan
    touched: torch.Tensor | None  # (P,) int32 tiles a row before any cut (no allow)
    allow: torch.Tensor | None  # (P,) int32 the tiles a row walks (a budget cut)


def _launch(stage: int, ps: _Pass, n: int):
    """One call of the C entry (the slots ``ps.ptrs`` lacks are null)."""
    table = (ctypes.c_void_p * N_PTR)(*(ps.ptrs.get(k) for k in range(N_PTR)))
    rc = _entry()(ctypes.addressof(table), stage, ps.P, n, *ps.strides, *ps.geometry,
                  ps.inv_tile, INV_ALPHA, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{STAGES[stage]} kernel launch failed with CUDA error {rc}")
    trace.count("launches.binning", STAGES[stage])


def count_stage(xy, radius, depth, valid, width: int, height: int, max_per_tile: int,
                tile: int = TILE, conic=None, opacity=None, allow=None) -> _Pass:
    """The count kernel over the rows and the scan of its counts, with no
    host sync: the counters' first two read the instances walked and kept
    once the device reaches them. Without ``allow`` a row walks its whole
    rect, and its tiles are kept in ``touched``; with it, (P,) int32, the
    first ``allow[i]`` tiles of row i's rect."""
    tiles_x, tiles_y = tile_grid(width, height, tile)
    rows, strides = _row_args(xy, radius, depth, valid, conic, opacity)
    P, dev = xy.shape[0], xy.device
    # [0] instances walked (before the exact test), [1] kept, [2] culled,
    # [3] the budget's overflow (0 here), [4] the longest tile, [5]
    # max_per_tile's drops
    counters = torch.zeros(6, dtype=torch.int64, device=dev)
    kept = torch.empty(P, dtype=torch.int32, device=dev)
    ptrs = dict(enumerate(rows)) | {6: kept.data_ptr(), 8: counters.data_ptr()}
    touched = None
    if allow is None:
        touched = torch.empty(P, dtype=torch.int32, device=dev)
        ptrs[17] = touched.data_ptr()
    else:
        if allow.device != dev or allow.dtype != torch.int32 or tuple(allow.shape) != (P,):
            raise ValueError(f"binning kernel input allow must be an int32 tensor of shape "
                             f"({P},) on {dev}")
        ptrs[18] = allow.data_ptr()
    ps = _Pass(ptrs, P, tiles_x * tiles_y, strides, (tiles_x, tiles_y, tile, max_per_tile),
               float(np.float32(1.0) / np.float32(tile)), counters, kept, None, touched, allow)
    _launch(0, ps, 0)
    incl = torch.cumsum(kept, 0, dtype=torch.int32)
    return ps._replace(ptrs=ps.ptrs | {7: incl.data_ptr()}, incl=incl)


def list_stage(ps: _Pass, n: int):
    """The lists of ``n`` kept instances: the duplicate kernel, the stable
    sort of its keys, the ranges kernels. Returns gauss_id, tile_id,
    tile_start, tile_count."""
    dev, i32 = ps.kept.device, torch.int32
    keys = torch.empty(n, dtype=torch.int64, device=dev)
    ids = torch.empty(n, dtype=i32, device=dev)
    ptrs = ps.ptrs | {9: keys.data_ptr(), 10: ids.data_ptr()}
    _launch(1, ps._replace(ptrs=ptrs), n)
    skeys, order = torch.sort(keys, stable=True)
    tile_id, gauss_id = torch.empty_like(ids), torch.empty_like(ids)
    bounds = torch.empty(ps.T + 1, dtype=i32, device=dev)
    tile_count = torch.empty(ps.T, dtype=i32, device=dev)
    ptrs |= {11: skeys.data_ptr(), 12: order.data_ptr(), 13: tile_id.data_ptr(),
             14: gauss_id.data_ptr(), 15: bounds.data_ptr(), 16: tile_count.data_ptr()}
    _launch(2, ps._replace(ptrs=ptrs), n)
    return gauss_id, tile_id, bounds[:ps.T], tile_count


def budget_allow(touched, depth, instance_budget: int):
    """Each row's share of a short instance budget, as the plain version
    cuts it: the rows' runs of ``touched`` tiles laid end to end in stable
    depth order (rows with no tile last) and the first ``instance_budget``
    slots kept, so row i keeps the first allow[i] of its rect's tiles
    (row-major) and the farthest rows lose their trailing ones."""
    t = touched.to(torch.int64)
    perm = torch.sort(torch.where(touched > 0, depth, torch.inf), stable=True).indices
    run = t[perm]
    start = torch.cumsum(run, 0) - run
    allow = torch.empty_like(touched)
    allow[perm] = torch.minimum(torch.clamp_min(instance_budget - start, 0), run).to(torch.int32)
    return allow


def bin_gaussians_kernel(xy, radius, depth, valid, width: int, height: int,
                         instance_budget: int, max_per_tile: int, tile: int = TILE,
                         conic=None, opacity=None, need_tile_gauss: bool = False) -> TileBinning:
    """``bin_gaussians`` on a card (CUDA tensors only): a count of each
    row's kept tiles, its scan and one host read of the totals; then the
    rows' keys written in row order, one stable sort and the ranges pass,
    which give the plain version's lists. Where the demand passes
    ``instance_budget`` (counted in ``BUDGET_PATH``), the count runs again
    on each row's ``budget_allow`` share, with a second host read of the
    kept total, and the duplicate kernel walks the same share."""
    dev = xy.device
    if dev.type != "cuda":
        raise ValueError(f"the binning kernels run on cuda tensors, not {dev}")
    if instance_budget >= 1 << 31:
        raise ValueError(f"the binning kernels' offsets are int32: instance budget "
                         f"{instance_budget} >= 2^31")
    with trace.span("binning"), on_device(dev):
        ps = count_stage(xy, radius, depth, valid, width, height, max_per_tile, tile, conic,
                         opacity)
        with trace.sync("binning.total"):  # binning's one host sync within its budget
            n_total, n_kept = ps.counters[:2].tolist()
        trace.gauge("binning", "instances", n_total)  # the view's demand
        trace.gauge("binning", "budget_cut", max(n_total - instance_budget, 0))
        n_instances, n_overflow = ps.counters[0], ps.counters[3]
        if n_total > instance_budget:
            trace.count("binning", "budget_path")
            ps = count_stage(xy, radius, depth, valid, width, height, max_per_tile, tile, conic,
                             opacity, allow=budget_allow(ps.touched, depth, instance_budget))
            n_overflow = n_instances - instance_budget
            with trace.sync("binning.budget"):
                n_kept = int(ps.counters[1])
        gauss_id, tile_id, tile_start, tile_count = list_stage(ps, n_kept)
        c = ps.counters
        return TileBinning(
            gauss_id=gauss_id,
            tile_id=tile_id,
            tile_start=tile_start,
            tile_count=tile_count,
            tile_gauss=_tile_gauss(tile_start, tile_count, gauss_id) if need_tile_gauss else None,
            n_instances=n_instances,
            n_overflow=n_overflow,
            tile_overflow=c[5],
            max_tile_count=c[4],
            n_culled=c[2],
        )


def default_instance_budget(num_points: int, multiplier: int = 8, minimum: int = 1 << 14) -> int:
    """Heuristic budget: ~multiplier tiles per Gaussian, padded to a power of two."""
    b = max(minimum, num_points * multiplier)
    return 1 << (b - 1).bit_length()


BUDGET_SEG = 1 << 21  # segment granularity of the JAX package's budget buckets
MAX_INSTANCE_BUDGET = 1 << 24  # the JAX package's ceiling: budget_cap's up to capacity 2^21
# the largest max_per_tile the work-buffer policies grow to; the JAX package
# stops at 2^14, which the deepest tiles of a 6M-splat scene exceed
MAX_PER_TILE_CAP = 1 << 16


def budget_cap(capacity: int) -> int:
    """The ceiling the budget policies grow an instance budget to, for a state
    of ``capacity`` rows: ``MAX_INSTANCE_BUDGET`` (the JAX package's), or the
    capacity's default budget where that is larger (2^26 at 2^23)."""
    return max(MAX_INSTANCE_BUDGET, default_instance_budget(capacity))


def round_budget(need: int, minimum: int = 1 << 14, cap: int | None = None) -> int:
    """Round a measured instance demand up to the JAX package's budget
    buckets: powers of two up to one 2M segment, 2M multiples above, capped
    at ``cap`` (default ``MAX_INSTANCE_BUDGET``, 2^24)."""
    cap = MAX_INSTANCE_BUDGET if cap is None else cap
    need = max(int(need), minimum)
    if need <= BUDGET_SEG:
        return 1 << (need - 1).bit_length()
    segs = -(-need // BUDGET_SEG)
    return min(segs * BUDGET_SEG, cap)
