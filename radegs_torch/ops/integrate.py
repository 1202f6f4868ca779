"""Point-opacity integration for Marching-Tetrahedra mesh extraction (port
of ``radegs_tpu/ops/integrate.py``; reference ``integrateCUDA``
forward.cu:938-1372 and ``preprocessPointsCUDA`` forward.cu:856-931).

- Phase A (``integrate_image``: the CUDA kernel ``csrc/integrate_image.cu``
  on the card, ``integrate_image_torch`` on the CPU) renders the 9-channel
  image [0:3 colour, 3 expected-depth sum, 4 median depth, 5 unused, 6 max
  depth, 7 alpha, 8 projected points] at pixel CENTRES (+0.5,
  forward.cu:982), tracking per pixel five sub-pixel transmittances (centre
  + 4 corners at +-0.5 px, forward.cu:1019-1021) and the median plane
  (``mid_*``) the point SDF reads.
- Phase B (``integrate_points``: ``csrc/integrate_points.cu`` on the card,
  ``integrate_points_torch`` on the CPU) walks, for every query point, its
  tile's depth-sorted list with the corner-transmittance "used" gate of
  phase A at the point's pixel centre, and accumulates the ray-space 3D
  opacity alpha = min(0.99, o exp(-1/2 d^T invraycov d)),
  d = (dx, dy, t_c - min(t_point, t_at_point)), front to back into the
  point's transmittance (forward.cu:1300-1339).

A corner whose T (1 - alpha) would fall below 1e-4 SKIPS that contributor
and keeps walking (forward.cu:1063-1086): the blend's termination does not
apply here. Binning uses the 3-sigma radius rects only (no exact per-tile
cut: the corner samples reach x0 + 16, past the cut's integer pixels).
No gradients flow through integration.
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import torch

from radegs_torch.core.projection import NEAR_PLANE, PreprocessOut
from radegs_torch.native import build
from radegs_torch.ops.binning import (
    TILE,
    TileBinning,
    bin_gaussians,
    default_instance_budget,
    tile_grid,
)
from radegs_torch.ops.rasterize import untile

ALPHA_EPS = 1.0 / 255.0
T_EPS = 1e-4
MAX_ALPHA = 0.99
# sub-pixel offsets: centre + 4 corners (forward.cu:1020-1021)
OFFS_X = (0.0, -0.5, 0.5, -0.5, 0.5)
OFFS_Y = (0.0, -0.5, -0.5, 0.5, 0.5)
MID_KEYS = ("mid_dc", "mid_p0", "mid_p1", "mid_x", "mid_y")
# rows of the (T, 13, 256) phase-A output (pallas_integrate.py:399-405
# without its padding): 0:3 colour, 3 expected depth, 4 median depth, 5 max
# depth, 6 alpha, 7 centre transmittance T0, 8:13 the median plane
N_IMG = 13
# the feature rows, each padded to a whole number of float4 after its last
# column, skip_below (``skip_below``), which only the kernels read
N_IMG_FEAT = 16  # xy 2, conic 3, opacity, rgb 3, ts, ray_plane 2, skip_below
N_PT_FEAT = 20  # xy 2, conic 3, opacity, ts, ray_plane 2, invraycov sym6, cond, skip_below
# below ln(ALPHA_EPS / opacity) by this margin, a power surely gives alpha < 1/255
SKIP_MARGIN = 1e-3
POINTS_PER_ITEM = 32  # points of one tile walked by one warp (ITEM in the kernel)
# the corner lattice of a tile: its pixels' corners at +-0.5 px are the
# integer points (x0 + a, y0 + b), a, b in 0..16
LATTICE = TILE + 1

# kernel launches, counted by the wrappers where they launch a kernel and
# nowhere else
LAUNCHES = {"integrate_image": 0, "integrate_points": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class PointProjection(NamedTuple):
    valid: torch.Tensor  # (N,) inside the frustum and the image
    xy: torch.Tensor  # (N, 2) pixel coordinates
    depth: torch.Tensor  # (N,) ray distance |p_view|
    pixel: torch.Tensor  # (N, 2) int64 pixel indices
    tile: torch.Tensor  # (N,) int64 tile id


def project_points(points3d, camera) -> PointProjection:
    """preprocessPointsCUDA (forward.cu:856-931)."""
    viewmat = camera.world_view
    p_view = points3d @ viewmat[:3, :3].T + viewmat[:3, 3]
    z = torch.where(p_view[:, 2] > 0, p_view[:, 2], 1e-7)
    fx, fy = camera.focal_x, camera.focal_y
    W, H = camera.width, camera.height
    px = fx * p_view[:, 0] / (z + 1e-7) + W / 2.0
    py = fy * p_view[:, 1] / (z + 1e-7) + H / 2.0
    inside = (px >= 0) & (px < W) & (py >= 0) & (py < H)
    valid = (p_view[:, 2] > NEAR_PLANE) & inside
    depth = torch.linalg.vector_norm(p_view, dim=-1)
    pi = torch.clamp(torch.floor(px).to(torch.int64), 0, W - 1)
    pj = torch.clamp(torch.floor(py).to(torch.int64), 0, H - 1)
    tiles_x, _ = tile_grid(W, H)
    tile = (pj // TILE) * tiles_x + (pi // TILE)
    return PointProjection(valid, torch.stack([px, py], -1), depth,
                           torch.stack([pi, pj], -1), tile)


def skip_below(opacity):
    """Per Gaussian of float32 ``opacity``, a power below which its alpha
    min(0.99, o exp(power)) is surely under 1/255, so a sample there skips it
    without the exp: ln(ALPHA_EPS / o) - SKIP_MARGIN in float64, rounded
    down to float32; +inf where o <= 0 (alpha 0 everywhere). The margin is
    ~1e4 times the error of a float32 expf and product, so the skip decision
    is the one the full test would take."""
    o = opacity.to(torch.float64)
    eps = torch.tensor(ALPHA_EPS, dtype=torch.float32).item()  # the kernels' float32 1/255
    p = torch.where(o > 0, torch.log(eps / o.clamp_min(1e-300)) - SKIP_MARGIN, torch.inf)
    f = p.to(torch.float32)
    return torch.where(f.double() > p, torch.nextafter(f, torch.full_like(f, -torch.inf)), f)


def _padded(cols, n):
    x = torch.cat(cols, dim=1).to(torch.float32)
    return torch.nn.functional.pad(x, (0, n - x.shape[1])).contiguous()


def image_features(prep: PreprocessOut):
    """(P, N_IMG_FEAT) float32 rows of phase A: xy, conic, opacity (0 where
    culled), rgb, ts, ray_plane (the first 12 columns of the blend's feature
    row), then ``skip_below`` and zeros."""
    op = torch.where(prep.valid, prep.opacity.reshape(-1), 0.0).to(torch.float32)
    return _padded([prep.xy, prep.conic, op[:, None], prep.rgb, prep.ts[:, None],
                    prep.ray_plane, skip_below(op)[:, None]], N_IMG_FEAT)


def point_features(prep: PreprocessOut):
    """(P, N_PT_FEAT) float32 rows of phase B (pack_integrate_features of
    pallas_integrate.py:43-59): xy, conic, opacity (0 where culled), ts,
    ray_plane, invraycov [00, 01, 02, 11, 12, 22], well_conditioned, then
    ``skip_below`` and zeros."""
    if prep.invraycov is None:
        raise ValueError("integrate needs preprocess with compute_invraycov=True")
    op = torch.where(prep.valid, prep.opacity.reshape(-1), 0.0).to(torch.float32)
    irc = prep.invraycov
    sym6 = torch.stack([irc[:, 0, 0], irc[:, 0, 1], irc[:, 0, 2], irc[:, 1, 1],
                        irc[:, 1, 2], irc[:, 2, 2]], dim=1)
    return _padded([prep.xy, prep.conic, op[:, None], prep.ts[:, None], prep.ray_plane,
                    sym6, prep.well_conditioned.to(torch.float32)[:, None],
                    skip_below(op)[:, None]], N_PT_FEAT)


def _power(f, dx, dy):
    return -0.5 * (f[..., 2] * dx * dx + f[..., 4] * dy * dy) - f[..., 3] * dx * dy


def _corner_alpha(f, px, py):
    """Alpha and pass flag of contributor rows ``f`` (..., >= 6 features) at
    sample positions (px, py) (_alphas_at, integrate.py:79-92)."""
    dx = f[..., 0] - px
    dy = f[..., 1] - py
    power = _power(f, dx, dy)
    alpha = torch.clamp_max(f[..., 5] * torch.exp(torch.clamp_max(power, 0.0)), MAX_ALPHA)
    return alpha, (power <= 0.0) & (alpha >= ALPHA_EPS), dx, dy


def _corner_step(Ts, alpha, passes):
    """One contributor's corner-transmittance update (forward.cu:1063-1086):
    skip (keep T) where the test transmittance would underflow."""
    test = Ts * (1.0 - alpha)
    ok = passes & (test >= T_EPS)
    return torch.where(ok, test, Ts), ok


def _corner_offsets(device):
    return (torch.tensor(OFFS_X, device=device)[:, None, None],
            torch.tensor(OFFS_Y, device=device)[:, None, None])


def lattice_corners():
    """For each point (a, b) of a tile's corner lattice (index b LATTICE + a),
    a (sample k, in-tile pixel) whose corner lies on it: k = 1 (-0.5, -0.5)
    of pixel (a, b) where a, b < 16, else k = 2 (+0.5, -0.5) of (a - 1, b),
    k = 3 (-0.5, +0.5) of (a, b - 1), k = 4 (+0.5, +0.5) of (a - 1, b - 1).
    Returns (k, pixel) as two (LATTICE**2,) int64 tensors."""
    idx = torch.arange(LATTICE * LATTICE)
    a, b = idx % LATTICE, idx // LATTICE
    right, below = a == TILE, b == TILE
    k = 1 + right.to(torch.int64) + 2 * below.to(torch.int64)
    return k, (b - below.to(torch.int64)) * TILE + (a - right.to(torch.int64))


def integrate_image_torch(tile_gauss, feat, width: int, height: int,
                          count_work: bool = False):
    """Plain version of the phase-A kernel (integrate_image, integrate.py:95-195):
    every tile walks its (T, K) front-to-back id list (-1 padded) one
    contributor at a time, all pixels and the 5 corners at once. ``feat`` is
    ``image_features(prep)``. Returns the (T, 13, 256) rows and the (T, 256)
    int32 index of the median contributor in its tile's run (-1 for none).
    The max depth starts at 0, as the XLA path does (integrate.py:118).

    ``count_work`` adds a third return, the work on these inputs:
    ``n_pairs`` (instance, pixel) pairs walked, ``n_power`` samples whose
    power test passes (a kernel without the skip test takes the exp there),
    ``n_taken`` samples that take the contributor, ``n_centre`` centre
    samples that do (the accumulation), ``n_alpha`` samples whose alpha
    reaches 1/255 (the exp is needed), all over the 5 samples of each
    pixel; ``n_lat_power``, ``n_lat_alpha`` and ``n_lat_taken`` the same
    counts over each tile's distinct samples, which the kernel walks once
    each: its 256 centres and the LATTICE x LATTICE corners
    (``lattice_corners``)."""
    dev = feat.device
    T_tiles, K = tile_gauss.shape
    tiles_x, _ = tile_grid(width, height)
    t = torch.arange(T_tiles, device=dev)
    i = torch.arange(TILE * TILE, device=dev)
    pix_x = ((t % tiles_x)[:, None] * TILE + (i % TILE)[None, :]).to(torch.float32) + 0.5
    pix_y = ((t // tiles_x)[:, None] * TILE + (i // TILE)[None, :]).to(torch.float32) + 0.5
    offx, offy = _corner_offsets(dev)
    cx, cy = pix_x[None] + offx, pix_y[None] + offy  # (5, T, 256)

    f32 = torch.float32
    Ts = torch.ones((5, T_tiles, TILE * TILE), dtype=f32, device=dev)
    out = torch.zeros((N_IMG, T_tiles, TILE * TILE), dtype=f32, device=dev)
    med_pos = torch.full((T_tiles, TILE * TILE), -1, dtype=torch.int32, device=dev)
    work = {k: torch.zeros((), dtype=torch.int64, device=dev)
            for k in ("n_pairs", "n_power", "n_taken", "n_centre", "n_alpha", "n_lat_power",
                      "n_lat_alpha", "n_lat_taken")}
    lat_k, lat_p = (x.to(dev) for x in lattice_corners())
    for k in range(K):
        ids = tile_gauss[:, k].to(torch.int64)
        f = torch.where((ids >= 0)[:, None], feat[ids.clamp_min(0)], 0.0)[:, None, :]  # (T,1,16)
        alpha, passes, dx, dy = _corner_alpha(f[None], cx, cy)  # (5, T, 256)
        if count_work:
            live = (ids >= 0)[None, :, None]
            work["n_pairs"] += (ids >= 0).sum() * TILE * TILE
            pw = live & (_power(f[None], dx, dy) <= 0.0)
            work["n_power"] += pw.sum()
            work["n_lat_power"] += pw[0].sum() + pw[lat_k, :, lat_p].sum()
            al = live & passes
            work["n_alpha"] += al.sum()
            work["n_lat_alpha"] += al[0].sum() + al[lat_k, :, lat_p].sum()
        T0_old = Ts[0]
        Ts, ok = _corner_step(Ts, alpha, passes)
        depth = f[None, ..., 9] + f[None, ..., 10] * dx + f[None, ..., 11] * dy
        out[5] = torch.maximum(out[5], torch.where(ok, depth, -torch.inf).amax(0))
        w = torch.where(ok[0], alpha[0] * T0_old, 0.0)
        for c in range(3):
            out[c] += w * f[..., 6 + c]
        out[6] += w
        out[3] += w * depth[0]
        med = ok[0] & (T0_old > 0.5)
        out[4] = torch.where(med, depth[0], out[4])
        for r, col in zip(range(8, 13), (9, 10, 11, 0, 1)):
            out[r] = torch.where(med, f[..., col], out[r])
        med_pos = torch.where(med, k, med_pos)
        if count_work:
            work["n_taken"] += ok.sum()
            work["n_centre"] += ok[0].sum()
            work["n_lat_taken"] += ok[0].sum() + ok[lat_k, :, lat_p].sum()
    out[7] = Ts[0]
    rows = out.transpose(0, 1).contiguous()
    return (rows, med_pos, work) if count_work else (rows, med_pos)


def image_from_rows(rows, bg, width: int, height: int):
    """(T, 13, 256) phase-A rows -> the 9-channel (9, H, W) image (channel 8,
    the projected-point counts, left 0) and the tiled median-plane dict."""
    f32 = torch.float32
    zero = torch.zeros((1, height, width), dtype=f32, device=rows.device)
    color = rows[:, 0:3].transpose(0, 1) + rows[:, 7][None] * bg.reshape(3, 1, 1)
    img = torch.cat([untile(color, width, height),
                     untile(rows[:, 3:5].transpose(0, 1), width, height), zero,
                     untile(rows[:, 5:7].transpose(0, 1), width, height), zero], dim=0)
    return img, {k: rows[:, 8 + j] for j, k in enumerate(MID_KEYS)}


def _check_binning(binning: TileBinning, T: int, dev):
    if dev.type != "cuda":
        raise ValueError(f"the integrate kernels run on cuda or cpu tensors, not {dev}")
    build.check_tensor("gauss_id", binning.gauss_id, torch.int32, binning.gauss_id.shape, dev)
    build.check_tensor("tile_start", binning.tile_start, torch.int32, (T,), dev)
    build.check_tensor("tile_count", binning.tile_count, torch.int32, (T,), dev)


def _plain_tile_gauss(binning: TileBinning):
    if binning.tile_gauss is None:
        raise ValueError("the plain integrate walks binning.tile_gauss; "
                         "bin with need_tile_gauss=True")
    return binning.tile_gauss


@functools.cache
def _entry(name: str):
    """The C entry of an integrate kernel, built and resolved once."""
    return build.entry(name, 7 if name == "integrate_image" else 10, 2)


def _on(dev):
    """A switch to ``dev`` only where it is not the current device."""
    return (torch.cuda.device(dev) if dev.index != torch.cuda.current_device()
            else contextlib.nullcontext())


def integrate_image_rows(binning: TileBinning, feat, width: int, height: int):
    """Phase A of every tile as (T, 13, 256) float32 rows and the (T, 256)
    int32 median index. On CUDA tensors it launches ``csrc/integrate_image.cu``
    (the tiles heaviest first) or raises; on CPU tensors it runs
    ``integrate_image_torch``."""
    if binning.tile_count.device.type == "cpu":
        return integrate_image_torch(_plain_tile_gauss(binning), feat, width, height)
    tiles_x, tiles_y = tile_grid(width, height)
    T = tiles_x * tiles_y
    dev = binning.tile_count.device
    _check_binning(binning, T, dev)
    build.check_tensor("features", feat, torch.float32, (feat.shape[0], N_IMG_FEAT), dev)
    rows = torch.empty((T, N_IMG, TILE * TILE), dtype=torch.float32, device=dev)
    med_pos = torch.empty((T, TILE * TILE), dtype=torch.int32, device=dev)
    tile_order = heaviest_first(binning.tile_count)
    with _on(dev):
        rc = _entry("integrate_image")(
            feat.data_ptr(), binning.gauss_id.data_ptr(), binning.tile_start.data_ptr(),
            binning.tile_count.data_ptr(), tile_order.data_ptr(), rows.data_ptr(),
            med_pos.data_ptr(), T, tiles_x, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"integrate_image kernel launch failed with CUDA error {rc}")
    LAUNCHES["integrate_image"] += 1
    return rows, med_pos


def integrate_image(prep: PreprocessOut, binning: TileBinning, bg, width: int, height: int):
    """Phase A: the 9-channel integrate image (channel 8 left 0) and the tiled
    per-pixel median plane (integrate.py:95-195 contract)."""
    rows, _ = integrate_image_rows(binning, image_features(prep), width, height)
    return image_from_rows(rows, bg, width, height)


def point_sdf_from_mid(pts: PointProjection, mid, tiles_x: int):
    """Per-point SDF from the pixel's median plane (forward.cu:1356-1363)."""
    within = (pts.pixel[:, 1] % TILE) * TILE + (pts.pixel[:, 0] % TILE)

    def at(f):
        return f[pts.tile, within]

    med_depth = (at(mid["mid_dc"]) + at(mid["mid_p0"]) * (at(mid["mid_x"]) - pts.xy[:, 0])
                 + at(mid["mid_p1"]) * (at(mid["mid_y"]) - pts.xy[:, 1]))
    return torch.where((pts.depth > 0) & pts.valid, med_depth - pts.depth, 0.0)


def _point_alpha(f, px, py, depth):
    """Ray-space 3D alpha of contributor rows ``f`` (N, 16) at the points
    (forward.cu:1300-1330), with the reference's ill-conditioned quirk: a
    Gaussian without an invertible covariance uses dz = t_c and counts only
    where the point is behind its plane (integrate.py:259-273)."""
    dx = f[:, 0] - px
    dy = f[:, 1] - py
    t_at = f[:, 6] + f[:, 7] * dx + f[:, 8] * dy
    cond = f[:, 15] > 0.5
    dz = torch.where(cond, f[:, 6] - torch.minimum(depth, t_at), f[:, 6])
    pw = -0.5 * (f[:, 9] * dx * dx + f[:, 12] * dy * dy + f[:, 14] * dz * dz
                 + 2.0 * (f[:, 10] * dx * dy + f[:, 11] * dx * dz + f[:, 13] * dy * dz))
    apt = torch.clamp_max(f[:, 5] * torch.exp(torch.clamp_max(pw, 0.0)), MAX_ALPHA)
    return torch.where(cond | (depth >= t_at), apt, 0.0)


def integrate_points_torch(tile_gauss, feat, pts: PointProjection, mid, tiles_x: int,
                           count_work: bool = False):
    """Plain version of the phase-B kernel plus the SDF (integrate_points,
    integrate.py:198-293): every point walks its tile's (K,) front-to-back
    list one contributor at a time, all points at once. ``feat`` is
    ``point_features(prep)``. Returns (alpha_integrated (N,), 1.0 for invalid
    points; point_sdf (N,), 0 for them).

    ``count_work`` adds a third return, the kernel's work over the valid
    points: ``n_pairs`` (instance, point) pairs walked, ``n_power`` samples
    whose power test passes, ``n_alpha`` samples whose alpha reaches 1/255
    (the exp is needed), ``n_used`` used pairs (the 3D alpha is taken),
    ``n_inc`` pairs that add to the point's opacity."""
    dev = feat.device
    N = pts.xy.shape[0]
    tile = torch.where(pts.valid, pts.tile, 0)
    pfx = pts.pixel[:, 0].to(torch.float32) + 0.5
    pfy = pts.pixel[:, 1].to(torch.float32) + 0.5
    offx, offy = _corner_offsets(dev)
    cx, cy = pfx[None] + offx[:, 0], pfy[None] + offy[:, 0]  # (5, N)
    px, py, depth = pts.xy[:, 0], pts.xy[:, 1], pts.depth

    Ts = torch.ones((5, N), dtype=torch.float32, device=dev)
    T_pt = torch.ones((N,), dtype=torch.float32, device=dev)
    a_int = torch.zeros((N,), dtype=torch.float32, device=dev)
    work = {k: torch.zeros((), dtype=torch.int64, device=dev)
            for k in ("n_pairs", "n_power", "n_alpha", "n_used", "n_inc")}
    for k in range(tile_gauss.shape[1]):
        ids = tile_gauss[tile, k].to(torch.int64)
        f = torch.where((ids >= 0)[:, None], feat[ids.clamp_min(0)], 0.0)  # (N, 20)
        alpha, passes, dx, dy = _corner_alpha(f[None], cx, cy)
        Ts, ok = _corner_step(Ts, alpha, passes)
        apt = _point_alpha(f, px, py, depth)
        used = ok.any(0)
        inc = used & (apt >= ALPHA_EPS)
        a_int = a_int + torch.where(inc, apt * T_pt, 0.0)
        T_pt = torch.where(inc, T_pt * (1.0 - apt), T_pt)
        if count_work:
            live = (ids >= 0) & pts.valid
            work["n_pairs"] += live.sum()
            work["n_power"] += (live[None] & (_power(f[None], dx, dy) <= 0.0)).sum()
            work["n_alpha"] += (live[None] & passes).sum()
            work["n_used"] += (live & used).sum()
            work["n_inc"] += (live & inc).sum()
    out = torch.where(pts.valid, a_int, 1.0), point_sdf_from_mid(pts, mid, tiles_x)
    return out + (work,) if count_work else out


def heaviest_first(tile_count):
    """The tiles in descending ``tile_count``, ties in tile order: (T,) int32."""
    return torch.argsort(tile_count, descending=True, stable=True).to(torch.int32)


def point_work_items(pts: PointProjection, tile_count):
    """Every point sorted by (tile, pixel within the tile), stable in the
    point id, the invalid ones last; each tile's run of valid points cut
    into items of at most POINTS_PER_ITEM points (the lanes of one warp:
    points of one pixel, or of neighbouring pixels, walk side by side). The
    item list has a length fixed by the shapes alone, T + N //
    POINTS_PER_ITEM + 1, so nothing here waits for the card; the entries it
    does not need hold 0 points and come last. The items are listed
    heaviest tile first (the binning's ``tile_count`` (T,), descending, ties
    in tile order): an item's walk takes as long as its tile's run, so a
    heavy tile started late sets the tail. Returns (order (N,) int32
    original ids in sorted order, item_tile, item_start, item_count (I,)
    int32)."""
    dev = pts.tile.device
    num_tiles = tile_count.numel()
    N, per, px = pts.tile.shape[0], POINTS_PER_ITEM, TILE * TILE
    within = (pts.pixel[:, 1] % TILE) * TILE + pts.pixel[:, 0] % TILE
    key = torch.where(pts.valid, pts.tile * px + within, num_tiles * px)
    key_s, order = torch.sort(key, stable=True)
    # first sorted slot of each tile's run, and of the invalid points
    bounds = torch.searchsorted(key_s, torch.arange(num_tiles + 1, device=dev) * px)
    counts = bounds[1:] - bounds[:-1]
    n_items = (counts + per - 1) // per
    ends = torch.cumsum(n_items, 0)
    j = torch.arange(num_tiles + N // per + 1, device=dev)
    tile = torch.searchsorted(ends, j, right=True)  # num_tiles past the last item
    used = tile < num_tiles
    tile = torch.where(used, tile, 0)
    k = j - (ends[tile] - n_items[tile])
    item_start = bounds[tile] + k * per
    item_count = torch.where(used, torch.clamp_max(counts[tile] - k * per, per), 0)
    rows = torch.where(used, tile_count[tile].to(torch.int64), -1)
    perm = torch.argsort(rows, descending=True, stable=True)
    tile, item_start, item_count = tile[perm], item_start[perm], item_count[perm]
    return (order.to(torch.int32), tile.to(torch.int32), item_start.to(torch.int32),
            item_count.to(torch.int32))


def integrate_points_alpha(binning: TileBinning, feat, pts: PointProjection, width: int,
                           height: int):
    """``alpha_integrated`` (N,) in the original point order, 1.0 for invalid
    points, from ``csrc/integrate_points.cu`` (CUDA tensors only)."""
    tiles_x, tiles_y = tile_grid(width, height)
    T = tiles_x * tiles_y
    dev = binning.tile_count.device
    _check_binning(binning, T, dev)
    build.check_tensor("features", feat, torch.float32, (feat.shape[0], N_PT_FEAT), dev)
    N = pts.xy.shape[0]
    order, item_tile, item_start, item_count = point_work_items(pts, binning.tile_count)
    sel = order.to(torch.int64)
    pfeat = torch.stack([pts.xy[sel, 0], pts.xy[sel, 1], pts.depth[sel],
                         torch.zeros_like(pts.depth[sel])], dim=1).to(torch.float32).contiguous()
    out = torch.ones((N,), dtype=torch.float32, device=dev)
    n_items = item_tile.shape[0]
    with _on(dev):
        rc = _entry("integrate_points")(
            feat.data_ptr(), binning.gauss_id.data_ptr(), binning.tile_start.data_ptr(),
            binning.tile_count.data_ptr(), pfeat.data_ptr(), order.data_ptr(),
            item_tile.data_ptr(), item_start.data_ptr(), item_count.data_ptr(),
            out.data_ptr(), n_items, POINTS_PER_ITEM, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"integrate_points kernel launch failed with CUDA error {rc}")
    LAUNCHES["integrate_points"] += 1
    return out


def integrate_points(prep: PreprocessOut, binning: TileBinning, pts: PointProjection, mid,
                     width: int, height: int):
    """Phase B: (alpha_integrated (N,), point_sdf (N,)). On CUDA tensors the
    alpha comes from ``csrc/integrate_points.cu`` (or it raises); on CPU
    tensors ``integrate_points_torch`` runs."""
    feat = point_features(prep)
    tiles_x, _ = tile_grid(width, height)
    if binning.tile_count.device.type == "cpu":
        return integrate_points_torch(_plain_tile_gauss(binning), feat, pts, mid, tiles_x)
    a_int = integrate_points_alpha(binning, feat, pts, width, height)
    return a_int, point_sdf_from_mid(pts, mid, tiles_x)


def integrate_view_cache(prep: PreprocessOut, camera, bg, max_per_tile: int = 1024,
                         instance_budget: int | None = None):
    """The POINTS-INDEPENDENT part of integrate: radius-only binning, the
    phase-A image and the per-pixel median plane. Marching Tetrahedra
    re-evaluates the SDF at new points 1 + n_binary_steps times per view
    (mesh_extract_tetrahedra.py:90-102); this cache makes those re-walks pay
    only phase B."""
    W, H = camera.width, camera.height
    if instance_budget is None:
        instance_budget = default_instance_budget(prep.xy.shape[0])
    binning = bin_gaussians(prep.xy, prep.radius, prep.depth, prep.valid, W, H,
                            instance_budget=instance_budget, max_per_tile=max_per_tile,
                            need_tile_gauss=prep.xy.device.type == "cpu")
    color, mid = integrate_image(prep, binning, bg, W, H)
    return {"binning": binning, "color": color, "mid": mid}


def integrate_points_cached(points3d, prep: PreprocessOut, cache, camera):
    """Phase B against a prepared view cache (``integrate_view_cache``):
    render (9, H, W) with channel 8 (the projected points per pixel) filled,
    alpha_integrated (N,), color_integrated (N, 3) — the point's pixel's final
    colour C + T bg (forward.cu:1354, a pixel sample, not a per-point blend),
    0 for invalid points — point_coordinate (N, 2), point_sdf (N,) and
    point_valid (N,)."""
    W, H = camera.width, camera.height
    pts = project_points(torch.as_tensor(points3d, dtype=torch.float32,
                                         device=prep.xy.device), camera)
    # per-pixel projected-point counts (channel 8); bincount is deterministic
    pix = pts.pixel[:, 1] * W + pts.pixel[:, 0]
    counts = torch.bincount(pix[pts.valid], minlength=H * W).reshape(H, W)
    out_color = cache["color"].clone()
    out_color[8] = counts.to(torch.float32)
    a_int, sdf = integrate_points(prep, cache["binning"], pts, cache["mid"], W, H)
    col = out_color[0:3].reshape(3, -1).T
    color = torch.where(pts.valid[:, None], col[torch.where(pts.valid, pix, 0)], 0.0)
    return {
        "render": out_color,
        "alpha_integrated": a_int,
        "color_integrated": color,
        "point_coordinate": pts.xy,
        "point_sdf": sdf,
        "point_valid": pts.valid,
    }

