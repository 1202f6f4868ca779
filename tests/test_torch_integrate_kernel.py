"""The integrate kernels (``csrc/integrate_image.cu``, B5, and
``csrc/integrate_points.cu``, B6) and the work layout their wrappers hand
them, on a scene of the port alone (torch only, so the card's machine runs
it: ``python -m pytest --noconftest tests/test_torch_integrate_kernel.py``;
the ``cuda`` tests skip without a card). The scene is 72x50 (ragged
tiles), with empty tiles and one tile whose points fill several work items.

On the CPU: the B6 work items (every valid point once, at most
POINTS_PER_ITEM points of one tile an item, points in (tile, pixel) order
stable in the id, items heaviest tile first, a list of a length fixed by
the shapes with its unused entries last), the premise of B5's sample
lattice (every corner of every pixel of a 1600x1200 view lies exactly on
its tile's lattice point, with the corner-index map the kernel uses; no
valid point has a clamped pixel), and the lattice work counts of
``integrate_image_torch`` against a direct walk of the lattice.

On the card: B5 within abs 1e-4 of ``integrate_image_torch`` on the float
rows, with at most 1e-4 of the pixels on another median contributor and no
median error where it is the same; B6 equal to ``integrate_points_torch``
bitwise (both kernels round op by op as the plain versions do); both
kernels the same bits run to run; B6 over all points equal to B6 over a
subset bitwise; B5 with the tiles heaviest first equal to B5 in tile order
bitwise.
"""

import numpy as np
import pytest
import torch

from radegs_torch.core.camera import Camera
from radegs_torch.core.projection import preprocess_gaussians
from radegs_torch.ops import integrate as ig
from radegs_torch.ops.binning import TILE, bin_gaussians, tile_grid

torch.set_num_threads(1)
W, H = 72, 50
ABS_TOL, MED_POS_TOL = 1e-4, 1e-4
CROWDED_TILE = (1, 1)  # (tile x, tile y) that gets 150 extra points


def world_points(cam, u, v, d):
    """World points at pixel coordinates (u, v) and view depth d (d < 0:
    behind the camera)."""
    fx, fy = float(cam.focal_x), float(cam.focal_y)
    p_view = np.stack([(u - W / 2) / fx * d, (v - H / 2) / fy * d, d], 1)
    R, T = cam.R.cpu().numpy().astype(np.float64), cam.T.cpu().numpy().astype(np.float64)
    return ((p_view - T) @ R.T).astype(np.float32)


def scene(device):
    """300 seeded Gaussians right of centre (the left tiles stay empty),
    radius-only binning with ``tile_gauss``; ~2400 query points: in the
    image, 150 in CROWDED_TILE (several work items), beside the image and
    behind the camera."""
    rng = np.random.default_rng(21)
    P = 300

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    q = rng.normal(size=(P, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    cam = Camera.look_at([0, 0.2, -4], [0, 0, 0], [0, 1, 0], 0.9, 0.8, W, H, device=device)
    prep = preprocess_gaussians(t(rng.normal(size=(P, 3)) * 0.4 + [0.7, 0, 0]),
                                t(np.exp(rng.normal(size=(P, 3)) * 0.5 - 2.2)), t(q),
                                t(rng.uniform(0.1, 0.95, (P, 1))),
                                t(rng.uniform(0, 1, (P, 1, 3))), sh_degree=0, camera=cam,
                                kernel_size=0.1, compute_invraycov=True)
    binning = bin_gaussians(prep.xy, prep.radius, prep.depth, prep.valid, W, H,
                            instance_budget=1 << 14, max_per_tile=1024, need_tile_gauss=True)
    tx, ty = CROWDED_TILE
    u = np.concatenate([rng.uniform(0, W, 2000), rng.uniform(tx * TILE, (tx + 1) * TILE, 150),
                        rng.uniform(-W / 2, 0, 150), rng.uniform(0, W, 100)])
    v = np.concatenate([rng.uniform(0, H, 2000), rng.uniform(ty * TILE, (ty + 1) * TILE, 150),
                        rng.uniform(0, H, 150), rng.uniform(0, H, 100)])
    d = np.concatenate([rng.uniform(2.5, 5.5, 2300), -rng.uniform(0.5, 3, 100)])
    pts = ig.project_points(t(world_points(cam, u, v, d)), cam)
    return prep, binning, pts


@pytest.fixture(scope="module")
def cpu_scene():
    return scene("cpu")


def test_scene_exercises_every_branch(cpu_scene):
    prep, binning, pts = cpu_scene
    T = binning.tile_count.numel()
    assert int(binning.n_overflow) == 0 and int(binning.tile_overflow) == 0
    assert (binning.tile_count == 0).any()  # empty tiles
    counts = torch.bincount(pts.tile[pts.valid], minlength=T)
    assert counts.max() > 2 * ig.POINTS_PER_ITEM  # a tile over several items
    assert (pts.valid & (binning.tile_count[pts.tile] == 0)).any()  # points on empty tiles
    assert (~pts.valid).sum() >= 250  # beside the image, behind the camera


def test_point_work_items(cpu_scene):
    _, binning, pts = cpu_scene
    T, N = binning.tile_count.numel(), pts.tile.numel()
    n_valid = int(pts.valid.sum())
    order, item_tile, item_start, item_count = ig.point_work_items(pts, binning.tile_count)
    for x in (order, item_tile, item_start, item_count):
        assert x.dtype == torch.int32
    order, it, ist, ic = (x.long() for x in (order, item_tile, item_start, item_count))
    # every point exactly once, the valid ones first, the others in id order
    assert torch.equal(torch.sort(order).values, torch.arange(N))
    assert pts.valid[order[:n_valid]].all() and not pts.valid[order[n_valid:]].any()
    assert (order[n_valid:].diff() > 0).all()
    # the valid points by (tile, pixel in the tile), stable in the point id
    within = (pts.pixel[:, 1] % TILE) * TILE + pts.pixel[:, 0] % TILE
    key = pts.tile * (TILE * TILE) + within
    k, ids = key[order[:n_valid]], order[:n_valid]
    assert ((k[1:] > k[:-1]) | ((k[1:] == k[:-1]) & (ids[1:] > ids[:-1]))).all()
    # a list of fixed length, its unused entries (0 points) last
    assert it.numel() == T + N // ig.POINTS_PER_ITEM + 1
    real = ic > 0
    n_real = int(real.sum())
    assert real[:n_real].all() and not real[n_real:].any()
    # items: 1..POINTS_PER_ITEM points of one tile, covering the valid points once
    assert (ic <= ig.POINTS_PER_ITEM).all()
    covered = torch.zeros(N, dtype=torch.int64)
    for t, s, c in zip(it[real].tolist(), ist[real].tolist(), ic[real].tolist()):
        assert (pts.tile[order[s:s + c]] == t).all()
        covered[s:s + c] += 1
    assert (covered[:n_valid] == 1).all() and (covered[n_valid:] == 0).all()
    # a tile's run is cut only where it must be
    n_pts = torch.bincount(pts.tile[pts.valid], minlength=T)
    n_items = torch.bincount(it[real], minlength=T)
    assert torch.equal(n_items, (n_pts + ig.POINTS_PER_ITEM - 1) // ig.POINTS_PER_ITEM)
    # heaviest tile first, ties in tile order, a tile's items in run order
    rows, t, st = binning.tile_count[it[real]], it[real], ist[real]
    assert (rows[1:] <= rows[:-1]).all()
    tie = rows[1:] == rows[:-1]
    assert ((t[1:] > t[:-1]) | ((t[1:] == t[:-1]) & (st[1:] > st[:-1])))[tie].all()


def test_point_work_items_without_points(cpu_scene):
    _, binning, pts = cpu_scene
    T = binning.tile_count.numel()
    for sel in (torch.zeros(0, dtype=torch.int64), (~pts.valid).nonzero()[:, 0]):
        sub = ig.PointProjection(*(f[sel] for f in pts))
        order, it, _, ic = ig.point_work_items(sub, binning.tile_count)
        assert order.numel() == sel.numel() and (ic == 0).all()
        assert it.numel() == T + sel.numel() // ig.POINTS_PER_ITEM + 1


def test_valid_points_have_their_own_pixel(cpu_scene):
    """No valid point's pixel is clamped, so its five samples are points of
    its own tile's lattice (the B6 walk and the B5 lattice agree)."""
    _, _, pts = cpu_scene
    v = pts.valid
    assert torch.equal(pts.pixel[v, 0], torch.floor(pts.xy[v, 0]).long())
    assert torch.equal(pts.pixel[v, 1], torch.floor(pts.xy[v, 1]).long())
    tiles_x, _ = tile_grid(W, H)
    assert torch.equal(pts.tile[v], (pts.pixel[v, 1] // TILE) * tiles_x + pts.pixel[v, 0] // TILE)


def test_corners_lie_on_the_lattice():
    """Every corner of every pixel of a 1600x1200 view, computed as
    ``integrate_image_torch`` computes it (pixel + 0.5, then +-0.5, in
    float32), equals its lattice point exactly; the kernel's map k = 1 ->
    (i, j), 2 -> (i+1, j), 3 -> (i, j+1), 4 -> (i+1, j+1) and
    ``lattice_corners`` agree."""
    Wv, Hv = 1600, 1200
    tiles_x, tiles_y = tile_grid(Wv, Hv)
    t = torch.arange(tiles_x * tiles_y)
    i = torch.arange(TILE * TILE)
    x0, y0 = (t % tiles_x) * TILE, (t // tiles_x) * TILE
    pix_x = (x0[:, None] + (i % TILE)[None]).to(torch.float32) + 0.5
    pix_y = (y0[:, None] + (i // TILE)[None]).to(torch.float32) + 0.5
    step = {1: (0, 0), 2: (1, 0), 3: (0, 1), 4: (1, 1)}
    for k, (a, b) in step.items():
        cx = pix_x + torch.tensor(ig.OFFS_X[k])
        cy = pix_y + torch.tensor(ig.OFFS_Y[k])
        lx = (x0[:, None] + (i % TILE)[None] + a).to(torch.float32)
        ly = (y0[:, None] + (i // TILE)[None] + b).to(torch.float32)
        assert torch.equal(cx, lx) and torch.equal(cy, ly), k
    lat_k, lat_p = ig.lattice_corners()
    assert lat_k.shape == (ig.LATTICE ** 2,)
    for idx, (k, p) in enumerate(zip(lat_k.tolist(), lat_p.tolist())):
        a, b = step[k]
        assert (p // TILE + b) * ig.LATTICE + p % TILE + a == idx


def test_lattice_work_counts(cpu_scene):
    """``n_lat_power`` / ``n_lat_alpha`` / ``n_lat_taken`` of
    ``integrate_image_torch`` against a direct walk of each tile's 256
    centres and 17 x 17 lattice corners."""
    prep, binning, _ = cpu_scene
    feat = ig.image_features(prep)
    _, _, work = ig.integrate_image_torch(binning.tile_gauss, feat, W, H, count_work=True)
    tiles_x, tiles_y = tile_grid(W, H)
    t = torch.arange(tiles_x * tiles_y)
    x0 = ((t % tiles_x) * TILE).to(torch.float32)[:, None]
    y0 = ((t // tiles_x) * TILE).to(torch.float32)[:, None]
    i = torch.arange(TILE * TILE)
    c = torch.arange(ig.LATTICE ** 2)
    sx = torch.cat([x0 + (i % TILE).to(torch.float32) + 0.5,
                    x0 + (c % ig.LATTICE).to(torch.float32)], 1)  # (T, 545)
    sy = torch.cat([y0 + (i // TILE).to(torch.float32) + 0.5,
                    y0 + (c // ig.LATTICE).to(torch.float32)], 1)
    Ts = torch.ones_like(sx)
    n_power = n_alpha = n_taken = 0
    for k in range(binning.tile_gauss.shape[1]):
        ids = binning.tile_gauss[:, k].long()
        f = torch.where((ids >= 0)[:, None], feat[ids.clamp_min(0)], 0.0)[:, None, :]
        alpha, passes, dx, dy = ig._corner_alpha(f, sx, sy)
        Ts, ok = ig._corner_step(Ts, alpha, passes)
        n_power += int(((ids >= 0)[:, None] & (ig._power(f, dx, dy) <= 0.0)).sum())
        n_alpha += int(((ids >= 0)[:, None] & passes).sum())
        n_taken += int(ok.sum())
    assert int(work["n_lat_power"]) == n_power
    assert int(work["n_lat_alpha"]) == n_alpha
    assert int(work["n_lat_taken"]) == n_taken
    assert 0 < n_taken <= n_alpha < n_power < int(work["n_power"])
    assert n_alpha < int(work["n_alpha"]) and n_taken < int(work["n_taken"])


# ------------------------------------------------------------- on a card ----


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the integrate kernels have no CPU mode")
    prep, binning, pts = scene("cuda")
    feat, pfeat = ig.image_features(prep), ig.point_features(prep)
    rows_p, med_p = ig.integrate_image_torch(binning.tile_gauss, feat, W, H)
    mid = {k: rows_p[:, 8 + j] for j, k in enumerate(ig.MID_KEYS)}
    alpha_p, _ = ig.integrate_points_torch(binning.tile_gauss, pfeat, pts, mid,
                                           tile_grid(W, H)[0])
    return binning, feat, pfeat, pts, rows_p, med_p, alpha_p


@pytest.mark.cuda
def test_image_kernel_matches_plain(card):
    binning, feat, _, _, rows_p, med_p, _ = card
    rows, med = ig.integrate_image_rows(binning, feat, W, H)
    rows2, med2 = ig.integrate_image_rows(binning, feat, W, H)
    torch.cuda.synchronize()
    assert torch.equal(rows, rows2) and torch.equal(med, med2)  # run == rerun
    err = (rows[:, :8] - rows_p[:, :8]).abs()[:, [0, 1, 2, 3, 5, 6, 7]].max().item()
    same = med == med_p
    med_err = max((rows[:, 4] - rows_p[:, 4]).abs()[same].max().item(),
                  (rows[:, 8:] - rows_p[:, 8:]).abs().amax(1)[same].max().item())
    assert err <= ABS_TOL
    assert 1.0 - same.float().mean().item() <= MED_POS_TOL and med_err == 0.0


@pytest.mark.cuda
def test_image_kernel_tile_order(card):
    """Blocks in heaviest-first tile order (the wrapper's) and in natural
    order give the same bits."""
    binning, feat, *_ = card
    T = binning.tile_count.numel()
    tiles_x = tile_grid(W, H)[0]
    outs = []
    for order in (torch.arange(T, dtype=torch.int32, device="cuda"),
                  ig.heaviest_first(binning.tile_count)):
        rows = torch.empty((T, ig.N_IMG, TILE * TILE), device="cuda")
        med = torch.empty((T, TILE * TILE), dtype=torch.int32, device="cuda")
        rc = ig._entry("integrate_image")(
            feat.data_ptr(), binning.gauss_id.data_ptr(), binning.tile_start.data_ptr(),
            binning.tile_count.data_ptr(), order.data_ptr(),
            rows.data_ptr(), med.data_ptr(), T, tiles_x, torch.cuda.current_stream().cuda_stream)
        assert rc == 0
        outs.append((rows, med))
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


@pytest.mark.cuda
def test_points_kernel_matches_plain(card):
    binning, _, pfeat, pts, _, _, alpha_p = card
    a1 = ig.integrate_points_alpha(binning, pfeat, pts, W, H)
    a2 = ig.integrate_points_alpha(binning, pfeat, pts, W, H)
    # a seeded subset: its points sit in other work items, at other lanes
    sel = torch.from_numpy(np.sort(np.random.default_rng(4).choice(
        pts.xy.shape[0], 700, replace=False))).cuda()
    sub = ig.PointProjection(*(f[sel] for f in pts))
    a_sub = ig.integrate_points_alpha(binning, pfeat, sub, W, H)
    torch.cuda.synchronize()
    assert torch.equal(a1, a2)  # run == rerun
    assert torch.equal(a1.view(torch.int32), alpha_p.view(torch.int32))
    assert torch.equal(a_sub, a1[sel])


@pytest.mark.cuda
def test_points_entry_refuses_another_item_size(card):
    binning, _, pfeat, pts, *_ = card
    out = torch.ones(pts.xy.shape[0], device="cuda")
    z = torch.zeros(4, dtype=torch.int32, device="cuda")
    rc = ig._entry("integrate_points")(
        pfeat.data_ptr(), binning.gauss_id.data_ptr(), binning.tile_start.data_ptr(),
        binning.tile_count.data_ptr(), pfeat.data_ptr(), z.data_ptr(), z.data_ptr(),
        z.data_ptr(), z.data_ptr(), out.data_ptr(), 1, 2 * ig.POINTS_PER_ITEM,
        torch.cuda.current_stream().cuda_stream)
    assert rc != 0
