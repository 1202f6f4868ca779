"""Marching-Tetrahedra surface extraction (port of
``radegs_tpu/mesh/extract_tetra.py``; reference mesh_extract_tetrahedra.py):

1. seed points = the Gaussians' box corners at 3 sigma + centres
   (``get_tetra_points``), optionally voxel-deduplicated;
2. Delaunay tetrahedralization — ``scipy.spatial.Delaunay`` on the host (the
   reference's CGAL extension, tetra_triangulation/src/triangulation.cpp);
3. SDF(p) = 0.5 - min over views of alpha_integrated(p), over the views
   where p projects inside a valid-alpha region (evaluage_cull_alpha :32-56);
   the integrate kernels run on the state's device, one phase-A image per
   view reused by every point set;
4. marching tetrahedra -> crossing edges + faces;
5. binary search along each crossing edge, re-evaluating the SDF;
6. drop edges longer than the summed endpoint scales; write the PLY.
"""

from __future__ import annotations

import time

import numpy as np

from radegs_torch.mesh.tetmesh import marching_tetrahedra
from radegs_torch.models.gaussian_model import get_tetra_points
from radegs_torch.renderer import integrate_points, integrate_prepare
from radegs_torch.utils import ply as plyio


def _bilinear_sample(img, xy, H, W):
    """grid_sample(align_corners=False, padding=zeros) on host numpy.

    img: (H, W) float32; xy: (N, 2) pixel coordinates. The reference maps
    point_coordinate to [-1, 1] with (x*2+1)/(W-1)-1 and grid_samples; that
    pair of mappings lands on sample position (x+0.5)*W/(W-1)-0.5 in pixel
    units, reproduced exactly here."""
    gx = (xy[:, 0] * 2 + 1) / (W - 1) - 1
    gy = (xy[:, 1] * 2 + 1) / (H - 1) - 1
    fx = ((gx + 1) * W - 1) / 2
    fy = ((gy + 1) * H - 1) / 2
    x0 = np.floor(fx).astype(np.int64)
    y0 = np.floor(fy).astype(np.int64)
    wx = fx - x0
    wy = fy - y0

    def tap(xi, yi):
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = img[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)]
        return np.where(inside, v, 0.0)

    return (tap(x0, y0) * (1 - wx) * (1 - wy) + tap(x0 + 1, y0) * wx * (1 - wy)
            + tap(x0, y0 + 1) * (1 - wx) * wy + tap(x0 + 1, y0 + 1) * wx * wy)


def decimate_seed_points(points, scales, voxel):
    """Voxel-dedup of the tetrahedralization seeds: one representative (the
    largest-scale member) per ``voxel``-sized cell. On a converged surface
    neighbouring splats' seed boxes overlap heavily; a dedup at ~1 sigma
    keeps the crossing edges and cuts the host Delaunay and every SDF pass.
    Keeping the largest member scale keeps the edge-length filter
    (mesh_extract_tetrahedra.py:107-110) conservative."""
    q = np.floor(points / voxel).astype(np.int64)
    q -= q.min(axis=0)
    dims = q.max(axis=0) + 1
    key = (q[:, 0] * dims[1] + q[:, 1]) * dims[2] + q[:, 2]
    order = np.lexsort((-scales, key))  # per cell: largest scale first
    ks = key[order]
    first = order[np.concatenate([[True], ks[1:] != ks[:-1]])]
    return points[first], scales[first]


def evaluate_cull_alpha(points, views, masks, state, kernel_size, bg, max_per_tile=1024,
                        instance_budget=None, point_chunk_size=262_144, progress=None,
                        caches=None, device=None):
    """SDF = 0.5 - min over valid views of alpha_integrated
    (mesh_extract_tetrahedra.py:32-56); -100 where no view sees the point.

    ``caches``: optional per-view (prep, cache) pairs of
    ``renderer.integrate_prepare`` (the points-independent half), reused
    across calls; built here when absent. ``points`` (N, 3) host numpy;
    returns (N,) float32 host numpy."""
    if caches is None:
        caches = [integrate_prepare(state, cam, bg, kernel_size=kernel_size,
                                    max_per_tile=max_per_tile,
                                    instance_budget=instance_budget, device=device)
                  for cam, _, _ in views]
    N = points.shape[0]
    final = np.ones(N, np.float32)
    weight = np.zeros(N, np.int32)
    for ci, (cam, _gt, _idx) in enumerate(views):
        H, W = cam.height, cam.width
        prep, cache = caches[ci]
        alphas = np.empty(N, np.float32)
        coords = np.empty((N, 2), np.float32)
        for s in range(0, N, point_chunk_size):
            e = min(s + point_chunk_size, N)
            ret = integrate_points(points[s:e], prep, cache, cam)
            alphas[s:e] = ret["alpha_integrated"].cpu().numpy()
            coords[s:e] = ret["point_coordinate"].cpu().numpy()
        mask_img = cache["color"][7].cpu().numpy()
        if masks is not None and masks[ci] is not None:
            mask_img = mask_img * np.asarray(masks[ci])
        prob = _bilinear_sample(mask_img.astype(np.float32), coords, H, W)
        ok = prob > 0.5
        final = np.where(ok, np.minimum(alphas, final), final)
        weight = np.where(ok, weight + 1, weight)
        if progress:
            progress(ci, len(views))
    return np.where(weight > 0, 0.5 - final, -100.0).astype(np.float32)


def extract_mesh_tetrahedra(state, views, kernel_size, bg, masks=None, out_path=None,
                            n_binary_steps=8, max_per_tile=1024, instance_budget=None,
                            verbose=True, decimate="auto", device=None, stats=None):
    """The full extractor (mesh_extract_tetrahedra.py:59-112) on ``device``
    (default ``cuda``; the state must already live there). Returns (vertices,
    faces) as host numpy and optionally writes ``out_path``.

    ``decimate``: voxel size of the seed dedup before the Delaunay ("auto" =
    one median splat sigma, None / 0 = the reference's exact seeds).
    ``stats``: a dict that receives the seed counts, Delaunay seconds, cell,
    crossing-edge and face counts and the seconds of each SDF pass (the
    first, then one per binary-search step)."""
    from scipy.spatial import Delaunay

    points, point_scales = get_tetra_points(state)
    n_seeds = points.shape[0]
    if verbose:
        print(f"tetra points: {n_seeds}")
    if decimate:
        # point_scales are 3 sigma_max, so 1 sigma = median(scales) / 3
        voxel = (float(np.median(point_scales)) * (1.0 / 3.0)
                 if decimate == "auto" else float(decimate))
        if voxel > 0:
            points, point_scales = decimate_seed_points(points, point_scales, voxel)
            if verbose:
                print(f"decimated to {points.shape[0]} seeds (voxel {voxel:.4g})")
    # qhull's output depends on the insertion order: the same seeded shuffle
    # as the JAX package
    perm = np.random.default_rng(0).permutation(points.shape[0])
    points, point_scales = points[perm], point_scales[perm]
    t0 = time.perf_counter()
    cells = Delaunay(points).simplices.astype(np.int64)  # (M, 4)
    t_delaunay = time.perf_counter() - t0
    if verbose:
        print(f"delaunay cells: {cells.shape[0]}")

    # the points-independent half, once per view; the binary search then pays
    # only phase B
    caches = [integrate_prepare(state, cam, bg, kernel_size=kernel_size,
                                max_per_tile=max_per_tile, instance_budget=instance_budget,
                                device=device)
              for cam, _, _ in views]
    pass_s = []

    def sdf_of(pts):
        t = time.perf_counter()
        out = evaluate_cull_alpha(
            pts, views, masks, state, kernel_size, bg, caches=caches,
            progress=(lambda i, n: print(f"  view {i + 1}/{n}", end="\r")) if verbose else None)
        pass_s.append(time.perf_counter() - t)
        return out

    sdf = sdf_of(points)
    edge_points, edge_sdf, edge_scales, faces = marching_tetrahedra(points, cells, sdf,
                                                                    point_scales)
    if verbose:
        print(f"\ncrossing edges: {edge_points.shape[0]}, faces: {faces.shape[0]}")

    left = edge_points[:, 0].astype(np.float32).copy()
    right = edge_points[:, 1].astype(np.float32).copy()
    left_sdf = edge_sdf[:, 0].astype(np.float32).copy()
    right_sdf = edge_sdf[:, 1].astype(np.float32).copy()
    distance = np.linalg.norm(left - right, axis=-1)
    scale_sum = edge_scales[:, 0] + edge_scales[:, 1]

    for step in range(n_binary_steps):
        if verbose:
            print(f"binary search step {step}")
        mid = (left + right) / 2
        mid_sdf = sdf_of(mid)
        low = ((mid_sdf < 0) & (left_sdf < 0)) | ((mid_sdf > 0) & (left_sdf > 0))
        left_sdf = np.where(low, mid_sdf, left_sdf)
        right_sdf = np.where(low, right_sdf, mid_sdf)
        left = np.where(low[:, None], mid, left)
        right = np.where(low[:, None], right, mid)
    verts = (left + right) / 2

    # edge-length vs scale filter (mesh_extract_tetrahedra.py:107-110)
    vmask = distance <= scale_sum
    fmask = vmask[faces].all(axis=1)
    remap = np.full(verts.shape[0], -1, np.int64)
    remap[vmask] = np.arange(int(vmask.sum()))
    verts = verts[vmask]
    faces = remap[faces[fmask]]
    if stats is not None:
        stats.update(n_seeds=n_seeds, n_seeds_decimated=int(points.shape[0]),
                     delaunay_s=t_delaunay, n_cells=int(cells.shape[0]),
                     n_crossing=int(edge_points.shape[0]), n_faces=int(faces.shape[0]),
                     sdf_pass_s=pass_s)

    if out_path is not None:
        plyio.write_mesh(out_path, verts, faces)
        if verbose:
            print(f"wrote {out_path}: {verts.shape[0]} verts, {faces.shape[0]} faces")
    return verts, faces
