"""Mesh visibility culling + floater post-processing (port of
``radegs_tpu/mesh/culling.py``):

- ``eval_tnt/cull_mesh.py:17-290``: render per-view mesh DEPTH maps, mark a
  vertex "seen" if it projects inside the frustum of >= ``min_views`` cameras
  in front of the rendered surface (z < depth + eps, grid_sample border /
  align_corners), keep only faces whose three vertices are seen.
- ``utils/mesh_utils.py:23-44`` (``post_process_mesh``): keep the
  ``cluster_to_keep`` largest edge-connected triangle clusters (at least 50
  triangles), dropping floaters.
- ``eval_tnt/cull_mesh.py:187-202`` (``get_connected_mesh``): keep the
  largest-area component, or every component above an area fraction.

The depth renderer is plain torch: triangles ride the port's tile binning
(``ops/binning.bin_gaussians`` on bounding circles, radius rects only), then
every tile's pixels z-buffer their faces with screen-space edge functions
and a min-reduction, perspective-correct through linear-in-screen 1/z.
Triangles with a vertex at or behind ``znear`` are dropped instead of
clipped; both windings are rasterized (SKIP_CULL_FACES, cull_mesh.py:44).
The connected-component parts are host numpy / scipy.
"""

from __future__ import annotations

import numpy as np
import torch

from radegs_torch.ops.binning import TILE, bin_gaussians, tile_grid
from radegs_torch.ops.rasterize import untile
from radegs_torch.utils.device import resolve_device


def project_verts(verts, w2c, fx, fy, cx, cy):
    """World -> (u, v, z_cam) with u = fx x / z + cx (cull_mesh.py:144-152)."""
    vc = verts @ w2c[:3, :3].T + w2c[:3, 3]
    z = vc[:, 2]
    return fx * vc[:, 0] / z + cx, fy * vc[:, 1] / z + cy, z


@torch.no_grad()
def mesh_depth_map(verts, faces, w2c, fx, fy, cx, cy, width, height, max_per_tile=2048,
                   instance_budget=None, chunk=128, znear=0.01, zfar=1e6, device=None):
    """Depth-only z-buffer rasterization of a triangle mesh on ``device``
    (default ``cuda``).

    Returns ((H, W) float32 camera-space depth, 0 where nothing was hit — the
    pyrender convention cull_mesh.py relies on; the tile_overflow count).
    Pixel (ix, iy) samples the ray through pixel coordinate (ix, iy), not
    (ix + .5, iy + .5), matching the align_corners=True depth sampling of
    ``point_visibility`` (cull_mesh.py:157-163)."""
    dev = resolve_device(device)
    verts = torch.as_tensor(verts, dtype=torch.float32, device=dev)
    faces = torch.as_tensor(faces, dtype=torch.int64, device=dev)
    w2c = torch.as_tensor(w2c, dtype=torch.float32, device=dev)
    F = faces.shape[0]
    u, v, z = project_verts(verts, w2c, fx, fy, cx, cy)
    tu, tv, tz = u[faces], v[faces], z[faces]  # (F, 3)
    valid = torch.all(tz > znear, dim=1) & torch.all(tz < zfar, dim=1)

    # bounding circle per face -> ride the Gaussian tile binning
    cxy = torch.stack([tu.mean(1), tv.mean(1)], dim=1)  # (F, 2)
    rad = torch.sqrt(torch.amax((tu - cxy[:, :1]) ** 2 + (tv - cxy[:, 1:2]) ** 2, dim=1))
    rad = torch.where(valid, rad + 1.0, 0.0)
    if instance_budget is None:
        instance_budget = 1 << max(14, (int(F) * 8 - 1).bit_length())
    binning = bin_gaussians(cxy, rad, tz.mean(1), valid, width, height,
                            instance_budget=min(instance_budget, 1 << 24),
                            max_per_tile=max_per_tile, tile=TILE, need_tile_gauss=True)

    # (F + 1, 10) face table; row F = a dead face for the -1 slots
    feat = torch.cat([tu, tv, 1.0 / tz, valid[:, None].to(torch.float32)], dim=1)
    feat = torch.cat([feat, torch.zeros((1, 10), device=dev)])
    tiles_x, _ = tile_grid(width, height)
    T = binning.tile_count.shape[0]
    t = torch.arange(T, device=dev)
    i = torch.arange(TILE * TILE, device=dev)
    pxs = ((t % tiles_x)[:, None] * TILE + (i % TILE)[None, :]).to(torch.float32)[:, None]
    pys = ((t // tiles_x)[:, None] * TILE + (i // TILE)[None, :]).to(torch.float32)[:, None]

    gid = binning.tile_gauss.to(torch.int64)
    # faces per step: bound the (T, chunk, 256) temporaries at ~2^24 elements
    step = max(1, min(chunk, (1 << 24) // max(T * TILE * TILE, 1)))
    best = torch.full((T, TILE * TILE), torch.inf, device=dev)
    for c0 in range(0, gid.shape[1], step):
        g = gid[:, c0:c0 + step]
        f = feat[torch.where(g >= 0, g, F)]  # (T, c, 10)
        ok = (g >= 0) & (f[..., 9] > 0.5)
        au, bu, cu = f[..., 0:1], f[..., 1:2], f[..., 2:3]
        av, bv, cv = f[..., 3:4], f[..., 4:5], f[..., 5:6]
        qa, qb, qc = f[..., 6:7], f[..., 7:8], f[..., 8:9]
        # edge functions against the pixels: w_A = E_BC(p) etc.
        wa = (cu - bu) * (pys - bv) - (cv - bv) * (pxs - bu)
        wb = (au - cu) * (pys - cv) - (av - cv) * (pxs - cu)
        wc = (bu - au) * (pys - av) - (bv - av) * (pxs - au)
        area = wa + wb + wc
        inside = ((wa >= 0) & (wb >= 0) & (wc >= 0)) | ((wa <= 0) & (wb <= 0) & (wc <= 0))
        nz = torch.abs(area) > 1e-12
        inside = inside & nz & ok[..., None]
        inv = (wa * qa + wb * qb + wc * qc) / torch.where(nz, area, 1.0)
        zpix = torch.where(inside & (inv > 1e-12), 1.0 / torch.clamp_min(inv, 1e-12), torch.inf)
        best = torch.minimum(best, zpix.amin(1))
    best = torch.where(torch.isfinite(best), best, 0.0)
    return untile(best[None], width, height)[0], binning.tile_overflow


def _bilinear_border(img, u, v):
    """grid_sample(padding_mode='border', align_corners=True) of (H, W) at
    pixel coordinates (u, v) (cull_mesh.py:157-163)."""
    H, W = img.shape
    u = torch.clamp(u, 0.0, W - 1.0)
    v = torch.clamp(v, 0.0, H - 1.0)
    u0 = torch.clamp(torch.floor(u), 0, W - 1)
    v0 = torch.clamp(torch.floor(v), 0, H - 1)
    u1 = torch.clamp(u0 + 1, 0, W - 1)
    v1 = torch.clamp(v0 + 1, 0, H - 1)
    fu, fv = u - u0, v - v0

    def at(vv, uu):
        return img[vv.to(torch.int64), uu.to(torch.int64)]

    return ((1 - fu) * (1 - fv) * at(v0, u0) + fu * (1 - fv) * at(v0, u1)
            + (1 - fu) * fv * at(v1, u0) + fu * fv * at(v1, u1))


def _seen_one_view(points, depth, w2c, fx, fy, cx, cy, eps, width, height):
    u, v, z = project_verts(points, w2c, fx, fy, cx, cy)
    in_frustum = (u >= 0) & (u <= width - 1) & (v >= 0) & (v <= height - 1) & (z > 0)
    d = _bilinear_border(depth, u, v)
    # depth 0 = nothing rendered there -> treated as visible
    # (cull_mesh.py:165 torch.where(depth_sample > 0, z < d + eps, True))
    front = torch.where(d > 0.0, z < d + eps, True)
    return in_frustum & front


def camera_tuple(cam):
    """(w2c (4, 4) numpy, fx, fy, cx, cy, W, H) of a port Camera (principal
    point at the image centre, as the reference's to_cam_open3d assumes,
    utils/mesh_utils.py:49-54), or such a tuple passed through."""
    if isinstance(cam, tuple):
        return cam
    return (cam.world_view.cpu().numpy(), float(cam.focal_x), float(cam.focal_y),
            cam.width / 2.0, cam.height / 2.0, cam.width, cam.height)


@torch.no_grad()
def point_visibility(points, cameras, depth_maps=None, meshes=None, eps=0.005,
                     min_views=20, batch=500_000, device=None):
    """Per-point seen mask (host numpy bool) over a camera list
    (cull_mesh.py:96-183), on ``device`` (default ``cuda``).

    ``cameras``: port Cameras or (w2c, fx, fy, cx, cy, W, H) tuples.
    ``depth_maps``: optional (H, W) arrays per camera; if None, ``meshes`` =
    (verts, faces) is rasterized per view. A point counts as seen when
    >= ``min_views`` cameras observe it (cull_mesh.py:175), capped at the
    camera count."""
    dev = resolve_device(device)
    cams = [camera_tuple(c) for c in cameras]
    if depth_maps is None:
        verts, faces = meshes
        depth_maps = [mesh_depth_map(verts, faces, w2c, fx, fy, cx, cy, W, H, device=dev)[0]
                      for (w2c, fx, fy, cx, cy, W, H) in cams]
    depth_maps = [torch.as_tensor(d, dtype=torch.float32, device=dev) for d in depth_maps]
    need = min(min_views, len(cams))
    points = torch.as_tensor(points, dtype=torch.float32, device=dev)
    out = []
    for s0 in range(0, points.shape[0], batch):
        pts = points[s0:s0 + batch]
        count = torch.zeros((pts.shape[0],), dtype=torch.int32, device=dev)
        for (w2c, fx, fy, cx, cy, W, H), depth in zip(cams, depth_maps):
            w2c = torch.as_tensor(w2c, dtype=torch.float32, device=dev)
            count += _seen_one_view(pts, depth, w2c, fx, fy, cx, cy, eps, W, H).to(torch.int32)
        out.append((count >= need).cpu().numpy())
    return np.concatenate(out, axis=0)


def remove_unreferenced_vertices(verts, faces):
    """Compact the vertex array to the referenced vertices only."""
    verts = np.asarray(verts)
    faces = np.asarray(faces)
    used = np.zeros(len(verts), bool)
    used[faces.ravel()] = True
    remap = np.cumsum(used) - 1
    return verts[used], remap[faces]


def cull_mesh(verts, faces, cameras, eps=0.005, min_views=20, device=None):
    """Drop faces any of whose vertices is unseen (cull_mesh.py:247-250).
    Returns (verts, faces) with unreferenced vertices removed."""
    mask = point_visibility(verts, cameras, meshes=(verts, faces), eps=eps,
                            min_views=min_views, device=device)
    keep = mask[np.asarray(faces)].all(axis=1)
    return remove_unreferenced_vertices(verts, np.asarray(faces)[keep])


def _triangle_clusters(faces):
    """Edge-connected triangle components (open3d cluster_connected_triangles
    semantics). Returns (labels (F,), sizes)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    faces = np.asarray(faces)
    F = len(faces)
    # canonical edge keys: faces sharing an edge are adjacent
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e.sort(axis=1)
    fid = np.tile(np.arange(F), 3)
    order = np.lexsort((e[:, 1], e[:, 0]))
    e, fid = e[order], fid[order]
    same = (e[1:] == e[:-1]).all(axis=1)
    a, b = fid[:-1][same], fid[1:][same]
    g = coo_matrix((np.ones(len(a)), (a, b)), shape=(F, F))
    n, labels = connected_components(g, directed=False)
    return labels, np.bincount(labels, minlength=n)


def post_process_mesh(verts, faces, cluster_to_keep=1000, min_triangles=50):
    """Keep the ``cluster_to_keep`` largest edge-connected triangle clusters
    (>= max(k-th size, 50) triangles), utils/mesh_utils.py:23-44."""
    faces = np.asarray(faces)
    labels, sizes = _triangle_clusters(faces)
    if len(sizes) == 0:
        return np.asarray(verts), faces
    srt = np.sort(sizes)
    nth = srt[-min(cluster_to_keep, len(srt))]
    keep = sizes[labels] >= max(int(nth), min_triangles)
    return remove_unreferenced_vertices(verts, faces[keep])


def keep_largest_component(verts, faces, area_fraction=None):
    """The largest-area connected component, or every component with area >
    ``area_fraction`` of the total (cull_mesh.py:187-202)."""
    verts = np.asarray(verts)
    faces = np.asarray(faces)
    labels, _ = _triangle_clusters(faces)
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    comp_area = np.zeros(labels.max() + 1)
    np.add.at(comp_area, labels, area)
    if area_fraction is None:
        keep = labels == comp_area.argmax()
    else:
        keep = comp_area[labels] > area_fraction * comp_area.sum()
    return remove_unreferenced_vertices(verts, faces[keep])
