"""TSDF fusion of rendered median depth + mesh extraction (port of
``radegs_tpu/mesh/tsdf.py``; the reference's Open3D VoxelBlockGrid path,
mesh_extract.py:54-105): per view, render median depth masked at
alpha < 0.5 (and an optional GT mask), fuse a truncated SDF into the
16^3-voxel blocks near the back-projected surface, and mesh the zero level
set with marching tetrahedra over a 6-tet cube split (linear interpolation;
the TSDF itself is the refined field).

Constants as the reference: voxel 0.002 (DTU scale), depth_scale 1.0,
depth_max 8.0, truncation 8 voxels.

Depth maps, back-projection, block marking and the fusion are plain torch
on the state's device; the grid is meshed on the host in numpy. The fused
values go to the host as float16 (``io_dtype="f16"``, the JAX package's
default) so that both packages mesh the same field.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from radegs_torch.mesh.tetmesh import marching_tetrahedra
from radegs_torch.renderer import render
from radegs_torch.utils import ply as plyio

# 6-tetrahedra decomposition of a unit cube (corner ids by bit order x+2y+4z)
CUBE_TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 1, 5, 7],
        [0, 2, 3, 7],
        [0, 2, 6, 7],
        [0, 4, 5, 7],
        [0, 4, 6, 7],
    ],
    np.int64,
)


def camera_intrinsics(cam):
    """(3, 3) float32 pinhole K with the principal point at the image centre."""
    fx, fy = float(cam.focal_x), float(cam.focal_y)
    return torch.tensor([[fx, 0, cam.width / 2.0], [0, fy, cam.height / 2.0], [0, 0, 1]],
                        dtype=torch.float32)


@torch.no_grad()
def render_depth_maps(state, views, kernel_size, bg, max_per_tile=1024, alpha_thres=0.5,
                      gt_masks=None, device=None):
    """(depth (H, W), w2c (4, 4), K (3, 3)) float32 tensors on the state's
    device per view (mesh_extract.py:49-61): median depth, 0 where the
    rendered alpha is below ``alpha_thres`` or the GT mask below 0.5.
    ``views``: (camera, gt, index) triples. ``render`` sizes its work
    buffers from each view's demand (no instance budget is given)."""
    out = []
    for i, (cam, _gt, _idx) in enumerate(views):
        pkg = render(state, cam, bg, kernel_size=kernel_size, max_per_tile=max_per_tile,
                     device=device)
        depth = torch.where(pkg["mask"][0] < alpha_thres, 0.0, pkg["median_depth"][0])
        if gt_masks is not None and gt_masks[i] is not None:
            mask = torch.as_tensor(gt_masks[i], device=depth.device)
            depth = torch.where(mask < 0.5, 0.0, depth)
        E = cam.world_view.to(depth.device)
        out.append((depth, E, camera_intrinsics(cam).to(depth.device)))
    return out


def _backproject_all(depth_maps, stride=1):
    """World-space surface points (float64) from every valid depth pixel."""
    pts = []
    for depth, E, K in depth_maps:
        d = depth[::stride, ::stride]
        ys, xs = torch.nonzero(d > 0, as_tuple=True)
        if len(ys) == 0:
            continue
        dd = d[ys, xs].double()
        K, E = K.double(), E.double()
        x = (xs.double() * stride + 0.5 - K[0, 2]) / K[0, 0] * dd
        y = (ys.double() * stride + 0.5 - K[1, 2]) / K[1, 1] * dd
        pc = torch.stack([x, y, dd], -1)
        pts.append((pc - E[:3, 3][None]) @ E[:3, :3])
    if not pts:
        return torch.zeros((0, 3), dtype=torch.float64, device=depth_maps[0][0].device)
    return torch.cat(pts, 0)


def _active_blocks(surf_pts, lo, margin, bedge, nblocks):
    """Ids (x + y BX + z BX BY) of every block that overlaps some surface
    point's +-margin box: the 8..27 corner blocks of each box (a box spans at
    most K + 1 blocks per axis), from the unique boxes."""
    BX, BY, BZ = nblocks
    blo = torch.floor((surf_pts - margin - lo[None]) / bedge).to(torch.int64)
    bhi = torch.floor((surf_pts + margin - lo[None]) / bedge).to(torch.int64)
    pair = torch.unique(torch.cat([blo, bhi], 1), dim=0)
    blo, bhi = pair[:, :3], pair[:, 3:]
    K = int(np.ceil(2 * margin / bedge))  # max blocks spanned per axis - 1
    hi = torch.tensor([BX - 1, BY - 1, BZ - 1], device=surf_pts.device)
    ids = []
    for kx in range(K + 1):
        for ky in range(K + 1):
            for kz in range(K + 1):
                k = torch.tensor([kx, ky, kz], device=surf_pts.device)
                b = torch.minimum(torch.minimum(blo + k, bhi).clamp_min(0), hi)
                ids.append(b[:, 0] + b[:, 1] * BX + b[:, 2] * BX * BY)
    return torch.unique(torch.cat(ids))


def sample_blocks(origins, local, Es, Ks, Ds, trunc, depth_max, io_dtype="f16"):
    """Fused TSDF of the voxels ``origins[:, None] + local[None]`` over all
    views: the mean over the views that see a voxel in front of (or within
    ``trunc`` behind) their surface of clip(sdf / trunc, -1, 1), and the count
    of those views (uint8). ``io_dtype`` "f16" returns the mean as float16."""
    pts = origins[:, None, :] + local[None]  # (nb, b^3, 3)
    H, W = Ds.shape[1:]
    s = torch.zeros(pts.shape[:2], dtype=torch.float32, device=pts.device)
    w = torch.zeros_like(s)
    for E, K, D in zip(Es, Ks, Ds):
        R, t = E[:3, :3], E[:3, 3]
        pc = [pts[..., 0] * R[i, 0] + pts[..., 1] * R[i, 1] + pts[..., 2] * R[i, 2] + t[i]
              for i in range(3)]
        z = pc[2]
        u = K[0, 0] * pc[0] / torch.clamp_min(z, 1e-9) + K[0, 2]
        v = K[1, 1] * pc[1] / torch.clamp_min(z, 1e-9) + K[1, 2]
        ui = torch.clamp(torch.floor(u).to(torch.int64), 0, W - 1)
        vi = torch.clamp(torch.floor(v).to(torch.int64), 0, H - 1)
        dsmp = D.reshape(-1)[vi * W + ui]
        inside = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (z > 0)
        sdf = dsmp - z
        valid = inside & (dsmp > 0) & (z < depth_max) & (sdf > -trunc)
        s = s + torch.where(valid, torch.clamp(sdf / trunc, -1.0, 1.0), 0.0)
        w = w + valid.to(torch.float32)
    s = s / torch.clamp_min(w, 1.0)
    return (s.to(torch.float16) if io_dtype == "f16" else s), w.to(torch.uint8)


@torch.no_grad()
def fuse_tsdf(depth_maps, voxel_size=0.002, trunc_multiplier=8.0, depth_max=8.0,
              bounds=None, block=16, max_resolution=768, block_chunk=512,
              margin_voxels=None, io_dtype="f16", stats=None):
    """Integrate depth maps into a BLOCK-SPARSE TSDF grid.

    Samples only the 16^3-voxel blocks within ``margin_voxels`` (default
    trunc + 2 voxels) of a back-projected surface point (the o3d
    VoxelBlockGrid allocation strategy the reference uses,
    mesh_extract.py:66-101); the far field keeps weight 0 and is excluded by
    ``tsdf_to_mesh``'s validity mask. ``io_dtype``: "f16" brings the fused
    values to the host as float16 (sdf is in [-1, 1]; ~3 decimal digits, far
    below the voxel discretisation), "f32" as they are. ``stats``: a dict
    that receives the seconds of block marking ("mark") and fusion ("fuse"),
    the active block count and the voxel size used after the
    ``max_resolution`` clamp ("voxel_size").

    Returns host numpy (tsdf (Z, Y, X), weight (Z, Y, X), origin (3,),
    voxel_size)."""
    t_mark = time.perf_counter()
    trunc = trunc_multiplier * voxel_size
    surf_pts = _backproject_all(depth_maps)
    if bounds is None:
        if len(surf_pts) == 0:
            return (np.zeros((1, 1, 1), np.float32), np.zeros((1, 1, 1), np.float32),
                    np.zeros(3, np.float32), voxel_size)
        lo = surf_pts.min(0).values.cpu().numpy() - 4 * trunc
        hi = surf_pts.max(0).values.cpu().numpy() + 4 * trunc
        bounds = (lo, hi)
    lo, hi = bounds
    dims = np.ceil((hi - lo) / voxel_size).astype(np.int64) + 1
    if dims.max() > max_resolution:
        # keep memory bounded: coarsen the grid (documented cap, not silent)
        scale = dims.max() / max_resolution
        voxel_size *= float(scale)
        trunc = trunc_multiplier * voxel_size
        dims = np.ceil((hi - lo) / voxel_size).astype(np.int64) + 1
        print(f"[tsdf] grid capped to {dims} (voxel -> {voxel_size:.5f})")
    X, Y, Z = int(dims[0]), int(dims[1]), int(dims[2])
    BX, BY, BZ = [-(-v // block) for v in (X, Y, Z)]  # padded up: edge blocks full

    if margin_voxels is None:
        margin_voxels = trunc_multiplier + 2
    dev = surf_pts.device
    lo_t = torch.as_tensor(np.asarray(lo, np.float64), device=dev)
    active = _active_blocks(surf_pts, lo_t, margin_voxels * voxel_size, block * voxel_size,
                            (BX, BY, BZ))
    NB = int(active.shape[0])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_fuse = time.perf_counter()

    Es = torch.stack([E for _, E, _ in depth_maps]).to(torch.float32)
    Ks = torch.stack([K for _, _, K in depth_maps]).to(torch.float32)
    Ds = torch.stack([d for d, _, _ in depth_maps]).to(torch.float32)
    zz, yy, xx = torch.meshgrid(*(torch.arange(block, device=dev),) * 3, indexing="ij")
    local = torch.stack([xx, yy, zz], -1).reshape(-1, 3).to(torch.float32) * \
        np.float32(voxel_size)
    abx, aby, abz = active % BX, (active // BX) % BY, active // (BX * BY)
    s_parts, w_parts = [], []
    for c0 in range(0, NB, block_chunk):
        sel = slice(c0, min(c0 + block_chunk, NB))
        orig = torch.stack([abx[sel], aby[sel], abz[sel]], -1).to(torch.float32)
        # the block origins as the JAX package rounds them: the float32 block
        # offset added to the float64 grid corner, then to float32
        orig = (lo_t[None] + (orig * np.float32(block * voxel_size)).double()).to(torch.float32)
        s, w = sample_blocks(orig, local, Es, Ks, Ds, trunc, depth_max, io_dtype)
        s_parts.append(s)
        w_parts.append(w)
    s_all = torch.cat(s_parts).cpu().numpy() if s_parts else np.zeros((0, block ** 3))
    w_all = torch.cat(w_parts).cpu().numpy() if w_parts else np.zeros((0, block ** 3))
    act = active.cpu().numpy()
    abx, aby, abz = act % BX, (act // BX) % BY, act // (BX * BY)
    # vectorised block scatter into the dense host grid
    tsdf6 = np.zeros((BZ, BY, BX, block, block, block), np.float32)
    weight6 = np.zeros((BZ, BY, BX, block, block, block), np.float32)
    tsdf6[abz, aby, abx] = s_all.reshape(NB, block, block, block).astype(np.float32)
    weight6[abz, aby, abx] = w_all.reshape(NB, block, block, block)
    tsdf = tsdf6.transpose(0, 3, 1, 4, 2, 5).reshape(BZ * block, BY * block, BX * block)
    weight = weight6.transpose(0, 3, 1, 4, 2, 5).reshape(BZ * block, BY * block, BX * block)
    if stats is not None:
        stats.update(mark=t_fuse - t_mark, fuse=time.perf_counter() - t_fuse, active_blocks=NB,
                     voxel_size=voxel_size)
    return tsdf[:Z, :Y, :X], weight[:Z, :Y, :X], np.asarray(lo, np.float32), voxel_size


def tsdf_to_mesh(tsdf, weight, origin, voxel_size, min_weight=1.0):
    """Zero-level-set mesh via marching tetrahedra over the surface cubes
    (host numpy). Returns (verts (V, 3) float32, faces (F, 3) int64)."""
    Z, Y, X = tsdf.shape
    occ = tsdf > 0
    valid = weight >= min_weight
    # surface cubes: all 8 corners valid and signs mixed (in-place
    # accumulators instead of 8 stacked shifted views)
    n_in = np.zeros((Z - 1, Y - 1, X - 1), np.uint8)
    all_val = np.ones((Z - 1, Y - 1, X - 1), np.bool_)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                n_in += occ[dz : Z - 1 + dz, dy : Y - 1 + dy, dx : X - 1 + dx]
                all_val &= valid[dz : Z - 1 + dz, dy : Y - 1 + dy, dx : X - 1 + dx]
    surf = all_val & (n_in > 0) & (n_in < 8)
    del n_in, all_val
    cz, cy, cx = np.nonzero(surf)
    if len(cz) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    # corner offsets in bit order (dz, dy, dx)
    offs = np.array([(dz, dy, dx) for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)],
                    np.int64)
    corner_idx = (
        (cz[:, None] + offs[None, :, 0]) * (Y * X)
        + (cy[:, None] + offs[None, :, 1]) * X
        + (cx[:, None] + offs[None, :, 2])
    )  # (C, 8) flat grid vertex ids
    tets = corner_idx[:, CUBE_TETS].reshape(-1, 4)  # (C*6, 4)

    used, inv = np.unique(tets.reshape(-1), return_inverse=True)
    tets_local = inv.reshape(-1, 4)
    uz = used // (Y * X)
    uy = (used % (Y * X)) // X
    ux = used % X
    verts_grid = origin[None] + np.stack([ux, uy, uz], -1).astype(np.float64) * voxel_size
    sdf_local = tsdf.reshape(-1)[used]

    edge_points, edge_sdf, _, faces = marching_tetrahedra(
        verts_grid, tets_local, sdf_local, np.ones_like(sdf_local))
    # linear interpolation to the zero crossing
    s0, s1 = edge_sdf[:, 0], edge_sdf[:, 1]
    t = np.clip(np.abs(s0) / np.maximum(np.abs(s0 - s1), 1e-12), 0.0, 1.0)
    verts = edge_points[:, 0] + t[:, None] * (edge_points[:, 1] - edge_points[:, 0])
    return verts.astype(np.float32), faces


def extract_mesh_tsdf(state, views, kernel_size, bg, voxel_size=0.002, out_path=None,
                      gt_masks=None, max_per_tile=1024, max_resolution=768, verbose=True,
                      device=None, stats=None):
    """The reference mesh_extract.py pipeline end to end on ``device``
    (default ``cuda``; the state must already live there). Returns (verts,
    faces) as host numpy and optionally writes ``out_path``. ``stats``: a
    dict that receives the seconds of the depth maps ("depth_maps"), block
    marking ("mark"), fusion ("fuse") and meshing ("mesh"), and the voxel
    size used ("voxel_size")."""
    t0 = time.perf_counter()
    maps = render_depth_maps(state, views, kernel_size, bg, max_per_tile=max_per_tile,
                             gt_masks=gt_masks, device=device)
    if state.device.type == "cuda":
        torch.cuda.synchronize(state.device)
    t1 = time.perf_counter()
    if verbose:
        print(f"rendered {len(maps)} depth maps")
    tsdf, weight, origin, vsz = fuse_tsdf(maps, voxel_size=voxel_size,
                                          max_resolution=max_resolution, stats=stats)
    if verbose:
        print(f"tsdf grid {tsdf.shape}, voxel {vsz:.5f}")
    t2 = time.perf_counter()
    verts, faces = tsdf_to_mesh(tsdf, weight, origin, vsz)
    if stats is not None:
        stats.update(depth_maps=t1 - t0, mesh=time.perf_counter() - t2)
    if out_path is not None:
        plyio.write_mesh(out_path, verts, faces)
        if verbose:
            print(f"wrote {out_path}: {verts.shape[0]} verts, {faces.shape[0]} faces")
    return verts, faces
