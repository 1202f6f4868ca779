"""Unbounded-scene mesh extraction in contracted space (port of
``radegs_tpu/mesh/unbounded.py``; the reference's experimental 2DGS
extractor, utils/mesh_utils.py:163-270 ``extract_mesh_unbounded`` and
utils/mcube_utils.py:17-95): render per-view median depth (+ rgb), contract
space (Mip-NeRF 360) around the camera ring's focus point, fuse a truncated
SDF on a dense grid in CONTRACTED coordinates (the truncation grows with the
contracted radius), mesh the zero level set with the 6-tet split of
``mesh/tsdf.py`` and map the vertices back through the inverse contraction.

The fusion runs block by block in plain torch on the state's device; only
the blocks whose minimum is <= 0 are written into the grid (the reference's
crop skip, mcube_utils.py:70); all-positive blocks keep the far-field 1.

Divergence kept from the JAX package: the adaptive truncation uses the norm
of the uncontracted NORMALISED point (the quantity the 1/(2-r) Jacobian
depends on), not that of the world point (mesh_utils.py:198-202); for a
centre ~ 0, radius ~ 1 scene the two coincide.
"""

from __future__ import annotations

import numpy as np
import torch

from radegs_torch.mesh.tsdf import tsdf_to_mesh
from radegs_torch.renderer import render
from radegs_torch.utils import ply as plyio


def contract(x):
    """Mip-NeRF-360 scene contraction (mesh_utils.py:171-173), on tensors."""
    mag = torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-12)
    return torch.where(mag < 1, x, (2 - 1 / mag) * (x / mag))


def uncontract(y):
    """Inverse contraction, valid for |y| < 2 (mesh_utils.py:175-177), on tensors."""
    mag = torch.clamp_min(torch.linalg.vector_norm(y, dim=-1, keepdim=True), 1e-12)
    return torch.where(mag < 1, y, 1 / torch.clamp_min(2 - mag, 1e-6) * (y / mag))


def focus_point(c2ws):
    """Nearest point to all camera focal axes (render_utils.py:69-75), host
    numpy float64. ``c2ws``: (N, 4, 4) or (N, 3, 4) camera-to-world matrices
    in the OpenCV convention (the reference's flip to OpenGL axes negates the
    directions, which the projector I - d d^T does not see)."""
    poses = np.asarray(c2ws)[:, :3, :]
    directions, origins = poses[:, :3, 2:3], poses[:, :3, 3:4]
    m = np.eye(3) - directions * np.transpose(directions, (0, 2, 1))
    mt_m = np.transpose(m, (0, 2, 1)) @ m
    return np.linalg.inv(mt_m.mean(0)) @ (mt_m @ origins).mean(0)[:, 0]


def scene_normalization(cameras):
    """(centre (3,) float32, radius): the contraction frame of the camera
    ring (mesh_utils.py:236-242: centre = focus point, radius = the least
    camera distance to it)."""
    c2ws = np.stack([np.linalg.inv(cam.world_view.cpu().numpy().astype(np.float64))
                     for cam in cameras])
    center = focus_point(c2ws)
    radius = float(np.linalg.norm(c2ws[:, :3, 3] - center, axis=-1).min())
    return center.astype(np.float32), radius


@torch.no_grad()
def render_rgbd(state, views, kernel_size, bg, max_per_tile=1024, device=None):
    """Per view (rgb (3, H, W) clipped to [0, 1], median depth (H, W) masked
    at alpha < 0.5, full_proj (4, 4)) on the state's device (the
    reconstruction pass, mesh_utils.py:92-116); ``render`` sizes its work
    buffers from each view's demand."""
    out = []
    for cam, _gt, _i in views:
        pkg = render(state, cam, bg, kernel_size=kernel_size, max_per_tile=max_per_tile,
                     device=device)
        depth = torch.where(pkg["mask"][0] < 0.5, 0.0, pkg["median_depth"][0])
        out.append((torch.clamp(pkg["render"], 0.0, 1.0), depth,
                    cam.full_proj.to(depth.device)))
    return out


def _sample_border(img, u, v):
    """grid_sample(bilinear, border, align_corners=True) of (C, H, W) at
    pixel coordinates (u, v) -> (C, n)."""
    C, H, W = img.shape
    u = torch.clamp(u, 0.0, W - 1.0)
    v = torch.clamp(v, 0.0, H - 1.0)
    u0, v0 = torch.floor(u), torch.floor(v)
    u1 = torch.clamp_max(u0 + 1, W - 1)
    v1 = torch.clamp_max(v0 + 1, H - 1)
    fu, fv = u - u0, v - v0
    flat = img.reshape(C, -1)

    def tap(vv, uu):
        return flat[:, (vv * W + uu).to(torch.int64)]

    return ((1 - fu) * (1 - fv) * tap(v0, u0) + fu * (1 - fv) * tap(v0, u1)
            + (1 - fu) * fv * tap(v1, u0) + fu * fv * tap(v1, u1))


def fuse_rgbd(rgbds, pts, sdf_trunc, want_rgb=True):
    """Running-mean fusion over all views at world points ``pts`` (n, 3) with
    per-point truncation ``sdf_trunc`` (n,) (mesh_utils.py:179-232). Returns
    (tsdf (n,), rgb (3, n) or None, the number of real observations (n,))."""
    n = pts.shape[0]
    tsdf = torch.ones((n,), dtype=torch.float32, device=pts.device)
    rgb = torch.zeros((3, n), dtype=torch.float32, device=pts.device)
    w = torch.ones((n,), dtype=torch.float32, device=pts.device)
    for rgbmap, depth, proj in rgbds:
        H, W = depth.shape
        ph = pts @ proj[:, :3].T + proj[:, 3]  # (n, 4) row-major clip
        z = ph[:, 3]
        ndc = ph[:, :2] / torch.where(torch.abs(z) > 1e-8, z, 1e-8)[:, None]
        in_ndc = torch.all((ndc > -1.0) & (ndc < 1.0), dim=1) & (z > 0)
        u = (ndc[:, 0] + 1) * 0.5 * (W - 1)
        v = (ndc[:, 1] + 1) * 0.5 * (H - 1)
        sdf = _sample_border(depth[None], u, v)[0] - z
        ok = in_ndc & (sdf > -sdf_trunc)
        sdf = torch.clamp(sdf / sdf_trunc, -1.0, 1.0)
        wp = w + ok.to(torch.float32)
        tsdf = torch.where(ok, (tsdf * w + sdf) / wp, tsdf)
        if want_rgb:
            c = _sample_border(rgbmap, u, v)
            rgb = torch.where(ok[None], (rgb * w[None] + c) / wp[None], rgb)
        w = wp
    return tsdf, (rgb if want_rgb else None), w - 1.0  # the init carries w = 1


@torch.no_grad()
def extract_mesh_unbounded(state, views, kernel_size, bg, resolution=512, block=64,
                           out_path=None, max_range=32.0, color=True, max_per_tile=1024,
                           verbose=True, mask_unobserved=True, device=None):
    """Contracted-space extraction end to end (mesh_utils.py:163-270) on
    ``device`` (default ``cuda``; the state must already live there).

    ``mask_unobserved`` (the JAX package's divergence from the reference,
    default on): only cubes all of whose corners received a real depth
    observation are meshed, which removes the spurious shell the reference
    leaves ~5 voxels behind every closed surface; False meshes as the
    reference does.

    Returns host numpy (verts (V, 3) world, faces (F, 3)[, vert_colors (V, 3)])."""
    if resolution % block:
        raise ValueError(f"resolution {resolution} is not a multiple of block {block}")
    cams = [v[0] for v in views]
    center, radius = scene_normalization(cams)
    voxel_size = radius * 2.0 / resolution  # mesh_utils.py:246 (world units)
    rgbds = render_rgbd(state, views, kernel_size, bg, max_per_tile=max_per_tile,
                        device=device)
    dev = state.device
    center_t = torch.as_tensor(center, device=dev)

    # grid bound: 95th percentile of the contracted splat radii (mesh_utils:251)
    xyz = state.params.xyz[state.active]
    cr = torch.linalg.vector_norm(contract((xyz - center_t) / radius), dim=-1)
    R = min(float(np.quantile(cr.cpu().numpy(), 0.95)) + 0.01, 1.9)
    if verbose:
        print(f"[unbounded] center {center.round(3)} radius {radius:.3f} grid R {R:.3f} "
              f"resolution {resolution}", flush=True)

    NB = resolution // block
    axis = torch.as_tensor(np.linspace(-R, R, resolution, dtype=np.float32), device=dev)
    gvox = 2.0 * R / (resolution - 1)  # contracted-space grid step
    zz, yy, xx = torch.meshgrid(*(torch.arange(block, device=dev),) * 3, indexing="ij")
    local = torch.stack([xx, yy, zz], -1).reshape(-1, 3).to(torch.float32) * np.float32(gvox)
    grid = torch.ones((resolution,) * 3, dtype=torch.float32, device=dev)
    wgrid = torch.ones_like(grid)
    n_fetch = 0
    for bi in range(NB):
        for bj in range(NB):
            for bk in range(NB):
                base = torch.stack([axis[bk * block], axis[bj * block], axis[bi * block]])
                y = base[None] + local  # (block^3, 3) contracted, x fastest
                un = uncontract(y)
                mag_n = torch.linalg.vector_norm(un, dim=-1)
                world = un * radius + center_t[None]
                trunc = 5.0 * voxel_size * torch.where(
                    mag_n > 1, 1.0 / torch.clamp_min(2.0 - torch.clamp_max(mag_n, 1.9), 1e-6),
                    1.0)
                tsdf, _, n_obs = fuse_rgbd(rgbds, world, trunc, want_rgb=False)
                if float(tsdf.min()) > 0.0:
                    continue  # all positive: keeps the far-field init 1
                sl = (slice(bi * block, (bi + 1) * block), slice(bj * block, (bj + 1) * block),
                      slice(bk * block, (bk + 1) * block))
                grid[sl] = tsdf.reshape(block, block, block)
                wgrid[sl] = n_obs.reshape(block, block, block)
                n_fetch += 1
    if verbose:
        print(f"[unbounded] fetched {n_fetch}/{NB ** 3} blocks", flush=True)

    # mesh in contracted coordinates (grid is (z, y, x)-indexed)
    origin = np.array([-R, -R, -R], np.float32)
    grid_h = grid.cpu().numpy()
    wgrid_h = wgrid.cpu().numpy() if mask_unobserved else np.full_like(grid_h, 2.0)
    verts_c, faces = tsdf_to_mesh(grid_h, wgrid_h, origin, gvox, min_weight=1.0)
    if len(verts_c) == 0:
        empty = np.zeros((0, 3), np.float32)
        return (verts_c, faces, empty) if color else (verts_c, faces)
    verts = uncontract(torch.from_numpy(verts_c.astype(np.float64))).numpy() * radius \
        + center[None]
    verts = np.clip(verts, -max_range, max_range).astype(np.float32)

    cols = None
    if color:
        # texture by re-fusing rgb at the world vertices (mesh_utils:264-269)
        parts = []
        for s0 in range(0, len(verts), 1 << 18):
            chunk = torch.as_tensor(verts[s0:s0 + (1 << 18)], device=dev)
            _, rgb, _ = fuse_rgbd(rgbds, chunk, torch.full((chunk.shape[0],), 5.0 * voxel_size,
                                                            device=dev))
            parts.append(rgb.T.cpu().numpy())
        cols = np.clip(np.concatenate(parts), 0.0, 1.0)

    if out_path is not None:
        plyio.write_mesh(out_path, verts, faces, vertex_colors=cols)
        if verbose:
            print(f"[unbounded] wrote {out_path}: {len(verts)} verts, {len(faces)} faces",
                  flush=True)
    return (verts, faces, cols) if color else (verts, faces)
