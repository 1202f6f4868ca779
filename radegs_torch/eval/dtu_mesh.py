"""DTU mesh preparation: align the reconstruction to the DTU reference frame
and cull by the observation masks (evaluate_dtu_mesh.py:16-194).

The port's own copy of ``radegs_tpu/eval/dtu_mesh.py`` (numpy), taking the
port's cameras: the ``(Camera, gt, index)`` tuples of ``data.scene.Scene``.
The reference aligns via Procrustes on camera centers (its cameras vs the
DTU calibration), then removes mesh faces whose vertices fall outside every
view's dilated foreground mask.
"""

from __future__ import annotations

import numpy as np

from radegs_torch.eval.tnt import umeyama
from radegs_torch.utils import ply as plyio


def best_fit_transform(A, B):
    """Procrustes with scale A->B (evaluate_dtu_mesh.py:16-57):
    returns 4x4 T with B ~= T @ [A,1]."""
    s, R, t = umeyama(A, B, with_scale=True)
    T = np.eye(4)
    T[:3, :3] = s * R
    T[:3, 3] = t
    return T


def binary_dilate(mask, it=1):
    """Cheap binary dilation (replaces skimage.morphology.dilation)."""
    m = mask.astype(bool)
    for _ in range(it):
        p = np.pad(m, 1)
        m = (
            p[1:-1, 1:-1] | p[:-2, 1:-1] | p[2:, 1:-1] | p[1:-1, :-2] | p[1:-1, 2:]
            | p[:-2, :-2] | p[:-2, 2:] | p[2:, :-2] | p[2:, 2:]
        )
    return m


def cull_mesh_by_masks(vertices, faces, cameras, masks, dilate=12):
    """Keep faces whose vertices project inside the (dilated) mask of at
    least every... the reference requires ALL projecting views agree
    (evaluate_dtu_mesh.py:82-138 keeps vertices inside the union of dilated
    masks and in front of the cameras)."""
    keep = np.zeros(len(vertices), bool)
    for (cam, _, _), mask in zip(cameras, masks):
        E = cam.world_view.cpu().numpy()
        pc = vertices @ E[:3, :3].T + E[:3, 3]
        z = pc[:, 2]
        fx = float(cam.focal_x)
        fy = float(cam.focal_y)
        u = fx * pc[:, 0] / np.maximum(z, 1e-9) + cam.width / 2.0
        v = fy * pc[:, 1] / np.maximum(z, 1e-9) + cam.height / 2.0
        inside = (z > 0) & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
        m = binary_dilate(np.asarray(mask) > 0.5, dilate)
        ui = np.clip(u.astype(np.int64), 0, cam.width - 1)
        vi = np.clip(v.astype(np.int64), 0, cam.height - 1)
        keep |= inside & m[vi, ui]
    fmask = keep[faces].all(axis=1)
    remap = np.full(len(vertices), -1, np.int64)
    remap[keep] = np.arange(int(keep.sum()))
    return vertices[keep], remap[faces[fmask]]


def align_and_cull(mesh_path, cameras, dtu_cam_centers, masks=None, out_path=None):
    """evaluate_dtu_mesh.py main flow: Procrustes-align our camera centers to
    the DTU calibration centers, transform the mesh, optionally cull."""
    verts, faces = plyio.read_mesh(mesh_path)
    ours = np.stack([c[0].camera_center.cpu().numpy() for c in cameras])
    T = best_fit_transform(ours, np.asarray(dtu_cam_centers))
    verts = verts @ T[:3, :3].T + T[:3, 3]
    if masks is not None:
        # masks are in the original camera frame; cull before writing
        verts_orig = (verts - T[:3, 3]) @ np.linalg.inv(T[:3, :3]).T
        keep_v, keep_f = cull_mesh_by_masks(verts_orig, faces, cameras, masks)
        verts = keep_v @ T[:3, :3].T + T[:3, 3]
        faces = keep_f
    if out_path:
        plyio.write_mesh(out_path, verts.astype(np.float32), faces)
    return verts, faces, T
