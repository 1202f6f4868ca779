"""Gaussian primitive math: quaternions, covariances, the Mip-Splatting 3D
filter (port of ``radegs_tpu/core/gaussians.py``).

Reference semantics:
- quaternion -> rotation: utils/general_utils.py:80-101 (w,x,y,z layout).
- covariance build: cuda_rasterizer/forward.cu:270-304 (Sigma = R S^2 R^T).
- 3D filter fusion: scene/gaussian_model.py:117-166.

Layouts are (P, k): a symmetric 3x3 is either a (P,3,3) matrix or the
reference's 6-float (P,6) ``sym6`` row [xx, xy, xz, yy, yz, zz].
"""

from __future__ import annotations

import torch

from radegs_torch.utils import trace


def quat_to_rotmat_raw(q):
    """Quaternion(s) (w,x,y,z) -> rotation matrices, WITHOUT normalisation
    (the rasterizer preprocess skips it, forward.cu:279). (..., 4) -> (..., 3, 3)."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack(
        [
            1 - 2 * (y * y + z * z),
            2 * (x * y - r * z),
            2 * (x * z + r * y),
            2 * (x * y + r * z),
            1 - 2 * (x * x + z * z),
            2 * (y * z - r * x),
            2 * (x * z - r * y),
            2 * (y * z + r * x),
            1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return R.reshape(q.shape[:-1] + (3, 3))


def quat_to_rotmat(q):
    """Unit-normalise, then convert (utils/general_utils.py:80-101)."""
    return quat_to_rotmat_raw(q / torch.linalg.vector_norm(q, dim=-1, keepdim=True))


def build_covariance(scales, quats, scale_modifier=1.0):
    """World-space covariance Sigma = R diag(s^2) R^T (forward.cu:270-304).
    ``quats`` are not re-normalised. Returns (..., 3, 3)."""
    R = quat_to_rotmat_raw(quats)
    s2 = torch.square(scales * scale_modifier)
    return (R * s2[..., None, :]) @ R.transpose(-1, -2)


_SYM6 = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def cov3d_to_sym6(cov):
    """(..., 3, 3) -> (..., 6) [xx, xy, xz, yy, yz, zz] (forward.cu:296-303)."""
    return torch.stack([cov[..., i, j] for i, j in _SYM6], dim=-1)


def sym6_to_cov3d(sym6):
    xx, xy, xz, yy, yz, zz = sym6.unbind(-1)
    return torch.stack(
        [torch.stack([xx, xy, xz], -1), torch.stack([xy, yy, yz], -1),
         torch.stack([xz, yz, zz], -1)],
        dim=-2,
    )


def sym6_inverse(sym6):
    """Adjugate inverse of (..., 6) sym6 -> (..., 6); a singular input
    (det == 0) gives zeros."""
    xx, xy, xz, yy, yz, zz = sym6.unbind(-1)
    cof_xx = yy * zz - yz * yz
    cof_xy = xz * yz - xy * zz
    cof_xz = xy * yz - xz * yy
    cof_yy = xx * zz - xz * xz
    cof_yz = xy * xz - xx * yz
    cof_zz = xx * yy - xy * xy
    det = xx * cof_xx + xy * cof_xy + xz * cof_xz
    inv = torch.where(det == 0, 0.0, 1.0 / torch.where(det == 0, 1.0, det))
    return torch.stack([cof_xx, cof_xy, cof_xz, cof_yy, cof_yz, cof_zz], -1) * inv[..., None]


# ---- Mip-Splatting 3D filter (scene/gaussian_model.py:117-166) --------------


def fuse_3d_filter(scales, opacity, filter_3d):
    """Fused getter (gaussian_model.py:157-166): returns (scales', opacity')
    with scales' = sqrt(s^2 + f^2) and opacity' = opacity * sqrt(det ratio)."""
    s2 = torch.square(scales)
    s2f = s2 + torch.square(filter_3d)
    ratio = torch.prod(s2 / s2f, dim=-1)
    trace.sync_node(ratio, "fuse_3d_filter.prod_backward")  # its backward reads the device
    coef = torch.sqrt(ratio)
    return torch.sqrt(s2f), opacity * coef[..., None]


def compute_3d_filter(xyz, cameras):
    """Per-point Mip 3D filter width (scene/gaussian_model.py:180-232): the
    minimum camera-space depth over the cameras that see the point (z > 0.2,
    inside a 15%-padded image), the largest visible depth for points no
    camera sees; filter = min_z / max_focal * sqrt(0.2). Returns (P, 1)."""
    P = xyz.shape[0]
    distance = torch.full((P,), 1e5, dtype=torch.float32, device=xyz.device)
    valid_any = torch.zeros((P,), dtype=torch.bool, device=xyz.device)
    focal_length = torch.zeros((), dtype=torch.float32, device=xyz.device)
    for cam in cameras:
        W, H = cam.width, cam.height
        focal_x = W / (2.0 * torch.tan(cam.fovx / 2.0))
        xyz_cam = xyz @ cam.R + cam.T[None, :]  # R is c2w: w2c = R.T
        z = xyz_cam[:, 2]
        zc = torch.clamp_min(z, 0.001)
        x = xyz_cam[:, 0] / zc * focal_x + W / 2.0
        y = xyz_cam[:, 1] / zc * (H / (2.0 * torch.tan(cam.fovy / 2.0))) + H / 2.0
        in_screen = (x >= -0.15 * W) & (x <= 1.15 * W) & (y >= -0.15 * H) & (y <= 1.15 * H)
        valid = (z > 0.2) & in_screen
        distance = torch.where(valid, torch.minimum(distance, zc), distance)
        valid_any = valid_any | valid
        focal_length = torch.maximum(focal_length, focal_x)
    with trace.sync("filter3d.far", 2):  # the test and the boolean index
        if bool(valid_any.any()):
            max_visible = distance[valid_any].max()
        else:  # nothing visible at all: the 1e5 sentinel
            max_visible = torch.full((), 1e5, dtype=torch.float32, device=xyz.device)
    distance = torch.where(valid_any, distance, max_visible)
    return (distance / focal_length * (0.2 ** 0.5))[:, None]
