"""Image-space geometry: backprojection and depth / coordinate maps to
normals (port of ``radegs_tpu/core/geometry.py``; reference
utils/graphics_utils.py:97-126), the inputs of the depth-normal
consistency loss (train.py:141-155)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def depths_to_points(camera, depthmap, row0: float = 0.0):
    """Backproject a (R, W) or (1, R, W) depth map to camera-space points
    (3, R, W): rays through pixel centres (x + 0.5, y + 0.5) with the
    principal point at W/2, H/2 (graphics_utils.py:97-111). The map holds
    the image's rows ``row0 .. row0 + R`` (the whole image by default; a
    band of it in the multi-rank step)."""
    H, W = camera.height, camera.width
    R = depthmap.shape[-2]
    dev = depthmap.device
    fx = W / (2.0 * torch.tan(camera.fovx / 2.0))
    fy = H / (2.0 * torch.tan(camera.fovy / 2.0))
    gx = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5 - W / 2.0) / fx
    gy = (row0 + torch.arange(R, dtype=torch.float32, device=dev) + 0.5 - H / 2.0) / fy
    rays = torch.stack([gx[None, :].expand(R, W), gy[:, None].expand(R, W),
                        torch.ones((R, W), dtype=torch.float32, device=dev)], dim=0)
    return depthmap.reshape(1, R, W) * rays


def points_to_normal(points):
    """Central-difference cross-product normals (graphics_utils.py:115-122):
    (..., 3, H, W) -> unit normals (..., 3, H, W), zero on the border. The
    reference's naming is kept: its ``dx`` differences image rows, its
    ``dy`` image columns."""
    d_row = points[..., :, 2:, 1:-1] - points[..., :, :-2, 1:-1]
    d_col = points[..., :, 1:-1, 2:] - points[..., :, 1:-1, :-2]
    n = torch.linalg.cross(d_row, d_col, dim=-3)
    # double-where: degenerate (flat or empty) pixels give zero, not NaN, grads
    n2 = torch.sum(torch.square(n), dim=-3, keepdim=True)
    ok = n2 > 1e-24
    inv = torch.where(ok, 1.0 / torch.sqrt(torch.where(ok, n2, 1.0)), 0.0)
    return F.pad(n * inv, (1, 1, 1, 1))


def depth_double_to_normal(camera, depth1, depth2):
    """(2, 3, H, W) normals from the expected and median depth
    (graphics_utils.py:124-126)."""
    p1 = depths_to_points(camera, depth1)
    p2 = depths_to_points(camera, depth2)
    return points_to_normal(torch.stack([p1, p2], dim=0))


def point_double_to_normal(camera, points1, points2):
    """(2, 3, H, W) normals from the expected and median coordinate maps
    (graphics_utils.py:115-122)."""
    return points_to_normal(torch.stack([points1, points2], dim=0))
