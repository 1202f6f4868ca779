"""The reference's own scene set-up: cameras, the initial splats from a
point cloud and the Mip 3D filter, in plain PyTorch.

The published recipe (3DGS / Mip-Splatting / RaDe-GS
``scene/gaussian_model.py``): scales from the mean squared distance to the
3 nearest neighbours (an exact search of its own, not the program's),
identity rotations, DC colour from RGB, and the 3D filter from the training
cameras. Nothing here imports the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

SH_C0 = 0.28209479177387814


@dataclass(frozen=True)
class Cam:
    """A pinhole camera: ``R`` (3, 3) camera-to-world rotation and ``T`` (3,)
    world-to-camera translation (``p_view = R.T p + T``), the fields of view
    in radians, the image size."""

    R: torch.Tensor
    T: torch.Tensor
    fovx: float
    fovy: float
    width: int
    height: int
    znear: float = 0.01
    zfar: float = 100.0

    @property
    def device(self):
        return self.R.device

    @property
    def tanfovx(self):
        return torch.tan(torch.tensor(self.fovx * 0.5, dtype=torch.float32, device=self.device))

    @property
    def tanfovy(self):
        return torch.tan(torch.tensor(self.fovy * 0.5, dtype=torch.float32, device=self.device))

    @property
    def focal_x(self):
        return self.width / (2.0 * self.tanfovx)

    @property
    def focal_y(self):
        return self.height / (2.0 * self.tanfovy)

    @property
    def world_view(self):
        top = torch.cat([self.R.T, self.T[:, None]], dim=1)
        bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=self.device)
        return torch.cat([top, bottom], dim=0)

    @property
    def full_proj(self):
        zn, zf = self.znear, self.zfar
        P = torch.zeros((4, 4), dtype=torch.float32, device=self.device)
        P[0, 0] = 1.0 / self.tanfovx
        P[1, 1] = 1.0 / self.tanfovy
        P[2, 2] = float(np.float32(zf / (zf - zn)))
        P[2, 3] = float(np.float32(-(zf * zn) / (zf - zn)))
        P[3, 2] = 1.0
        return P @ self.world_view

    @property
    def camera_center(self):
        return -(self.R @ self.T)


def look_at(eye, target, up, fovx, fovy, width, height, device) -> Cam:
    """The camera at ``eye`` looking at ``target``: x right, y down, z forward."""
    eye, target, up = (np.asarray(v, np.float64) for v in (eye, target, up))
    fwd = (target - eye) / np.linalg.norm(target - eye)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    Rw2c = np.stack([right, down, fwd], axis=0)
    f32 = np.float32
    return Cam(torch.tensor(Rw2c.T.astype(f32), device=device),
               torch.tensor((-Rw2c @ eye).astype(f32), device=device),
               float(f32(fovx)), float(f32(fovy)), int(width), int(height))


# ---- 3-NN mean squared distance ---------------------------------------------


def _expand_bits(v):
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _morton_order(points):
    lo, hi = points.min(0).values, points.max(0).values
    q = torch.clamp((points - lo) / torch.clamp_min(hi - lo, 1e-9) * 1023.0, 0, 1023)
    q = q.to(torch.int64)
    code = _expand_bits(q[:, 0]) | (_expand_bits(q[:, 1]) << 1) | (_expand_bits(q[:, 2]) << 2)
    return torch.sort(code, stable=True).indices


def _dist2(a, b):
    """(n, 3), (m, 3) -> (n, m) squared distances, axis by axis."""
    return sum((a[:, None, i] - b[None, :, i]) ** 2 for i in range(3))


def _k_smallest_other(q_idx, q, c_idx, c, k, best=None):
    """The ``k`` smallest squared distances from each query to the
    candidates, a point's own index left out; merged with ``best``."""
    d2 = _dist2(q, c)
    d2 = torch.where(q_idx[:, None] == c_idx[None, :], torch.inf, d2)
    if best is not None:
        d2 = torch.cat([best, d2], dim=1)
    return torch.topk(d2, min(k, d2.shape[1]), dim=1, largest=False).values


def mean_dist2_knn(points, k: int = 3, block: int = 1024, window: int = 16,
                   chunk: int = 1 << 17):
    """(P, 3) -> (P,): the mean squared distance to the ``k`` nearest other
    points, exact. Each point's neighbours among its ``window`` Morton
    neighbours on either side bound its k-th distance from above; a block
    of ``block`` Morton-consecutive points then searches every point inside
    its box grown by the block's largest bound, which holds every true
    neighbour. Points are told apart by index, so two neighbours at the
    same distance both count."""
    P = points.shape[0]
    dev = points.device
    idx = torch.arange(P, device=dev)
    if P <= 2 * block:
        return _k_smallest_other(idx, points, idx, points, k).mean(-1)
    order = _morton_order(points)
    sp = points[order]
    W = min(window, P - 1)
    j = torch.clamp(torch.arange(P, device=dev)[:, None]
                    + torch.arange(-W, W + 1, device=dev)[None, :], 0, P - 1)
    d2 = sum((sp[j, i] - sp[:, None, i]) ** 2 for i in range(3))
    d2 = torch.where(j == torch.arange(P, device=dev)[:, None], torch.inf, d2)
    d2 = torch.where(torch.cat([j[:, :1] * 0 - 1, j[:, :-1]], 1) == j, torch.inf, d2)
    bound = torch.topk(d2, k, dim=1, largest=False).values[:, -1]
    reach = torch.sqrt(bound) * (1 + 1e-5) + 1e-6
    out = torch.empty((P,), dtype=points.dtype, device=dev)
    for s in range(0, P, block):
        q_idx = order[s:s + block]
        q = sp[s:s + block]
        r = reach[s:s + block].max()
        lo, hi = q.min(0).values - r, q.max(0).values + r
        inside = ((points >= lo) & (points <= hi)).all(1)
        c_idx = torch.nonzero(inside).squeeze(1)
        best = None
        for c0 in range(0, c_idx.numel(), chunk):
            ci = c_idx[c0:c0 + chunk]
            best = _k_smallest_other(q_idx, q, ci, points[ci], k, best)
        out[q_idx] = best.mean(-1)
    return out


# ---- initial splats and the 3D filter --------------------------------------


def logit(p: float) -> float:
    """float32 inverse sigmoid, as a Python float."""
    x = torch.tensor(p, dtype=torch.float32)
    return float(torch.log(x / (1.0 - x)))


def initial_params(points, colors, scale_shrink: float, opacity: float, sh_degree: int = 3,
                   dist2=None):
    """The optimisable tensors of a scene made from a point cloud: xyz,
    f_dc (P,1,3), f_rest (P,M-1,3) zeros, log-scales from the 3-NN spacing
    (``dist2``, the mean squared distance, or ``mean_dist2_knn``'s) times
    ``scale_shrink``, identity rotations, opacity logits."""
    P = points.shape[0]
    dev = points.device
    if dist2 is None:
        dist2 = mean_dist2_knn(points)
    dist2 = torch.clamp_min(dist2, 1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    if scale_shrink != 1.0:
        scales = scales + float(np.log(scale_shrink))
    rot = torch.zeros((P, 4), dtype=torch.float32, device=dev)
    rot[:, 0] = 1.0
    M = (sh_degree + 1) ** 2
    return {
        "xyz": points.clone(),
        "f_dc": ((colors - 0.5) / SH_C0)[:, None, :],
        "f_rest": torch.zeros((P, M - 1, 3), dtype=torch.float32, device=dev),
        "scaling": scales,
        "rotation": rot,
        "opacity": torch.full((P, 1), logit(opacity), dtype=torch.float32, device=dev),
    }


def filter_3d(xyz, cams) -> torch.Tensor:
    """Per-point Mip 3D filter width: the least depth over the cameras that
    see the point (z > 0.2, inside the image padded by 15%), the largest such
    depth for points no camera sees, over the largest focal, times sqrt(0.2)."""
    P = xyz.shape[0]
    dev = xyz.device
    distance = torch.full((P,), 1e5, dtype=torch.float32, device=dev)
    seen = torch.zeros((P,), dtype=torch.bool, device=dev)
    focal = torch.zeros((), dtype=torch.float32, device=dev)
    for cam in cams:
        W, H = cam.width, cam.height
        fx_t = W / (2.0 * torch.tan(torch.tensor(cam.fovx, dtype=torch.float32,
                                                 device=dev) / 2.0))
        fy_t = H / (2.0 * torch.tan(torch.tensor(cam.fovy, dtype=torch.float32,
                                                 device=dev) / 2.0))
        pc = xyz @ cam.R + cam.T[None, :]
        z = pc[:, 2]
        zc = torch.clamp_min(z, 0.001)
        x = pc[:, 0] / zc * fx_t + W / 2.0
        y = pc[:, 1] / zc * fy_t + H / 2.0
        ok = (z > 0.2) & (x >= -0.15 * W) & (x <= 1.15 * W) & (y >= -0.15 * H) & (y <= 1.15 * H)
        distance = torch.where(ok, torch.minimum(distance, zc), distance)
        seen = seen | ok
        focal = torch.maximum(focal, fx_t)
    far = distance[seen].max() if bool(seen.any()) else torch.tensor(1e5, device=dev)
    distance = torch.where(seen, distance, far)
    return (distance / focal * (0.2 ** 0.5))[:, None]
