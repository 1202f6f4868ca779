"""Camera model (port of ``radegs_tpu/core/camera.py``).

Row-major matrices throughout, exactly as the JAX package builds them:
``p_view = world_view @ [p, 1]`` with +z looking forward, pixel x to the
right, pixel y down (scene/cameras.py:17-84, utils/graphics_utils.py:40-93).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from radegs_torch.utils import trace
from radegs_torch.utils.device import resolve_device


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


@dataclass(frozen=True)
class Camera:
    """A pinhole camera: float32 tensors ``R`` (3,3) camera-to-world rotation,
    ``T`` (3,) world-to-camera translation, 0-d ``fovx``/``fovy`` (radians);
    static ``width``/``height``/``znear``/``zfar``.
    ``p_view = R.T @ p_world + T``."""

    R: torch.Tensor
    T: torch.Tensor
    fovx: torch.Tensor
    fovy: torch.Tensor
    width: int = 0
    height: int = 0
    znear: float = 0.01
    zfar: float = 100.0

    @property
    def device(self) -> torch.device:
        return self.R.device

    def to(self, device) -> "Camera":
        return Camera(self.R.to(device), self.T.to(device), self.fovx.to(device),
                      self.fovy.to(device), self.width, self.height, self.znear,
                      self.zfar)

    # ---- derived quantities -------------------------------------------------

    @property
    def tanfovx(self):
        return torch.tan(self.fovx * 0.5)

    @property
    def tanfovy(self):
        return torch.tan(self.fovy * 0.5)

    @property
    def focal_x(self):
        return self.width / (2.0 * torch.tan(self.fovx * 0.5))

    @property
    def focal_y(self):
        return self.height / (2.0 * torch.tan(self.fovy * 0.5))

    @property
    def world_view(self):
        """Row-major 4x4 world-to-camera matrix (utils/graphics_utils.py:40-65)."""
        top = torch.cat([self.R.T, self.T[:, None]], dim=1)  # (3,4)
        with trace.sync("camera.world_view"):  # a copy from pageable host memory
            bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=torch.float32,
                                  device=self.device)
        return torch.cat([top, bottom], dim=0)

    @property
    def projection(self):
        """Row-major perspective matrix (utils/graphics_utils.py:67-87): maps
        view space to clip space; w carries the view-space z."""
        znear, zfar = self.znear, self.zfar
        z0 = torch.zeros((), dtype=torch.float32, device=self.device)
        inv_tx = 1.0 / torch.tan(self.fovx * 0.5)
        inv_ty = 1.0 / torch.tan(self.fovy * 0.5)
        # the JAX code rounds these to float32 from the Python doubles
        zz = z0 + float(np.float32(zfar / (zfar - znear)))
        zw = z0 + float(np.float32(-(zfar * znear) / (zfar - znear)))
        one = z0 + 1.0
        return torch.stack([
            torch.stack([inv_tx, z0, z0, z0]),
            torch.stack([z0, inv_ty, z0, z0]),
            torch.stack([z0, z0, zz, zw]),
            torch.stack([z0, z0, one, z0]),
        ])

    @property
    def full_proj(self):
        """Row-major view-projection: clip = full_proj @ [p_world, 1]."""
        return self.projection @ self.world_view

    @property
    def camera_center(self):
        """World-space camera position (scene/cameras.py:57)."""
        return -(self.R @ self.T)

    # ---- constructors -------------------------------------------------------

    @staticmethod
    def create(R, T, fovx, fovy, width, height, znear=0.01, zfar=100.0,
               device=None) -> "Camera":
        dev = resolve_device(device)

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        return Camera(R=f32(R), T=f32(T), fovx=f32(fovx), fovy=f32(fovy),
                      width=int(width), height=int(height), znear=float(znear),
                      zfar=float(zfar))

    @staticmethod
    def look_at(eye, target, up, fovx, fovy, width, height, device=None) -> "Camera":
        """Convenience constructor for tests and synthetic scenes."""
        eye = np.asarray(eye, np.float64)
        target = np.asarray(target, np.float64)
        up = np.asarray(up, np.float64)
        fwd = target - eye
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, up)
        right = right / np.linalg.norm(right)
        down = np.cross(fwd, right)
        # camera axes as rows of the w2c rotation: x=right, y=down, z=forward
        Rw2c = np.stack([right, down, fwd], axis=0)
        return Camera.create(Rw2c.T, -Rw2c @ eye, fovx, fovy, width, height,
                             device=device)
