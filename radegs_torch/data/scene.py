"""Scene set-up (port of ``radegs_tpu/data/scene.py``; reference
scene/__init__.py:21-92): dataset load, cameras and ground-truth images on
the device, the Gaussian initialisation from the point cloud, and the
output folder's ``input.ply`` / ``cameras.json`` / PLY snapshots."""

from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from radegs_torch.core.camera import Camera, fov2focal
from radegs_torch.data.readers import SceneInfo, load_scene_info
from radegs_torch.models import gaussian_model as gm
from radegs_torch.utils.device import resolve_device


def camera_to_json(idx, cam_info):
    """utils/camera_utils.py:71-91."""
    return {
        "id": idx,
        "img_name": cam_info.image_name,
        "width": cam_info.width,
        "height": cam_info.height,
        "position": (-(cam_info.R @ cam_info.T)).tolist(),
        "rotation": [r.tolist() for r in cam_info.R],
        "fx": fov2focal(cam_info.fovx, cam_info.width),
        "fy": fov2focal(cam_info.fovy, cam_info.height),
    }


class Scene:
    """A dataset on ``device`` (default ``cuda``; raises without a card unless
    ``device="cpu"``). Cameras are (Camera, gt image (3, H, W) float32
    tensor, view index) tuples, as ``train.loop.SceneLike`` takes them; the
    train list is shuffled with ``numpy.random.default_rng(seed)`` as the
    JAX package shuffles it."""

    def __init__(self, source_path: str, model_path: str | None = None, images: str = "images",
                 eval_split: bool = False, white_background: bool = False,
                 resolution: int = -1, resolution_scales=(1.0,), shuffle: bool = True,
                 load_images: bool = True, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.model_path = model_path
        info: SceneInfo = load_scene_info(source_path, images_dir=images,
                                          eval_split=eval_split,
                                          white_background=white_background)
        self.info = info
        self.cameras_extent = info.nerf_normalization["radius"]
        self.white_background = white_background

        if model_path:
            os.makedirs(model_path, exist_ok=True)
            shutil.copyfile(info.ply_path, os.path.join(model_path, "input.ply"))
            cams = info.train_cameras + info.test_cameras
            with open(os.path.join(model_path, "cameras.json"), "w") as f:
                json.dump([camera_to_json(i, c) for i, c in enumerate(cams)], f)

        if shuffle:
            np.random.default_rng(seed).shuffle(info.train_cameras)

        self.train_cameras = {}
        self.test_cameras = {}
        if load_images:
            for scale in resolution_scales:
                self.train_cameras[scale] = self._build(info.train_cameras, scale, resolution)
                self.test_cameras[scale] = self._build(info.test_cameras, scale, resolution)

    def _build(self, cam_infos, scale, resolution):
        # zlib and numpy release the GIL: decode the images in parallel
        with ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 4)) as ex:
            list(ex.map(lambda ci: ci.load_image(resolution_scale=scale, resolution=resolution),
                        cam_infos))
        out = []
        for idx, ci in enumerate(cam_infos):
            cam = Camera.create(ci.R, ci.T, ci.fovx, ci.fovy, ci.width, ci.height,
                                device=self.device)
            gt = torch.from_numpy(np.ascontiguousarray(ci.image.transpose(2, 0, 1),
                                                       np.float32)).to(self.device)
            out.append((cam, gt, idx))
            ci.image = None  # the device holds it now
        return out

    def create_gaussians(self, sh_degree: int = 3, capacity: int | None = None):
        xyz, rgb = self.info.point_cloud
        return gm.create_from_points(xyz, rgb, sh_degree=sh_degree, capacity=capacity,
                                     device=self.device)

    def save(self, state, iteration: int):
        """scene/__init__.py:84-86 PLY snapshot layout."""
        d = os.path.join(self.model_path, "point_cloud", f"iteration_{iteration}")
        os.makedirs(d, exist_ok=True)
        gm.save_gaussian_ply(os.path.join(d, "point_cloud.ply"), state)

    def getTrainCameras(self, scale=1.0):
        return self.train_cameras[scale]

    def getTestCameras(self, scale=1.0):
        return self.test_cameras[scale]


def search_max_iteration(point_cloud_dir):
    """utils/system_utils.py:15-28."""
    return max(int(d.split("_")[-1]) for d in os.listdir(point_cloud_dir)
               if d.startswith("iteration_"))
