"""Dataset readers: COLMAP and Blender / NeRF-synthetic scenes (port of
``radegs_tpu/data/readers.py``; reference scene/dataset_readers.py
readColmapSceneInfo :191-243, readNerfSyntheticInfo :287-322, getNerfppNorm
:51-72, and the loadCam resolution policy of utils/camera_utils.py:20-61).

Host numpy only; the device tensors are made by ``data.scene.Scene``. Images
are decoded and resized by ``utils/image.py`` (PIL's LANCZOS reproduced on
uint8, PNG without PIL), so the gt pixels equal the JAX package's.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from radegs_torch.core.camera import focal2fov, fov2focal
from radegs_torch.data import colmap
from radegs_torch.utils import ply as plyio
from radegs_torch.utils.image import image_size, read_image, resize_lanczos


@dataclass
class CameraInfo:
    uid: int
    R: np.ndarray  # (3, 3) c2w rotation
    T: np.ndarray  # (3,) w2c translation
    fovx: float
    fovy: float
    image_path: str
    image_name: str
    width: int
    height: int
    # pixel data, filled by load_image()
    image: np.ndarray | None = None  # (H, W, 3) float32 in [0, 1]
    mask: np.ndarray | None = None  # (H, W) float32 alpha or None
    bg: tuple = (0.0, 0.0, 0.0)

    def load_image(self, resolution_scale: float = 1.0, resolution: int = -1):
        """Decode + the reference resolution policy (camera_utils.py:20-61):
        -1 (or 0) = auto-downscale so the width is at most 1600; k > 0 =
        divide by k. Alpha composites over ``bg``; grey becomes RGB."""
        arr = read_image(self.image_path)
        orig_h, orig_w = arr.shape[:2]
        if resolution in (-1, 0):
            scale = (orig_w / resolution_scale) / 1600 if orig_w / resolution_scale > 1600 \
                else 1.0
            scale *= resolution_scale
        else:
            scale = float(resolution) * resolution_scale
        size = (round(orig_w / scale), round(orig_h / scale))
        arr = resize_lanczos(arr, size).astype(np.float32) / 255.0
        mask = None
        if arr.ndim == 3 and arr.shape[2] in (2, 4):  # LA / RGBA
            mask = arr[..., -1]
            col = arr[..., :-1]
            arr = col * mask[..., None] + np.asarray(self.bg) * (1.0 - mask[..., None])
            if arr.shape[2] == 1:
                arr = np.repeat(arr, 3, axis=2)
        elif arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, axis=2)
        self.image = np.clip(arr, 0.0, 1.0)
        self.mask = mask
        self.width, self.height = size
        return self


@dataclass
class SceneInfo:
    point_cloud: tuple  # (xyz (N, 3), rgb (N, 3) in [0, 1])
    train_cameras: list
    test_cameras: list
    nerf_normalization: dict  # {"translate": (3,), "radius": float}
    ply_path: str
    is_blender: bool = False


def get_nerfpp_norm(cam_infos):
    """Scene extent from the camera centres (dataset_readers.py:51-72)."""
    centers = np.stack([-(c.R @ c.T) for c in cam_infos])  # centre = -R T, R c2w
    avg = centers.mean(axis=0)
    radius = float(np.linalg.norm(centers - avg, axis=1).max()) * 1.1
    return {"translate": -avg, "radius": radius}


def read_colmap_scene(path, images_dir="images", eval_split=False, llffhold=8) -> SceneInfo:
    """readColmapSceneInfo (dataset_readers.py:191-243): cameras sorted by
    image name; with ``eval_split`` every ``llffhold``-th one is a test view."""
    sparse = os.path.join(path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(path, "sparse")
    try:
        cams = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
        imgs = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
    except FileNotFoundError:
        cams = colmap.read_cameras_text(os.path.join(sparse, "cameras.txt"))
        imgs = colmap.read_images_text(os.path.join(sparse, "images.txt"))

    cam_infos = []
    for iid, im in sorted(imgs.items(), key=lambda kv: kv[1].name):
        cam = cams[im.camera_id]
        fx, fy = colmap.camera_intrinsics(cam)
        cam_infos.append(CameraInfo(
            uid=iid, R=colmap.qvec2rotmat(im.qvec).T, T=im.tvec.copy(),
            fovx=focal2fov(fx, cam.width), fovy=focal2fov(fy, cam.height),
            image_path=os.path.join(path, images_dir, im.name),
            image_name=os.path.splitext(im.name)[0], width=cam.width, height=cam.height))

    if eval_split:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []
    norm = get_nerfpp_norm(train)

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = colmap.read_points3d_binary(os.path.join(sparse, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = colmap.read_points3d_text(os.path.join(sparse, "points3D.txt"))
        store_points_ply(ply_path, xyz, rgb)
    return SceneInfo(fetch_points_ply(ply_path), train, test, norm, ply_path)


def read_blender_scene(path, white_background=False, eval_split=True, n_init=100_000,
                       seed=0) -> SceneInfo:
    """readNerfSyntheticInfo (dataset_readers.py:287-322); without a
    ``points3d.ply`` the point cloud is ``n_init`` seeded random points in
    the [-1.3, 1.3] cube."""
    bg = (1.0, 1.0, 1.0) if white_background else (0.0, 0.0, 0.0)

    def read_split(fname):
        with open(os.path.join(path, fname)) as f:
            meta = json.load(f)
        fovx = meta["camera_angle_x"]
        infos = []
        for i, frame in enumerate(meta["frames"]):
            img_path = os.path.join(path, frame["file_path"] + ".png")
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1  # Blender / OpenGL -> COLMAP / OpenCV camera axes
            w2c = np.linalg.inv(c2w)
            W, H = image_size(img_path)
            infos.append(CameraInfo(
                uid=i, R=w2c[:3, :3].T, T=w2c[:3, 3], fovx=fovx,
                fovy=focal2fov(fov2focal(fovx, W), H), image_path=img_path,
                image_name=os.path.basename(frame["file_path"]), width=W, height=H, bg=bg))
        return infos

    train = read_split("transforms_train.json")
    test = (read_split("transforms_test.json")
            if eval_split and os.path.exists(os.path.join(path, "transforms_test.json"))
            else [])
    norm = get_nerfpp_norm(train)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        rng = np.random.default_rng(seed)
        xyz = (rng.random((n_init, 3)) * 2.6 - 1.3).astype(np.float32)
        rgb = rng.random((n_init, 3)).astype(np.float32)
        store_points_ply(ply_path, xyz, (rgb * 255).astype(np.uint8))
    return SceneInfo(fetch_points_ply(ply_path), train, test, norm, ply_path, is_blender=True)


def load_scene_info(path, **kw) -> SceneInfo:
    """Autodetect the dataset type (scene/__init__.py:43-47)."""
    if os.path.exists(os.path.join(path, "sparse")):
        kw.pop("white_background", None)
        return read_colmap_scene(path, **kw)
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        kw.pop("images_dir", None)
        kw.pop("llffhold", None)
        return read_blender_scene(path, **kw)
    raise ValueError(f"Could not recognize scene type at {path}")


def store_points_ply(path, xyz, rgb):
    """storePly (dataset_readers.py:169-189), normals written as zeros."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arr = np.zeros(xyz.shape[0], dtype=[(k, "f4") for k in ("x", "y", "z", "nx", "ny", "nz")]
                   + [(k, "u1") for k in ("red", "green", "blue")])
    for i, k in enumerate(("x", "y", "z")):
        arr[k] = xyz[:, i]
    for i, k in enumerate(("red", "green", "blue")):
        arr[k] = rgb[:, i]
    plyio.write_ply(path, {"vertex": arr})


def fetch_points_ply(path):
    """fetchPly (dataset_readers.py:156-167) -> (xyz, rgb in [0, 1])."""
    v = plyio.read_ply(path)["vertex"]
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    if "red" in v.dtype.names:
        rgb = np.stack([v["red"], v["green"], v["blue"]], axis=1).astype(np.float32)
        if rgb.max() > 1.0:
            rgb /= 255.0
    else:
        rgb = np.full_like(xyz, 0.5)
    return xyz, rgb
