"""COLMAP sparse-reconstruction parsers, binary and text (port of
``radegs_tpu/data/colmap.py``; the public COLMAP file formats,
colmap.github.io/format.html; reference scene/colmap_loader.py:83-261).

Numpy instead of the JAX package's C++ reader: ``points3D.bin`` records
have a variable-length track, so one pass over the track lengths finds the
record offsets and numpy gathers the fixed-size fields of all records at
once; ``images.bin`` is walked per image (names are NUL-terminated) with
the 2D-point lists skipped by offset. Supported camera models: SIMPLE_PINHOLE
and PINHOLE, plus SIMPLE_RADIAL / RADIAL treated as pinhole (with a warning
when their distortion is not zero).
"""

from __future__ import annotations

import struct
import warnings
from dataclasses import dataclass

import numpy as np

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}
POINT_RECORD = 43  # id u64, xyz 3 f64, rgb 3 u8, error f64


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # (4,) wxyz
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str


def qvec2rotmat(q):
    """Quaternion (w, x, y, z) -> rotation matrix (colmap_loader.py:43)."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _read_bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def read_cameras_binary(path):
    buf = _read_bytes(path)
    (num,) = struct.unpack_from("<Q", buf, 0)
    pos, cams = 8, {}
    for _ in range(num):
        cid, model_id, w, h = struct.unpack_from("<iiQQ", buf, pos)
        name, n_params = CAMERA_MODELS[model_id]
        params = np.frombuffer(buf, "<f8", n_params, pos + 24).astype(np.float64)
        pos += 24 + 8 * n_params
        cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def read_images_binary(path):
    buf = _read_bytes(path)
    (num,) = struct.unpack_from("<Q", buf, 0)
    pos, images = 8, {}
    for _ in range(num):
        iid, *pose, cam_id = struct.unpack_from("<i7di", buf, pos)
        pos += 64
        end = buf.index(b"\x00", pos)
        name = buf[pos:end].decode()
        (n_pts,) = struct.unpack_from("<Q", buf, end + 1)
        pos = end + 9 + 24 * n_pts  # skip the 2D points (x, y, point3D id)
        images[iid] = ColmapImage(iid, np.array(pose[:4]), np.array(pose[4:]), cam_id, name)
    return images


def read_points3d_binary(path):
    """(xyz (N, 3) float64, rgb (N, 3) uint8, error (N,) float64)."""
    buf = _read_bytes(path)
    (num,) = struct.unpack_from("<Q", buf, 0)
    offsets = np.empty(num, np.int64)
    pos = 8
    unpack = struct.Struct("<Q").unpack_from
    for i in range(num):  # record i ends with its track of 8-byte entries
        offsets[i] = pos
        pos += POINT_RECORD + 8 + 8 * unpack(buf, pos + POINT_RECORD)[0]
    raw = np.frombuffer(buf, np.uint8)
    rec = raw[offsets[:, None] + np.arange(POINT_RECORD)]  # (N, 43) fixed fields
    xyz = rec[:, 8:32].copy().view("<f8").astype(np.float64)
    rgb = rec[:, 32:35].copy()
    err = rec[:, 35:43].copy().view("<f8")[:, 0].astype(np.float64)
    return xyz.reshape(num, 3), rgb, err


def _text_lines(path):
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip() and not ln.strip().startswith("#")]


def read_cameras_text(path):
    cams = {}
    for line in _text_lines(path):
        parts = line.split()
        cid = int(parts[0])
        cams[cid] = ColmapCamera(cid, parts[1], int(parts[2]), int(parts[3]),
                                 np.array([float(p) for p in parts[4:]]))
    return cams


def read_images_text(path):
    """images.txt alternates a pose line and a 2D-points line (which may be
    empty: the JAX reader drops blank lines, and so does this one)."""
    images = {}
    for line in _text_lines(path)[0::2]:
        parts = line.split()
        iid = int(parts[0])
        images[iid] = ColmapImage(iid, np.array([float(p) for p in parts[1:5]]),
                                  np.array([float(p) for p in parts[5:8]]), int(parts[8]),
                                  parts[9])
    return images


def read_points3d_text(path):
    rows = [ln.split() for ln in _text_lines(path)]
    xyz = np.array([[float(p) for p in r[1:4]] for r in rows]).reshape(-1, 3)
    rgb = np.array([[int(p) for p in r[4:7]] for r in rows], np.uint8).reshape(-1, 3)
    err = np.array([float(r[7]) for r in rows])
    return xyz, rgb, err


def camera_intrinsics(cam: ColmapCamera):
    """(focal_x, focal_y) of the supported models (dataset_readers.py:120-135)."""
    if cam.model == "SIMPLE_PINHOLE":
        return float(cam.params[0]), float(cam.params[0])
    if cam.model == "PINHOLE":
        return float(cam.params[0]), float(cam.params[1])
    if cam.model in ("SIMPLE_RADIAL", "RADIAL"):
        # undistorted-as-radial exports are common: treat as simple pinhole,
        # but warn when the distortion is not negligible (the reference
        # refuses non-pinhole models, dataset_readers.py:120-135)
        k = [float(p) for p in cam.params[3:]]
        if any(abs(v) > 1e-6 for v in k):
            warnings.warn(
                f"COLMAP camera model {cam.model} has non-zero distortion {k}; treating as "
                "pinhole WITHOUT undistortion — geometry will be wrong. Undistort the "
                "dataset first.", stacklevel=2)
        return float(cam.params[0]), float(cam.params[0])
    raise ValueError(
        f"Unsupported COLMAP camera model {cam.model}: undistort the dataset first (the "
        "reference requires PINHOLE/SIMPLE_PINHOLE too)")
