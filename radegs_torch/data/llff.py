"""LLFF dataset preparation: ``poses_bounds.npy`` from a COLMAP model (port of
``radegs_tpu/data/llff.py``; the reference's ``utils/pose_utils.py``, the
LLFF imgs2poses toolchain it vendors).

- ``colmap_to_llff_poses`` / ``save_poses_bounds``: load_colmap_data +
  save_poses (pose_utils.py:10-87): per image a [3, 5] matrix holding the
  camera-to-world rotation and translation in LLFF's [-u, r, -t] axis order
  with an (h, w, focal) column appended, plus the view's [0.1%, 99.9%]
  depth bounds over the sparse points it sees.
- ``load_poses_bounds``: load_data's pose / bounds part (pose_utils.py:195-239).
- ``minify_images``: the image pyramids (pose_utils.py:141-190). The
  reference shells out to ImageMagick's ``mogrify`` and the JAX package
  resizes with PIL's LANCZOS; here ``utils.image.resize_lanczos``, which
  gives PIL's bytes, and ``write_png``. PNG input needs no PIL; other
  formats go through ``read_image``, which needs PIL for them and says so.
- ``gen_poses``: pose_utils.py:258-283 without running COLMAP (there is no
  colmap executable to run): it needs an existing ``sparse/0`` model and
  raises without one.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from radegs_torch.data.colmap import POINT_RECORD, qvec2rotmat, read_cameras_binary, \
    read_images_binary

IMG_EXTS = (".jpg", ".jpeg", ".png", ".JPG", ".JPEG", ".PNG")


def read_points3d_with_tracks(path):
    """points3D.bin -> {point id: (xyz (3,), image ids (k,))}. The scene
    reader (``data/colmap.py``) skips the tracks; LLFF's per-view depth
    bounds need them."""
    with open(path, "rb") as f:
        buf = f.read()
    (num,) = struct.unpack_from("<Q", buf, 0)
    pos, out = 8, {}
    for _ in range(num):
        pid, x, y, z = struct.unpack_from("<Q3d", buf, pos)
        (track_len,) = struct.unpack_from("<Q", buf, pos + POINT_RECORD)
        pos += POINT_RECORD + 8
        track = np.frombuffer(buf, "<i4", 2 * track_len, pos)
        pos += 8 * track_len
        out[pid] = (np.asarray([x, y, z]), track[0::2].astype(np.int64))
    return out


def colmap_to_llff_poses(realdir):
    """(poses (3, 5, N), points {id: (xyz, image ids)}, perm): pose_utils.py:10-52.

    poses[:, :4, i] is the i-th camera-to-world matrix with its rotation
    columns in LLFF's [-u, r, -t] order, and poses[:, 4, i] = (h, w, focal);
    ``perm`` sorts the views by image name."""
    sparse = os.path.join(realdir, "sparse", "0")
    camdata = read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    cam = camdata[sorted(camdata.keys())[0]]
    hwf = np.array([cam.height, cam.width, cam.params[0]], np.float64).reshape(3, 1)

    imdata = read_images_binary(os.path.join(sparse, "images.bin"))
    names = [imdata[k].name for k in imdata]
    perm = np.argsort(names)
    bottom = np.array([[0, 0, 0, 1.0]])
    w2c = []
    for k in imdata:
        im = imdata[k]
        R = qvec2rotmat(im.qvec)
        w2c.append(np.concatenate([np.concatenate([R, np.reshape(im.tvec, (3, 1))], 1),
                                   bottom], 0))
    c2w = np.linalg.inv(np.stack(w2c))
    poses = c2w[:, :3, :4].transpose(1, 2, 0)  # (3, 4, N)
    poses = np.concatenate([poses, np.tile(hwf[..., None], (1, 1, poses.shape[-1]))], 1)
    # [r, -u, t] -> [-u, r, -t] (pose_utils.py:49-50)
    poses = np.concatenate([poses[:, 1:2], poses[:, 0:1], -poses[:, 2:3], poses[:, 3:4],
                            poses[:, 4:5]], 1)
    pts3d = read_points3d_with_tracks(os.path.join(sparse, "points3D.bin"))
    return poses, pts3d, perm


def save_poses_bounds(basedir, poses, pts3d, perm):
    """poses_bounds.npy: (N, 17) = the raveled (3, 5) pose + [near, far],
    the depth percentiles of the view's visible sparse points
    (pose_utils.py:55-87). Returns the array written."""
    n_img = poses.shape[-1]
    pts_arr = []
    vis_arr = []
    for k in pts3d:
        xyz, image_ids = pts3d[k]
        pts_arr.append(np.asarray(xyz, np.float64))
        cams = np.zeros(n_img)
        for ind in np.asarray(image_ids):
            if ind - 1 >= n_img:
                raise ValueError("point visibility references image id beyond the pose "
                                 "count (pose_utils.py:62-64)")
            cams[ind - 1] = 1
        vis_arr.append(cams)
    pts_arr = np.array(pts_arr)
    vis_arr = np.array(vis_arr)

    # depth of each point along each view's forward axis (-t row = axis 2)
    zvals = np.sum(-(pts_arr[:, None, :].transpose(2, 0, 1) - poses[:3, 3:4, :])
                   * poses[:3, 2:3, :], 0)  # (P, N)
    save_arr = []
    for i in perm:
        zs = zvals[:, i][vis_arr[:, i] == 1]
        if len(zs) == 0:
            raise ValueError(f"view {i} sees no sparse points")
        close, inf = np.percentile(zs, 0.1), np.percentile(zs, 99.9)
        save_arr.append(np.concatenate([poses[..., i].ravel(), [close, inf]], 0))
    out = np.array(save_arr)
    np.save(os.path.join(basedir, "poses_bounds.npy"), out)
    return out


def load_poses_bounds(basedir):
    """(poses (3, 5, N), bds (2, N)) from poses_bounds.npy (pose_utils.py:195-199)."""
    arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = arr[:, :-2].reshape(-1, 3, 5).transpose(1, 2, 0)
    bds = arr[:, -2:].transpose(1, 0)
    return poses, bds


def minify_images(basedir, factors=(), resolutions=()):
    """``images_{f}/`` (each side divided by f, floored) and
    ``images_{W}x{H}/`` (``resolutions`` as (H, W)) pyramids of
    ``images/``, each as PNG (pose_utils.py:141-190). A folder that exists
    is left as it is."""
    from radegs_torch.utils.image import read_image, resize_lanczos, write_png

    imgdir = os.path.join(basedir, "images")
    files = [f for f in sorted(os.listdir(imgdir)) if f.endswith(IMG_EXTS)]
    for r in list(factors) + list(resolutions):
        name = f"images_{r}" if isinstance(r, int) else f"images_{r[1]}x{r[0]}"
        outdir = os.path.join(basedir, name)
        if os.path.exists(outdir):
            continue
        os.makedirs(outdir)
        for f in files:
            img = read_image(os.path.join(imgdir, f))
            H, W = img.shape[:2]
            size = (W // r, H // r) if isinstance(r, int) else (r[1], r[0])
            write_png(os.path.join(outdir, os.path.splitext(f)[0] + ".png"),
                      resize_lanczos(img, size))


def gen_poses(basedir, factors=None):
    """pose_utils.py:258-283 without the colmap run: ``sparse/0`` must hold
    the model (run COLMAP elsewhere)."""
    sparse = os.path.join(basedir, "sparse", "0")
    needed = ["cameras.bin", "images.bin", "points3D.bin"]
    have = os.listdir(sparse) if os.path.isdir(sparse) else []
    if not all(f in have for f in needed):
        raise FileNotFoundError(
            f"{sparse} must contain {needed}; there is no colmap executable to create it "
            "(the reference would run colmap here, pose_utils.py:258-267)")
    poses, pts3d, perm = colmap_to_llff_poses(basedir)
    save_poses_bounds(basedir, poses, pts3d, perm)
    if factors:
        minify_images(basedir, factors=factors)
    return True
