"""LLFF preparation on the port (``radegs_torch/data/llff.py``) against the
JAX package's ``radegs_tpu/data/llff.py``: the four cases of
``tests/test_llff.py`` on the same COLMAP model (written here with
``struct``), plus a rotated, shuffled one. Poses, tracks and
``poses_bounds.npy`` equal; the minified images equal PIL's LANCZOS (the
JAX package's resize) pixel for pixel, grey, RGB and RGBA."""

import os
import struct

import numpy as np
import pytest
from PIL import Image

from radegs_tpu.data import llff as jllff
from radegs_torch.data import llff as tllff
from radegs_torch.utils.image import read_png, write_png


def write_model(root, imgs, pts, tracks, cam=(64, 48, [60.0, 60.0, 32.0, 24.0])):
    """sparse/0/{cameras,images,points3D}.bin: one PINHOLE camera, images as
    {id: (qvec, tvec, name)}, points with their tracks of image ids."""
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    W, H, params = cam
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<QiiQQ4d", 1, 1, 1, W, H, *params))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for iid, (q, t, name) in imgs.items():
            f.write(struct.pack("<i4d3di", iid, *q, *t, 1) + name.encode() + b"\x00"
                    + struct.pack("<Q", 1) + struct.pack("<ddq", 1.0, 2.0, -1))
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for pid, (xyz, track) in enumerate(zip(pts, tracks)):
            f.write(struct.pack("<Q3d3Bd", pid, *xyz, 128, 128, 128, 0.5)
                    + struct.pack("<Q", len(track))
                    + b"".join(struct.pack("<ii", iid, 0) for iid in track))
    return root


@pytest.fixture(params=["identity", "rotated"])
def llff_scene(request, tmp_path):
    root = str(tmp_path / "scene")
    if request.param == "identity":  # tests/test_llff.py's model
        imgs = {i + 1: ([1.0, 0, 0, 0], [0.0, 0.0, float(i)], f"im_{i:03d}.png")
                for i in range(3)}
        pts = [[0.1 * i, -0.1 * i, 4.0 + i] for i in range(5)]
        return write_model(root, imgs, pts, [[1, 2, 3]] * 5)
    rng = np.random.default_rng(0)
    imgs = {}
    for i in range(6):  # ids and names in different orders
        q = np.array([1.0, *(rng.normal(size=3) * 0.1)])
        imgs[i + 1] = ((q / np.linalg.norm(q)).tolist(), (rng.normal(size=3) * 0.3).tolist(),
                       f"im_{(i * 5) % 6:03d}.png")
    pts = (rng.normal(size=(40, 3)) + [0, 0, 6.0]).tolist()
    tracks = [sorted(rng.choice(np.arange(1, 7), size=rng.integers(1, 6), replace=False)
                     .tolist()) for _ in pts]
    for i in range(1, 7):  # every view sees a point
        if i not in tracks[i]:
            tracks[i].append(i)
    return write_model(root, imgs, pts, tracks)


def test_colmap_to_llff_poses(llff_scene):
    jp, jpts, jperm = jllff.colmap_to_llff_poses(llff_scene)
    tp, tpts, tperm = tllff.colmap_to_llff_poses(llff_scene)
    assert (tp == jp).all() and (tperm == jperm).all()
    assert tpts.keys() == jpts.keys()
    for k in jpts:
        assert (tpts[k][0] == jpts[k][0]).all() and (tpts[k][1] == jpts[k][1]).all()
        assert tpts[k][1].dtype == jpts[k][1].dtype
    np.testing.assert_allclose(tp[:, 4, 0], [48, 64, 60])


def test_save_and_load_poses_bounds(llff_scene, tmp_path):
    out = {}
    for name, mod in (("jax", jllff), ("torch", tllff)):
        poses, pts3d, perm = mod.colmap_to_llff_poses(llff_scene)
        arr = mod.save_poses_bounds(llff_scene, poses, pts3d, perm)
        saved = np.load(os.path.join(llff_scene, "poses_bounds.npy"))
        out[name] = (arr, saved, *mod.load_poses_bounds(llff_scene))
    for a, b in zip(out["jax"], out["torch"]):
        assert a.shape == b.shape and (a == b).all()
    assert out["torch"][1].shape[1] == 17


def test_gen_poses_requires_model(tmp_path):
    for mod in (jllff, tllff):
        with pytest.raises(FileNotFoundError, match="sparse"):
            mod.gen_poses(str(tmp_path))


def test_gen_poses_and_minify(llff_scene, tmp_path):
    imgdir = os.path.join(llff_scene, "images")
    os.makedirs(imgdir)
    rng = np.random.default_rng(1)
    shapes = [(48, 64, 3), (48, 64, 4), (48, 64)]  # RGB, RGBA, grey
    n = len(shapes)
    for i in range(n):
        write_png(os.path.join(imgdir, f"im_{i:03d}.png"),
                  rng.integers(0, 256, shapes[i], dtype=np.uint8))
    twin = str(tmp_path / "twin")
    os.makedirs(twin)
    os.symlink(os.path.join(llff_scene, "sparse"), os.path.join(twin, "sparse"))
    os.symlink(imgdir, os.path.join(twin, "images"))
    assert jllff.gen_poses(llff_scene, factors=[2, 3])
    assert tllff.gen_poses(twin, factors=[2, 3])
    assert (np.load(os.path.join(llff_scene, "poses_bounds.npy"))
            == np.load(os.path.join(twin, "poses_bounds.npy"))).all()
    jllff.minify_images(llff_scene, resolutions=[(12, 16), (30, 50)])  # (H, W)
    tllff.minify_images(twin, resolutions=[(12, 16), (30, 50)])
    for sub, (w, h) in (("images_2", (32, 24)), ("images_3", (21, 16)),
                        ("images_16x12", (16, 12)), ("images_50x30", (50, 30))):
        names = sorted(os.listdir(os.path.join(twin, sub)))
        assert names == sorted(os.listdir(os.path.join(llff_scene, sub))) \
            == [f"im_{i:03d}.png" for i in range(n)]
        for f in names:
            want = np.asarray(Image.open(os.path.join(llff_scene, sub, f)))
            got = read_png(os.path.join(twin, sub, f))
            assert got.shape[:2] == (h, w) and got.dtype == want.dtype
            assert (got == want).all(), (sub, f)
