"""The port's data path (``radegs_torch/data/``, ``utils/image.py``) against
the JAX package's (``radegs_tpu/data/``, PIL) on fixtures the tests write:
COLMAP binary and text sparse models (PINHOLE, SIMPLE_PINHOLE,
SIMPLE_RADIAL with zero distortion) and a Blender scene with RGBA frames.

Tolerances: parsed ids, names, points and colours equal, qvec / tvec equal;
cameras (R, T, fov), their order and ``nerf_normalization`` rtol 1e-12
(float64 on both sides); gt images bitwise equal at scale 1 and within
1/255 of PIL's LANCZOS when resized; the PNG codec bitwise equal to PIL.
"""

import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from radegs_tpu.data import colmap as jcolmap
from radegs_tpu.data.readers import load_scene_info as j_load_scene_info
from radegs_tpu.data.scene import Scene as JScene
from radegs_torch.data import colmap as tcolmap
from radegs_torch.data.readers import CameraInfo, load_scene_info
from radegs_torch.data.scene import Scene, camera_to_json, search_max_iteration
from radegs_torch.utils import image as timage

torch.set_num_threads(1)
# camera id -> (model id, width, height, params)
CAMS = {1: (1, 64, 48, [60.0, 58.0, 32.0, 24.0]),  # PINHOLE
        2: (0, 64, 48, [55.0, 32.0, 24.0]),  # SIMPLE_PINHOLE
        3: (2, 64, 48, [57.0, 32.0, 24.0, 0.0])}  # SIMPLE_RADIAL, no distortion
N_IMG = 10


def model(seed=0, n_pts=40):
    rng = np.random.default_rng(seed)
    imgs = {}
    for i in range(N_IMG):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        # ids and names in different orders: the readers sort by name
        imgs[100 - i] = (q.tolist(), rng.normal(size=3).tolist(), 1 + i % 3,
                         f"im_{(i * 7) % N_IMG:03d}.png")
    pts = [(rng.normal(size=3).tolist(), rng.integers(0, 256, 3).tolist(), float(i) * 0.1)
           for i in range(n_pts)]
    return imgs, pts


def write_binary(sparse, imgs, pts):
    os.makedirs(sparse, exist_ok=True)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(CAMS)))
        for cid, (mid, w, h, params) in CAMS.items():
            f.write(struct.pack("<iiQQ", cid, mid, w, h) + struct.pack(f"<{len(params)}d",
                                                                        *params))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for iid, (q, t, cid, name) in imgs.items():
            f.write(struct.pack("<i4d3di", iid, *q, *t, cid) + name.encode() + b"\x00")
            n2d = iid % 3
            f.write(struct.pack("<Q", n2d) + b"".join(struct.pack("<ddq", 1.0 * k, 2.0, k - 1)
                                                      for k in range(n2d)))
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for pid, (xyz, rgb, err) in enumerate(pts):
            track = pid % 4
            f.write(struct.pack("<Q3d3Bd", pid, *xyz, *rgb, err) + struct.pack("<Q", track)
                    + b"".join(struct.pack("<ii", k, pid) for k in range(track)))


def write_text(sparse, imgs, pts):
    os.makedirs(sparse, exist_ok=True)
    names = {0: "SIMPLE_PINHOLE", 1: "PINHOLE", 2: "SIMPLE_RADIAL"}
    with open(os.path.join(sparse, "cameras.txt"), "w") as f:
        f.write("# camera list\n")
        for cid, (mid, w, h, params) in CAMS.items():
            f.write(f"{cid} {names[mid]} {w} {h} " + " ".join(repr(p) for p in params) + "\n")
    with open(os.path.join(sparse, "images.txt"), "w") as f:
        f.write("# image list\n")
        for iid, (q, t, cid, name) in imgs.items():
            f.write(f"{iid} " + " ".join(repr(v) for v in q + t) + f" {cid} {name}\n")
            f.write("1.0 2.0 -1\n")
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        for pid, (xyz, rgb, err) in enumerate(pts):
            f.write(f"{pid} " + " ".join(repr(v) for v in xyz) + " "
                    + " ".join(str(v) for v in rgb) + f" {err!r} 1 0\n")


def write_images(root, size=(64, 48), seed=1):
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for i in range(N_IMG):
        Image.fromarray((rng.random((size[1], size[0], 3)) * 255).astype(np.uint8)).save(
            os.path.join(root, "images", f"im_{i:03d}.png"))


@pytest.fixture(scope="module")
def colmap_scenes(tmp_path_factory):
    imgs, pts = model()
    out = {}
    for kind, writer in (("bin", write_binary), ("txt", write_text)):
        root = str(tmp_path_factory.mktemp(f"colmap_{kind}"))
        writer(os.path.join(root, "sparse", "0"), imgs, pts)
        write_images(root)
        out[kind] = root
    return out, imgs, pts


@pytest.mark.parametrize("kind", ["bin", "txt"])
def test_colmap_parsers_agree(colmap_scenes, kind):
    roots, imgs, pts = colmap_scenes
    sp = os.path.join(roots[kind], "sparse", "0")
    reader = "binary" if kind == "bin" else "text"
    jc = getattr(jcolmap, f"read_cameras_{reader}")(os.path.join(sp, f"cameras.{kind}"))
    tc = getattr(tcolmap, f"read_cameras_{reader}")(os.path.join(sp, f"cameras.{kind}"))
    assert jc.keys() == tc.keys() == CAMS.keys()
    for cid in jc:
        assert (jc[cid].model, jc[cid].width, jc[cid].height) == \
            (tc[cid].model, tc[cid].width, tc[cid].height)
        np.testing.assert_array_equal(jc[cid].params, tc[cid].params)
        assert jcolmap.camera_intrinsics(jc[cid]) == tcolmap.camera_intrinsics(tc[cid])
    ji = getattr(jcolmap, f"read_images_{reader}")(os.path.join(sp, f"images.{kind}"))
    ti = getattr(tcolmap, f"read_images_{reader}")(os.path.join(sp, f"images.{kind}"))
    assert list(ji) == list(ti) == list(imgs)
    for iid in ji:
        assert (ji[iid].name, ji[iid].camera_id) == (ti[iid].name, ti[iid].camera_id)
        np.testing.assert_array_equal(ji[iid].qvec, ti[iid].qvec)
        np.testing.assert_array_equal(ji[iid].tvec, ti[iid].tvec)
        np.testing.assert_array_equal(jcolmap.qvec2rotmat(ji[iid].qvec),
                                      tcolmap.qvec2rotmat(ti[iid].qvec))
    jx, jr, je = getattr(jcolmap, f"read_points3d_{reader}")(os.path.join(sp, f"points3D.{kind}"))
    tx, tr, te = getattr(tcolmap, f"read_points3d_{reader}")(os.path.join(sp, f"points3D.{kind}"))
    np.testing.assert_array_equal(jx, tx)
    np.testing.assert_array_equal(jr, tr)
    np.testing.assert_array_equal(je, te)
    assert tx.shape == (len(pts), 3) and tr.dtype == np.uint8


def test_camera_models_warn_and_refuse_as_jax():
    radial = tcolmap.ColmapCamera(1, "SIMPLE_RADIAL", 8, 8, np.array([5.0, 4, 4, 0.1]))
    with pytest.warns(UserWarning, match="distortion"):
        assert tcolmap.camera_intrinsics(radial) == (5.0, 5.0)
    with pytest.raises(ValueError, match="Unsupported COLMAP camera model OPENCV"):
        tcolmap.camera_intrinsics(tcolmap.ColmapCamera(1, "OPENCV", 8, 8, np.zeros(8)))


def cameras_equal(jcams, tcams):
    assert [c.image_name for c in jcams] == [c.image_name for c in tcams]
    for jc, tc in zip(jcams, tcams):
        assert jc.uid == tc.uid and (jc.width, jc.height) == (tc.width, tc.height)
        np.testing.assert_allclose(tc.R, jc.R, rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(tc.T, jc.T, rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose([tc.fovx, tc.fovy], [jc.fovx, jc.fovy], rtol=1e-12)


def infos_equal(j, t):
    cameras_equal(j.train_cameras, t.train_cameras)
    cameras_equal(j.test_cameras, t.test_cameras)
    np.testing.assert_allclose(t.nerf_normalization["translate"],
                               j.nerf_normalization["translate"], rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(t.nerf_normalization["radius"], j.nerf_normalization["radius"],
                               rtol=1e-12)
    np.testing.assert_array_equal(j.point_cloud[0], t.point_cloud[0])
    np.testing.assert_array_equal(j.point_cloud[1], t.point_cloud[1])


@pytest.mark.parametrize("kind", ["bin", "txt"])
@pytest.mark.parametrize("eval_split", [False, True])
def test_load_scene_info_colmap(colmap_scenes, tmp_path, kind, eval_split):
    import shutil

    roots, _, _ = colmap_scenes
    # each package writes points3D.ply beside the model: a copy per package
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(roots[kind], jroot)
    shutil.copytree(roots[kind], troot)
    j = j_load_scene_info(jroot, eval_split=eval_split)
    t = load_scene_info(troot, eval_split=eval_split)
    infos_equal(j, t)
    assert len(t.test_cameras) == (2 if eval_split else 0)  # i % 8 == 0 of 10
    with open(j.ply_path, "rb") as a, open(t.ply_path, "rb") as b:
        assert a.read() == b.read()


def write_blender(root, size=(40, 30), n=4, seed=2):
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    os.makedirs(os.path.join(root, "test"), exist_ok=True)
    for split in ("train", "test"):
        frames = []
        for i in range(n):
            ang = 2 * np.pi * i / n + (0.3 if split == "test" else 0.0)
            c2w = np.eye(4)
            c2w[:3, 3] = [4 * np.sin(ang), 4 * np.cos(ang), 1.5]
            z = c2w[:3, 3] / np.linalg.norm(c2w[:3, 3])  # OpenGL: the camera looks down -z
            x = np.cross([0, 0, 1.0], z)
            x /= np.linalg.norm(x)
            c2w[:3, :3] = np.stack([x, np.cross(z, x), z], 1)
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
            rgba = (rng.random((size[1], size[0], 4)) * 255).astype(np.uint8)
            rgba[..., 3] = rng.choice([0, 255, 90, 200], size=size[::-1])
            Image.fromarray(rgba, "RGBA").save(os.path.join(root, split, f"r_{i}.png"))
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.69, "frames": frames}, f)


@pytest.mark.parametrize("white", [False, True])
def test_blender_scene_and_gt(tmp_path, white):
    import shutil

    write_blender(str(tmp_path / "src"))
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(tmp_path / "src", jroot)
    shutil.copytree(tmp_path / "src", troot)
    infos_equal(j_load_scene_info(jroot, white_background=white, n_init=500),
                load_scene_info(troot, white_background=white, n_init=500))
    for res in (1, 2):  # scale 1: bitwise; 2: PIL resamples RGBa premultiplied
        js = JScene(jroot, white_background=white, eval_split=True, resolution=res)
        ts = Scene(troot, white_background=white, eval_split=True, resolution=res,
                   device="cpu")
        for jl, tl in ((js.getTrainCameras(), ts.getTrainCameras()),
                       (js.getTestCameras(), ts.getTestCameras())):
            for (_, jgt, ji), (tcam, tgt, ti) in zip(jl, tl):
                assert ji == ti and tgt.dtype == torch.float32
                diff = np.abs(np.asarray(jgt) - tgt.numpy()).max()
                assert diff == 0.0 if res == 1 else diff <= 1 / 255 + 1e-7, (res, diff)


def test_scene_shuffle_outputs_and_gt(colmap_scenes, tmp_path):
    import shutil

    roots, _, _ = colmap_scenes
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(roots["bin"], jroot)
    shutil.copytree(roots["bin"], troot)
    for seed in (0, 5):
        js = JScene(jroot, model_path=str(tmp_path / f"jm{seed}"), eval_split=True, seed=seed)
        ts = Scene(troot, model_path=str(tmp_path / f"tm{seed}"), eval_split=True, seed=seed,
                   device="cpu")
        cameras_equal(js.info.train_cameras, ts.info.train_cameras)
        for (jc, jgt, ji), (tc, tgt, ti) in zip(js.getTrainCameras(), ts.getTrainCameras()):
            assert ji == ti
            np.testing.assert_array_equal(np.asarray(jgt), tgt.numpy())  # scale 1: bitwise
            np.testing.assert_allclose(tc.world_view.numpy(), np.asarray(jc.world_view),
                                       rtol=1e-6, atol=1e-6)
        for name in ("cameras.json", "input.ply"):
            with open(tmp_path / f"jm{seed}" / name, "rb") as a, \
                    open(tmp_path / f"tm{seed}" / name, "rb") as b:
                assert a.read() == b.read(), name
    assert camera_to_json(0, ts.info.train_cameras[0])["img_name"].startswith("im_")
    g = ts.create_gaussians(sh_degree=3)
    assert int(g.n_active()) == 40 and g.device.type == "cpu"
    ts.save(g, 7)
    ts.save(g, 30)
    assert search_max_iteration(str(tmp_path / "tm5" / "point_cloud")) == 30


@pytest.mark.parametrize("resolution", [2, -1])
def test_resized_gt_within_one_level_of_pil(tmp_path, resolution):
    """resolution=2 halves; -1 auto-downscales a 1700-wide image to 1600."""
    rng = np.random.default_rng(4)
    W, H = (1700, 34) if resolution == -1 else (90, 70)
    img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    path = str(tmp_path / "im.png")
    Image.fromarray(img).save(path)
    ci = CameraInfo(0, np.eye(3), np.zeros(3), 1.0, 1.0, path, "im", W, H).load_image(
        resolution=resolution)
    scale = W / 1600 if resolution == -1 else 2.0
    size = (round(W / scale), round(H / scale))
    ref = np.asarray(Image.open(path).resize(size, Image.LANCZOS)).astype(np.float32) / 255
    assert ci.image.shape == (size[1], size[0], 3) and (ci.width, ci.height) == size
    assert np.abs(ci.image - ref).max() <= 1 / 255 + 1e-7


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "LA"])
def test_png_codec_against_pil(tmp_path, mode):
    rng = np.random.default_rng(5)
    C = {"L": 1, "RGB": 3, "RGBA": 4, "LA": 2}[mode]
    # smooth content, so that PIL's optimize picks several filter types
    base = np.kron(rng.random((8, 10, C)), np.ones((8, 8, 1))) * 200
    arr = (base + rng.random(base.shape) * 40).astype(np.uint8)
    arr = arr[..., 0] if C == 1 else arr
    path = str(tmp_path / "pil.png")
    Image.fromarray(arr, mode).save(path, optimize=True)
    np.testing.assert_array_equal(timage.read_png(path), np.asarray(Image.open(path)))
    out = str(tmp_path / "ours.png")
    timage.write_png(out, arr)
    np.testing.assert_array_equal(np.asarray(Image.open(out)), arr)
    np.testing.assert_array_equal(timage.read_png(out), arr)
    assert timage.image_size(out) == (arr.shape[1], arr.shape[0])


def test_png_all_five_filters(tmp_path):
    """A PNG whose rows use filters 0-4 in turn (encoded here), decoded by
    PIL and by read_png."""
    rng = np.random.default_rng(6)
    H, W, C = 15, 11, 3
    img = rng.integers(0, 256, (H, W, C)).astype(np.int64)
    raw = []
    prev = np.zeros((W, C), np.int64)
    for y in range(H):
        ft = y % 5
        row, enc = img[y], np.zeros((W, C), np.int64)
        for x in range(W):
            a = row[x - 1] if x else np.zeros(C, np.int64)
            b = prev[x]
            c = prev[x - 1] if x else np.zeros(C, np.int64)
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
            pred = [np.zeros(C, np.int64), a, b, (a + b) // 2, paeth][ft]
            enc[x] = (row[x] - pred) % 256
        raw.append(bytes([ft]) + enc.astype(np.uint8).tobytes())
        prev = row

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(raw))) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img.astype(np.uint8))
    np.testing.assert_array_equal(timage.read_png(path), img.astype(np.uint8))


def test_unsupported_png_and_jpeg_without_pil(tmp_path, monkeypatch):
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(tmp_path / "d16.png")
    with pytest.raises(timage.ImageFormatError, match="d16.png.*bit depth 16"):
        timage.read_image(str(tmp_path / "d16.png"))
    jpg = str(tmp_path / "photo.jpg")
    Image.fromarray(np.full((8, 8, 3), 128, np.uint8)).save(jpg, quality=95)
    assert timage.read_image(jpg).shape == (8, 8, 3)  # through PIL where it imports
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(timage.ImageFormatError, match=r"photo\.jpg.*JPEG.*without PIL"):
        timage.read_image(jpg)
    ci = CameraInfo(0, np.eye(3), np.zeros(3), 1.0, 1.0, jpg, "photo", 8, 8)
    with pytest.raises(timage.ImageFormatError, match="JPEG"):
        ci.load_image()
