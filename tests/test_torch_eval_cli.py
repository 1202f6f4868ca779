"""The evaluation CLIs of the port (``python -m radegs_torch.scripts.{metrics,
cull_mesh,eval_tnt,eval_dtu,evaluate_dtu_mesh}``) end to end on the CPU at
48x48, each against the JAX package's CLI (``scripts/*.py``) on the same
files.

- ``metrics``: ``results.json`` / ``per_view.json`` SSIM and PSNR within
  1e-5 relative (the float32 mean of the squared error is summed in
  another order by XLA and PyTorch: ~1e-6 relative on the PSNR, 2e-5 dB),
  LPIPS rtol 1e-4 (both given the same random-weight ``.npz``; the JAX
  LPIPS reads it through its ``DEFAULT_WEIGHTS_PATH``);
- ``cull_mesh``: the same faces, vertices within 1e-6 (the mesh depth
  rasterizers agree to rtol 1e-6, ``tests/test_torch_mesh.py``);
- ``eval_tnt``, ``eval_dtu``: the same files (both are numpy + scipy);
- ``evaluate_dtu_mesh`` on a COLMAP dataset with alpha masks: the same
  culled faces, vertices and results within 1e-6 relative (the camera
  centres are float32 products of two frameworks).
"""

import importlib.util
import json
import os
import pathlib
import struct
import sys

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from radegs_torch.core.camera import Camera as TCamera
from radegs_torch.core.camera import fov2focal
from radegs_torch.scripts import cull_mesh, eval_dtu, eval_tnt, evaluate_dtu_mesh, metrics
from radegs_torch.train.arguments import save_cfg_args
from radegs_torch.train.config import ModelConfig
from radegs_torch.utils import ply as tply
from radegs_torch.utils.image import write_png
from tests.test_torch_lpips import random_weights
from tests.test_torch_eval import rot_z, sphere_mesh, write_dtu_layout

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def jax_cli(name):
    """The JAX package's ``scripts/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_cli_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(path):
    with open(path, "rb") as f:
        return f.read()


def test_metrics_matches_jax(tmp_path, monkeypatch):
    import radegs_tpu.eval.lpips as jlpips

    rng = np.random.default_rng(0)
    weights = str(tmp_path / "lpips.npz")
    np.savez(weights, **random_weights(scale=0.3))
    models = []
    for m, methods in (("a", ("ours_10", "ours_30")), ("b", ("ours_7",))):
        for method in methods:
            for sub in ("renders", "gt"):
                os.makedirs(tmp_path / m / "test" / method / sub)
            for i in range(3):
                gt = rng.integers(0, 256, (48, 48, 3), dtype=np.uint8)
                noise = rng.integers(-30, 31, gt.shape)
                ren = np.clip(gt.astype(int) + noise, 0, 255).astype(np.uint8)
                base = tmp_path / m / "test" / method
                write_png(str(base / "gt" / f"{i:05d}.png"), gt)
                write_png(str(base / "renders" / f"{i:05d}.png"), ren)
                write_png(str(base / "renders" / f"{i:05d}_depth.png"), ren[..., 0])
        models.append(str(tmp_path / m))
    out = {}
    for name in ("jax", "torch"):
        for m in models:
            os.makedirs(os.path.join(m, name), exist_ok=True)
        if name == "jax":
            monkeypatch.setattr(jlpips, "DEFAULT_WEIGHTS_PATH", weights)
            jax_cli("metrics").main(["-m", *models])
        else:
            metrics.main(["-m", *models, "--lpips_weights", weights, "--device", "cpu"])
        out[name] = [[json.loads(read(os.path.join(m, f)))
                      for f in ("results.json", "per_view.json")] for m in models]
    assert out["jax"][0][0].keys() == {"ours_10", "ours_30"}
    for (jres, jview), (tres, tview) in zip(out["jax"], out["torch"]):
        for jd, td in ((jres, tres), (jview, tview)):
            assert jd.keys() == td.keys()
            for method in jd:
                assert jd[method].keys() == td[method].keys() == {"SSIM", "PSNR", "LPIPS"}
                for k, rtol in (("SSIM", 1e-5), ("PSNR", 1e-5), ("LPIPS", 1e-4)):
                    a, b = jd[method][k], td[method][k]
                    if isinstance(a, dict):
                        assert a.keys() == b.keys() == {f"{i:05d}.png" for i in range(3)}
                        a, b = [a[n] for n in sorted(a)], [b[n] for n in sorted(a)]
                    np.testing.assert_allclose(b, a, rtol=rtol)


def test_metrics_without_weights_and_with_a_bad_file(tmp_path):
    base = tmp_path / "m" / "test" / "ours_1"
    for sub in ("renders", "gt"):
        os.makedirs(base / sub)
        write_png(str(base / sub / "00000.png"), np.full((16, 16, 3), 100, np.uint8))
    res = metrics.main(["-m", str(tmp_path / "m"), "--device", "cpu"])
    assert res[str(tmp_path / "m")]["ours_1"].keys() == {"SSIM", "PSNR"}
    with pytest.raises(FileNotFoundError):
        metrics.main(["-m", str(tmp_path / "m"), "--device", "cpu", "--lpips_weights",
                      str(tmp_path / "none.npz")])


def orbit(n, radius=3.0, size=48):
    cams = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        cams.append(TCamera.look_at([radius * np.sin(ang), 0.6, -radius * np.cos(ang)],
                                    [0, 0, 0], [0, 1, 0], 0.9, 0.9, size, size, device="cpu"))
    return cams


def c2w(cam):
    return np.linalg.inv(cam.world_view.numpy().astype(np.float64))


def write_log(path, mats):
    with open(path, "w") as f:
        for i, m in enumerate(mats):
            f.write(f"{i} {i} 0\n" + "".join(" ".join(repr(float(v)) for v in row) + "\n"
                                              for row in m))


def test_cull_mesh_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    verts, faces = sphere_mesh(600, 1.0, rng)
    verts = np.concatenate([verts, verts[:200] * 0.3 + np.array([0, 0, 6.0], np.float32)])
    faces = np.concatenate([faces, sphere_mesh(200, 1.0, rng)[1] + 600])  # one behind a view
    ply = str(tmp_path / "mesh.ply")
    tply.write_mesh(ply, verts, faces)
    cams = orbit(6)
    log = str(tmp_path / "traj.log")
    write_log(log, [c2w(c) for c in cams])
    f = fov2focal(0.9, 48)
    common = ["--traj-path", log, "--ply-path", ply, "--width", "48", "--height", "48",
              "--fx", repr(f), "--fy", repr(f), "--min-views", "2", "--eps", "0.05",
              "--device", "cpu"]
    monkeypatch.setattr(sys, "argv", ["cull_mesh", *common, "--out", str(tmp_path / "j.ply")])
    jax_cli("cull_mesh").main()
    tv, tf = cull_mesh.main([*common, "--out", str(tmp_path / "t.ply")])
    jv, jf = tply.read_mesh(str(tmp_path / "j.ply"))
    assert (np.asarray(tf) == jf).all() and 0 < len(jf) < len(faces)
    np.testing.assert_allclose(tply.read_mesh(str(tmp_path / "t.ply"))[0], jv, rtol=0, atol=1e-6)
    monkeypatch.setattr(sys, "argv", ["cull_mesh", *common, "--largest-component", "--out",
                                      str(tmp_path / "j2.ply")])
    jax_cli("cull_mesh").main()
    cull_mesh.main([*common, "--largest-component", "--out", str(tmp_path / "t2.ply")])
    assert read(str(tmp_path / "j2.ply")) == read(str(tmp_path / "t2.ply"))


def test_eval_tnt_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    gt = rng.uniform(size=(6000, 3))
    R, t = rot_z(0.25), np.array([0.3, -0.1, 0.2])
    est = (gt @ R + (-R.T @ t) + rng.normal(scale=0.002, size=gt.shape)).astype(np.float32)
    ds = tmp_path / "Barn"
    ds.mkdir()
    tply.write_point_cloud(str(ds / "Barn.ply"), gt.astype(np.float32))
    c_gt = rng.uniform(size=(12, 3)) * 2
    gt_traj = np.tile(np.eye(4), (12, 1, 1))
    gt_traj[:, :3, 3] = c_gt
    est_traj = gt_traj.copy()
    est_traj[:, :3, 3] = (c_gt - t) @ R
    write_log(str(ds / "Barn_COLMAP_SfM.log"), gt_traj)
    write_log(str(tmp_path / "est.log"), est_traj)
    with open(ds / "Barn.json", "w") as f:
        json.dump({"orthogonal_axis": "Z", "axis_min": 0.02, "axis_max": 0.98,
                   "bounding_polygon": [[0.02, 0.02, 0], [0.98, 0.02, 0], [0.98, 0.98, 0],
                                        [0.02, 0.98, 0]]}, f)
    tply.write_point_cloud(str(tmp_path / "est.ply"), est)
    common = ["--dataset_dir", str(ds), "--traj_path", str(tmp_path / "est.log"),
              "--ply_path", str(tmp_path / "est.ply")]
    jax_cli("eval_tnt").main([*common, "--out_dir", str(tmp_path / "j")])
    r, stats = eval_tnt.main([*common, "--out_dir", str(tmp_path / "t")])
    assert r["f1"] > 0.9 and r["tau"] == 0.01 and stats["histo_s"] >= 0
    for f in ("Barn.recall.txt", "Barn.precision.txt", "Barn.prf_tau_plotstr.txt",
              "Barn_results.json"):
        assert read(str(tmp_path / "j" / f)) == read(str(tmp_path / "t" / f)), f
    r2, _ = eval_tnt.main([*common, "--out_dir", str(tmp_path / "t2"), "--tau", "0.02"])
    assert r2["tau"] == 0.02 and r2["precision"] >= r["precision"]


def test_eval_dtu_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    verts, faces = sphere_mesh(300, 40.0, rng)
    verts += rng.normal(scale=0.4, size=verts.shape).astype(np.float32)
    tply.write_mesh(str(tmp_path / "mesh.ply"), verts, faces)
    write_dtu_layout(str(tmp_path / "dtu"), 37, sphere_mesh(5000, 40.0, rng)[0],
                     np.array([[-50.0, -50.0, -50.0], [30.0, 50.0, 50.0]]), 4.0)
    common = ["--data", str(tmp_path / "mesh.ply"), "--scan", "37", "--dataset_dir",
              str(tmp_path / "dtu"), "--downsample_density", "1.5", "--patch_size", "10"]
    jax_cli("eval_dtu").main([*common, "--vis_out_dir", str(tmp_path / "j")])
    r, stats = eval_dtu.main([*common, "--vis_out_dir", str(tmp_path / "t")])
    assert stats["n_down"] < stats["n_samples"] and 0 < r["overall"] < 5
    for f in ("vis_037_d2s.ply", "vis_037_s2d.ply", "results.json"):
        assert read(str(tmp_path / "j" / f)) == read(str(tmp_path / "t" / f)), f


def write_masked_dataset(root, cams, rng):
    """A COLMAP dataset of RGBA PNGs (the alpha a disk: the foreground masks)
    and 30 points3D with two-entry tracks."""
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(root, "images"))
    W = H = cams[0].width
    f = fov2focal(float(cams[0].fovx), W)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as fh:
        fh.write(struct.pack("<QiiQQ4d", 1, 1, 1, W, H, f, f, W / 2, H / 2))
    yy, xx = np.mgrid[:H, :W]
    with open(os.path.join(sparse, "images.bin"), "wb") as fh:
        fh.write(struct.pack("<Q", len(cams)))
        for i, cam in enumerate(cams):
            x, y, z, w = Rotation.from_matrix(cam.R.numpy().astype(np.float64).T).as_quat()
            name = f"v{i:02d}.png"
            fh.write(struct.pack("<i4d3di", i + 1, w, x, y, z,
                                 *cam.T.numpy().astype(np.float64), 1)
                     + name.encode() + b"\x00" + struct.pack("<Q", 0))
            img = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
            cx, cy = rng.choice([2, 46], size=2)  # a corner: the 12-pixel dilation reaches in
            img[..., 3] = np.where((xx - cx) ** 2 + (yy - cy) ** 2 < 150, 255, 0)
            write_png(os.path.join(root, "images", name), img)
    with open(os.path.join(sparse, "points3D.bin"), "wb") as fh:
        fh.write(struct.pack("<Q", 30))
        for i in range(30):
            fh.write(struct.pack("<Q3d3BdQ4i", i, *(rng.normal(size=3) * 0.5),
                                 *rng.integers(0, 256, 3).tolist(), 0.5, 2, 1, i, 2, i))


def test_evaluate_dtu_mesh_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    cams = orbit(5)
    ds, m = str(tmp_path / "ds"), str(tmp_path / "m")
    write_masked_dataset(ds, cams, rng)
    save_cfg_args(m, ModelConfig(source_path=ds, model_path=m))
    verts, faces = sphere_mesh(400, 0.5, rng)
    mesh = str(tmp_path / "recon.ply")
    tply.write_mesh(mesh, verts, faces)
    s, R, t = 10.0, rot_z(0.3), np.array([5.0, -3.0, 40.0])
    dtu = str(tmp_path / "dtu")
    write_dtu_layout(dtu, 24, s * sphere_mesh(4000, 0.5, rng)[0] @ R.T + t,
                     np.array([[-10.0, -10.0, 30.0], [15.0, 10.0, 50.0]]), 1.0)
    os.makedirs(os.path.join(dtu, "Calibration", "cal18"))
    for i, cam in enumerate(cams):  # P = K [R_dtu | t_dtu] of the transformed camera
        w2c = cam.world_view.numpy().astype(np.float64)
        centre = s * (-w2c[:3, :3].T @ w2c[:3, 3]) @ R.T + t
        rot = w2c[:3, :3] @ R.T
        K = np.array([[100.0, 0, 24], [0, 100.0, 24], [0, 0, 1]])
        np.savetxt(os.path.join(dtu, "Calibration", "cal18", f"pos_{i + 1:03d}.txt"),
                   K @ np.concatenate([rot, (-rot @ centre)[:, None]], 1))
    argv = ["-m", m, "--DTU", dtu, "--scan_id", "24", "--mesh", mesh]
    jax_cli("evaluate_dtu_mesh").main(argv)
    jv, jf = tply.read_mesh(os.path.join(m, "culled_mesh.ply"))
    jres = json.loads(read(os.path.join(m, "dtu_eval", "results.json")))
    T, r, stats = evaluate_dtu_mesh.main([*argv, "--device", "cpu"])
    tv, tf = tply.read_mesh(os.path.join(m, "culled_mesh.ply"))
    np.testing.assert_allclose(T[:3, :3], s * R, atol=1e-5)
    assert (tf == jf).all() and 0 < len(tf) < len(faces)
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6 * np.abs(jv).max())
    assert r.keys() == jres.keys()
    for k in r:
        assert r[k] == pytest.approx(jres[k], rel=1e-6)
    assert stats["n_down"] > 0
