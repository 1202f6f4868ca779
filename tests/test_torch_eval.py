"""The evaluation toolkit on the port (``radegs_torch/eval``: ``tnt``,
``dtu``, ``dtu_mesh``; ``utils/ply`` point clouds; ``get_truc_tetra_points``)
against the JAX package on the same numpy inputs.

The cases of ``tests/test_eval.py`` run through both packages: both are
numpy + scipy, so the results must agree to 1e-12 (they are the same
calls). ``evaluate_dtu`` on a synthetic DTU layout (ObsMask / Plane written
with ``scipy.io.savemat``): equal results and the same error-cloud bytes.
``align_and_cull`` on a synthetic scene with masks: the same transform
(1e-9: the camera centres are float32 products of two frameworks) and the
same faces. ``get_truc_tetra_points``: rtol / atol 1e-6 (the quaternion
norm rounds in another order), the same kept Gaussians.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import savemat
from scipy.spatial import ConvexHull

from radegs_tpu.core.camera import Camera as JCamera
from radegs_tpu.eval import dtu as jdtu
from radegs_tpu.eval import dtu_mesh as jdtu_mesh
from radegs_tpu.eval import tnt as jtnt
from radegs_tpu.models import gaussian_model as jgm
from radegs_tpu.utils import ply as jply
from radegs_torch.core.camera import Camera as TCamera
from radegs_torch.eval import dtu as tdtu
from radegs_torch.eval import dtu_mesh as tdtu_mesh
from radegs_torch.eval import tnt as ttnt
from radegs_torch.models import gaussian_model as tgm
from radegs_torch.utils import ply as tply

torch.set_num_threads(1)
PKGS = {"jax": (jtnt, jdtu), "torch": (ttnt, tdtu)}


def assert_same(a, b, tol=1e-12, path="result"):
    """Equal structure; floats and arrays within ``tol`` (absolute)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], tol, f"{path}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, tol, f"{path}[{i}]")
    elif a is None or isinstance(a, str):
        assert a == b, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, path
        np.testing.assert_allclose(b, a, rtol=0, atol=tol, err_msg=path)


def rot_z(ang):
    return np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])


def traj(centers):
    T = np.tile(np.eye(4), (len(centers), 1, 1))
    T[:, :3, 3] = centers
    return T


def case_umeyama(tnt, dtu, tmp):
    rng = np.random.default_rng(0)
    src = rng.normal(size=(200, 3))
    dst = 2.3 * src @ rot_z(0.7).T + np.array([1.0, -2.0, 0.5])
    s, R, t = tnt.umeyama(src, dst)
    assert abs(s - 2.3) < 1e-6 and np.abs(R - rot_z(0.7)).max() < 1e-6
    return s, R, t


def case_icp(tnt, dtu, tmp):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(3000, 3))
    dst = pts + np.array([0.02, -0.01, 0.015])
    T = tnt.icp_point_to_point(pts, dst, thresh=0.2)
    assert np.abs(pts @ T[:3, :3].T + T[:3, 3] - dst).max() < 1e-3
    return T


def case_fscore(tnt, dtu, tmp):
    rng = np.random.default_rng(2)
    gt = rng.uniform(size=(5000, 3))
    est = gt + rng.normal(scale=0.002, size=gt.shape)
    r, r2 = tnt.evaluate_histo(est, gt, tau=0.01), tnt.evaluate_histo(est + 0.5, gt, tau=0.01)
    assert r["f1"] > 0.95 and r2["f1"] < 0.05
    return r, r2


def case_chamfer_and_downsample(tnt, dtu, tmp):
    rng = np.random.default_rng(3)
    a = rng.uniform(size=(4000, 3))
    b = a + rng.normal(scale=0.01, size=a.shape)
    assert dtu.chamfer_distance(a, a) < 1e-12
    return (dtu.chamfer_distance(a, b), dtu.chamfer_distance(a, b, max_dist=0.02),
            tnt.voxel_downsample(a, 0.2), dtu.radius_downsample(a, 0.15),
            tnt.uniform_downsample(a, 1500))


def case_surface_sampling(tnt, dtu, tmp):
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0.3, 0.2, 0.9]], np.float64)
    faces = np.array([[0, 1, 2], [0, 1, 3], [1, 2, 3], [0, 0, 1]])  # the last degenerate
    pts = dtu.sample_mesh_surface(verts, faces, 0.05)
    assert 100 < len(pts) < 2000
    return pts


def case_evaluate_tnt(tnt, dtu, tmp):
    rng = np.random.default_rng(4)
    gt = rng.uniform(size=(8000, 3))
    R, t = rot_z(0.3), np.array([0.4, 0.1, -0.2])
    est = gt @ R + (-R.T @ t)  # R @ est + t == gt
    c_gt = rng.uniform(size=(20, 3)) * 2
    r = tnt.evaluate_tnt("TestScene", est, gt, est_traj=traj((c_gt - t) @ R),
                         gt_traj=traj(c_gt), tau=0.01)
    assert r["f1"] > 0.9
    return r


def case_two_stage_icp_and_dumps(tnt, dtu, tmp):
    rng = np.random.default_rng(9)
    gt = rng.uniform(size=(9000, 3))
    est = gt @ rot_z(0.04).T + np.array([0.02, -0.015, 0.01])
    crop = os.path.join(tmp, "crop.json")
    with open(crop, "w") as f:
        json.dump({"orthogonal_axis": "Z", "axis_min": 0.05, "axis_max": 0.95,
                   "bounding_polygon": [[0.05, 0.05, 0], [0.95, 0.05, 0], [0.95, 0.95, 0],
                                        [0.05, 0.95, 0]]}, f)
    stats = {}
    kw = {"stats": stats} if tnt is ttnt else {}
    r_icp = tnt.evaluate_tnt("S", est, gt, tau=0.005, icp_refine=True, crop_json=crop,
                             out_dir=tmp, **kw)
    r_no = tnt.evaluate_tnt("S2", est, gt, tau=0.005, icp_refine=False)
    assert r_icp["f1"] > 0.97 and r_icp["f1"] > r_no["f1"] + 0.1
    if tnt is ttnt:
        assert {"registration_s", "downsample_s", "histo_s"} <= stats.keys()
    dumps = [np.loadtxt(os.path.join(tmp, f"S.{k}.txt"))
             for k in ("recall", "precision", "prf_tau_plotstr")]
    with open(os.path.join(tmp, "S_results.json")) as f:
        scalars = json.load(f)
    return r_icp, r_no, dumps, scalars


CASES = [case_umeyama, case_icp, case_fscore, case_chamfer_and_downsample,
         case_surface_sampling, case_evaluate_tnt, case_two_stage_icp_and_dumps]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_eval_cases_match_jax(case, tmp_path):
    out = {}
    for name, mods in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        out[name] = case(*mods, str(d))
    assert_same(out["jax"], out["torch"])


def test_point_cloud_ply_bytes_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    for kw in ({}, {"colors": rng.uniform(size=(300, 3))},
               {"colors": rng.integers(0, 256, (300, 3)).astype(np.uint8),
                "normals": rng.normal(size=(300, 3)).astype(np.float32)}):
        a, b = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
        jply.write_point_cloud(a, pts, **kw)
        tply.write_point_cloud(b, pts, **kw)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        assert_same(jply.read_point_cloud(a), tply.read_point_cloud(b), tol=0)


def sphere_mesh(n, radius, rng):
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hull = ConvexHull(d)
    return (d * radius).astype(np.float32), hull.simplices.astype(np.int64)


def write_dtu_layout(root, scan, stl, bb, res):
    """A DTU reference directory: an ObsMask grid over ``bb`` (every other
    x-slab observed), a ground plane z > -45 and the stl cloud."""
    os.makedirs(os.path.join(root, "ObsMask"))
    os.makedirs(os.path.join(root, "Points", "stl"))
    shape = np.ceil((bb[1] - bb[0]) / res).astype(int) + 1
    mask = np.ones(shape, bool)
    mask[::2] = False
    mask[1::4] = True
    savemat(os.path.join(root, "ObsMask", f"ObsMask{scan}_10.mat"),
            {"ObsMask": mask, "BB": bb, "Res": np.array([[res]])})
    savemat(os.path.join(root, "ObsMask", f"Plane{scan}.mat"),
            {"P": np.array([[0.0], [0.0], [1.0], [45.0]])})
    tply.write_point_cloud(os.path.join(root, "Points", "stl", f"stl{scan:03}_total.ply"), stl)


def test_evaluate_dtu_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    verts, faces = sphere_mesh(400, 50.0, rng)
    verts += rng.normal(scale=0.5, size=verts.shape).astype(np.float32)
    mesh = str(tmp_path / "mesh.ply")
    tply.write_mesh(mesh, verts, faces)
    stl, _ = sphere_mesh(6000, 50.0, rng)
    bb = np.array([[-60.0, -60.0, -60.0], [40.0, 60.0, 60.0]])
    write_dtu_layout(str(tmp_path / "dtu"), 24, stl, bb, 4.0)
    out = {}
    for name, dtu in (("jax", jdtu), ("torch", tdtu)):
        d = str(tmp_path / f"out_{name}")
        out[name] = dtu.evaluate_dtu(mesh, 24, str(tmp_path / "dtu"), out_dir=d,
                                     downsample_density=2.0, patch_size=10.0, max_dist=20.0)
        out[name + "_files"] = [open(os.path.join(d, f), "rb").read()
                                for f in ("vis_024_d2s.ply", "vis_024_s2d.ply", "results.json")]
    assert_same(out["jax"], out["torch"])
    assert out["jax_files"] == out["torch_files"]
    assert 0 < out["torch"]["mean_d2s"] < 5 and 0 < out["torch"]["mean_s2d"] < 5


def test_align_and_cull_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    verts, faces = sphere_mesh(500, 1.0, rng)
    mesh = str(tmp_path / "mesh.ply")
    tply.write_mesh(mesh, verts, faces)
    jcams, tcams, masks = [], [], []
    W, H = 160, 128
    yy, xx = np.mgrid[:H, :W]
    for i in range(5):
        ang = 2 * np.pi * i / 5
        args = ([3.0 * np.sin(ang), 0.5, -3.0 * np.cos(ang)], [0, 0, 0], [0, 1, 0], 0.8, 0.7,
                W, H)
        jcams.append((JCamera.look_at(*args), None, i))
        tcams.append((TCamera.look_at(*args, device="cpu"), None, i))
        cx, cy = rng.uniform(50, 110), rng.uniform(40, 90)
        masks.append(((xx - cx) ** 2 + (yy - cy) ** 2 < 150).astype(np.float32))
    centres = np.stack([np.asarray(c[0].camera_center) for c in jcams]).astype(np.float64)
    dtu_centres = 80.0 * centres @ rot_z(0.4).T + np.array([10.0, -5.0, 300.0])
    j = jdtu_mesh.align_and_cull(mesh, jcams, dtu_centres, masks=masks,
                                 out_path=str(tmp_path / "j.ply"))
    t = tdtu_mesh.align_and_cull(mesh, tcams, dtu_centres, masks=masks,
                                 out_path=str(tmp_path / "t.ply"))
    np.testing.assert_allclose(t[2], j[2], rtol=0, atol=1e-9 * np.abs(j[2]).max())
    assert (t[1] == j[1]).all() and 0 < len(t[1]) < len(faces)
    np.testing.assert_allclose(t[0], j[0], rtol=0, atol=1e-9 * np.abs(j[0]).max())
    n = tdtu_mesh.align_and_cull(mesh, tcams, dtu_centres)
    assert len(n[1]) == len(faces)


def test_get_truc_tetra_points_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(0, 1.5, (60, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (60, 3)).astype(np.float32)
    js = jgm.create_from_points(pts, cols, sh_degree=0, capacity=128)
    js = js.replace(params=js.params.replace(
        rotation=jnp.asarray(rng.normal(size=(128, 4)).astype(np.float32))))
    p = js.params
    ts = tgm.state_from_arrays(
        np.asarray(p.xyz), np.asarray(p.f_dc), np.asarray(p.f_rest), np.asarray(p.scaling),
        np.asarray(p.rotation), np.asarray(p.opacity), np.asarray(js.active),
        np.asarray(js.filter_3d), int(js.active_sh_degree), js.max_sh_degree, device="cpu")
    jcams, tcams = [], []
    for eye in ([0, 0, -4], [3, 1, 0]):
        args = (eye, [0, 0, 0], [0, 1, 0], 0.7, 0.6, 64, 48)
        jcams.append(JCamera.look_at(*args))
        tcams.append(TCamera.look_at(*args, device="cpu"))
    for depth_truc in (3.0, 4.5, 1e9):
        jp, jsc = jgm.get_truc_tetra_points(js, jcams, depth_truc)
        tp, tsc = tgm.get_truc_tetra_points(ts, tcams, depth_truc)
        assert tp.shape == jp.shape and tsc.shape == jsc.shape
        np.testing.assert_allclose(tp, jp, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tsc, jsc, rtol=1e-6, atol=0)
    assert 0 < len(tgm.get_truc_tetra_points(ts, tcams, 3.0)[0]) < len(tp)
