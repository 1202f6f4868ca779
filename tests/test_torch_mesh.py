"""Mesh extraction on the port (``radegs_torch/mesh``) against the JAX
package: marching tetrahedra, seed points and their dedup, TSDF fusion and
meshing on the same depth maps, the three extractors on the opaque-sphere
scene of tests/test_mesh.py, the mesh depth rasterizer, the mesh writer,
and the CUDA-by-default entry points.

Tolerances:
- marching tetrahedra, seed dedup, mesh PLY bytes: exactly equal;
- ``get_tetra_points``: rtol 1e-6 / atol 1e-6 (the quaternion norm rounds
  in another order in the two frameworks);
- ``fuse_tsdf`` + ``tsdf_to_mesh`` on the same depth maps: equal vertex and
  face counts and faces; vertices within 1e-5 with float32 transfer
  (``io_dtype="f32"``; the view transform rounds differently, ~6e-7 on the
  fused value), within 1e-4 with the default float16 transfer (one float16
  step of a fused value moves a vertex by up to ~voxel x 2^-11 / |s0 - s1|);
- the extractors end to end (each package renders with its own
  preprocess): vertex counts within 1%, the median vertex radius within 0.2
  of the unit sphere (the JAX test's bound), within 0.08 for unbounded;
- ``mesh_depth_map``: rtol 1e-6 (XLA may contract the edge functions into
  FMAs), the same hit pixels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radegs_tpu.core.camera import Camera as JCamera
from radegs_tpu.mesh import culling as jcull
from radegs_tpu.mesh import tsdf as jtsdf
from radegs_tpu.mesh.extract_tetra import decimate_seed_points as j_decimate, \
    extract_mesh_tetrahedra as j_tetra
from radegs_tpu.mesh.tetmesh import marching_tetrahedra as j_mt
from radegs_tpu.mesh.unbounded import contract as j_contract, \
    extract_mesh_unbounded as j_unbounded, scene_normalization as j_scene_norm, \
    uncontract as j_uncontract
from radegs_tpu.models import gaussian_model as jgm
from radegs_tpu.utils import ply as jply
from radegs_torch.core.camera import Camera as TCamera
from radegs_torch.mesh import culling as tcull
from radegs_torch.mesh import tsdf as ttsdf
from radegs_torch.mesh.extract_tetra import decimate_seed_points as t_decimate, \
    extract_mesh_tetrahedra as t_tetra
from radegs_torch.mesh.tetmesh import marching_tetrahedra as t_mt
from radegs_torch.mesh.unbounded import contract as t_contract, \
    extract_mesh_unbounded as t_unbounded, scene_normalization as t_scene_norm, \
    uncontract as t_uncontract
from radegs_torch.models import gaussian_model as tgm
from radegs_torch.utils import ply as tply

torch.set_num_threads(1)


def carry(js):
    p = js.params
    return tgm.state_from_arrays(
        np.asarray(p.xyz), np.asarray(p.f_dc), np.asarray(p.f_rest), np.asarray(p.scaling),
        np.asarray(p.rotation), np.asarray(p.opacity), np.asarray(js.active),
        np.asarray(js.filter_3d), int(js.active_sh_degree), js.max_sh_degree, device="cpu")


@pytest.fixture(scope="module")
def sphere():
    """tests/test_mesh.py's scene: 700 opaque splats on the unit sphere, 6
    orbit views at 64x64; the JAX state and its port twin."""
    rng = np.random.default_rng(0)
    n = 700
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    js = jgm.create_from_points(dirs.astype(np.float32),
                                rng.uniform(0.3, 0.8, size=(n, 3)).astype(np.float32),
                                capacity=jgm.round_capacity(n, 1024))
    js = js.replace(params=js.params.replace(
        opacity=jnp.where(js.active[:, None], jgm.inverse_sigmoid(jnp.float32(0.95)),
                          js.params.opacity),
        scaling=jnp.where(js.active[:, None], jnp.log(jnp.float32(0.09)), js.params.scaling)))
    jviews, tviews = [], []
    for i in range(6):
        ang = 2 * np.pi * i / 6
        args = ([3.2 * np.sin(ang), 0.4, -3.2 * np.cos(ang)], [0, 0, 0], [0, 1, 0], 0.9, 0.9,
                64, 64)
        jviews.append((JCamera.look_at(*args), None, i))
        tviews.append((TCamera.look_at(*args, device="cpu"), None, i))
    return js, carry(js), jviews, tviews


def test_marching_tetrahedra_single_tet():
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float64)
    tets = np.array([[0, 1, 2, 3]])
    sdf = np.array([-1.0, -1.0, 0.5, 0.5])
    ref, out = j_mt(verts, tets, sdf, np.ones(4)), t_mt(verts, tets, sdf, np.ones(4))
    assert out[0].shape[0] == 4 and out[3].shape == (2, 3)
    for a, b in zip(ref, out):
        assert a.shape == b.shape and (a == b).all()


def test_marching_tetrahedra_random():
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, size=(400, 3))
    tets = Delaunay(pts).simplices
    sdf = np.linalg.norm(pts, axis=1) - 0.6
    scales = rng.uniform(0.1, 1, size=400)
    ref, out = j_mt(pts, tets, sdf, scales), t_mt(pts, tets, sdf, scales)
    assert out[3].shape[0] > 100
    for a, b in zip(ref, out):
        assert a.shape == b.shape and (a == b).all()


def test_decimate_and_tetra_points(sphere):
    js, ts, _, _ = sphere
    jp, js_ = jgm.get_tetra_points(js)
    tp, ts_ = tgm.get_tetra_points(ts)
    assert tp.shape == (9 * 700, 3) and ts_.shape == (9 * 700,)
    np.testing.assert_allclose(tp, jp, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts_, js_, rtol=1e-6, atol=0)
    voxel = float(np.median(js_)) / 3
    a, b = j_decimate(jp, js_, voxel), t_decimate(jp, js_, voxel)
    assert (a[0] == b[0]).all() and (a[1] == b[1]).all() and len(b[0]) < len(jp)


def test_fuse_tsdf_on_the_same_depth_maps(sphere):
    js, ts, jviews, tviews = sphere
    jmaps = jtsdf.render_depth_maps(js, jviews, 0.1, jnp.zeros(3), max_per_tile=256)
    tmaps = ttsdf.render_depth_maps(ts, tviews, 0.1, [0, 0, 0], max_per_tile=256, device="cpu")
    for (jd, jE, jK), (td, tE, tK) in zip(jmaps, tmaps):  # the port's own renders
        assert np.abs(jd - td.numpy()).max() < 1e-4
        assert (jE == tE.numpy()).all() and (jK == tK.numpy()).all()
    same = [tuple(torch.from_numpy(x) for x in m) for m in jmaps]
    for io, tol in (("f32", 1e-5), ("f16", 1e-4)):
        jg = jtsdf.fuse_tsdf(jmaps, voxel_size=0.05, io_dtype=io)
        stats = {}
        tg = ttsdf.fuse_tsdf(same, voxel_size=0.05, io_dtype=io, stats=stats)
        assert tg[0].shape == jg[0].shape and (tg[1] == jg[1]).all()
        assert (tg[2] == jg[2]).all() and tg[3] == jg[3]
        assert stats["active_blocks"] > 0 and stats["fuse"] >= 0
        jv, jf = jtsdf.tsdf_to_mesh(*jg)
        tv, tf = ttsdf.tsdf_to_mesh(*tg)
        assert tv.shape == jv.shape and tf.shape == jf.shape and (tf == jf).all(), io
        assert np.abs(tv - jv).max() <= tol, (io, np.abs(tv - jv).max())
        assert len(tf) > 1000


def _check_sphere(verts, ref_verts, radius_tol):
    assert abs(len(verts) - len(ref_verts)) <= 0.01 * len(ref_verts), \
        (len(verts), len(ref_verts))
    r = np.linalg.norm(verts, axis=1)
    assert abs(np.median(r) - 1.0) < radius_tol, np.median(r)


def test_extract_mesh_tsdf_matches_jax(sphere, tmp_path):
    js, ts, jviews, tviews = sphere
    jv, jf = jtsdf.extract_mesh_tsdf(js, jviews, 0.1, jnp.zeros(3), voxel_size=0.05,
                                     max_per_tile=256, verbose=False)
    stats = {}
    out = tmp_path / "tsdf.ply"
    tv, tf = ttsdf.extract_mesh_tsdf(ts, tviews, 0.1, [0, 0, 0], voxel_size=0.05,
                                     out_path=str(out), max_per_tile=256, verbose=False,
                                     device="cpu", stats=stats)
    assert len(tv) > 100 and len(tf) > 100
    _check_sphere(tv, jv, 0.2)
    rv, rf = tply.read_mesh(str(out))
    assert (rv == tv).all() and (rf == tf).all()
    assert set(stats) >= {"depth_maps", "mark", "fuse", "mesh"}


def test_extract_mesh_tetrahedra_matches_jax(sphere):
    js, ts, jviews, tviews = sphere
    kw = dict(n_binary_steps=3, max_per_tile=256, instance_budget=1 << 15, verbose=False)
    jv, jf = j_tetra(js, jviews, 0.1, jnp.zeros(3), **kw)
    stats = {}
    tv, tf = t_tetra(ts, tviews, 0.1, [0, 0, 0], device="cpu", stats=stats, **kw)
    assert len(tv) > 100 and len(tf) > 100
    _check_sphere(tv, jv, 0.2)
    assert stats["n_faces"] == len(tf) and len(stats["sdf_pass_s"]) == 4
    assert stats["n_seeds"] == 9 * 700 and stats["n_seeds_decimated"] < stats["n_seeds"]


def test_extract_mesh_unbounded_matches_jax(sphere):
    js, ts, jviews, tviews = sphere
    kw = dict(resolution=96, block=32, max_per_tile=256, verbose=False)
    jv, jf, jc = j_unbounded(js, jviews, 0.1, jnp.zeros(3), **kw)
    tv, tf, tc = t_unbounded(ts, tviews, 0.1, [0, 0, 0], device="cpu", **kw)
    assert len(tv) > 200 and len(tf) > 200
    _check_sphere(tv, jv, 0.08)
    assert tc.shape == (len(tv), 3) and (tc >= 0).all() and (tc <= 1).all()


def test_contraction_and_normalization(sphere):
    x = np.random.default_rng(2).normal(size=(500, 3)).astype(np.float32) * 3.0
    np.testing.assert_allclose(t_contract(torch.from_numpy(x)).numpy(), j_contract(x),
                               rtol=1e-6, atol=1e-6)
    y = j_contract(x)
    np.testing.assert_allclose(t_uncontract(torch.from_numpy(y)).numpy(), j_uncontract(y),
                               rtol=1e-5, atol=1e-5)
    _, _, jviews, tviews = sphere
    jc, jr = j_scene_norm([v[0] for v in jviews])
    tc, tr = t_scene_norm([v[0] for v in tviews])
    np.testing.assert_allclose(tc, jc, atol=1e-5)
    assert abs(tr - jr) < 1e-5


def test_mesh_depth_map_matches_jax():
    W = H = 64
    rng = np.random.default_rng(6)
    verts = np.concatenate([rng.uniform(-1, 1, (60, 2)), rng.uniform(1.5, 3, (60, 1))], 1)
    verts = verts.astype(np.float32)
    faces = rng.integers(0, 60, size=(40, 3))
    w2c = np.eye(4, dtype=np.float32)
    jd, jo = jcull.mesh_depth_map(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(w2c),
                                  60.0, 60.0, 32.0, 32.0, width=W, height=H,
                                  max_per_tile=64, instance_budget=1 << 14)
    td, to = tcull.mesh_depth_map(verts, faces, w2c, 60.0, 60.0, 32.0, 32.0, W, H,
                                  max_per_tile=64, instance_budget=1 << 14, device="cpu")
    jd = np.asarray(jd)
    assert int(jo) == int(to)
    assert ((jd > 0) == (td.numpy() > 0)).all() and (jd > 0).mean() > 0.2
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-6, atol=0)
    # visibility and culling on the same mesh
    cams = [(w2c, 60.0, 60.0, 32.0, 32.0, W, H)]
    jm = jcull.point_visibility(verts, cams, meshes=(jnp.asarray(verts), jnp.asarray(faces)),
                                min_views=1)
    tm = tcull.point_visibility(verts, cams, meshes=(verts, faces), min_views=1,
                                device="cpu")
    assert (jm == tm).all() and tm.any() and not tm.all()
    for a, b in zip(jcull.cull_mesh(verts, faces, cams, min_views=1),
                    tcull.cull_mesh(verts, faces, cams, min_views=1, device="cpu")):
        assert (np.asarray(a) == b).all()


def test_post_processing_matches_jax():
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(8)
    # two separate patches and a 2-triangle floater
    a = rng.uniform(0, 1, (80, 2))
    b = rng.uniform(3, 3.5, (30, 2))
    verts = np.concatenate([np.c_[a, np.zeros(80)], np.c_[b, np.zeros(30)],
                            [[9, 9, 0], [9.1, 9, 0], [9, 9.1, 0], [9.1, 9.1, 0]]])
    faces = np.concatenate([Delaunay(a).simplices, Delaunay(b).simplices + 80,
                            [[110, 111, 112], [111, 112, 113]]])
    for fn, kw in ((jcull.post_process_mesh, dict(cluster_to_keep=2, min_triangles=3)),
                   (jcull.keep_largest_component, {}),
                   (jcull.keep_largest_component, dict(area_fraction=0.01))):
        tfn = getattr(tcull, fn.__name__)
        for x, y in zip(fn(verts, faces, **kw), tfn(verts, faces, **kw)):
            assert (np.asarray(x) == y).all(), fn.__name__


def test_write_mesh_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(9)
    v = rng.normal(size=(50, 3)).astype(np.float32)
    f = rng.integers(0, 50, size=(70, 3))
    c = rng.uniform(0, 1, size=(50, 3)).astype(np.float32)
    for cols in (None, c):
        jply.write_mesh(str(tmp_path / "j.ply"), v, f, vertex_colors=cols)
        tply.write_mesh(str(tmp_path / "t.ply"), v, f, vertex_colors=cols)
        assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
        rv, rf = tply.read_mesh(str(tmp_path / "t.ply"))
        assert (rv == v).all() and (rf == f).all()


def test_entry_points_need_cuda_unless_asked_for_cpu(sphere, monkeypatch):
    from radegs_torch.renderer import integrate, integrate_prepare

    _, ts, _, tviews = sphere
    cam = tviews[0][0]
    pts = np.zeros((4, 3), np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda **d: integrate(pts, ts, cam, [0, 0, 0], **d),
        lambda **d: integrate_prepare(ts, cam, [0, 0, 0], **d),
        lambda **d: ttsdf.extract_mesh_tsdf(ts, tviews[:1], 0.1, [0, 0, 0], voxel_size=0.2,
                                            verbose=False, **d),
        lambda **d: t_tetra(ts, tviews[:1], 0.1, [0, 0, 0], n_binary_steps=0, verbose=False,
                            **d),
        lambda **d: t_unbounded(ts, tviews[:1], 0.1, [0, 0, 0], resolution=16, block=16,
                                verbose=False, **d),
        lambda **d: tcull.mesh_depth_map(np.eye(3), np.array([[0, 1, 2]]), np.eye(4), 50.0,
                                         50.0, 16.0, 16.0, 32, 32, **d),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    out = integrate(pts, ts, cam, [0, 0, 0], device="cpu")
    assert out["alpha_integrated"].shape == (4,)
