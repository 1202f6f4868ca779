"""Point-opacity integration: the port's plain phase A / phase B
(``radegs_torch/ops/integrate.py``) against the JAX package's XLA path and
both Pallas kernels in interpret mode, on the same preprocess arrays (the
JAX ``PreprocessOut`` carried across as numpy, ill-conditioned rows
included), and ``renderer.integrate`` against the JAX renderer.

Tolerances:
- ``project_points``: validity, pixel, tile and ray distance exactly equal;
  the pixel coordinates within rtol 2e-6 / atol 1e-5 px (the 3x3 view
  transform rounds in another order in XLA's dot than in torch's matmul).
- phase A: abs 1e-5 on every channel of the 9-channel image and on every
  ``mid_*`` field (the JAX suite's own bound, tests/test_integrate.py);
- phase B: abs 1e-5 on ``alpha_integrated`` and the SDF;
- binning: exactly equal per-tile lists;
- ``renderer.integrate`` vs the JAX renderer (the port's own preprocess):
  atol 5e-5 / rtol 1e-4 on every float key, as the render parity test, and
  equal ``point_valid``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radegs_tpu.core.camera import Camera as JCamera
from radegs_tpu.core.projection import preprocess_gaussians as j_preprocess
from radegs_tpu.models import gaussian_model as jgm
from radegs_tpu.ops import integrate as ji
from radegs_tpu.ops.pallas_integrate import integrate_image_pallas, integrate_points_pallas
from radegs_tpu.renderer import integrate as j_integrate
from radegs_torch.core.camera import Camera as TCamera
from radegs_torch.core.projection import COLUMNS, PreprocessOut
from radegs_torch.models import gaussian_model as tgm
from radegs_torch.ops import integrate as ti
from radegs_torch.renderer import integrate as t_integrate, integrate_points, \
    integrate_prepare

torch.set_num_threads(1)
ATOL = 1e-5
BG = (0.1, 0.2, 0.3)
CASES = {
    # name: (width, height, max_per_tile)
    "64x64": (64, 64, 256),
    "ragged_72x50": (72, 50, 256),
    "starved_max_per_tile": (72, 50, 6),
}


def scene_prep(W, H, seed=0, P=150):
    """A seeded scene's JAX preprocess (with the inverse ray-space
    covariance; 10 Gaussians with one scale 1e-5, ill-conditioned) and its
    port twin from the same arrays."""
    rng = np.random.default_rng(seed)
    args = ([0, 0.2, -4], [0, 0, 0], [0, 1, 0], 0.9, 0.8, W, H)
    q = rng.normal(size=(P, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    scales = np.exp(rng.normal(size=(P, 3)) * 0.5 - 2.0)
    scales[:10, 0] = 1e-5
    prep = j_preprocess(
        jnp.asarray(rng.normal(size=(P, 3)) * 0.6, jnp.float32),
        jnp.asarray(scales, jnp.float32), jnp.asarray(q, jnp.float32),
        jnp.asarray(rng.uniform(0.3, 0.99, (P, 1)), jnp.float32),
        jnp.asarray(rng.uniform(0, 1, (P, 1, 3)), jnp.float32),
        sh_degree=0, camera=JCamera.look_at(*args), kernel_size=0.1, compute_invraycov=True)
    t = {k: torch.from_numpy(np.array(getattr(prep, k)))
         for k in ["valid", "radius", "well_conditioned", "invraycov", *COLUMNS]}
    tprep = PreprocessOut.from_fields(**t)
    return prep, tprep, JCamera.look_at(*args), TCamera.look_at(*args, device="cpu")


def query_points(seed=1):
    """Points in the cloud, in front of it, behind the camera (z < 0.2 in
    view) and outside the image."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(size=(300, 3)) * 0.7,
                           [[0, 0, -5.0], [0, 0.2, -3.9], [9, 9, 1.0], [-9, 0, 0.5]]]
                          ).astype(np.float32)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    W, H, K = CASES[request.param]
    prep, tprep, jcam, tcam = scene_prep(W, H)
    assert (~np.asarray(prep.well_conditioned)).sum() == 10
    bg = jnp.asarray(BG)
    jcache = ji.integrate_view_cache(prep, jcam, bg, max_per_tile=K, instance_budget=1 << 13,
                                     backend="xla")
    tcache = ti.integrate_view_cache(tprep, tcam, torch.tensor(BG), max_per_tile=K,
                                     instance_budget=1 << 13)
    pts = query_points()
    jp = ji.project_points(jnp.asarray(pts), jcam)
    tp = ti.project_points(torch.from_numpy(pts), tcam)
    return dict(name=request.param, W=W, H=H, K=K, prep=prep, tprep=tprep, jcache=jcache,
                tcache=tcache, jp=jp, tp=tp)


def test_project_points_exact(case):
    jp, tp = case["jp"], case["tp"]
    for k in ("valid", "pixel", "tile", "depth"):
        assert (np.asarray(getattr(jp, k)) == getattr(tp, k).numpy()).all(), k
    np.testing.assert_allclose(tp.xy.numpy(), np.asarray(jp.xy), rtol=2e-6, atol=1e-5)
    v = tp.valid.numpy()
    assert v.any() and not v.all()  # behind the camera and outside the image too


def test_radius_only_binning_equals_jax(case):
    jb, tb = case["jcache"]["binning"], case["tcache"]["binning"]
    assert int(tb.n_culled) == 0  # no exact per-tile cut on this path
    for name in ("n_instances", "n_overflow", "tile_overflow", "max_tile_count"):
        assert int(getattr(jb, name)) == int(getattr(tb, name)), name
    count = np.asarray(jb.tile_count)
    assert (count == tb.tile_count.numpy()).all()
    Kp = tb.tile_gauss.shape[1]
    assert (np.asarray(jb.tile_gauss)[:, :Kp] == tb.tile_gauss.numpy()).all()
    assert (np.asarray(jb.tile_gauss)[:, Kp:] == -1).all()
    if case["name"] == "starved_max_per_tile":
        assert int(tb.tile_overflow) > 0


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_plain_phase_a_matches_jax(case, backend):
    W, H = case["W"], case["H"]
    jb = case["jcache"]["binning"]
    zeros = jnp.zeros((H, W), jnp.int32)
    if backend == "xla":
        img, mid = ji.integrate_image(case["prep"], jb, jnp.asarray(BG), zeros, width=W,
                                      height=H)
    else:
        img, mid = integrate_image_pallas(case["prep"], jb, jnp.asarray(BG), zeros, width=W,
                                          height=H, chunk=16, interpret=True)
    timg, tmid = case["tcache"]["color"], case["tcache"]["mid"]
    assert timg.shape == (9, H, W)
    for c in range(9):
        err = np.abs(np.asarray(img[c]) - timg[c].numpy()).max()
        assert err <= ATOL, (c, err)
    for k in ti.MID_KEYS:
        assert np.abs(np.asarray(mid[k]) - tmid[k].numpy()).max() <= ATOL, k
    # the scene exercises skipped corners (starved: 6 contributors a tile
    # never reach them), medians and empty pixels
    assert (timg[7].numpy() > 0.99).any() or case["name"] == "starved_max_per_tile"
    assert (timg[7].numpy() == 0).any()
    assert (tmid["mid_dc"].numpy() != 0).any()


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_plain_phase_b_matches_jax(case, backend):
    W, H = case["W"], case["H"]
    prep, jp, jb = case["prep"], case["jp"], case["jcache"]["binning"]
    tiles_x = (W + 15) // 16
    a_x, s_x = ji.integrate_points(prep, jb, jp, case["jcache"]["mid"], tiles_x)
    if backend == "xla":
        a_ref = np.where(np.asarray(jp.valid), np.asarray(a_x), 1.0)
    else:
        a_ref = np.asarray(integrate_points_pallas(prep, jb, jp, width=W, height=H, chunk=16,
                                                   interpret=True))
    a_t, s_t = ti.integrate_points(case["tprep"], case["tcache"]["binning"], case["tp"],
                                   case["tcache"]["mid"], W, H)
    assert np.abs(a_ref - a_t.numpy()).max() <= ATOL
    assert np.abs(np.asarray(s_x) - s_t.numpy()).max() <= ATOL
    valid = case["tp"].valid.numpy()
    assert (a_t.numpy()[~valid] == 1.0).all() and (s_t.numpy()[~valid] == 0).all()
    assert (a_t.numpy()[valid] > 0.5).any() and (a_t.numpy()[valid] < 0.01).any()


def test_plain_versions_without_tile_gauss_refuse(case):
    tb = case["tcache"]["binning"]._replace(tile_gauss=None)
    with pytest.raises(ValueError, match="tile_gauss"):
        ti.integrate_image(case["tprep"], tb, torch.tensor(BG), case["W"], case["H"])


def test_wrappers_on_cpu_count_no_launch(case):
    before = dict(ti.LAUNCHES)
    W, H = case["W"], case["H"]
    ti.integrate_image(case["tprep"], case["tcache"]["binning"], torch.tensor(BG), W, H)
    ti.integrate_points(case["tprep"], case["tcache"]["binning"], case["tp"],
                        case["tcache"]["mid"], W, H)
    assert ti.LAUNCHES == before


@pytest.fixture(scope="module")
def wall():
    """tests/test_integrate.py's scene: an opaque wall of Gaussians at z=0
    facing the camera at z=-4, carried to the port with state_from_arrays."""
    rng = np.random.default_rng(3)
    n = 11
    g = np.stack(np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n)), -1)
    pts = np.concatenate([g.reshape(-1, 2), np.zeros((n * n, 1))], 1).astype(np.float32)
    cols = rng.uniform(0.2, 0.9, size=(n * n, 3)).astype(np.float32)
    js = jgm.create_from_points(pts, cols, capacity=jgm.round_capacity(n * n, 128))
    js = js.replace(params=js.params.replace(
        opacity=jnp.where(js.active[:, None], jgm.inverse_sigmoid(jnp.float32(0.95)),
                          js.params.opacity),
        scaling=jnp.where(js.active[:, None], jnp.log(jnp.float32(0.16)), js.params.scaling)))
    p = js.params
    ts = tgm.state_from_arrays(
        np.asarray(p.xyz), np.asarray(p.f_dc), np.asarray(p.f_rest), np.asarray(p.scaling),
        np.asarray(p.rotation), np.asarray(p.opacity), np.asarray(js.active),
        np.asarray(js.filter_3d), int(js.active_sh_degree), js.max_sh_degree, device="cpu")
    args = ([0, 0, -4], [0, 0, 0], [0, 1, 0], 0.8, 0.8, 64, 64)
    probes = np.concatenate([np.random.default_rng(5).normal(size=(200, 3)) * 0.8,
                             [[0, 0, -2.0], [0, 0, -0.3], [0, 0, 0], [0, 0, 1.0]]]
                            ).astype(np.float32)
    return js, ts, JCamera.look_at(*args), TCamera.look_at(*args, device="cpu"), probes


def test_renderer_integrate_matches_jax(wall):
    js, ts, jcam, tcam, probes = wall
    kw = dict(max_per_tile=256, instance_budget=1 << 13)
    jo = j_integrate(jnp.asarray(probes), js, jcam, jnp.asarray(BG), kernel_size=0.1, **kw)
    to = t_integrate(probes, ts, tcam, BG, kernel_size=0.1, device="cpu", **kw)
    assert set(to) == set(jo)
    for k in ("render", "alpha_integrated", "color_integrated", "point_coordinate",
              "point_sdf"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), atol=5e-5, rtol=1e-4,
                                   err_msg=k)
    assert (to["point_valid"].numpy() == np.asarray(jo["point_valid"])).all()
    for name in ("n_instances", "n_overflow", "tile_overflow"):
        assert int(getattr(to["binning"], name)) == int(getattr(jo["binning"], name)), name
    # the central-ray probes: opacity grows with depth, the SDF changes sign
    a, s = to["alpha_integrated"].numpy()[-4:], to["point_sdf"].numpy()[-4:]
    assert a[0] < 0.05 and a[3] > 0.9 and (np.diff(a) >= -1e-5).all()
    assert s[0] > 0.5 and s[3] < -0.5
    assert to["render"][8].sum().item() == to["point_valid"].sum().item()


def test_prepare_then_points_equals_integrate(wall):
    _, ts, _, tcam, probes = wall
    kw = dict(kernel_size=0.1, max_per_tile=256, instance_budget=1 << 13)
    full = t_integrate(probes, ts, tcam, BG, device="cpu", **kw)
    prep, cache = integrate_prepare(ts, tcam, BG, device="cpu", **kw)
    for pts in (probes, probes[::3]):  # one cache, two point sets
        part = integrate_points(pts, prep, cache, tcam)
        ref = full if pts is probes else t_integrate(pts, ts, tcam, BG, device="cpu", **kw)
        assert set(part) == set(ref) - {"binning"}
        for k, v in part.items():
            assert torch.equal(v, ref[k]), k


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the integrate kernels have no CPU mode")
    dev = torch.device("cuda")
    W, H, K = CASES["ragged_72x50"]
    _, tprep, _, tcam = scene_prep(W, H)
    tprep = PreprocessOut(**{k: getattr(tprep, k).to(dev)
                             for k in PreprocessOut.__dataclass_fields__})
    b = ti.bin_gaussians(tprep.xy, tprep.radius, tprep.depth, tprep.valid, W, H,
                         instance_budget=1 << 13, max_per_tile=K, need_tile_gauss=True)
    feat, pfeat = ti.image_features(tprep), ti.point_features(tprep)
    rows, med = ti.integrate_image_rows(b, feat, W, H)
    prow, pmed = ti.integrate_image_torch(b.tile_gauss, feat, W, H)
    pts = ti.project_points(torch.from_numpy(query_points()).to(dev), tcam.to(dev))
    a_k = ti.integrate_points_alpha(b, pfeat, pts, W, H)
    mid = {k: prow[:, 8 + j] for j, k in enumerate(ti.MID_KEYS)}
    a_p, _ = ti.integrate_points_torch(b.tile_gauss, pfeat, pts, mid, (W + 15) // 16)
    torch.cuda.synchronize()
    # the kernels round as the plain versions do (csrc/integrate_common.cuh)
    assert (rows - prow).abs().max().item() <= 1e-4
    assert (med != pmed).float().mean().item() <= 1e-3
    assert (a_k - a_p).abs().max().item() <= 1e-4
