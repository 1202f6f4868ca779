"""radegs_torch.core against radegs_tpu.core on the same numpy inputs (JAX on
the CPU): cameras, SH colour, the Mip 3D filter and every field of the
preprocess. Tolerance rtol=1e-4, atol=1e-5 (float32 through different
summation orders: the port multiplies (P,3,3) matrices where the JAX code
expands sym6 components); discrete outputs must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radegs_tpu.core import gaussians as jg
from radegs_tpu.core.camera import Camera as JCamera
from radegs_tpu.core.projection import preprocess_gaussians as j_preprocess
from radegs_tpu.core.sh import eval_sh_color as j_sh
from radegs_torch.core import gaussians as tg
from radegs_torch.core.camera import Camera as TCamera
from radegs_torch.core.projection import preprocess_gaussians as t_preprocess
from radegs_torch.core.sh import eval_sh_color as t_sh

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-5


def close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), b.cpu().numpy() if torch.is_tensor(b) else b,
                               rtol=kw.get("rtol", RTOL), atol=kw.get("atol", ATOL),
                               err_msg=kw.get("msg", ""))


def cameras(kind):
    if kind == "look_at":
        args = ([0.4, 0.6, -3.6], [0.1, 0, 0.2], [0, 1, 0], 0.9, 0.8, 80, 64)
        return JCamera.look_at(*args), TCamera.look_at(*args, device="cpu")
    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    args = (q, rng.normal(size=3), 1.1, 0.7, 72, 50, 0.05, 50.0)
    return JCamera.create(*args), TCamera.create(*args, device="cpu")


@pytest.mark.parametrize("kind", ["look_at", "create"])
def test_camera_matrices(kind):
    jc, tc = cameras(kind)
    for name in ["world_view", "projection", "full_proj", "camera_center", "focal_x",
                 "focal_y", "tanfovx", "tanfovy"]:
        close(getattr(jc, name), getattr(tc, name), msg=name)
    assert (jc.width, jc.height) == (tc.width, tc.height)


@pytest.mark.parametrize("degree,active", [(0, 0), (1, 0), (2, 1), (3, 1), (3, 2), (3, 3)])
def test_sh_color(degree, active):
    rng = np.random.default_rng(degree * 10 + active)
    P, M = 64, (degree + 1) ** 2
    sh = rng.normal(size=(P, M, 3)).astype(np.float32) * 2.0
    means = rng.normal(size=(P, 3)).astype(np.float32)
    campos = np.array([0.3, -0.2, -3.0], np.float32)
    jr, jc = j_sh(degree, jnp.asarray(sh), jnp.asarray(means), jnp.asarray(campos),
                  active_degree=jnp.asarray(active))
    tr, tc = t_sh(degree, torch.from_numpy(sh), torch.from_numpy(means),
                  torch.from_numpy(campos), active_degree=active)
    close(jr, tr)
    assert (np.asarray(jc) == tc.numpy()).all()
    assert tc.any() and (tr == 0).any()  # the clamp is exercised


def test_quaternion_and_sym6_helpers():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(40, 4)).astype(np.float32)
    s = np.exp(rng.normal(size=(40, 3)) - 1).astype(np.float32)
    close(jg.quat_to_rotmat(jnp.asarray(q)), tg.quat_to_rotmat(torch.from_numpy(q)))
    close(jg.quat_to_rotmat_raw(jnp.asarray(q)), tg.quat_to_rotmat_raw(torch.from_numpy(q)))
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    jc = jg.build_covariance(jnp.asarray(s), jnp.asarray(qn), 0.7)
    tc = tg.build_covariance(torch.from_numpy(s), torch.from_numpy(qn), 0.7)
    close(jc, tc)
    j6, t6 = jg.cov3d_to_sym6(jc), tg.cov3d_to_sym6(tc)
    close(j6, t6)
    close(jg.sym6_to_cov3d(j6), tg.sym6_to_cov3d(t6))
    eye6 = np.array([1, 0, 0, 1, 0, 1], np.float32)  # keep the inverse well-conditioned
    inv = jg.sym6_inverse(tuple(jnp.moveaxis(j6 + eye6, -1, 0)))
    close(jnp.stack(inv, -1), tg.sym6_inverse(t6 + torch.from_numpy(eye6)))
    singular = torch.zeros((1, 6))
    assert (tg.sym6_inverse(singular) == 0).all()


def test_fuse_3d_filter():
    rng = np.random.default_rng(1)
    s = np.exp(rng.normal(size=(50, 3)) - 2).astype(np.float32)
    op = rng.uniform(0.05, 0.95, (50, 1)).astype(np.float32)
    f = rng.uniform(0, 0.1, (50, 1)).astype(np.float32)
    js, jo = jg.fuse_3d_filter(jnp.asarray(s), jnp.asarray(op), jnp.asarray(f))
    ts, to = tg.fuse_3d_filter(*map(torch.from_numpy, (s, op, f)))
    close(js, ts)
    close(jo, to)


def test_compute_3d_filter():
    rng = np.random.default_rng(2)
    xyz = (rng.normal(size=(200, 3)) * 1.5).astype(np.float32)
    xyz[:5] = [0.0, 0.0, -50.0]  # behind every camera: the max-visible fallback
    pairs = [cameras("look_at"), cameras("create")]
    pairs.append(tuple(C.look_at([2.5, 0.2, -2.5], [0, 0, 0], [0, 1, 0], 0.8, 0.8, 64, 48,
                                 **kw) for C, kw in ((JCamera, {}), (TCamera, {"device": "cpu"}))))
    jf = jg.compute_3d_filter(jnp.asarray(xyz), [p[0] for p in pairs])
    tf = tg.compute_3d_filter(torch.from_numpy(xyz), [p[1] for p in pairs])
    close(jf, tf)


def preprocess_inputs(seed=3, P=150):
    rng = np.random.default_rng(seed)
    xyz = (rng.normal(size=(P, 3)) * 0.8).astype(np.float32)
    xyz[:12, 2] = -3.55 + rng.uniform(-0.1, 0.1, 12)  # around/behind the near plane
    scales = np.exp(rng.normal(size=(P, 3)) * 0.5 - 2.0).astype(np.float32)
    scales[12:20, 0] = 1e-5  # ill-conditioned (flat) Gaussians
    q = rng.normal(size=(P, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    op = rng.uniform(0.05, 0.95, (P, 1)).astype(np.float32)
    shs = (rng.normal(size=(P, 16, 3)) * 0.3).astype(np.float32)
    return xyz, scales, q, op, shs


FIELDS = ["valid", "xy", "depth", "view_point", "conic", "opacity", "rgb", "camera_plane",
          "ray_plane", "normal", "ts", "radius", "well_conditioned", "invraycov"]


@pytest.mark.parametrize("cov_input", ["scales", "cov3d_precomp"])
def test_preprocess_every_field(cov_input):
    xyz, scales, q, op, shs = preprocess_inputs()
    jc, tc = cameras("look_at")
    kw = dict(sh_degree=3, kernel_size=0.1, compute_invraycov=True)
    if cov_input == "scales":
        jkw = dict(scales=jnp.asarray(scales), rotations=jnp.asarray(q))
        tkw = dict(scales=torch.from_numpy(scales), rotations=torch.from_numpy(q))
    else:
        cov = np.asarray(jg.build_covariance(jnp.asarray(scales), jnp.asarray(q)))
        cov = cov + 1e-4 * np.eye(3, dtype=np.float32)  # keep the eigen path well-posed
        jkw = dict(scales=None, rotations=None, cov3d_precomp=jnp.asarray(cov))
        tkw = dict(scales=None, rotations=None, cov3d_precomp=torch.from_numpy(cov))
    jo = j_preprocess(jnp.asarray(xyz), opacities=jnp.asarray(op), shs=jnp.asarray(shs),
                      camera=jc, active_sh_degree=jnp.asarray(2), **kw, **jkw)
    to = t_preprocess(torch.from_numpy(xyz), opacities=torch.from_numpy(op),
                      shs=torch.from_numpy(shs), camera=tc, active_sh_degree=2, **kw, **tkw)
    valid = np.asarray(jo.valid)
    assert (valid == to.valid.numpy()).all()
    assert 0 < valid.sum() < len(valid)  # some Gaussians are culled
    for name in FIELDS[1:]:
        a, b = np.asarray(getattr(jo, name)), getattr(to, name).numpy()
        if a.dtype == bool:
            assert (a == b).all(), name
        elif name == "invraycov":
            # where Sigma is ill-conditioned the ray covariance is singular
            # up to a 1e-6 regulariser (condition ~1e6): both sides' float32
            # inverses are rounding noise there, so only finiteness is held
            well = np.asarray(jo.well_conditioned)
            assert well.any() and (cov_input != "scales" or not well.all())
            close(a[well], b[well], msg=name)
            assert np.isfinite(b[~well]).all()
        elif name == "opacity":
            # the per-Gaussian table's contract: 0 where a row is not valid
            close(np.where(valid, a, 0.0), b, msg=name)
        else:
            close(a, b, msg=name)
