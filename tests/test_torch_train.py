"""The port's training slice against the JAX package on the same numpy
inputs (JAX on the CPU): image geometry and SSIM, the Adam step and its
schedule, densification statistics, densify / prune fed JAX's own normal
draws, opacity reset, capacity growth, the KNN scale initialisation, the
loss with its gradients, one whole train step from a carried mid-training
state, and a torch twin of tests/test_train_smoke.py.

Tolerances: geometry and SSIM values and gradients rtol 1e-5; expon_lr and
adam_step rtol 1e-6; statistics, reset_opacity and densify params rtol 1e-6
with `active` and the counts equal; KNN rtol 1e-5; the loss, its gradients
and the train step rtol 1e-4 (rel: max |a - b| / max |a| for gradients).
After a train step, parameters are compared only where |grad| > 1e-6 max
|grad|: Adam's early steps move a parameter by about lr sign(g), so a
near-zero gradient may flip sign between the frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radegs_tpu.core import geometry as jgeo
from radegs_tpu.core.camera import Camera as JCamera
from radegs_tpu.models import gaussian_model as jgm
from radegs_tpu.ops import knn as jknn
from radegs_tpu.ops import ssim as jssim
from radegs_tpu.train import loop as jloop
from radegs_tpu.train import optim as joptim
from radegs_tpu.train.config import (
    ModelConfig as JModelConfig,
    OptimizationConfig as JOptimizationConfig,
    PipelineConfig as JPipelineConfig,
)
from radegs_torch.core import geometry as tgeo
from radegs_torch.core.camera import Camera as TCamera
from radegs_torch.models import gaussian_model as tgm
from radegs_torch.ops import knn as tknn
from radegs_torch.ops import ssim as tssim
from radegs_torch.renderer import render as t_render
from radegs_torch.train import loop as tloop
from radegs_torch.train import optim as toptim
from radegs_torch.train.config import ModelConfig, OptimizationConfig, PipelineConfig

torch.set_num_threads(1)
PARAMS = ["xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity"]
CAM = ([0.3, -0.4, -3.8], [0.1, 0, 0], [0, 1, 0], 0.85, 0.7, 56, 40)


def t(x):
    return torch.from_numpy(np.array(x))


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


def close(a, b, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(b.detach() if torch.is_tensor(b) else b),
                               np.asarray(a), rtol=rtol, atol=atol, err_msg=msg)


def carry(js, training=True):
    """A JAX GaussianState, training fields included, into a port state."""
    p = js.params
    tr = None
    if training:
        tr = {k: np.asarray(getattr(js, k)) for k in tgm.TRAINING_FIELDS}
        tr["adam_m"] = {k: np.asarray(getattr(js.adam_m, k)) for k in PARAMS}
        tr["adam_v"] = {k: np.asarray(getattr(js.adam_v, k)) for k in PARAMS}
        tr["adam_step"] = int(js.adam_step)
    return tgm.state_from_arrays(
        *(np.asarray(getattr(p, k)) for k in PARAMS), np.asarray(js.active),
        np.asarray(js.filter_3d), int(js.active_sh_degree), js.max_sh_degree,
        device="cpu", training=tr)


def mid_training_state(seed=4, P=100, capacity=128):
    """A seeded JAX state as training leaves it: SH degree 1 of 3 live, Adam
    moments after a few steps, densification statistics accumulated, 3D
    filter set, a few inactive slots."""
    rng = np.random.default_rng(seed)
    js = jgm.empty_state(capacity, 3)
    act = np.arange(capacity) < P

    def f32(*shape, scale=1.0, shift=0.0):
        return jnp.asarray(rng.normal(size=shape) * scale + shift, jnp.float32)

    C = capacity
    p = js.params.replace(xyz=f32(C, 3, scale=0.6), f_dc=f32(C, 1, 3, scale=0.8),
                          f_rest=f32(C, 15, 3, scale=0.1),
                          scaling=f32(C, 3, scale=0.4, shift=-2.2),
                          rotation=f32(C, 4), opacity=f32(C, 1, shift=0.5))
    m = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape) * 1e-3, jnp.float32), p)
    v = jax.tree.map(lambda x: jnp.asarray(rng.uniform(size=x.shape) * 1e-6, jnp.float32), p)
    denom = rng.integers(0, 6, C).astype(np.float32)
    js = js.replace(
        params=p, active=jnp.asarray(act), adam_m=m, adam_v=v,
        adam_step=jnp.asarray(7, jnp.int32), active_sh_degree=jnp.asarray(1, jnp.int32),
        grad_accum=jnp.asarray(denom * rng.uniform(0, 4e-4, C), jnp.float32),
        grad_abs_accum=jnp.asarray(denom * rng.uniform(0, 1e-3, C), jnp.float32),
        grad_abs_max=jnp.asarray(rng.uniform(0, 1e-3, C), jnp.float32),
        denom=jnp.asarray(denom), max_radii2d=jnp.asarray(rng.uniform(0, 9, C), jnp.float32))
    return jgm.update_3d_filter(js, [JCamera.look_at(*CAM)])


# ------------------------------------------------------ geometry, SSIM ----


def test_depth_and_point_normals():
    rng = np.random.default_rng(0)
    jc, tc = JCamera.look_at(*CAM), TCamera.look_at(*CAM, device="cpu")
    H, W = jc.height, jc.width
    d1 = 2.0 + rng.uniform(size=(1, H, W)).astype(np.float32)
    d2 = 2.0 + rng.uniform(size=(1, H, W)).astype(np.float32)
    d2[:, :6, :6] = 0.0  # flat, empty corner: the double-where
    w = rng.normal(size=(2, 3, H, W)).astype(np.float32)
    jn, jvjp = jax.vjp(lambda a, b: jgeo.depth_double_to_normal(jc, a, b), jnp.asarray(d1),
                       jnp.asarray(d2))
    ja, jb = jvjp(jnp.asarray(w))
    ta, tb = t(d1).requires_grad_(True), t(d2).requires_grad_(True)
    tn = tgeo.depth_double_to_normal(tc, ta, tb)
    (tn * t(w)).sum().backward()
    close(jn, tn, 1e-5, 1e-6)
    close(ja, ta.grad, 1e-5, 1e-5)
    close(jb, tb.grad, 1e-5, 1e-5)
    p1 = rng.normal(size=(3, H, W)).astype(np.float32)
    p2 = rng.normal(size=(3, H, W)).astype(np.float32)
    close(jgeo.point_double_to_normal(jc, jnp.asarray(p1), jnp.asarray(p2)),
          tgeo.point_double_to_normal(tc, t(p1), t(p2)), 1e-5, 1e-6)
    close(jgeo.depths_to_points(jc, jnp.asarray(d1)), tgeo.depths_to_points(tc, t(d1)), 1e-5)


def test_ssim_l1_psnr():
    rng = np.random.default_rng(1)
    a = rng.uniform(size=(3, 40, 56)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape).astype(np.float32) * 0.1, 0, 1)
    close(jssim.ssim_map(jnp.asarray(a), jnp.asarray(b)), tssim.ssim_map(t(a), t(b)), 1e-5,
          1e-6)
    close(jssim.l1_loss(jnp.asarray(a), jnp.asarray(b)), tssim.l1_loss(t(a), t(b)), 1e-6)
    close(jssim.psnr(jnp.asarray(a), jnp.asarray(b)), tssim.psnr(t(a), t(b)), 1e-6)
    jg = jax.grad(lambda x: jssim.ssim(x, jnp.asarray(b)))(jnp.asarray(a))
    ta = t(a).requires_grad_(True)
    tssim.ssim(ta, t(b)).backward()
    close(jg, ta.grad, 1e-5, 1e-9)


# --------------------------------------------------------------- Adam ----


@pytest.mark.parametrize("delay_steps", [0, 50])
def test_expon_lr(delay_steps):
    for step in [0, 1, 7, 100, 2999, 30000, 40000]:
        kw = dict(lr_delay_steps=delay_steps, lr_delay_mult=0.01)
        a = float(joptim.expon_lr(jnp.float32(step), 1.6e-4 * 3.5, 1.6e-6 * 3.5, 30000, **kw))
        b = toptim.expon_lr(step, 1.6e-4 * 3.5, 1.6e-6 * 3.5, 30000, **kw)
        assert abs(a - b) <= 1e-6 * abs(a), (step, a, b)


def test_adam_step():
    js = mid_training_state()
    rng = np.random.default_rng(9)
    grads = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape) * 1e-3, jnp.float32),
                         js.params)
    lrs = dict(xyz=1.3e-4, f_dc=0.0025, f_rest=0.0025 / 20, opacity=0.05, scaling=0.005,
               rotation=0.001)
    jo = joptim.adam_step(js, grads, joptim.GroupLRs(**lrs))
    to = toptim.adam_step(carry(js), tgm.GaussianParams(
        **{k: t(getattr(grads, k)) for k in PARAMS}), toptim.GroupLRs(**lrs))
    assert to.adam_step == int(jo.adam_step) == 8
    for k in PARAMS:
        for jx, tx in ((jo.params, to.params), (jo.adam_m, to.adam_m), (jo.adam_v, to.adam_v)):
            close(getattr(jx, k), getattr(tx, k), 1e-6, 1e-12, msg=k)
    # inactive slots keep their parameters
    assert torch.equal(to.params.xyz[~to.active], carry(js).params.xyz[~to.active])


# ------------------------------------------------------ densification ----


def test_densification_stats_and_radii():
    js = mid_training_state()
    rng = np.random.default_rng(2)
    C = js.capacity
    xy = rng.normal(size=(C, 2)).astype(np.float32) * 1e-3
    ab = rng.uniform(size=C).astype(np.float32) * 1e-3
    vis = rng.uniform(size=C) < 0.7
    radii = rng.uniform(0, 12, C).astype(np.float32)
    jo = jgm.update_max_radii(jgm.add_densification_stats(
        js, jnp.asarray(xy), jnp.asarray(ab), jnp.asarray(vis)), jnp.asarray(radii),
        jnp.asarray(vis))
    to = tgm.update_max_radii(tgm.add_densification_stats(carry(js), t(xy), t(ab), t(vis)),
                              t(radii), t(vis))
    for k in tgm.TRAINING_FIELDS:
        close(getattr(jo, k), getattr(to, k), 1e-6, msg=k)


def test_reset_opacity():
    js = mid_training_state()
    jo, to = jgm.reset_opacity(js), tgm.reset_opacity(carry(js))
    close(jo.params.opacity, to.params.opacity, 1e-6, 1e-6)
    assert not to.adam_m.opacity.any() and not to.adam_v.opacity.any()
    close(jo.adam_m.xyz, to.adam_m.xyz, 0)


@pytest.mark.parametrize("prune_big_ws", [False, True])
def test_densify_and_prune_with_jax_draws(prune_big_ws):
    js = mid_training_state()
    # small Gaussians clone, the rest split; a few exceed 0.1 x extent
    scaling = np.asarray(js.params.scaling).copy()
    scaling[:30] = np.log(0.01)
    scaling[30:36] = np.log(0.5)
    opacity = np.asarray(js.params.opacity).copy()
    opacity[36:40] = -5.0  # transparent: pruned
    js = js.replace(params=js.params.replace(scaling=jnp.asarray(scaling),
                                             opacity=jnp.asarray(opacity)))
    key = jax.random.PRNGKey(3)
    # the JAX function's own draws (gaussian_model.py:281-285)
    draws = tuple(t(jax.random.normal(k, (js.capacity, 3))) for k in jax.random.split(key, 3))
    jo, jstats = jgm.densify_and_prune(js, key, 2e-4, 0.05, 2.5, percent_dense=0.01,
                                       prune_big_ws=prune_big_ws)
    to, tstats = tgm.densify_and_prune(carry(js), None, 2e-4, 0.05, 2.5, percent_dense=0.01,
                                       prune_big_ws=prune_big_ws, draws=draws)
    assert (np.asarray(jo.active) == to.active.numpy()).all()
    for k, v in jstats.items():
        assert int(v) == int(tstats[k]), k
    assert int(tstats["n_clone"]) > 0 and int(tstats["n_split"]) > 0
    assert int(tstats["n_prune"]) > 0 and int(tstats["n_drop"]) > 0
    for k in PARAMS:
        close(getattr(jo.params, k), getattr(to.params, k), 1e-6, 1e-6, msg=k)
        close(getattr(jo.adam_m, k), getattr(to.adam_m, k), 0, msg=k)
        close(getattr(jo.adam_v, k), getattr(to.adam_v, k), 0, msg=k)
    for k in tgm.TRAINING_FIELDS + ("filter_3d",):
        close(getattr(jo, k), getattr(to, k), 0, msg=k)


def test_maybe_grow_and_resize():
    js = mid_training_state(P=120)  # 120 of 128 > 90%: grows
    jo, to = jgm.maybe_grow(js), tgm.maybe_grow(carry(js))
    assert to.capacity == jo.capacity == 256
    for k in PARAMS:
        close(getattr(jo.params, k), getattr(to.params, k), 0, msg=k)
    for k in tgm.TRAINING_FIELDS + ("active", "filter_3d"):
        close(getattr(jo, k), getattr(to, k), 0, msg=k)
    assert tgm.maybe_grow(to) is to  # 120 of 256: no growth
    shrunk = tgm.resize_capacity(to, 128)
    assert shrunk.capacity == 128 and int(shrunk.n_active()) == 120
    close(tgm.resize_capacity(shrunk, 256).params.xyz[:120], to.params.xyz[:120], 0)
    with pytest.raises(ValueError, match="cannot shrink"):
        tgm.resize_capacity(to, 64)


# ------------------------------------------------------- initialisation ----


@pytest.mark.parametrize("P", [500, 5000])
def test_mean_dist2_knn(P):
    """P = 500: the exact path; P = 5000: the grid + Morton-window union."""
    rng = np.random.default_rng(P)
    pts = (rng.normal(size=(P, 3)) * [1.0, 0.5, 2.0]).astype(np.float32)
    pts[: P // 10] *= 6.0  # a sparse tail
    close(jknn.mean_dist2_knn(jnp.asarray(pts)), tknn.mean_dist2_knn(t(pts)), 1e-5)


def test_create_from_points():
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    cols = rng.uniform(size=(300, 3)).astype(np.float32)
    jo = jgm.create_from_points(pts, cols, capacity=512)
    to = tgm.create_from_points(pts, cols, capacity=512, device="cpu")
    for k in PARAMS:
        close(getattr(jo.params, k), getattr(to.params, k), 1e-5, 1e-6, msg=k)
    assert (np.asarray(jo.active) == to.active.numpy()).all()


# ------------------------------------------------------ loss and a step ----


@pytest.fixture(scope="module")
def step_case():
    """A carried mid-training state, a camera and a ground-truth image."""
    js = mid_training_state()
    rng = np.random.default_rng(8)
    gt = rng.uniform(size=(3, CAM[-1], CAM[-2])).astype(np.float32)
    return js, carry(js), gt


CFGS = dict(kernel_size=0.1), dict(regularization_from_iter=5, densify_from_iter=100), \
    dict(max_per_tile=128)


def test_compute_loss_and_grads(step_case):
    js, ts, gt = step_case
    jm, jo, jp = (JModelConfig(**CFGS[0]), JOptimizationConfig(**CFGS[1]),
                  JPipelineConfig(**CFGS[2]))
    C = js.capacity

    def j_loss(params, xo, xa):
        return jloop.compute_loss(js.replace(params=params), None, xo, xa,
                                  JCamera.look_at(*CAM), jnp.asarray(gt), jnp.zeros(3),
                                  jnp.asarray(10, jnp.int32), jm, jo, jp)

    (jl, jaux), jg = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True))(
        js.params, jnp.zeros((C, 2)), jnp.zeros((C, 2)))
    params = ts.params.map(lambda x: x.clone().requires_grad_(True))
    xo = torch.zeros((C, 2), requires_grad=True)
    xa = torch.zeros((C, 2), requires_grad=True)
    tl, taux = tloop.compute_loss(ts.replace(params=params), None, xo, xa,
                                  TCamera.look_at(*CAM, device="cpu"), t(gt), torch.zeros(3),
                                  10, ModelConfig(**CFGS[0]), OptimizationConfig(**CFGS[1]),
                                  PipelineConfig(**CFGS[2]))
    tl.backward()
    close(jl, tl, 1e-4)
    assert float(jaux["depth_normal_loss"]) > 0  # the regularisation is on
    for k in ["l1", "depth_normal_loss", "psnr"]:
        close(jaux[k], taux[k], 1e-4, msg=k)
    for k in PARAMS:
        assert rel_err(getattr(jg[0], k), getattr(params, k).grad.numpy()) <= 1e-4, k
    assert rel_err(jg[1], xo.grad.numpy()) <= 1e-4
    assert rel_err(jg[2], xa.grad.numpy()) <= 1e-4


def test_train_step_from_carried_state(step_case):
    js, ts, gt = step_case
    js = jax.tree.map(jnp.array, js)  # a copy: the JAX step donates its state
    m_old = {k: np.array(getattr(js.adam_m, k)) for k in PARAMS}
    jm, jo, jp = (JModelConfig(**CFGS[0]), JOptimizationConfig(**CFGS[1]),
                  JPipelineConfig(**CFGS[2]))
    jts = jloop.TrainState(gaussians=js, app_params=None, app_m=None, app_v=None,
                           iteration=jnp.asarray(9, jnp.int32), key=jax.random.PRNGKey(0))
    W, H = CAM[-2], CAM[-1]
    jstep = jloop.make_train_step(jm, jo, jp, spatial_lr_scale=2.5)
    jnew, jmet = jstep(jts, JCamera.look_at(*CAM), jnp.asarray(gt), jnp.zeros(3), 0,
                       width=W, height=H)
    tstep = tloop.make_train_step(ModelConfig(**CFGS[0]), OptimizationConfig(**CFGS[1]),
                                  PipelineConfig(**CFGS[2]), spatial_lr_scale=2.5)
    tnew, tmet = tstep(tloop.TrainState(gaussians=ts, iteration=9),
                       TCamera.look_at(*CAM, device="cpu"), t(gt), torch.zeros(3), 0, W, H)
    assert tnew.iteration == int(jnew.iteration) == 10
    for k in ["loss", "l1", "depth_normal_loss", "psnr"]:
        close(jmet[k], tmet[k], 1e-4, msg=k)
    for k in ["n_overflow", "tile_overflow", "n_instances"]:
        assert int(jmet[k]) == int(tmet[k]), k
    jg, tg = jnew.gaussians, tnew.gaussians
    for k in tgm.TRAINING_FIELDS:
        close(getattr(jg, k), getattr(tg, k), 1e-4, 1e-9, msg=k)
    # parameters where the gradient is clearly away from zero: the Adam
    # moment m_new - beta1 m_old is (1 - beta1) g
    for k in PARAMS:
        g = (np.asarray(getattr(jg.adam_m, k)) - 0.9 * m_old[k]) / 0.1
        sel = np.abs(g) > 1e-6 * np.abs(g).max()
        assert sel.any(), k
        close(np.asarray(getattr(jg.params, k))[sel], getattr(tg.params, k).numpy()[sel],
              1e-4, 1e-7, msg=k)


def test_training_improves_psnr():
    """The torch twin of tests/test_train_smoke.py::test_training_improves_psnr."""
    rng = np.random.default_rng(0)
    P = 60
    target = tgm.create_from_points((rng.normal(size=(P, 3)) * 0.5).astype(np.float32),
                                    rng.uniform(0.2, 0.9, size=(P, 3)).astype(np.float32),
                                    capacity=tgm.round_capacity(P, 64), device="cpu")
    target = target.replace(params=target.params.replace(
        opacity=torch.where(target.active[:, None], tgm.inverse_sigmoid(torch.tensor(0.8)),
                            target.params.opacity),
        scaling=target.params.scaling + 0.7))
    cams = []
    for i in range(3):
        ang = 2 * np.pi * i / 3
        cam = TCamera.look_at([3.5 * np.sin(ang), 0.5, -3.5 * np.cos(ang)], [0, 0, 0],
                              [0, 1, 0], 0.9, 0.9, 48, 48, device="cpu")
        with torch.no_grad():
            gt = t_render(target, cam, [0, 0, 0], max_per_tile=64, instance_budget=1 << 12,
                          device="cpu")["render"]
        cams.append((cam, gt.clamp(0, 1), i))
    rng = np.random.default_rng(7)
    g = tgm.create_from_points((rng.normal(size=(50, 3)) * 0.5).astype(np.float32),
                               rng.uniform(size=(50, 3)).astype(np.float32), capacity=64,
                               device="cpu")
    ocfg = OptimizationConfig(
        iterations=120, densify_from_iter=30, densification_interval=40, densify_until_iter=100,
        opacity_reset_interval=10_000, regularization_from_iter=60, position_lr_init=0.005,
        position_lr_final=0.0005, position_lr_max_steps=120)
    ts, history = tloop.train(tloop.SceneLike(cameras=cams, extent=3.5), g,
                              ModelConfig(kernel_size=0.1), ocfg, PipelineConfig(max_per_tile=64),
                              log_every=20, device="cpu")
    losses = [h["loss"] for h in history]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.8, losses
    assert 1 <= history[-1]["n_active"] <= ts.gaussians.capacity
    cam, gt, _ = cams[0]
    with torch.no_grad():
        out = t_render(ts.gaussians, cam, [0, 0, 0], max_per_tile=64, instance_budget=1 << 12,
                       device="cpu")
    assert torch.isfinite(out["render"]).all()
    assert float(tssim.psnr(out["render"].clamp(0, 1), gt)) > 10.0


def test_unported_options_raise():
    # decoupled appearance (tests/test_torch_appearance.py) and the
    # multi-rank path (tests/test_torch_parallel_train.py) are ported; the
    # multi-rank step renders bands of one image size, so views of two
    # sizes are refused before any rank communicates
    from radegs_torch.parallel import Mesh1D

    ts = tgm.create_from_points(np.zeros((4, 3), np.float32), np.full((4, 3), 0.5, np.float32),
                                capacity=64, device="cpu")
    cams = [TCamera.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0], 0.9, 0.9, w, 16, device="cpu")
            for w in (16, 32)]
    scene = tloop.SceneLike(cameras=[(c, torch.zeros(3, 16, c.width), i)
                                     for i, c in enumerate(cams)], extent=1.0)
    mesh = Mesh1D(group=None, rank=0, world=2, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="one size"):
        tloop.train(scene, ts, mesh=mesh, device="cpu")


def test_training_needs_cuda_unless_asked_for_cpu(monkeypatch):
    pts = np.random.default_rng(0).normal(size=(20, 3)).astype(np.float32)
    state = tgm.create_from_points(pts, np.full((20, 3), 0.5, np.float32), device="cpu")
    cam = TCamera.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0], 0.9, 0.9, 16, 16, device="cpu")
    scene = tloop.SceneLike(cameras=[(cam, torch.zeros(3, 16, 16), 0)], extent=1.0)
    ocfg = OptimizationConfig(iterations=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgm.create_from_points(pts, np.zeros((20, 3), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tloop.train(scene, state, ModelConfig(), ocfg)
    ts, history = tloop.train(scene, state, ModelConfig(), ocfg, device="cpu", log_every=1)
    assert ts.iteration == 2 and len(history) == 2
