"""The port's multi-rank train step (``parallel/step.py``) against the JAX
package's ``make_sharded_train_step`` over the same count of devices (of
conftest's 8 virtual CPU devices, XLA path) and against the port's own
single-rank step, on tests/test_sharding.py's scene (P = 48, capacity 256,
32x32: at world 4, two of the bands lie wholly below the image). Also the
strided permutation and the gather-cap autotune against the JAX package's.

Tolerances (tests/test_sharding.py:66-112): loss abs 1e-5, PSNR 1e-3, xyz
after the step atol 1e-5, ``grad_accum`` atol 1e-4. The port's
``grad_abs_accum`` is held to its single-rank step (atol 1e-4) and not to
JAX's: the JAX step scales that statistic by the band's height, the port
by the image's, as both single-rank steps do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radegs_tpu.core.camera import Camera as JCamera
from radegs_tpu.models import gaussian_model as jgm
from radegs_tpu.parallel import rebalance as jreb
from radegs_tpu.parallel import step as jstep
from radegs_tpu.train import loop as jloop
from radegs_tpu.train.config import (
    ModelConfig as JModelConfig,
    OptimizationConfig as JOptimizationConfig,
    PipelineConfig as JPipelineConfig,
)
from radegs_torch.core.camera import Camera as TCamera
from radegs_torch.models import gaussian_model as tgm
from radegs_torch.parallel import inverse_perm, run_ranks, strided_perm
from radegs_torch.train import loop as tloop
from radegs_torch.train.config import ModelConfig, OptimizationConfig, PipelineConfig
from test_torch_parallel_ranks import rank_step

torch.set_num_threads(1)
SPAWN_S = 240
CAM = ([0, 0.5, -3.5], [0, 0, 0], [0, 1, 0], 0.9, 0.9, 32, 32)
CFG = (dict(kernel_size=0.1), dict(regularization_from_iter=0), dict(max_per_tile=64))
PARAMS = ["xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity"]


def j_configs(cfg=CFG):
    return JModelConfig(**cfg[0]), JOptimizationConfig(**cfg[1]), JPipelineConfig(**cfg[2])


def t_configs(cfg=CFG):
    return ModelConfig(**cfg[0]), OptimizationConfig(**cfg[1]), PipelineConfig(**cfg[2])


def scene_arrays():
    """tests/test_sharding.py's setup: the JAX state, camera and gt, and the
    state's fields as host arrays for ``state_from_arrays``."""
    rng = np.random.default_rng(0)
    P = 48
    js = jgm.create_from_points((rng.normal(size=(P, 3)) * 0.5).astype(np.float32),
                                rng.uniform(0.2, 0.9, size=(P, 3)).astype(np.float32),
                                capacity=256)
    jc = JCamera.look_at(*CAM)
    js = jgm.update_3d_filter(js, [jc])
    gt = np.clip(rng.uniform(size=(3, 32, 32)), 0, 1).astype(np.float32)
    arrays = {k: np.asarray(getattr(js.params, k)) for k in PARAMS}
    arrays.update(active=np.asarray(js.active), filter_3d=np.asarray(js.filter_3d),
                  active_sh_degree=int(js.active_sh_degree), max_sh_degree=js.max_sh_degree)
    return js, jc, gt, arrays


def j_sharded(js, jc, gt, n, cfg=CFG, app=False):
    """JAX's make_sharded_train_step over jax.devices()[:n] on the strided
    layout, as JAX's train(mesh=) runs it: (metrics, canonical state)."""
    mesh = jstep.make_mesh_1d(jax.devices()[:n])
    step = jstep.make_sharded_train_step(*j_configs(cfg), spatial_lr_scale=3.5, mesh=mesh,
                                         width=32, height=32)
    ts = jloop.init_train_state(jreb.to_strided(js, n), jax.random.PRNGKey(0), 32, 32,
                                use_appearance=app)
    gt_p = jstep.pad_gt(jnp.asarray(gt), jstep.band_layout(32, n)[2])
    with mesh:
        ts, m = step(ts, jc, gt_p, jnp.zeros(3), 0)
    return {k: float(v) for k, v in m.items()}, ts.replace(
        gaussians=jreb.to_canonical(ts.gaussians, n))


def t_single(arrays, gt, cfg=CFG, app=None):
    """The port's single-rank step: (metrics, state)."""
    ts = tloop.TrainState(gaussians=tgm.state_from_arrays(**arrays, device="cpu"),
                          **(app or {}))
    step = tloop.make_train_step(*t_configs(cfg), spatial_lr_scale=3.5)
    ts, m = step(ts, TCamera.look_at(*CAM, device="cpu"), torch.from_numpy(gt), torch.zeros(3),
                 0, 32, 32)
    return {k: float(v) for k, v in m.items()}, ts


def assert_step_close(m, fields, m_ref, xyz_ref, grad_accum_ref, label):
    assert abs(m["loss"] - m_ref["loss"]) < 1e-5, (label, m["loss"], m_ref["loss"])
    assert abs(m["psnr"] - m_ref["psnr"]) < 1e-3, label
    np.testing.assert_allclose(fields["xyz"], np.asarray(xyz_ref), rtol=0, atol=1e-5,
                               err_msg=label)
    np.testing.assert_allclose(fields["grad_accum"], np.asarray(grad_accum_ref), rtol=0,
                               atol=1e-4, err_msg=label)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_step_matches_jax_and_single_rank(world):
    js, jc, gt, arrays = scene_arrays()
    m_j, ts_j = j_sharded(js, jc, gt, world)
    m_1, ts_1 = t_single(arrays, gt)
    caps = (None, 2) if world == 2 else (None,)
    outs = run_ranks(rank_step, world, "gloo", "cpu", timeout_s=SPAWN_S,
                     args=(arrays, CAM, gt, CFG, None, caps))
    results = [o.result for o in outs]
    (m, fields, _) = results[0][0]
    for r in results[1:]:  # every rank reports the same metrics and state
        assert r[0][0] == m and all(np.array_equal(r[0][1][k], fields[k]) for k in fields)
    assert m["n_vis_overflow"] == 0 and m["n_overflow"] == 0 and m["tile_overflow"] == 0
    assert m["gather_rows"] == m["full_gather_rows"] == 256
    assert m["n_vis"] == m_j["n_vis"] and m["n_vis_max"] == m_j["n_vis_max"]
    assert m["n_instances"] == m_j["n_instances"]
    g_j = ts_j.gaussians
    assert_step_close(m, fields, m_j, g_j.params.xyz, g_j.grad_accum, "vs JAX")
    g_1 = ts_1.gaussians
    assert_step_close(m, fields, m_1, g_1.params.xyz, g_1.grad_accum, "vs single rank")
    np.testing.assert_allclose(fields["grad_abs_accum"], g_1.grad_abs_accum.numpy(), rtol=0,
                               atol=1e-4)
    assert np.array_equal(fields["denom"] > 0, g_1.denom.numpy() > 0)
    if world == 2:  # a starved gather cap is reported, never silent
        m2 = results[0][1][0]
        assert m2["n_vis_overflow"] > 0 and np.isfinite(m2["loss"])
        assert m2["gather_rows"] == 2 * 2


def test_strided_perm_matches_jax():
    for cap, n in ((256, 8), (64, 2), (4096, 4)):
        p = strided_perm(cap, n)
        assert np.array_equal(p.numpy(), np.asarray(jreb.strided_perm(cap, n)))
        assert np.array_equal(inverse_perm(p).numpy(), np.asarray(jreb.inverse_perm(
            jreb.strided_perm(cap, n))))


AUTOTUNE_CASES = [  # tests/test_sharding.py:281-317: (vis_capacity, args of the call)
    (0, (0, 0, 1000, 8 << 17, True, 0, 20_000, 1 << 17)),
    (1 << 15, (0, 0, 1000, 8 << 17, False, 5000, 40_000, 1 << 17)),
    (1 << 16, (0, 0, 1000, 8 << 17, False, 999_999, float(1 << 18), 1 << 17)),
    (1 << 17, (0, 0, 1000, 8 << 17, False, 10, float(1 << 17), 1 << 17)),
    (0, (0, 0, 1000, 1 << 17, True, 0, 100, 0)),
    (4096, (0, 0, 1000, 1 << 17, True, 0, 100, 1 << 17)),
    (0, (10, 0, 3_000_000, 1 << 17, True, 3, 70_000, 1 << 16)),
]


@pytest.mark.parametrize("vis,args", AUTOTUNE_CASES)
def test_autotune_vis_capacity_matches_jax(vis, args):
    n_ovf, t_ovf, peak, cap, shrink, vis_ovf, vis_peak, per_shard = args
    kw = dict(vis_ovf=vis_ovf, vis_peak=vis_peak, per_shard_cap=per_shard)
    jp, jch = jloop.autotune_pipeline(JPipelineConfig(vis_capacity=vis), n_ovf, t_ovf, peak,
                                      cap, shrink, **kw)
    tp, tch = tloop.autotune_pipeline(PipelineConfig(vis_capacity=vis), n_ovf, t_ovf, peak,
                                      cap, shrink, **kw)
    assert tch == jch
    assert (tp.vis_capacity, tp.instance_budget, tp.max_per_tile) == \
        (jp.vis_capacity, jp.instance_budget, jp.max_per_tile)
