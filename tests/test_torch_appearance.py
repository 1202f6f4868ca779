"""Decoupled appearance (``radegs_torch/models/appearance.py`` and its Adam
in ``train/loop.py``) against the JAX package's flax network on the same
numpy parameters and inputs (JAX on the CPU).

Tolerances: the network's outputs rtol 1e-5 (atol 1e-6); the appearance
transform (crop, antialiased x32 downsample, multiplier) atol 1e-6; one
train step with appearance from a carried JAX state at the tolerances of
tests/test_torch_train.py's one-step test: rtol 1e-4, parameters compared
where the gradient is clearly away from zero, moments by max |a - b| / max
|a| <= 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radegs_tpu.core.camera import Camera as JCamera
from radegs_tpu.models import appearance as ja
from radegs_tpu.train import loop as jloop
from radegs_tpu.train.config import (
    ModelConfig as JModelConfig,
    OptimizationConfig as JOptimizationConfig,
    PipelineConfig as JPipelineConfig,
)
from radegs_torch.core.camera import Camera as TCamera
from radegs_torch.models import appearance as ta
from radegs_torch.models import gaussian_model as tgm
from radegs_torch.train import loop as tloop
from radegs_torch.train.config import ModelConfig, OptimizationConfig, PipelineConfig
from test_torch_train import PARAMS, carry, close, mid_training_state, rel_err

torch.set_num_threads(1)
CAM = ([0.3, -0.4, -3.8], [0.1, 0, 0], [0, 1, 0], 0.85, 0.75, 72, 64)  # crop 64 x 64


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_app():
    net, params = ja.init_appearance(jax.random.PRNGKey(3), 64, 72)
    return net, params


@pytest.mark.parametrize("hw", [(2, 3), (3, 5)])
def test_network_matches_flax(jax_app, hw):
    net, params = jax_app
    p = host(params)
    tp = ta.appearance_from_arrays(p["net"], p["embeddings"], device="cpu")
    x = np.random.default_rng(hw[1]).normal(size=(1, *hw, 3 + ta.EMBED_DIM)).astype(np.float32)
    want = np.asarray(net.apply(params["net"], jnp.asarray(x)))
    got = torch.func.functional_call(ta.AppearanceNetwork(), tp["net"],
                                     (torch.from_numpy(x).permute(0, 3, 1, 2),))
    assert got.shape == (1, 3, 32 * hw[0], 32 * hw[1])
    close(want, got.permute(0, 2, 3, 1), 1e-5, 1e-6)


def test_pixel_shuffle_keeps_the_jax_channel_order():
    x = np.random.default_rng(0).normal(size=(1, 3, 4, 12)).astype(np.float32)  # NHWC
    want = np.asarray(ja.pixel_shuffle(jnp.asarray(x), 2))
    got = ta.pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("size,view", [((3, 70, 100), 5), ((3, 64, 96), 2047)])
def test_appearance_transform_matches_jax(jax_app, size, view):
    net, params = jax_app
    p = host(params)
    tp = ta.appearance_from_arrays(p["net"], p["embeddings"], device="cpu")
    img = np.random.default_rng(view).uniform(size=size).astype(np.float32)
    jt, jbox = ja.appearance_transform(net, params, jnp.asarray(img), view)
    tt, tbox = ta.appearance_transform(tp, torch.from_numpy(img), view)
    assert tuple(jbox) == tbox
    close(jt, tt, 0, 1e-6)
    # the downsample alone: jax.image.resize "linear" antialiases
    top, left, Hc, Wc = tbox
    crop = img[:, top:top + Hc, left:left + Wc]
    jd = jax.image.resize(jnp.asarray(crop[None].transpose(0, 2, 3, 1)),
                          (1, Hc // 32, Wc // 32, 3), "linear")
    td = torch.nn.functional.interpolate(torch.from_numpy(crop)[None], size=(Hc // 32, Wc // 32),
                                         mode="bilinear", antialias=True, align_corners=False)
    close(jd, td.permute(0, 2, 3, 1), 0, 1e-6)


def test_init_matches_the_flax_distribution(jax_app):
    _, params = jax_app
    _, tp = ta.init_appearance(torch.Generator().manual_seed(0), 64, 72)
    flat = dict(jax.tree_util.tree_flatten_with_path(params["net"])[0])
    for name, path in ta.FLAX_PATHS.items():
        jk = np.asarray(next(v for k, v in flat.items()
                             if tuple(getattr(e, "key", None) for e in k)[1:-1] == path
                             and k[-1].key == "kernel"))
        w = tp["net"][f"{name}.weight"]
        std = np.sqrt(1.0 / np.prod(jk.shape[:3])) / ta.TRUNC_STD
        assert w.shape == jk.transpose(3, 2, 0, 1).shape
        assert abs(float(w.std()) / jk.std() - 1) < 0.15, name
        assert float(w.abs().max()) <= 2 * std + 1e-7 and float(np.abs(jk).max()) <= 2 * std
        assert not tp["net"][f"{name}.bias"].any()
    assert tp["embeddings"].shape == (ta.NUM_EMBEDDINGS, ta.EMBED_DIM)
    assert abs(float(tp["embeddings"].std()) / 1e-4 - 1) < 0.05


def test_train_step_with_appearance_from_carried_state(jax_app):
    _, params = jax_app
    js = mid_training_state()
    rng = np.random.default_rng(11)
    jm_app = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(size=x.shape) * 1e-3, jnp.float32), params)
    jv_app = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.uniform(size=x.shape) * 1e-6, jnp.float32), params)
    W, H = CAM[-2], CAM[-1]
    gt = rng.uniform(size=(3, H, W)).astype(np.float32)
    cfg = (dict(kernel_size=0.1, use_decoupled_appearance=True),
           dict(regularization_from_iter=5, densify_from_iter=100), dict(max_per_tile=128))
    carried = {k: host(v) for k, v in (("p", params), ("m", jm_app), ("v", jv_app))}
    g_m_old = {k: np.array(getattr(js.adam_m, k)) for k in PARAMS}
    ts = tloop.TrainState(
        gaussians=carry(js), iteration=9,
        **{f"app_{n}": ta.appearance_from_arrays(carried[k]["net"], carried[k]["embeddings"],
                                                 device="cpu")
           for n, k in (("params", "p"), ("m", "m"), ("v", "v"))})
    jts = jloop.TrainState(gaussians=jax.tree_util.tree_map(jnp.array, js), app_params=params,
                           app_m=jm_app, app_v=jv_app, iteration=jnp.asarray(9, jnp.int32),
                           key=jax.random.PRNGKey(0))
    jstep = jloop.make_train_step(JModelConfig(**cfg[0]), JOptimizationConfig(**cfg[1]),
                                  JPipelineConfig(**cfg[2]), spatial_lr_scale=2.5)
    jnew, jmet = jstep(jts, JCamera.look_at(*CAM), jnp.asarray(gt), jnp.zeros(3), 7,
                       width=W, height=H)
    tstep = tloop.make_train_step(ModelConfig(**cfg[0]), OptimizationConfig(**cfg[1]),
                                  PipelineConfig(**cfg[2]), spatial_lr_scale=2.5)
    tnew, tmet = tstep(ts, TCamera.look_at(*CAM, device="cpu"), torch.from_numpy(gt),
                       torch.zeros(3), 7, W, H)
    assert tnew.iteration == int(jnew.iteration) == 10
    for k in ["loss", "l1", "depth_normal_loss", "psnr"]:
        close(jmet[k], tmet[k], 1e-4, msg=k)
    jg, tg = jnew.gaussians, tnew.gaussians
    for k in tgm.TRAINING_FIELDS:
        close(getattr(jg, k), getattr(tg, k), 1e-4, 1e-9, msg=k)
    for k in PARAMS:
        g = (np.asarray(getattr(jg.adam_m, k)) - 0.9 * g_m_old[k]) / 0.1
        sel = np.abs(g) > 1e-6 * np.abs(g).max()
        close(np.asarray(getattr(jg.params, k))[sel], getattr(tg.params, k).numpy()[sel],
              1e-4, 1e-7, msg=k)
    # the appearance parameters and moments, carried back the same way
    back = {n: ta.appearance_from_arrays(host(getattr(jnew, f"app_{n}"))["net"],
                                         np.asarray(getattr(jnew, f"app_{n}")["embeddings"]),
                                         device="cpu") for n in ("params", "m", "v")}
    moved = 0
    for n in ("params", "m", "v"):
        want, got = back[n], getattr(tnew, f"app_{n}")
        for name in want["net"]:
            assert rel_err(want["net"][name].numpy(), got["net"][name].numpy()) <= 1e-4, \
                (n, name)
        assert rel_err(want["embeddings"].numpy(), got["embeddings"].numpy()) <= 1e-4, n
    for name, v in tnew.app_params["net"].items():
        moved += int(not torch.equal(v, ts.app_params["net"][name]))
    assert moved == len(tnew.app_params["net"])
    # dense Adam: rows of the embedding table without a gradient still move
    assert not torch.equal(tnew.app_params["embeddings"][0], ts.app_params["embeddings"][0])


def test_train_runs_with_appearance():
    rng = np.random.default_rng(0)
    g = tgm.create_from_points((rng.normal(size=(40, 3)) * 0.5).astype(np.float32),
                               rng.uniform(size=(40, 3)).astype(np.float32), capacity=64,
                               device="cpu")
    cams = [(TCamera.look_at([3.5 * np.sin(a), 0.5, -3.5 * np.cos(a)], [0, 0, 0], [0, 1, 0], 0.9,
                             0.9, 64, 64, device="cpu"),
             torch.from_numpy(rng.uniform(size=(3, 64, 64)).astype(np.float32)), i)
            for i, a in enumerate((0.0, 2.0))]
    ts, hist = tloop.train(tloop.SceneLike(cameras=cams, extent=3.5), g,
                           ModelConfig(use_decoupled_appearance=True),
                           OptimizationConfig(iterations=4, densify_from_iter=100),
                           PipelineConfig(max_per_tile=64), log_every=1, device="cpu", seed=2)
    _, init = ta.init_appearance(torch.Generator().manual_seed(3))  # seed + 1
    assert ts.iteration == 4 and all(np.isfinite([h["loss"] for h in hist]))
    assert not torch.equal(ts.app_params["net"]["conv_out.weight"],
                           init["net"]["conv_out.weight"])
    assert torch.equal(ts.app_m["embeddings"][5], torch.zeros(ta.EMBED_DIM))  # no such view
