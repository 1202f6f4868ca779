"""The densification event of ``train()`` (``train/loop.densify_event``) on
the CPU: against the benchmark's plain reference (``benchmark/reference/
densify.py``) on the same state and normal draws (the counts exactly; the
compacted rows, moments and filter to float32 rounding), capacity growth
when the count crosses 90% (the new slots zero and inactive; the gauges and
the counter of a traced event), and ``train()`` through two densifications
and an opacity reset against the JAX package's ``train()`` on the same
scene and draws (the history, the capacity and the state)."""

import numpy as np
import pytest
import torch

from benchmark.reference import densify as rd
from benchmark.reference import scene as rs
from radegs_torch.core.camera import Camera
from radegs_torch.models import gaussian_model as gm
from radegs_torch.renderer import render
from radegs_torch.train import loop
from radegs_torch.train.config import ModelConfig, OptimizationConfig, PipelineConfig
from radegs_torch.utils import trace

W, H = 64, 48
N_CAMS = 6
EXTENT = 4.0
IT = 3100  # on the densify schedule, after the first opacity reset
OCFG = OptimizationConfig()
MCFG = ModelConfig(kernel_size=0.1)


def eyes():
    return [[3.0 * np.sin(a), 0.3 + 0.2 * np.sin(2 * a), -3.0 * np.cos(a)]
            for a in 2 * np.pi * np.arange(N_CAMS) / N_CAMS]


def cameras():
    return [Camera.look_at(e, [0, 0, 0], [0, 1, 0], 0.9, 0.7, W, H, device="cpu")
            for e in eyes()]


def ref_cameras():
    return [rs.look_at(e, [0, 0, 0], [0, 1, 0], 0.9, 0.7, W, H, "cpu") for e in eyes()]


def mid_training(P=4096, C=8192, hot=None, seed=0):
    """A state as training leaves it: points on a sphere, spread opacities
    (some under the prune threshold), Adam moments and densification
    statistics, the 3D filter of the cameras. ``hot``: only these rows get
    gradients past the threshold, every other row a small abs gradient."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(P, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (d * (1.0 + 0.05 * rng.normal(size=(P, 1)))).astype(np.float32)
    g = gm.create_from_points(pts, rng.uniform(0.1, 0.9, (P, 3)).astype(np.float32),
                              capacity=C, device="cpu")
    act = g.active

    def rows(x):
        return torch.where(act.reshape((-1,) + (1,) * (x.dim() - 1)), x, torch.zeros_like(x))

    def f32(*shape, scale=1.0, shift=0.0):
        return torch.tensor(rng.normal(size=shape) * scale + shift, dtype=torch.float32)

    p = g.params
    p = p.replace(scaling=p.scaling + rows(f32(C, 3, scale=0.4)),
                  rotation=rows(f32(C, 4)) + torch.where(act[:, None], 0.0, p.rotation),
                  opacity=rows(f32(C, 1, scale=1.5, shift=0.5)) - 10.0 * (~act[:, None]))
    denom = torch.tensor(rng.integers(0, 6, C), dtype=torch.float32) * act
    if hot is None:
        accum = denom * torch.tensor(rng.uniform(0, 4e-4, C), dtype=torch.float32)
        abs_accum = denom * torch.tensor(rng.uniform(0, 1e-3, C), dtype=torch.float32)
    else:
        denom = torch.where(act, torch.clamp_min(denom, 1.0), 0.0)
        mask = torch.zeros(C, dtype=torch.bool)
        mask[hot] = True
        accum = denom * torch.where(mask, 1e-3, 0.0)
        abs_accum = denom * torch.where(mask, 1e-3, torch.tensor(rng.uniform(1e-8, 1e-7, C),
                                                                  dtype=torch.float32))
    g = g.replace(params=p, adam_m=p.map(lambda x: rows(f32(*x.shape, scale=1e-3))),
                  adam_v=p.map(lambda x: rows(f32(*x.shape, scale=1e-6).abs())), adam_step=7,
                  denom=denom, grad_accum=accum * act, grad_abs_accum=abs_accum * act,
                  grad_abs_max=rows(torch.tensor(rng.uniform(0, 1e-3, C), dtype=torch.float32)),
                  max_radii2d=rows(torch.tensor(rng.uniform(0, 9, C), dtype=torch.float32)))
    return gm.update_3d_filter(g, cameras())


def to_reference(g, n):
    return {"params": {k: v[:n].clone() for k, v in g.params.items()},
            "m": {k: v[:n].clone() for k, v in g.adam_m.items()},
            "v": {k: v[:n].clone() for k, v in g.adam_v.items()},
            "stats": {k: getattr(g, k)[:n].clone() for k in rd.STATS},
            "filter3d": g.filter_3d[:n].clone(), "capacity": g.capacity,
            "adam_step": g.adam_step}


def event(g, draws):
    ts = loop.init_train_state(g)
    return loop.densify_event(ts, IT, None, OCFG, MCFG, EXTENT, cameras(), draws=draws)


def draws_of(C, seed=1):
    return gm.normal_draws(torch.Generator().manual_seed(seed), C, "cpu")


def test_the_event_equals_the_reference():
    P, C = 4096, 8192
    g = mid_training(P, C)
    draws = draws_of(C)
    ts, counts = event(g, draws)
    ref, rc = rd.densify(to_reference(g, P), [d[:P] for d in draws], ref_cameras(),
                         max_grad=OCFG.densify_grad_threshold, min_opacity=loop.MIN_OPACITY,
                         extent=EXTENT, percent_dense=OCFG.percent_dense, prune_big_ws=True)
    out = ts.gaussians
    n = counts["active"]
    assert rc["n_clone"] > 50 and rc["n_split"] > 50 and rc["n_prune"] > 50, rc
    assert {"n_clone": counts["cloned"], "n_split": counts["split"],
            "n_prune": counts["pruned"], "n_drop": counts["dropped"], "n_active": n,
            "capacity": out.capacity} == rc
    assert counts["active_before"] == P and out.capacity == C
    assert torch.equal(out.active, torch.arange(C) < n)
    for k in rd.GROUPS:
        np.testing.assert_allclose(getattr(out.params, k)[:n], ref["params"][k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
        assert torch.equal(getattr(out.adam_m, k)[:n], ref["m"][k]), k
        assert torch.equal(getattr(out.adam_v, k)[:n], ref["v"][k]), k
    np.testing.assert_allclose(out.filter_3d[:n], ref["filter3d"], rtol=1e-6, atol=0)
    assert not out.filter_3d[n:].any()
    for k in rd.STATS:
        assert not getattr(out, k).any(), k


@pytest.mark.parametrize("n_hot", [120, 20])
def test_the_event_grows_past_ninety_percent(n_hot):
    """3,600 rows at capacity 4,096 with ``n_hot`` rows to clone: 3,720
    reach 90% and the capacity doubles; 3,620 do not."""
    P, C = 3600, 4096
    g = mid_training(P, C, hot=np.arange(0, P, P // n_hot)[:n_hot], seed=2)
    g = g.replace(params=g.params.replace(
        scaling=torch.clamp_max(g.params.scaling, np.log(0.9 * OCFG.percent_dense * EXTENT)),
        opacity=torch.where(g.active[:, None], 1.0, g.params.opacity)))
    before = dict(trace.counters("densify"))
    trace.reset()
    with trace.unit("iteration", [], None):
        ts, counts = event(g, draws_of(C))
    (u,) = trace.units()
    out = ts.gaussians
    grows = P + n_hot >= 0.9 * C
    assert counts == {"cloned": n_hot, "split": 0, "pruned": 0, "dropped": 0,
                      "active_before": P, "active": P + n_hot}
    assert out.capacity == (2 * C if grows else C)
    assert u["gauges"] == {**{f"densify.{k}": v for k, v in counts.items()},
                           "densify.capacity": out.capacity}
    assert u["sites"]["densify.grow"][0] == 1
    assert u["counts"].get("densify.grows", 0) == int(grows)
    assert trace.counters("densify").get("grows", 0) == before.get("grows", 0) + int(grows)
    assert torch.equal(out.active, torch.arange(out.capacity) < P + n_hot)
    if grows:
        for name, x in [*out.params.items(), *out.adam_m.items(), *out.adam_v.items(),
                        ("filter_3d", out.filter_3d), *((k, getattr(out, k)) for k in rd.STATS)]:
            assert not x[C:].any(), name


def test_train_through_two_densifications_is_unchanged(monkeypatch):
    """``train()`` through events at 3 (the count reaches the capacity: rows
    are dropped and the capacity doubles) and 6 (with the opacity reset)
    against the JAX package's ``train()`` on the same scene, views and
    densify draws: the history, the capacity and the state."""
    import jax

    from radegs_tpu.core.camera import Camera as JCamera
    from radegs_tpu.models import gaussian_model as jgm
    from radegs_tpu.train import config as jcfg
    from radegs_tpu.train import loop as jloop

    torch.set_num_threads(1)
    rng = np.random.default_rng(5)

    def sphere(n):
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return (d * (1.0 + 0.03 * rng.normal(size=(n, 1)))).astype(np.float32)

    target = gm.create_from_points(sphere(400), rng.uniform(0.1, 0.9, (400, 3)).astype(
        np.float32), capacity=512, device="cpu")
    target = target.replace(params=target.params.replace(opacity=torch.where(
        target.active[:, None], gm.inverse_sigmoid(torch.tensor(0.8)), target.params.opacity)))
    views = [([3.2 * np.sin(a), 0.4, -3.2 * np.cos(a)], [0, 0, 0], [0, 1, 0], 0.9, 0.9, 48, 40)
             for a in 2 * np.pi * np.arange(3) / 3]
    cams, jcams = [], []
    for i, v in enumerate(views):
        cam = Camera.look_at(*v, device="cpu")
        with torch.no_grad():
            gt = render(target, cam, [0, 0, 0], max_per_tile=256, instance_budget=1 << 14,
                        device="cpu")["render"]
        cams.append((cam, gt, i))
        jcams.append((JCamera.look_at(*v), jax.numpy.asarray(gt.numpy()), i))
    js = jgm.create_from_points(sphere(240), rng.uniform(0.1, 0.9, (240, 3)).astype(np.float32),
                                capacity=256)
    g = gm.state_from_arrays(*(np.asarray(getattr(js.params, k)) for k in rd.GROUPS),
                             np.asarray(js.active), np.asarray(js.filter_3d),
                             int(js.active_sh_degree), js.max_sh_degree, device="cpu")
    sched = dict(iterations=8, densify_from_iter=2, densification_interval=3,
                 densify_until_iter=100, opacity_reset_interval=6, densify_grad_threshold=0.002,
                 regularization_from_iter=4)
    seed = 0
    # the JAX loop's densify keys (one split for its set-up, then one an
    # event, three draws of it), replayed as the port's draws
    key = [jax.random.split(jax.random.PRNGKey(seed))[0]]

    def jax_draws(generator, capacity, device):
        key[0], sub = jax.random.split(key[0])
        return tuple(torch.from_numpy(np.array(jax.random.normal(k, (capacity, 3))))
                     for k in jax.random.split(sub, 3))

    monkeypatch.setattr(gm, "normal_draws", jax_draws)
    ts, hist = loop.train(loop.SceneLike(cameras=cams, extent=4.0), g, MCFG,
                          OptimizationConfig(**sched), PipelineConfig(max_per_tile=256),
                          seed=seed, log_every=1, device="cpu")
    jts, jhist = jloop.train(jloop.SceneLike(cameras=jcams, extent=4.0), js,
                             jcfg.ModelConfig(kernel_size=0.1), jcfg.OptimizationConfig(**sched),
                             jcfg.PipelineConfig(max_per_tile=256), seed=seed, log_every=1)
    assert [[h["iteration"], h["n_active"]] for h in hist] == [
        [h["iteration"], h["n_active"]] for h in jhist]
    assert [h["n_active"] for h in hist][2:6:3] == [256, 430]  # dropped, then grown
    np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in jhist],
                               rtol=1e-5)
    st, jst = ts.gaussians, jts.gaussians
    assert st.capacity == jst.capacity == 512 and int(jst.n_active()) == 430
    assert torch.equal(st.active, torch.from_numpy(np.array(jst.active)))
    def rel(a, b):  # the largest gap over the largest magnitude
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)

    for k in rd.GROUPS:
        for name in ("params", "adam_m", "adam_v"):
            assert rel(getattr(getattr(st, name), k),
                       getattr(getattr(jst, name), k)) < 1e-4, (name, k)
    assert rel(st.filter_3d, jst.filter_3d) < 1e-5
    for k in rd.STATS:
        assert rel(getattr(st, k), getattr(jst, k)) < 1e-4, k
