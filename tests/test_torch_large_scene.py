"""Scenes past the JAX package's work-buffer caps (``ops/binning.py``): the
instance budget's ceiling follows the capacity (``budget_cap``: 2^24 up to
capacity 2^21, as the JAX package, 2^26 at 2^23), and ``max_per_tile`` grows
to ``MAX_PER_TILE_CAP`` = 2^16 (the JAX package stops at 2^14).

On the CPU: the budget policies equal the JAX package's up to capacity 2^21
and grow past 2^24 at 2^23; a small ``surface`` scene whose demand is three
times a lowered ``MAX_INSTANCE_BUDGET`` trains and renders whole, held to the
benchmark's plain reference within the benchmark's limits; one tile 20,000
splats deep is blended whole once the autotune doubles ``max_per_tile`` past
2^14; the binning's two gauges are read at its existing sync. The card's
tests are in ``test_torch_large_scene_kernel.py``, which imports no JAX.
"""

import contextlib
import warnings

import pytest
import torch

from benchmark import check, jobs, program, run
from benchmark.reference import fp32
from benchmark.reference import render as rr
from radegs_torch import renderer
from radegs_torch.ops import binning
from radegs_torch.ops.binning import (
    MAX_INSTANCE_BUDGET,
    MAX_PER_TILE_CAP,
    budget_cap,
    default_instance_budget,
    round_budget,
)
from radegs_torch.train import loop
from radegs_torch.train.config import PipelineConfig
from radegs_torch.utils import trace
from radegs_tpu.ops import binning as jbin
from radegs_tpu.train import loop as jloop
from radegs_tpu.train.config import PipelineConfig as JPipelineConfig
from test_torch_large_scene_kernel import CELL, config, deep_tile
from test_torch_trace import STEP_SITES, FakeEvent

SEED = 2147483659
CPU = torch.device("cpu")


class FakeBinning:
    """The fields of a binning that ``renderer._grown`` reads."""

    def __init__(self, n_instances, budget, max_tile, max_per_tile):
        self.n_instances = torch.tensor(n_instances)
        self.n_overflow = torch.tensor(max(n_instances - budget, 0))
        self.max_tile_count = torch.tensor(max_tile)
        self.tile_overflow = torch.tensor(max(max_tile - max_per_tile, 0))


# ---- (a) the budget policy up to capacity 2^21 is the JAX package's ---------

CAPACITIES = [4096, 1 << 17, 1 << 20, 1 << 21]
# (n_ovf, t_ovf, window peak, shrink check) of one autotune call
AUTOTUNE = [(0, 0, 1000.0, True), (5000, 0, 3e6, False), (10, 3, 2e7, True),
            (0, 0, 9e6, True), (1e6, 0, 4e7, False)]


@pytest.mark.parametrize("capacity", CAPACITIES)
def test_budget_policy_matches_jax_up_to_2_21(capacity):
    assert budget_cap(capacity) == MAX_INSTANCE_BUDGET == jbin.MAX_INSTANCE_BUDGET
    for mult in (4, 8, 16):
        tp, jp = PipelineConfig(instance_multiplier=mult), JPipelineConfig(instance_multiplier=mult)
        assert loop.instance_budget(tp, capacity) == min(
            jbin.default_instance_budget(capacity, mult), jbin.MAX_INSTANCE_BUDGET)
        for budget in (0, 1 << 16, 6 << 21):
            for args in AUTOTUNE:
                got, ch = loop.autotune_pipeline(PipelineConfig(instance_budget=budget,
                                                                instance_multiplier=mult),
                                                 *args[:3], capacity, args[3])
                want, jch = jloop.autotune_pipeline(JPipelineConfig(instance_budget=budget,
                                                                    instance_multiplier=mult),
                                                    *args[:3], capacity, args[3])
                assert ch == jch and got.instance_budget == want.instance_budget
                if want.max_per_tile < 1 << 14:
                    assert got.max_per_tile == want.max_per_tile
    # render's growth: the budget JAX's round_budget gives, from the default
    start = default_instance_budget(capacity)
    for need in [n for n in (start + 1, 3 * start, 10_500_000, 40_000_000) if n > start]:
        b = FakeBinning(need, start, 100, 512)
        n_ovf, t_ovf, budget, mpt = renderer._grown(b, start, 512, capacity, "test")
        assert (n_ovf, t_ovf, mpt) == (need - start, 0, 512)
        assert budget == jbin.round_budget(need) == round_budget(need)


# ---- (b) at capacity 2^23 the ceiling is 2^26 ---------------------------------

def test_capacity_2_23_grows_past_2_24():
    cap = 1 << 23
    assert budget_cap(cap) == 1 << 26 == default_instance_budget(cap)
    assert loop.instance_budget(PipelineConfig(), cap) == 1 << 26
    assert round_budget(40_000_000) == 1 << 24  # the default cap stays the JAX package's
    assert round_budget(40_000_000, cap=budget_cap(cap)) == 20 * binning.BUDGET_SEG
    p, changed = loop.autotune_pipeline(PipelineConfig(instance_budget=1 << 24), 1e6, 0,
                                        18e6, cap, False)
    assert changed and p.instance_budget == round_budget(18e6 * 1.3, cap=1 << 26) > 1 << 24
    # the JAX package stops at 2^24 and truncates
    jp, jch = jloop.autotune_pipeline(JPipelineConfig(instance_budget=1 << 24), 1e6, 0, 18e6,
                                      cap, False)
    assert not jch and jp.instance_budget == 1 << 24
    # at the ceiling nothing grows further
    p, changed = loop.autotune_pipeline(PipelineConfig(instance_budget=1 << 26), 1e6, 0, 9e7,
                                        cap, False)
    assert not changed and p.instance_budget == 1 << 26
    # a settle from PipelineConfig() on the 6.1M scene's demand (about 17.9M
    # instances at its busiest view, tiles about 17,000 deep) drops nothing
    p = program.settle_train(PipelineConfig(), cap, 17_940_000, 17_073)
    assert loop.instance_budget(p, cap) >= 17_940_000 and p.max_per_tile == 1 << 15
    b = FakeBinning(17_940_000, 1 << 26, 17_073, 512)
    assert renderer._grown(b, 1 << 26, 512, cap, "test")[2:] == (1 << 26, 1 << 15)


# ---- (c) a small surface scene past a lowered MAX_INSTANCE_BUDGET -----------

def small_cfg():
    return config(points={"generator": "surface", "n": 20_000}, capacity=1 << 15, width=96,
                  height=64, views=3, pipeline={"max_per_tile": 8192})


def test_small_scene_past_the_budget_constant_trains_and_renders_whole(monkeypatch):
    cfg = small_cfg()
    pts, cols = jobs.scene.points_and_colors(cfg, SEED)
    cams = program.cameras(jobs.scene.view_eyes(cfg), cfg, CPU)
    state = program.load_state(cfg, jobs.scene_params(cfg, pts, cols, CPU), cams, CPU)
    peak, _ = program.demand(state, cams, cfg["kernel_size"])
    monkeypatch.setattr(binning, "MAX_INSTANCE_BUDGET", peak // 3)
    # the former rule's budget, min(default, MAX_INSTANCE_BUDGET), would cut every view
    assert min(default_instance_budget(cfg["capacity"]), binning.MAX_INSTANCE_BUDGET) < peak
    assert budget_cap(cfg["capacity"]) == default_instance_budget(cfg["capacity"]) > peak

    mix = run.load_json(f"{run.ROOT}/benchmark/mixes/train.json")
    res = jobs.run_train(cfg, mix, SEED, 0.0, False, CPU, 0.0)
    assert res["failed"] == 0 and res["attempted"] >= 1
    ok, checks = check.judge(res["numbers"], check.load_limits(CELL))
    assert ok, checks

    # render from a starved start grows to the demand, and equals the reference
    monkeypatch.setattr(renderer, "default_instance_budget", lambda capacity: 1 << 14)
    cam = cams[1]
    with torch.no_grad(), no_drop_warning():
        out = renderer.render(state, cam, torch.zeros(3), kernel_size=cfg["kernel_size"],
                              max_per_tile=64, device="cpu")
    b = out["binning"]
    assert int(b.n_overflow) == 0 == int(b.tile_overflow) and int(b.n_instances) > peak // 3
    assert_equals_reference(cfg, pts, cols, cam, out, jobs.ref_cameras([jobs.scene.view_eyes(
        cfg)[1]], cfg, CPU)[0])


@contextlib.contextmanager
def no_drop_warning():
    """Fail on a warning that a render or an integrate dropped instances."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        yield
    dropped = [str(w.message) for w in caught if "dropped" in str(w.message)]
    assert not dropped, dropped


def assert_equals_reference(cfg, pts, cols, cam, out, rcam, params=None):
    """``render``'s maps against the benchmark's reference render of the same
    scene within the serve cell's limits."""
    with fp32():
        if params is None:
            params, f3 = jobs.ref_scene(cfg, pts, cols, CPU)
        else:
            params, f3 = params
        ref = rr.render(params, f3, rcam, cfg["kernel_size"], cfg["active_sh_degree"])
    nums = check.serve_numbers([(check.to_host(out), check.to_host(ref))])
    ok, checks = check.judge(nums, check.load_limits("serve-surface-1.2M"))
    assert ok, checks


# ---- (d) one tile stacked 20,000 splats deep ----------------------------------

def test_a_tile_deeper_than_2_14_blends_whole_after_the_autotune():
    cfg, pts, cols, cam, state, dist2 = deep_tile(CPU)
    pcfg = PipelineConfig(max_per_tile=1 << 14, instance_budget=1 << 16)
    bg = torch.zeros(3)

    def view(p):
        with torch.no_grad():
            return renderer.render(state, cam, bg, kernel_size=cfg["kernel_size"],
                                   max_per_tile=p.max_per_tile, instance_budget=p.instance_budget,
                                   device="cpu")

    cut = view(pcfg)["binning"]
    assert int(cut.max_tile_count) > 1 << 14 and int(cut.tile_overflow) > 0
    pcfg, changed = loop.autotune_pipeline(pcfg, float(cut.n_overflow),
                                           float(cut.tile_overflow), float(cut.n_instances),
                                           state.capacity, False)
    assert changed and pcfg.max_per_tile == 1 << 15 <= MAX_PER_TILE_CAP
    whole = view(pcfg)
    assert int(whole["binning"].tile_overflow) == 0 == int(whole["binning"].n_overflow)
    with fp32():
        rparams = jobs.ref_scene(cfg, pts, cols, CPU, dist2=dist2)
    rcam = jobs.ref_cameras([[0.0, 0.0, -5.0]], cfg, CPU)[0]
    assert_equals_reference(cfg, pts, cols, cam, whole, rcam, params=rparams)
    # render's own sizing reaches the same list from the default 512
    with torch.no_grad(), no_drop_warning():
        grown = renderer.render(state, cam, bg, kernel_size=cfg["kernel_size"], device="cpu")
    assert int(grown["binning"].tile_overflow) == 0
    assert torch.equal(grown["render"], whole["render"])


# ---- integrate_prepare grows max_per_tile as render does ---------------------

def test_integrate_prepare_grows_max_per_tile(monkeypatch):
    cfg = dict(small_cfg(), points={"generator": "surface", "n": 3000}, capacity=4096)
    pts, cols = jobs.scene.points_and_colors(cfg, SEED)
    cams = program.cameras(jobs.scene.view_eyes(cfg), cfg, CPU)
    state = program.load_state(cfg, jobs.scene_params(cfg, pts, cols, CPU), cams, CPU)
    cam = cams[0]
    points = torch.as_tensor(pts[:500])
    bg = torch.zeros(3)
    full = renderer.integrate(points, state, cam, bg, kernel_size=0.1, max_per_tile=4096,
                              instance_budget=1 << 16, device="cpu")
    busiest = int(full["binning"].max_tile_count)
    assert int(full["binning"].tile_overflow) == 0 and busiest > 8
    starved = renderer.integrate(points, state, cam, bg, kernel_size=0.1, max_per_tile=8,
                                 instance_budget=1 << 16, device="cpu")
    assert int(starved["binning"].tile_overflow) > 0  # a given budget is used as it is
    with no_drop_warning():
        grown = renderer.integrate(points, state, cam, bg, kernel_size=0.1, max_per_tile=8,
                                   device="cpu")
    assert int(grown["binning"].tile_overflow) == 0 == int(grown["binning"].n_overflow)
    for k in ("render", "alpha_integrated", "color_integrated", "point_sdf", "point_valid"):
        assert torch.equal(grown[k], full[k]), k
    # at a lowered cap it warns, as render does
    monkeypatch.setattr(renderer, "MAX_PER_TILE_CAP", 8)
    with pytest.warns(UserWarning, match="integrate dropped 0 instances"):
        renderer.integrate(points, state, cam, bg, kernel_size=0.1, max_per_tile=8,
                           device="cpu")


# ---- (e) the binning's gauges --------------------------------------------------

@pytest.mark.parametrize("budget", [1 << 14, 1000])
def test_binning_gauges_and_the_step_syncs(monkeypatch, budget):
    from radegs_torch.train.config import ModelConfig, OptimizationConfig

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    cfg = dict(small_cfg(), points={"generator": "surface", "n": 2000}, capacity=2048,
               width=48, height=32)
    pts, cols = jobs.scene.points_and_colors(cfg, SEED)
    cams = program.cameras(jobs.scene.view_eyes(cfg), cfg, CPU)
    state = program.load_state(cfg, jobs.scene_params(cfg, pts, cols, CPU), cams, CPU)
    gt = torch.rand((3, 32, 48), generator=torch.Generator().manual_seed(1))
    step = loop.make_train_step(ModelConfig(kernel_size=0.1),
                                OptimizationConfig(regularization_from_iter=0),
                                PipelineConfig(max_per_tile=1024, instance_budget=budget),
                                spatial_lr_scale=5.0)
    trace.reset()
    try:
        _, m = step(loop.init_train_state(state), cams[0], gt, torch.zeros(3), 0, 48, 32,
                    events=[])
        (u,) = trace.units()
        summary = trace.summary()
    finally:
        trace.reset()
    n = int(m["n_instances"])
    assert u["gauges"] == {"binning.instances": n, "binning.budget_cut": max(n - budget, 0)}
    assert (max(n - budget, 0) > 0) == (budget == 1000)
    assert summary["units"]["step"]["gauges"]["binning.instances"] == n
    assert "binning.instances" not in u["counts"]
    # the same syncs as before the gauges: binning.total is read once
    assert u["sites"]["binning.total"][0] == 1
    assert {k: c for k, (c, _) in u["sites"].items()} == STEP_SITES
    assert u["syncs"] == sum(STEP_SITES.values())
    # untraced, a binning leaves no reading anywhere
    step(loop.init_train_state(state), cams[0], gt, torch.zeros(3), 0, 48, 32)
    assert trace.units() == []
