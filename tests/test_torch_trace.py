"""The port's tracer (``radegs_torch/utils/trace.py``) on a scene of the port
alone (torch only, so the card's machine runs the ``cuda`` test:
``python -m pytest --noconftest -q -m cuda tests/test_torch_trace.py``).

On the CPU: an untraced step and view record nothing and never enter
``record_function``; a traced step, view and ``train()`` iteration give the
named span tree with one unit id, parents and self times, and their
``trace.sync`` sites; under ``torch.profiler`` the spans are ``radegs::``
user annotations and the aten op count does not move; ``idle_by_span``
on a hand-made trace; the launch and build counters live in the tracer's
registry. On a card: the syncs a step and a view count equal the
synchronising operations ``torch.cuda.set_sync_debug_mode`` reports, and a
step crosses ``CARD_STEP_SITES``.
"""

import json
import warnings

import numpy as np
import pytest
import torch

from radegs_torch.core.camera import Camera
from radegs_torch.models import gaussian_model as gm
from radegs_torch.native import build
from radegs_torch.ops import bisect, blend, integrate
from radegs_torch.renderer import render
from radegs_torch.train import loop
from radegs_torch.train.config import ModelConfig, OptimizationConfig, PipelineConfig
from radegs_torch.utils import trace

W, H = 48, 32
MCFG = ModelConfig(kernel_size=0.1)
OCFG = OptimizationConfig(regularization_from_iter=0)
PCFG = PipelineConfig(max_per_tile=64, instance_budget=1 << 14)

# the step's spans and each one's parent (the CPU path: no kernel pieces)
STEP_TREE = {"step": None, "view": "step", "preprocess": "view", "binning": "view",
             "binning.depth_sort": "binning", "binning.duplicate": "binning",
             "binning.sort": "binning", "binning.ranges": "binning", "blend_fwd": "view",
             "normalize": "view", "loss": "step", "loss.ssim": "loss", "backward": "step",
             "blend_bwd": "backward", "adam": "step"}
# the sync sites a binning crosses on the CPU (the plain path's longest run too)
BINNING_SITES = {"binning.total": 1, "binning.keep": 2, "binning.max_tile_count": 1}
VIEW_SITES = {"camera.world_view": 2, **BINNING_SITES}
STEP_SITES = {**VIEW_SITES, "ssim.taps": 1, "fuse_3d_filter.prod_backward": 1}
# a step on the card: the preprocess kernels read the camera and differentiate
# the fused filter without the host (no camera.world_view, no
# fuse_3d_filter.prod_backward), the binning kernels read their totals once
# and take no tile count
CARD_STEP_SITES = {"binning.total": 1, "ssim.taps": 1}


class FakeEvent:
    """``torch.cuda.Event`` stand-in for a CPU step."""

    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass


def scene(device):
    rng = np.random.default_rng(3)
    pts = (rng.normal(size=(300, 3)) * 0.5).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, (300, 3)).astype(np.float32)
    state = gm.create_from_points(pts, cols, capacity=512, device=device)
    cam = Camera.look_at([0.0, 0.3, -3.0], [0, 0, 0], [0, 1, 0], 0.9, 0.7, W, H,
                         device=device)
    gt = torch.rand((3, H, W), generator=torch.Generator().manual_seed(4)).to(device)
    return state, cam, gt


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    trace.reset()
    yield scene("cpu")
    trace.reset()


def step_fn():
    return loop.make_train_step(MCFG, OCFG, PCFG, spatial_lr_scale=1.0)


def view(state, cam, device, events=None, budget=1 << 14):
    return render(state, cam, torch.zeros(3, device=device), kernel_size=0.1,
                  max_per_tile=64, instance_budget=budget, device=device, events=events)


def tree(spans):
    by_seq = {s["seq"]: s["name"] for s in spans}
    return {s["name"]: by_seq.get(s["parent"]) for s in spans}


def sites(u):
    return {k: n for k, (n, _) in u["sites"].items()}


def test_off_records_nothing_and_enters_no_record_function(cpu, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with tracing off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    state, cam, gt = cpu
    step_fn()(loop.init_train_state(state), cam, gt, torch.zeros(3), 0, W, H)
    view(state, cam, "cpu")
    assert trace.spans() == [] and trace.units() == []


def test_a_traced_step_gives_the_span_tree(cpu):
    state, cam, gt = cpu
    events = []
    step_fn()(loop.init_train_state(state), cam, gt, torch.zeros(3), 0, W, H, events=events)
    spans = trace.spans()
    assert tree(spans) == STEP_TREE and len(spans) == len(STEP_TREE)
    assert {s["unit"] for s in spans} == {trace.units()[0]["id"]}
    for s in spans:
        kids = [c for c in spans if c["parent"] == s["seq"]]
        assert s["self_ns"] == (s["t1_ns"] - s["t0_ns"]) - sum(c["t1_ns"] - c["t0_ns"]
                                                               for c in kids)
        assert all(s["t0_ns"] <= c["t0_ns"] and c["t1_ns"] <= s["t1_ns"] for c in kids)
    (u,) = trace.units()
    assert u["kind"] == "step" and u["allocs"] is None
    assert u["host_ns"] >= max(s["t1_ns"] - s["t0_ns"] for s in spans)
    assert u["counts"] == {"render.pass": 1}
    # the marks are the step's, as before
    assert [n for n, _ in events][:4] == ["start", "start", "preprocess", "binning"]


def test_sync_counts_equal_the_sites_crossed(cpu):
    state, cam, gt = cpu
    step_fn()(loop.init_train_state(state), cam, gt, torch.zeros(3), 0, W, H, events=[])
    view(state, cam, "cpu", events=[])
    step_u, view_u = trace.units()
    assert sites(step_u) == STEP_SITES and step_u["syncs"] == sum(STEP_SITES.values())
    assert view_u["kind"] == "view" and sites(view_u) == VIEW_SITES
    assert view_u["syncs"] == sum(VIEW_SITES.values())
    assert 0 <= view_u["blocked_ns"] <= view_u["host_ns"]
    s = trace.summary()
    assert s["units"]["step"]["syncs"] == sum(STEP_SITES.values())
    assert s["units"]["view"]["dispatch_ms"] == pytest.approx(
        (view_u["host_ns"] - view_u["blocked_ns"]) * 1e-6)
    assert s["sites"]["camera.world_view"]["n"] == 4


def test_a_traced_view_and_its_grow_loop(cpu):
    state, cam, _ = cpu
    view(state, cam, "cpu", events=[], budget=None)
    (u,) = trace.units()
    assert u["kind"] == "view" and u["counts"]["render.pass"] >= 1
    got = sites(u)
    passes = u["counts"]["render.pass"]
    assert got["render.grow"] >= 2 * passes
    assert {k: v for k, v in got.items() if k != "render.grow"} == {
        "camera.world_view": 2, **{k: v * passes for k, v in BINNING_SITES.items()}}
    spans = trace.spans()
    assert tree(spans)["view"] is None and tree(spans)["binning"] == "view"
    assert sum(s["name"] == "binning" for s in spans) == passes


def test_train_iterations_are_units_with_autotune_reads(cpu):
    state, cam, gt = cpu
    marks = []
    ocfg = OptimizationConfig(iterations=3, regularization_from_iter=0)
    loop.train(loop.SceneLike([(cam, gt, 0)], 1.0), state, MCFG, ocfg, PCFG, log_every=2,
               device="cpu", step_events=marks)
    us = trace.units()
    assert [u["kind"] for u in us] == ["iteration"] * 3 and len(marks) == 3
    assert "train.autotune" not in sites(us[0])
    assert sites(us[1])["train.autotune"] == 3 and sites(us[1])["train.log"] == 8
    assert sites(us[2])["train.autotune"] == 3
    names = tree([s for s in trace.spans() if s["unit"] == us[1]["id"]])
    assert names["step"] == "iteration" and names["train.autotune"] == "iteration"
    assert names["view"] == "step"


def chrome_trace(tmp_path, fn, name):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / f"{name}.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def test_spans_are_profiler_annotations_and_add_no_aten_op(cpu, tmp_path):
    from benchmark.tracing import reduce_trace

    state, cam, gt = cpu
    ts, step = loop.init_train_state(state), step_fn()
    ev_on = chrome_trace(tmp_path, lambda: step(ts, cam, gt, torch.zeros(3), 0, W, H,
                                                events=[]), "on")
    ev_off = chrome_trace(tmp_path, lambda: step(ts, cam, gt, torch.zeros(3), 0, W, H),
                          "off")
    for ev in (ev_on, ev_off):
        names = {e["name"] for e in ev if e.get("cat") == "user_annotation"}
        assert {"radegs::" + n for n in STEP_TREE} <= names
        assert "radegs::sync.binning.total" in names
        assert not any(e["name"].startswith("radegs::") for e in ev if e.get("cat") == "cpu_op")
    assert reduce_trace(ev_on, 1)["aten_ops_per_step"] == reduce_trace(ev_off, 1)[
        "aten_ops_per_step"]
    assert len(trace.units()) == 1  # only the call with events opened a unit


def test_idle_by_span_on_a_hand_made_trace():
    def x(cat, name, ts, dur, tid=1):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}

    events = [
        x("kernel", "k0", 0, 10), x("kernel", "k1", 20, 10), x("gpu_memcpy", "c", 35, 5),
        x("kernel", "k2", 38, 4), x("kernel", "k3", 100, 10), x("gpu_memset", "s", 130, 5),
        x("user_annotation", "radegs::step", 0, 120),
        x("user_annotation", "radegs::binning", 12, 13),
        x("user_annotation", "radegs::sync.binning.total", 14, 5),
        x("user_annotation", "radegs::walk", 60, 30, tid=2),  # the autograd thread
        x("user_annotation", "other", 31, 2), x("cpu_op", "aten::ge", 30, 4),
    ]
    got = trace.idle_by_span(events)
    # gaps: [10, 20] mid 15, [30, 35] mid 32.5, [42, 100] mid 71, [110, 130] mid 120
    assert got == {"walk": pytest.approx(58e-6), "sync.binning.total": pytest.approx(10e-6),
                   "step": pytest.approx(25e-6)}
    assert list(got)[0] == "walk"
    assert trace.idle_by_span(events[:1]) == {}
    late = events + [x("kernel", "k4", 200, 1)]
    assert trace.idle_by_span(late)[trace.OUTSIDE] == pytest.approx(65e-6)


def test_launch_and_build_counters_live_in_the_registry(cpu):
    assert trace.counters("launches.blend") is blend.LAUNCHES
    assert trace.counters("launches.integrate") is integrate.LAUNCHES
    assert trace.counters("launches.bisect") is bisect.LAUNCHES
    before = {m: dict(m.LAUNCHES) for m in (blend, integrate, bisect)}
    state, cam, gt = cpu
    step_fn()(loop.init_train_state(state), cam, gt, torch.zeros(3), 0, W, H, events=[])
    assert {m: dict(m.LAUNCHES) for m in before} == before  # no launch on the CPU
    wall = build.build_wall_s()
    trace.count("native", "build_s", 1.5)
    assert build.build_wall_s() == pytest.approx(wall + 1.5)
    trace.count("native", "build_s", -1.5)
    assert set(trace.summary()["counters"]) >= {"launches.blend", "launches.integrate",
                                                "launches.bisect", "native"}


@pytest.mark.cuda
def test_syncs_equal_the_sync_debug_warnings_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    state, cam, gt = scene(dev)
    ts, step = loop.init_train_state(state), step_fn()
    bg = torch.zeros(3, device=dev)
    for _ in range(2):
        ts, _ = step(ts, cam, gt, bg, 0, W, H)
    torch.cuda.synchronize()
    trace.reset()

    def warned(fn):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return sum("called a synchronizing CUDA operation" in str(w.message) for w in got)

    n_step = warned(lambda: step(ts, cam, gt, bg, 0, W, H, events=[]))
    n_view = warned(lambda: view(ts.gaussians, cam, dev, events=[]))
    n_grow = warned(lambda: view(ts.gaussians, cam, dev, events=[], budget=None))
    step_u, view_u, grow_u = trace.units()
    assert (step_u["syncs"], view_u["syncs"], grow_u["syncs"]) == (n_step, n_view, n_grow)
    assert sites(step_u) == CARD_STEP_SITES
    assert n_step > 0 and step_u["allocs"] is not None and step_u["alloc_retries"] == 0
