"""A run end to end on the CPU at a tiny size (``run.run_cell`` skips the
look for a card): the last line's schema, ``correct`` true on the program
as it is, and false with the timed path broken underneath (a step that
returns its state unchanged, half of the image left out, an answer
altered where it is produced, one map of a view altered alone) and with the control (the reference in
bfloat16 in the program's place). The limits are the cells' own."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import check, jobs, run
from benchmark.tests.conftest import ROOT, tiny

CELLS = ["train-surface-1.2M", "train-cloud-100k", "serve-surface-1.2M", "serve-cloud-100k"]
SEED = 2 ** 31 + 77


def line_of(bench, cell, trace=False, seed=SEED):
    cfg, mix = tiny(bench, cell)
    return run.run_cell(bench, cell, cfg, mix, seed, 0.3, trace, torch.device("cpu"), 0.0)


@pytest.mark.parametrize("cell", CELLS)
def test_line_schema_and_correct(bench_all, cell):
    check_line(bench_all, cell, line_of(bench_all, cell, trace=cell.endswith("100k")))


def check_line(bench_all, cell, line):
    """The line's keys in order, ``correct`` with every number under its
    limit, and the cell's metrics: its per-layer ones traced, else its
    end-to-end ones."""
    assert list(line) [:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["checks"]) == set(check.load_limits(cell))
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    json.loads(json.dumps(line))
    if "breakdown" in line:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(line["device"]) >= {"busy_s", "window_s"}
        want = {m["name"] for m in bench_all["per_layer"] if cell in m["workloads"]}
        assert set(line["metrics"]) <= want and line["metrics"]
    else:
        want = {m["name"] for m in bench_all["end_to_end"]
                if cell in m.get("workloads", [cell])}
        assert set(line["metrics"]) == want and "setup_s" in want


def unchanged_step(monkeypatch):
    import radegs_torch.train.loop as loop

    real = loop.make_train_step

    def make(*a, **k):
        step = real(*a, **k)

        def same(ts, *args, **kw):
            _, m = step(ts, *args, **kw)
            return ts, m

        return same

    monkeypatch.setattr(loop, "make_train_step", make)


def half_loss(monkeypatch):
    import radegs_torch.train.loop as loop

    l1, ss = loop.l1_loss, loop.ssim

    def half(f):
        return lambda a, b, *r: f(a[:, : a.shape[1] // 2], b[:, : b.shape[1] // 2], *r)

    monkeypatch.setattr(loop, "l1_loss", half(l1))
    monkeypatch.setattr(loop, "ssim", half(ss))


def altered_gradient(monkeypatch):
    import radegs_torch.ops.rasterize as ras
    from radegs_torch.core.projection import COLUMNS

    real = ras.blend_backward

    def altered(*a, **k):
        # the (P, 26) gradient buffer, its colour columns scaled
        g = real(*a, **k).clone()
        g[:, COLUMNS["rgb"]] *= 1.5
        return g

    monkeypatch.setattr(ras, "blend_backward", altered)


def render_fault(kind):
    def patch(monkeypatch):
        import radegs_torch.renderer as rend

        real = rend.render
        first = []

        def render(*a, **k):
            out = real(*a, **k)
            if kind == "stale":
                first.append(out)
                return first[0]
            out = dict(out)
            if kind == "half":
                H = out["render"].shape[1]
                for m in check.MAPS:
                    out[m] = torch.cat([out[m][:, : H // 2], torch.zeros_like(out[m][:, H // 2:])],
                                       1)
            elif kind in ("median_depth", "mask", "median_coord"):
                # one map's answer altered where it is produced, the others sound
                out[kind] = out[kind] * 1.01
            else:
                out["render"] = out["render"].clone()
                out["render"][:, 3, 5] += 0.5
            return out

        monkeypatch.setattr(rend, "render", render)

    return patch


@pytest.mark.parametrize("cell,fault", [
    ("train-surface-1.2M", unchanged_step), ("train-surface-1.2M", half_loss),
    ("train-surface-1.2M", altered_gradient), ("train-cloud-100k", unchanged_step),
    ("train-cloud-100k", half_loss), ("train-cloud-100k", altered_gradient),
    ("serve-surface-1.2M", render_fault("stale")), ("serve-surface-1.2M", render_fault("half")),
    ("serve-surface-1.2M", render_fault("altered")), ("serve-cloud-100k", render_fault("stale")),
    ("serve-cloud-100k", render_fault("half")), ("serve-cloud-100k", render_fault("altered")),
    ("serve-surface-1.2M", render_fault("median_depth")),
    ("serve-surface-1.2M", render_fault("mask")),
    ("serve-cloud-100k", render_fault("median_coord")),
])
def test_broken_timed_path_is_not_correct(bench_all, monkeypatch, cell, fault):
    fault(monkeypatch)
    line = line_of(bench_all, cell)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(bench_all, cell):
    """The reference in bfloat16 put in the program's place fails a limit."""
    from benchmark.calibrate import serve_control
    from benchmark.reference import fp32

    cfg, mix = tiny(bench_all, cell)
    dev = torch.device("cpu")
    if mix["kind"] == "train":
        pts, cols, _, gt = jobs.program.inputs(cfg, SEED, dev)
        order = jobs.scene.first_views(cfg["views"], 3, SEED)
        with fp32():
            ref = jobs.reference_train(cfg, pts, cols, gt, order, dev)
            low = jobs.reference_train(cfg, pts, cols, gt, order, dev, dtype=torch.bfloat16)
        numbers = check.train_numbers(low, ref)
    else:
        numbers = serve_control(cfg, mix, SEED, dev)
    ok, checks = check.judge(numbers, check.load_limits(cell))
    assert not ok, checks


def test_no_card_exits_nonzero_without_a_line(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.cuda
def test_cell_on_the_card(bench_all):
    """One tiny run of each kind on the card (CUDA kernels, events, trace)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell in ("train-cloud-100k", "serve-cloud-100k"):
        cfg, mix = tiny(bench_all, cell)
        cfg = dict(cfg, width=160, height=96)
        line = run.run_cell(bench_all, cell, cfg, mix, SEED, 0.5, True, torch.device("cuda", 0))
        assert line["correct"] is True, line["checks"]
        assert line["device"]["busy_s"] > 0
