"""The kind file ``kinds/densify.py`` of the cell ``train-densify-3.7M`` at
its ``tiny`` size on the CPU: a run through ``run.run_cell``, untraced and
traced, against the line's schema; the traced window's event gives the
cell's four readings of the event (its device ms and its filter refresh's
from the program's marks, its roofline share, the rows it added); and
``calibrate.readings``' control path, where the program passes the cell's
limits and the control and each planted fault fail them."""

import time

import pytest
import torch

from benchmark import calibrate, check, jobs, run
from benchmark.tests.conftest import tiny
from benchmark.tests.test_benchmark_run import SEED, check_line

CELL = "train-densify-3.7M"
NEW = ("densify_ms.densify", "filter3d_ms.densify", "densify_roofline.densify",
       "rows_added_per_event.densify")


class HostEvent:
    """``torch.cuda.Event``'s timing on the host clock, so that the
    program's marks can be recorded on the CPU."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


@pytest.fixture
def marked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", HostEvent)
    monkeypatch.setattr(jobs.kind("densify"), "MARK_DEVICES", ("cuda", "cpu"))


def line_of(bench, trace):
    from radegs_torch.utils import trace as ptrace

    ptrace.reset()
    cfg, mix = tiny(bench, CELL)
    return run.run_cell(bench, CELL, cfg, mix, SEED, 1.5, trace, torch.device("cpu"), 0.0)


def test_tiny_is_small(bench):
    cfg, mix = tiny(bench, CELL)
    assert (cfg["width"], cfg["views"], cfg["start"]["capacity"]) == (48, 3, 2048)
    job = jobs.kind(mix["kind"])
    assert job.first_event(cfg) == 7100
    # the checked event must be the start's third step
    with pytest.raises(ValueError, match="7101"):
        job.first_event(dict(cfg, start=dict(cfg["start"], iteration=7099)))




def test_untraced_line(bench_all):
    line = line_of(bench_all, False)
    check_line(bench_all, CELL, line)
    assert set(line["metrics"]) == {"train_rays_per_s", "setup_s"}
    # the window runs from the step after the checked one to an event
    cfg, _ = tiny(bench_all, CELL)
    first = cfg["start"]["iteration"] + 4
    assert (first - 1 + line["attempted"]) % cfg["schedule"]["densification_interval"] == 0


def test_traced_line_reads_the_event(bench_all, marked):
    line = line_of(bench_all, True)
    check_line(bench_all, CELL, line)
    got = line["metrics"]
    assert set(NEW) <= set(got), sorted(got)
    assert 0 < got["filter3d_ms.densify"]["value"] < got["densify_ms.densify"]["value"]
    assert 0 < got["densify_roofline.densify"]["value"] < 100
    assert got["rows_added_per_event.densify"]["value"] > 0
    assert {"preprocess_ms.train", "backward_ms.train", "host_syncs_per_step.train",
            "aten_ops_per_step.train"} <= set(got)


def test_control_and_faults_fail_the_limits(bench):
    cfg, mix = tiny(bench, CELL)
    (rec,) = calibrate.readings(cfg, mix, [SEED], 1, 5.0, torch.device("cpu"))
    limits = check.load_limits(CELL)
    assert check.judge(rec["program"], limits)[0], rec["program"]
    assert rec["failed"] == 0 and rec["attempted"] >= 1
    for name in ("control", "split_kept", "unrefreshed", "inherited"):
        assert not check.judge(rec[name], limits)[0], (name, rec[name])
