"""The readers of the binning's instance gauge (``instances_per_step.train``,
``instances_per_view.serve``, over ``radegs_torch.utils.trace.summary()``):
None with nothing traced, with a program that has no tracer and with one
whose tracer has no gauges (the summary of a program before them); the
median in millions otherwise; their entries in ``BENCHMARK.json``; and a
traced run of ``train-surface-6.1M`` at a tiny size."""

import sys

import pytest
import torch

from benchmark import run
from benchmark.tests.conftest import tiny

READS = {"instances_per_step.train": "step", "instances_per_view.serve": "view"}
UNIT = {"step": {"n": 245, "syncs": 8, "counts": {"render.pass": 1}}}
KNOWN = {"units": {
    "step": dict(UNIT["step"], gauges={"binning.instances": 8_250_000,
                                       "binning.budget_cut": 0}),
    "view": dict(UNIT["step"], syncs=3, gauges={"binning.instances": 8_100_000.5,
                                                "binning.budget_cut": 0}),
}}
BEFORE = {"units": {"step": UNIT["step"], "view": dict(UNIT["step"], syncs=3)}}


@pytest.fixture
def traced():
    from radegs_torch.utils import trace

    trace.reset()
    yield trace
    trace.reset()


@pytest.mark.parametrize("name", sorted(READS))
def test_none_with_nothing_traced(traced, name):
    assert run.reader(name)({}) is None


@pytest.mark.parametrize("name", sorted(READS))
def test_none_without_the_tracer(monkeypatch, name):
    monkeypatch.setitem(sys.modules, "radegs_torch.utils.trace", None)
    assert run.reader(name)({}) is None


@pytest.mark.parametrize("name", sorted(READS))
def test_none_from_a_program_without_gauges(traced, monkeypatch, name):
    monkeypatch.setattr(traced, "summary", lambda: BEFORE)
    assert run.reader(name)({}) is None


@pytest.mark.parametrize("name", sorted(READS))
def test_reads_the_median_in_millions(traced, monkeypatch, name):
    monkeypatch.setattr(traced, "summary", lambda: KNOWN)
    want = KNOWN["units"][READS[name]]["gauges"]["binning.instances"] / 1e6
    assert run.reader(name)({"stages": {}}) == want


def test_entries_in_the_benchmark(bench):
    per = {m["name"]: m for m in bench["per_layer"]}
    step, view = per["instances_per_step.train"], per["instances_per_view.serve"]
    assert step["workloads"] == ["train-surface-1.2M", "train-surface-6.1M"]
    assert view["workloads"] == ["serve-surface-1.2M"]
    assert step["moves"] == "train_rays_per_s" and view["moves"] == "views_per_s"
    for m in (step, view):
        assert m["source"] == "program_counter" and m["better"] == "lower"
        assert m["layer"] == per["binning_ms.train"]["layer"]
    assert list(per)[-2:] == list(READS)
    # the new cell joins every metric of a train cell
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in [e2e["train_rays_per_s"]] + [m for m in bench["per_layer"]
                                          if m["name"].endswith(".train")]:
        assert m["workloads"][-1] == "train-surface-6.1M", m["name"]


def test_a_traced_tiny_run_of_the_new_cell_reads_its_steps(bench):
    """On a card the window's steps are traced and the line reads their
    gauge; on the CPU no step is traced, and the line leaves it out."""
    cell = "train-surface-6.1M"
    cfg, mix = tiny(bench, cell)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    line = run.run_cell(bench, cell, cfg, mix, 2 ** 31 + 101, 0.3, True, dev, 0.0)
    assert line["correct"] is True and line["failed"] == 0
    if dev.type == "cuda":
        got = line["metrics"]["instances_per_step.train"]
        assert got["unit"] == "M-instances/step" and 0 < got["value"] < 1
    else:
        assert "instances_per_step.train" not in line["metrics"]
