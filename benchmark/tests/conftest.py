"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
root of the checkout. Tests that need a CUDA card carry the ``cuda`` marker
and skip inside the test where there is none."""

import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture(scope="session")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture(scope="session")
def bench_all(bench):
    """``BENCHMARK.json`` with the cells ``held/`` keeps for a later PR and
    their configurations, each cell added to the ``workloads`` of the
    metrics the file names for it."""
    with open(os.path.join(ROOT, "benchmark", "held", "host-bound-cells.json")) as f:
        held = json.load(f)
    out = dict(bench, workloads=bench["workloads"] + held["workloads"],
               configs=bench["configs"] + held["configs"])
    for key in ("end_to_end", "per_layer"):
        out[key] = [dict(m, workloads=m["workloads"] + [c for c, names in held["joins"].items()
                                                        if m["name"] in names])
                    if "workloads" in m else m for m in bench[key]]
    return out


def tiny(bench, cell):
    """(cfg, mix) of ``cell`` cut to a size the CPU runs in seconds: a kind
    file's cells by its ``tiny``; else the configuration's generator, SH
    degree, opacity and filters at 48 x 32 pixels, 3 views; an orbit of 8
    poses. Training keeps 4000 points: the change's norm gap moves by
    1 / (2 n) when one of n splats' Adam steps differs (a gate that rounds
    the other way), 8e-4 at 600 points, above the cells' limits."""
    from benchmark import jobs, run

    _, cfg, mix = run.cell_inputs(bench, cell)
    job = jobs.kind(mix["kind"])
    if jobs.is_file_kind(job):
        return job.tiny(cfg, mix)
    n = 4000 if cell.startswith("train") else 600
    cfg = dict(cfg, points=dict(cfg["points"], n=n), capacity=4096 if n > 1024 else 1024, width=48, height=32,
               views=3, pipeline={"max_per_tile": 64})
    if mix["kind"] == "orbit":
        mix = dict(mix, poses=8, sample_within=3, sample_views=2, trace_views=2,
                   warmup_views=1)
    return cfg, mix


@pytest.fixture(autouse=True)
def _few_threads():
    """Few torch threads a test, so that parallel test workers do not crowd
    the cores."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
