"""The readers of the program's tracer (``benchmark/metrics/<name>.py``
over ``radegs_torch.utils.trace.summary()``): None with nothing traced and
with a program that has no tracer, the right field of a known summary
otherwise, and each metric's entry in ``BENCHMARK.json``."""

import sys

import pytest

from benchmark import run

# metric -> (unit kind, summary field)
READS = {
    "dispatch_ms.train": ("step", "dispatch_ms"),
    "dispatch_ms.serve": ("view", "dispatch_ms"),
    "host_blocked_ms.train": ("step", "blocked_ms"),
    "host_blocked_ms.serve": ("view", "blocked_ms"),
    "host_syncs_per_step.train": ("step", "syncs"),
    "host_syncs_per_view.serve": ("view", "syncs"),
    "device_allocs_per_step.train": ("step", "allocs"),
    "device_allocs_per_view.serve": ("view", "allocs"),
}
KNOWN = {"units": {
    "step": {"n": 245, "host_ms": 61.5, "blocked_ms": 7.25, "dispatch_ms": 54.25, "syncs": 8,
             "allocs": 0, "alloc_retries": 0, "counts": {"render.pass": 1}},
    "view": {"n": 670, "host_ms": 21.0, "blocked_ms": 3.5, "dispatch_ms": 17.5, "syncs": 5,
             "allocs": 2, "alloc_retries": 0, "counts": {"render.pass": 1}},
}, "sites": {}, "spans": {}, "counters": {}, "dropped": {"spans": 0, "units": 0}}


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
def test_reads_a_known_summary(traced, monkeypatch, name):
    monkeypatch.setattr(traced, "summary", lambda: KNOWN)
    kind, field = READS[name]
    assert run.reader(name)({"stages": {}}) == KNOWN["units"][kind][field]
    other = {"units": {k: v for k, v in KNOWN["units"].items() if k != kind}}
    monkeypatch.setattr(traced, "summary", lambda: other)
    assert run.reader(name)({}) is None


def test_entries_in_the_benchmark(bench):
    """Each metric's entry, found by name: it lists every cell of its unit's
    kind (mix ``train`` for a step, ``orbit`` for a view), lower is better,
    what it moves and where it comes from."""
    per = {m["name"]: m for m in bench["per_layer"]}
    unit_of = {"train": "step", "orbit": "view"}
    cells = {"step": set(), "view": set()}
    for w in bench["workloads"]:
        unit = unit_of.get(run.cell_inputs(bench, w["name"])[2]["kind"])
        if unit:
            cells[unit].add(w["name"])
    assert cells["step"] and cells["view"]
    for name, (unit, _) in READS.items():
        m = per[name]
        assert set(m["workloads"]) >= cells[unit] and m["better"] == "lower"
        assert m["moves"] == ("train_rays_per_s" if unit == "step" else "views_per_s")
        assert m["source"] == ("program_counter" if "_per_" in name else "program_span")
