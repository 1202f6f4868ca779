"""``BENCHMARK.json`` against the benchmark's contract: keys, names, units,
bounds, files found by name, and the run's time budget."""

import json
import os
import re

from benchmark.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def line_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and len(bench["command"]) <= 32
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line_ok(c["source"]) and line_ok(c["why"]) and c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
    cfgs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfgs and w["chips"] == 1 and line_ok(w["why"])
        assert os.path.exists(os.path.join(ROOT, "benchmark", "mixes", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(ROOT, "benchmark", "limits", w["name"] + ".json"))
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {w["config"] for w in bench["workloads"]} == cfgs
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert set(e2e) == {"train_rays_per_s", "views_per_s", "view_ms_p95", "setup_s"}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and line_ok(m["layer"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:  # every cell: setup_s, another end-to-end metric, a per-layer one
        assert sum(cell in m.get("workloads", cells) for m in bench["end_to_end"]) >= 2
        assert any(cell in m["workloads"] for m in bench["per_layer"])
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert len(json.dumps(bench)) < 64 * 1024


def test_held_cells_fit_the_benchmark(bench, bench_all):
    """The cells held for a later PR use the benchmark's configurations,
    mixes, readers and limits, and name no metric twice."""
    names = [m["name"] for m in bench_all["end_to_end"] + bench_all["per_layer"]]
    assert len(names) == len(set(names))
    cfgs = {c["name"] for c in bench_all["configs"]}
    for w in bench_all["workloads"]:
        assert w["config"] in cfgs and NAME.match(w["name"]) and line_ok(w["why"])
        assert os.path.exists(os.path.join(ROOT, "benchmark", "limits", w["name"] + ".json"))
    for m in bench_all["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))


def test_full_check_fits_the_day(bench):
    """A full check at 24 cells fits 43200 s."""
    rs = bench["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
