"""A job kind brought as a file (``jobs.kind``): a kind file, a mix, a
limits file and an entry in ``BENCHMARK.json``, none of them an edit, run
through ``run.run_cell`` at the kind's ``tiny`` size and through
``calibrate``'s control path; an unknown kind names the file it looked for;
a mark no one declared raises in ``tracing.step_stages``;
``program.configs`` gives the three configuration files today's
objects."""

import json
import os
import shutil

import pytest
import torch

from benchmark import calibrate, check, jobs, program, run, tracing
from benchmark.tests.conftest import ROOT, tiny
from benchmark.tests.test_benchmark_run import SEED, check_line

# a minimal job that keeps the contract: the orbit viewer under another name
KIND = '''
from benchmark import calibrate, jobs

CALIBRATE_SECONDS = 0.2


def run(cfg, mix, seed, seconds, trace, device, t_start):
    return jobs.run_orbit(cfg, mix, seed, seconds, trace, device, t_start)


def controls(cfg, mix, seed, device, res):
    assert res["numbers"]
    return {"control": calibrate.serve_control(cfg, mix, seed, device)}


def tiny(cfg, mix):
    cfg = dict(cfg, points=dict(cfg["points"], n=600), capacity=1024, width=48, height=32,
               views=3, pipeline={"max_per_tile": 64})
    return cfg, dict(mix, poses=8, sample_within=3, sample_views=2, trace_views=2,
                     warmup_views=1)
'''
CELL, LIKE = "serve-file", "serve-surface-1.2M"


@pytest.fixture
def added(bench, tmp_path, monkeypatch):
    """``BENCHMARK.json`` with the cell ``serve-file``: the kind file
    ``kinds/orbit_file.py``, the mix ``mixes/orbit-file.json``, the limits of
    ``serve-surface-1.2M``, and the metrics of that cell (their readers
    linked), all under ``tmp_path``, which the lookups are pointed at."""
    for d in ("kinds", "mixes", "limits"):
        (tmp_path / d).mkdir()
    (tmp_path / "kinds" / "orbit_file.py").write_text(KIND)
    with open(os.path.join(ROOT, "benchmark", "mixes", "orbit.json")) as f:
        mix = dict(json.load(f), kind="orbit_file")
    (tmp_path / "mixes" / "orbit-file.json").write_text(json.dumps(mix))
    shutil.copy(os.path.join(ROOT, "benchmark", "limits", f"{LIKE}.json"),
                tmp_path / "limits" / f"{CELL}.json")
    (tmp_path / "metrics").symlink_to(os.path.join(ROOT, "benchmark", "metrics"))
    monkeypatch.setattr(jobs, "KIND_DIR", str(tmp_path / "kinds"))
    monkeypatch.setattr(run, "HERE", str(tmp_path))
    monkeypatch.setattr(check, "HERE", str(tmp_path))
    out = dict(bench, workloads=bench["workloads"] + [
        {"name": CELL, "config": "dtu49-surface-1.2M", "traffic": "orbit-file", "chips": 1,
         "why": "the serve cell's viewer as a kind file"}])
    for key in ("end_to_end", "per_layer"):
        out[key] = [dict(m, workloads=m["workloads"] + [CELL])
                    if LIKE in m.get("workloads", []) else m for m in bench[key]]
    return out


@pytest.mark.parametrize("trace", [False, True])
def test_a_kind_file_runs_a_cell(added, trace):
    cfg, mix = tiny(added, CELL)
    assert (cfg["width"], mix["poses"]) == (48, 8)
    line = run.run_cell(added, CELL, cfg, mix, SEED, 0.3, trace, torch.device("cpu"), 0.0)
    check_line(added, CELL, line)
    assert ("breakdown" in line) == trace
    assert set(jobs.KINDS) == {"train", "orbit"}


def test_a_kind_file_is_calibrated_by_its_controls(added):
    cfg, mix = tiny(added, CELL)
    (rec,) = calibrate.readings(cfg, mix, [SEED], 1, 5.0, torch.device("cpu"))
    limits = check.load_limits(CELL)
    assert check.judge(rec["program"], limits)[0] and rec["attempted"] >= 1
    assert not check.judge(rec["control"], limits)[0], rec["control"]


def test_kind_lookup(tmp_path, monkeypatch):
    assert jobs.kind("train") is jobs.run_train and jobs.kind("orbit") is jobs.run_orbit
    monkeypatch.setattr(jobs, "KIND_DIR", str(tmp_path))
    with pytest.raises(LookupError, match=str(tmp_path / "densify.py")):
        jobs.kind("densify")
    (tmp_path / "half.py").write_text("def run(*a):\n    pass\n")
    with pytest.raises(LookupError, match="controls, tiny, CALIBRATE_SECONDS"):
        jobs.kind("half")
    # loaded once: module state is not rebuilt by a second lookup
    (tmp_path / "whole.py").write_text(KIND)
    assert jobs.kind("whole") is jobs.kind("whole")
    # a kind file cannot hide behind a kind of jobs.py
    (tmp_path / "orbit.py").write_text(KIND)
    with pytest.raises(LookupError, match="orbit.py"):
        jobs.kind("orbit")


def test_controls_may_not_overwrite_the_record(added):
    with open(jobs.KIND_DIR + "/orbit_file.py", "a") as f:
        f.write("\n\ndef controls(cfg, mix, seed, device, res):\n"
                "    return {'control': {}, 'program': {}}\n")
    cfg, mix = tiny(added, CELL)
    with pytest.raises(ValueError, match="program"):
        calibrate.readings(cfg, mix, [SEED], 1, 5.0, torch.device("cpu"))


class _Ev:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


def test_an_undeclared_mark_raises():
    marks = [("start", 0.0), ("preprocess", 1.0), ("adam", 2.0), ("stats", 2.5),
             ("densify", 6.0), ("reset_opacity", 6.5)]
    events = [(n, _Ev(t)) for n, t in marks]
    with pytest.raises(KeyError, match="densify"):
        tracing.step_stages(events)
    # a kind file declares its program's own marks
    ms = tracing.step_stages(events, {**tracing.STAGE_OF, "densify": "densify",
                                      "reset_opacity": "densify"})
    assert ms == pytest.approx({"preprocess": 1.0, "adam_stats": 1.5, "densify": 4.0})


def test_configs_of_the_files_are_todays(bench):
    from radegs_torch.train.config import ModelConfig, OptimizationConfig, PipelineConfig

    files = [c["file"] for c in bench["configs"]]
    files.append("benchmark/configs/dtu49-cloud-100k.json")
    assert len(set(files)) == 3
    for f in files:
        with open(os.path.join(ROOT, f)) as fh:
            cfg = json.load(fh)
        assert program.configs(cfg) == (ModelConfig(kernel_size=cfg["kernel_size"]),
                                        OptimizationConfig(regularization_from_iter=0),
                                        PipelineConfig(**cfg["pipeline"]))
