"""One run of one cell of ``BENCHMARK.json``:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of the checkout, on a machine with a CUDA card. It finds the
cell in ``BENCHMARK.json``, its configuration (the cell's ``config`` entry's
``file``) and its traffic mix (``benchmark/mixes/<traffic>.json``), runs the
mix's job (``jobs.kind(mix["kind"])``: one of ``jobs.py`` or a kind file,
``benchmark/kinds/<kind>.py``): set-up, a window of ``--seconds``, with
``--trace 1`` a profiled segment after it and the per-layer readers
(``benchmark/metrics/<metric>.py``); then the comparison with the plain
reference (``check.py``, limits in ``benchmark/limits/<cell>.json``). The
compared numbers go to standard error as its last lines; the result is the
last line of standard output. Without a card, or with fewer cards than the
cell asks for, it exits 2 and prints no result; with JAX or the JAX package
loaded it exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402

# one thread of host compute: the program's host work is dispatch, and idle
# pool threads only contend with it
os.environ.setdefault("OMP_NUM_THREADS", "1")

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "radegs_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_inputs(bench: dict, name: str):
    """(cell, configuration, mix) of the cell ``name``."""
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = load_json(os.path.join(ROOT, entry["file"]))
    mix = load_json(os.path.join(HERE, "mixes", f"{cell['traffic']}.json"))
    return cell, cfg, mix


def reader(name: str):
    """The ``read`` of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def in_cell(metric: dict, cell: str, reported=None) -> bool:
    """Whether the cell reports the metric: the cells its ``workloads``
    list; without one, an end-to-end metric is every cell's and a
    per-layer one goes with the end-to-end metric it moves (``reported``)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(bench, name, cfg, mix, seed, seconds, trace, device, t_start=None):
    """The result line (a dict) and the check lines of one run on ``device``."""
    import torch

    from benchmark import check, jobs

    job = jobs.kind(mix["kind"])
    if jobs.is_file_kind(job):
        job = job.run
    res = job(cfg, mix, seed, seconds, trace, device,
              T_START if t_start is None else t_start)
    metrics = {}
    for m in bench["end_to_end"]:
        if in_cell(m, name) and m["name"] in res["metrics"]:
            value = res["metrics"][m["name"]][0]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": None, "attempted": res["attempted"], "failed": res["failed"]}
    if trace:
        rec = res["record"]
        reported = set(metrics)
        per_layer = {}
        for m in bench["per_layer"]:
            if in_cell(m, name, reported):
                v = reader(m["name"])(rec)
                if v is not None:
                    per_layer[m["name"]] = {"value": v, "unit": m["unit"]}
        metrics = per_layer
        dev.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
    line.update(metrics=metrics, device=dev)
    if trace:
        line["breakdown"] = res["record"]["breakdown"]
    correct, checks = check.judge(res["numbers"], check.load_limits(name))
    line["correct"] = correct
    line["checks"] = {k: {kk: (v if v is None or math.isfinite(v) else repr(v))
                          for kk, v in c.items()} for k, c in checks.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, cfg, mix = cell_inputs(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: needs {cell['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    line = run_cell(bench, args.workload, cfg, mix, args.seed, args.seconds,
                    bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
