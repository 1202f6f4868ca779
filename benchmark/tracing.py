"""What a traced run reads: the program's CUDA-event marks (``events=`` of
the train step and of ``renderer.render``) cut into stages, and a
``torch.profiler`` trace reduced to device busy time, kernel time by name,
aten op counts and the idle gaps with the host op running in each.

The stage arithmetic is a copy of ``radegs_torch/scripts/bench_breakdown.py``
(``STAGE_OF``, ``step_stages``) and the busy-time union a copy of
``bench.device_busy_ms``, so that the yardstick stays where it is when the
program changes. Where the host's dispatch bounds a step, an event is
recorded when the host reaches it, so a stage's milliseconds are the time
its dispatch took, not its device time.
"""

from __future__ import annotations

import json
import os
import statistics
import tempfile

# a mark -> the stage that ends at it (a stage runs from the previous mark)
STAGE_OF = {
    "start": "preprocess",
    "preprocess": "preprocess",
    "binning": "binning",
    "pack_features": "pack_align",
    "blend": "blend_fwd",
    "normalize": "loss_tail",
    "render": "loss_tail",
    "loss": "loss_tail",
    "tail_backward": "backward",
    "bwd_features": "backward",
    "pack_aux": "backward",
    "instance_segments": "backward",
    "bwd_walk": "backward",
    "bwd_segment_sum": "backward",
    "backward": "backward",
    "adam": "adam_stats",
    "stats": "adam_stats",
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def step_stages(events, stage_of: dict = STAGE_OF) -> dict:
    """One step's (mark, torch.cuda.Event) list -> ms per stage (summed over
    its marks). Every mark after the first must be in ``stage_of``: a kind
    file whose program records marks of its own passes ``{**STAGE_OF,
    **its_marks}``, and a mark no one declared raises, so that a new mark
    inside a stage cannot take time out of it unseen. The events must have
    completed."""
    ms: dict = {}
    for (_, a), (name, b) in zip(events, events[1:]):
        if name not in stage_of:
            raise KeyError(f"mark {name!r} ends no declared stage")
        stage = stage_of[name]
        ms[stage] = ms.get(stage, 0.0) + a.elapsed_time(b)
    return ms


def stage_medians(steps) -> dict:
    """The median over steps of each stage's ms (a stage a step lacks counts 0)."""
    if not steps:
        return {}
    names = {k for s in steps for k in s}
    return {k: statistics.median([s.get(k, 0.0) for s in steps]) for k in sorted(names)}


def device_spans(events):
    """Sorted (start, end) us of the device's kernels, copies and sets."""
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)


def busy_and_gaps(spans):
    """(busy us: the union of the spans, [(gap start, gap end), ...] between them)."""
    if not spans:
        return 0.0, []
    busy, gaps = 0.0, []
    lo, hi = spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            gaps.append((hi, a))
            lo = a
        hi = max(hi, b)
    return busy + hi - lo, gaps


def host_op_at(cpu_ops, t):
    """The innermost host op (shortest ``cpu_op`` span) running at ``t``."""
    best = None
    for ts, te, name in cpu_ops:
        if ts <= t <= te and (best is None or te - ts < best[1] - best[0]):
            best = (ts, te, name)
    return best[2] if best else "host outside any op"


def reduce_trace(events, n_steps: int) -> dict:
    """A Chrome trace's events -> the traced run's record: ``busy_s`` (union
    of device intervals), ``window_s`` (first device start to last device
    end), ``kernels`` {name: seconds}, ``aten_ops`` per step, and the
    ``breakdown`` lists (top 10 device ops by time; the 10 longest idle gaps,
    each named by the host op running at its middle)."""
    spans = device_spans(events)
    busy, gaps = busy_and_gaps(spans)
    kernels: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            kernels[e["name"]] = kernels.get(e["name"], 0.0) + e["dur"] * 1e-6
    cpu_ops = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
               if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    aten = sum(1 for *_, n in cpu_ops if n.startswith("aten::"))
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    window = (spans[-1][1] - spans[0][0]) * 1e-6 if spans else 0.0
    return {
        "busy_s": busy * 1e-6,
        "window_s": window,
        "kernels": kernels,
        "aten_ops_per_step": aten / max(n_steps, 1),
        "breakdown": {
            "device_ops": sorted(([k, v] for k, v in kernels.items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": [[host_op_at(cpu_ops, 0.5 * (a + b)), (b - a) * 1e-6]
                          for a, b in longest],
        },
    }


def kernel_seconds(kernels: dict, *parts: str) -> float:
    """Seconds of the device ops whose name holds any of ``parts``."""
    return sum(v for k, v in kernels.items() if any(p in k for p in parts))


def profile(fn, n_steps: int, on_card: bool = True) -> dict:
    """Run ``fn`` (which does ``n_steps`` steps and synchronises) under
    ``torch.profiler``; the trace goes to a temporary file under ``TMPDIR``,
    is reduced (``reduce_trace``) and deleted."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with tprofile(activities=acts) as prof:
        fn()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return reduce_trace(events, n_steps)
