"""The stage and busy-share arithmetic of ``tracing.py``."""

import pytest

from benchmark import tracing


class _Ev:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


def test_step_stages_sum_marks_into_stages():
    marks = [("start", 0.0), ("start", 1.0), ("preprocess", 3.0), ("binning", 4.5),
             ("pack_features", 4.6), ("blend", 5.0), ("normalize", 5.5), ("render", 5.6),
             ("loss", 7.0), ("tail_backward", 7.5), ("bwd_walk", 9.0), ("backward", 12.0),
             ("adam", 13.0), ("stats", 13.5)]
    ms = tracing.step_stages([(n, _Ev(t)) for n, t in marks])
    assert ms == pytest.approx({"preprocess": 3.0, "binning": 1.5, "pack_align": 0.1,
                                "blend_fwd": 0.4, "loss_tail": 2.0, "backward": 5.0,
                                "adam_stats": 1.5})
    assert sum(ms.values()) == pytest.approx(13.5)
    assert tracing.stage_medians([{"a": 1.0}, {"a": 3.0, "b": 2.0}, {"a": 2.0}]) == \
        {"a": 2.0, "b": 0.0}


def test_busy_union_and_gaps():
    spans = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)]
    busy, gaps = tracing.busy_and_gaps(spans)
    assert busy == 12 + 10 + 1
    assert gaps == [(12, 20), (30, 40)]


def test_reduce_trace_names_gaps_by_host_op():
    ev = [
        {"ph": "X", "cat": "kernel", "name": "void blend_fwd_kernel<2>(...)", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 30, "dur": 5},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 50, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 10, "dur": 25},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 12, "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 36, "dur": 20},
        {"ph": "X", "cat": "cpu_op", "name": "autograd::engine", "ts": 36, "dur": 1},
    ]
    r = tracing.reduce_trace(ev, 2)
    assert r["busy_s"] == pytest.approx(25e-6) and r["window_s"] == pytest.approx(60e-6)
    assert r["aten_ops_per_step"] == 1.5
    assert r["breakdown"]["idle_gaps"] == [["aten::sort", pytest.approx(20e-6)],
                                          ["aten::copy_", pytest.approx(15e-6)]]
    assert r["breakdown"]["device_ops"][0][0] == "void blend_fwd_kernel<2>(...)"
    assert tracing.kernel_seconds(r["kernels"], "blend_fwd_kernel") == pytest.approx(10e-6)
