"""The kind file ``kinds/appearance.py`` of the cell ``train-appearance-3.0M``
at its ``tiny`` size on the CPU: a run through ``run.run_cell``, untraced
and traced, `correct` against the cell's limits and the line's schema; the
traced window's marks give the three appearance stages (the roofline reads
device kernels, of which a CPU trace has none: ``conv_seconds`` and its
reader are held to a hand-made trace); the control in bfloat16 and each
planted fault fail the limits (the TF32 control is a no-op off a card: its
readings come from the card's calibration, ``PERF.md``);
``appearance_flops`` against a hand count of the seven convolutions at 960
x 512."""

import pytest
import torch

from benchmark import appearance_flops, calibrate, check, jobs, roofline, run
from benchmark.tests.conftest import tiny
from benchmark.tests.test_benchmark_densify_kind import HostEvent
from benchmark.tests.test_benchmark_run import SEED, check_line

CELL = "train-appearance-3.0M"
STAGES = ("appearance_ms.appearance", "appearance_bwd_ms.appearance",
          "appearance_adam_ms.appearance")
ROOFLINE = "appearance_roofline.appearance"


@pytest.fixture
def marked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", HostEvent)
    monkeypatch.setattr(jobs.kind("appearance"), "MARK_DEVICES", ("cuda", "cpu"))


def line_of(bench, trace):
    from radegs_torch.utils import trace as ptrace

    ptrace.reset()
    cfg, mix = tiny(bench, CELL)
    return run.run_cell(bench, CELL, cfg, mix, SEED, 0.5, trace, torch.device("cpu"), 0.0)


def test_tiny_is_small(bench):
    cfg, mix = tiny(bench, CELL)
    assert (cfg["width"], cfg["height"], cfg["views"], cfg["capacity"]) == (64, 48, 3, 4096)
    assert jobs.kind(mix["kind"]).crop(cfg) == (32, 64)
    full = run.cell_inputs(bench, CELL)[1]
    assert jobs.kind(mix["kind"]).crop(full) == (512, 960)


def test_untraced_line(bench_all):
    line = line_of(bench_all, False)
    check_line(bench_all, CELL, line)
    assert set(line["metrics"]) == {"train_rays_per_s", "setup_s"}
    assert {"app_grad_gap", "app_change_gap"} <= set(line["checks"])


def test_traced_line_reads_the_appearance(bench_all, marked):
    line = line_of(bench_all, True)
    check_line(bench_all, CELL, line)
    got = line["metrics"]
    assert set(STAGES) <= set(got), sorted(got)
    for name in STAGES:
        assert got[name]["value"] > 0, name
    assert ROOFLINE not in got  # no device kernels off the card
    assert {"preprocess_ms.train", "backward_ms.train", "adam_stats_ms.train",
            "host_syncs_per_step.train", "aten_ops_per_step.train"} <= set(got)


def test_control_and_faults_fail_the_limits(bench):
    cfg, mix = tiny(bench, CELL)
    (rec,) = calibrate.readings(cfg, mix, [SEED], 1, 5.0, torch.device("cpu"))
    limits = check.load_limits(CELL)
    assert check.judge(rec["program"], limits)[0], rec["program"]
    assert rec["failed"] == 0 and rec["attempted"] >= 1
    for name in ("control", "dssim_transformed", "other_row", "no_app_adam"):
        assert not check.judge(rec[name], limits)[0], (name, rec[name])
    assert set(rec["tf32"]) == set(rec["program"])


def test_least_time_is_the_seven_convolutions():
    # (Cin, Cout, output pixels) at the 960 x 512 crop, by hand: conv_in at
    # 30 x 16, the four upsample convs at 60 x 32 ... 480 x 256, conv_mid
    # and conv_out at 960 x 512
    convs = [(67, 256, 480), (64, 128, 1920), (32, 64, 7680), (16, 32, 30720),
             (8, 16, 122880), (16, 16, 491520), (16, 3, 491520)]
    assert appearance_flops.convs(512, 960) == convs
    fwd = sum(2 * 9 * a * b * n for a, b, n in convs)
    assert abs(fwd - 3.97e9) < 0.01e9
    byts = sum(4 * n * (2 * a + 2 * b + a) for a, b, n in convs)
    want = max(3 * fwd / roofline.PEAK_FP32, byts / roofline.PEAK_BYTES)
    assert appearance_flops.least_s(512, 960) == pytest.approx(want, rel=1e-12)
    assert 3 * fwd / roofline.PEAK_FP32 > byts / roofline.PEAK_BYTES  # operations bound it
    assert appearance_flops.least_s(512, 960) == pytest.approx(1.779e-4, rel=1e-3)


def op(name, tid, ts, dur):
    return {"ph": "X", "cat": "cpu_op", "name": name, "tid": tid, "ts": ts, "dur": dur}


def launch(tid, ts, corr, cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "tid": tid, "ts": ts, "dur": 2,
            "args": {"correlation": corr}}


def kernel(name, corr, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "tid": 7, "ts": 1000 + corr, "dur": dur,
            "args": {"correlation": corr}}


def test_conv_seconds_and_the_roofline_read_the_networks_kernels():
    """A hand-made trace: the network's forward (main thread) and backward
    (autograd thread, a driver launch among them) count; the SSIM filter's
    backward (a depthwise kernel and a copy in one op), a kernel launched
    by another thread while a convolution ran, and one outside any
    convolution do not."""
    events = [
        op("aten::cudnn_convolution", 1, 100, 50), launch(1, 110, 1),
        op("aten::convolution_backward", 2, 300, 50), launch(2, 310, 2, "cuda_driver"),
        launch(2, 320, 3), launch(1, 320, 6),
        op("aten::convolution_backward", 2, 400, 50), launch(2, 410, 4), launch(2, 420, 5),
        launch(1, 500, 7),
        kernel("sm90_xmma_fprop_implicit_gemm_f32f32", 1, 30),
        kernel("wgrad_alg0_engine<float, 128, 5, 5, 3, 3, 3, false, 512>", 2, 40),
        kernel("reduce_kernel<512, 1>", 3, 5),
        kernel("conv_depthwise2d_backward_kernel", 4, 20), kernel("elementwise_copy", 5, 3),
        kernel("clamp_min_relu", 6, 7), kernel("sigmoid", 7, 9),
    ]
    conv_s = jobs.kind("appearance").conv_seconds(events)
    assert conv_s == pytest.approx(75e-6, rel=1e-12)
    read = run.reader(ROOFLINE)
    assert read({"conv_s": conv_s, "least": {"appearance": 15e-6}}) == pytest.approx(20.0)
    assert read({"conv_s": 0.0, "least": {"appearance": 15e-6}}) is None
    assert read({"least": {"appearance": 15e-6}}) is None
