"""The tracer's marks and spans of a train step with decoupled appearance
(``train/loop.compute_loss`` and ``make_train_step``), on the CPU.

With appearance on, the step records ``appearance`` at the end of the
forward (the span ``loss.appearance``, child of ``loss``, with the gauge
``appearance.pixels``), ``appearance.bwd_start`` and ``appearance.bwd``
around the network's backward (tensor hooks), and ``adam.appearance``
after the appearance Adam (the span ``adam.appearance``, child of
``adam``), each in the order the step reaches it. With appearance off a
step's marks and spans are the ones every other cell's stages are cut
from, unchanged.
"""

import time

import pytest
import torch

from radegs_torch.train import loop
from radegs_torch.train.config import ModelConfig
from radegs_torch.utils import trace
from test_torch_trace import OCFG, PCFG, H, W, scene, tree

# a CPU step's marks and spans with appearance off (the render's plain path)
OFF_MARKS = ["start", "start", "preprocess", "binning", "blend", "normalize", "render", "loss",
             "tail_backward", "backward", "adam", "stats"]
OFF_SPANS = ["preprocess", "binning.depth_sort", "binning.duplicate", "binning.sort",
             "binning.ranges", "binning", "blend_fwd", "normalize", "view", "loss.ssim",
             "loss", "blend_bwd", "backward", "adam", "step"]
ON_MARKS = ["start", "start", "preprocess", "binning", "blend", "normalize", "render",
            "appearance", "loss", "appearance.bwd_start", "appearance.bwd", "tail_backward",
            "backward", "adam", "stats", "adam.appearance"]


class ClockEvent:
    """``torch.cuda.Event`` on the host clock: a CPU step's ``record`` order
    stands for the device's."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter_ns()


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", ClockEvent)
    trace.reset()
    yield scene("cpu")
    trace.reset()


def traced_step(state, cam, gt, appearance: bool):
    mcfg = ModelConfig(kernel_size=0.1, use_decoupled_appearance=appearance)
    step = loop.make_train_step(mcfg, OCFG, PCFG, spatial_lr_scale=1.0)
    ts = loop.init_train_state(state, appearance, H, W)
    events = []
    ts2, _ = step(ts, cam, gt, torch.zeros(3), 0, W, H, events=events)
    return events, ts2


def test_appearance_marks_in_device_order(cpu):
    events, ts = traced_step(*cpu, appearance=True)
    assert [n for n, _ in events] == ON_MARKS
    times = [e.t for _, e in events]
    assert times == sorted(times)
    spans = trace.spans()
    parents = tree(spans)
    assert parents["loss.appearance"] == "loss" and parents["adam.appearance"] == "adam"
    assert {"loss.appearance", "adam.appearance"} <= {s["name"] for s in spans}
    (unit,) = trace.units()
    Hc, Wc = H // 32 * 32, W // 32 * 32
    assert unit["gauges"]["appearance.pixels"] == Hc * Wc
    assert ts.app_params is not None and ts.iteration == 1


def test_appearance_off_keeps_the_step_marks(cpu):
    events, ts = traced_step(*cpu, appearance=False)
    assert [n for n, _ in events] == OFF_MARKS
    assert [s["name"] for s in trace.spans()] == OFF_SPANS
    (unit,) = trace.units()
    assert not any(k.startswith("appearance") for k in unit["gauges"])
    assert ts.app_params is None


def test_untraced_step_registers_no_hook(cpu, monkeypatch):
    """Without ``events`` the appearance path records nothing and hooks no
    tensor."""
    hooked = []
    real = torch.Tensor.register_hook

    def spy(self, fn):
        hooked.append(fn)
        return real(self, fn)

    monkeypatch.setattr(torch.Tensor, "register_hook", spy)
    state, cam, gt = cpu
    mcfg = ModelConfig(kernel_size=0.1, use_decoupled_appearance=True)
    step = loop.make_train_step(mcfg, OCFG, PCFG, spatial_lr_scale=1.0)
    step(loop.init_train_state(state, True, H, W), cam, gt, torch.zeros(3), 0, W, H)
    assert hooked == [] and trace.spans() == [] and trace.units() == []
