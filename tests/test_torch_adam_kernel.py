"""Adam and the densification statistics of a train step through one entry,
``train/optim.adam_and_stats`` (``csrc/adam_stats.cu`` on a card). Torch
only, so the card's machine runs it: ``python -m pytest --noconftest -q
tests/test_torch_adam_kernel.py``; the ``cuda`` tests skip without a card.

On the CPU: the entry is the three plain calls in sequence (``adam_step``,
``add_densification_stats`` with the screen gradient times the NDC scale as
a tensor, ``update_max_radii``) bit for bit, at SH degrees 0-3, with the
NDC scale as two floats, the abs-gradient read at column 0 of a (C, 2)
tensor, and a gradient that is None (zeros); a train step makes no kernel
launch there, and the kernel's wrapper refuses CPU tensors.

On the card: the kernel against the same plain chain on the card, every
output the same bits (the six groups' parameters and both moments, the five
statistics), at 1,000,003 rows (no group's length a multiple of 4), SH
degrees 0 and 3, Adam steps 1 and 1000, random active and visible masks,
inactive rows with non-zero moments and NaN gradients, a group whose
gradient is None, and groups that are not 16-byte aligned; a non-contiguous
input raises; a train step launches the kernel once and ends in the state
the plain chain gives.
"""

import numpy as np
import pytest
import torch

from radegs_torch.core.camera import Camera
from radegs_torch.models import gaussian_model as gm
from radegs_torch.train import loop, optim
from radegs_torch.train.config import ModelConfig, OptimizationConfig, PipelineConfig

torch.set_num_threads(1)
NDC = (618.5, 411.0)  # (W / 2, H / 2) of a 1237 x 822 view
LRS = optim.GroupLRs(xyz=1.6e-4 * 3.7)


def scene(device, capacity, sh_degree, adam_step, seed=0, none_grad="opacity",
          misaligned=False):
    """A state mid-training of ``capacity`` rows (70% active, scattered),
    its step's gradients (NaN on a tenth of the inactive rows; ``none_grad``
    None) and statistics inputs. ``misaligned``: every parameter, moment and
    gradient a contiguous view one float past a 16-byte boundary."""
    gen = torch.Generator().manual_seed(seed)
    C, M = capacity, (sh_degree + 1) ** 2
    shapes = dict(xyz=(C, 3), f_dc=(C, 1, 3), f_rest=(C, M - 1, 3), scaling=(C, 3),
                  rotation=(C, 4), opacity=(C, 1))

    def randn(shape, scale=1.0):
        n = int(np.prod(shape))
        if misaligned:
            return (torch.randn(n + 1, generator=gen) * scale).to(device)[1:].reshape(shape)
        return (torch.randn(shape, generator=gen) * scale).to(device)

    active = (torch.rand(C, generator=gen) < 0.7).to(device)
    params = gm.GaussianParams(**{k: randn(s) for k, s in shapes.items()})
    m = gm.GaussianParams(**{k: randn(s, 1e-2) for k, s in shapes.items()})
    v = gm.GaussianParams(**{k: randn(s, 1e-2).abs_() for k, s in shapes.items()})
    nan_rows = (~active) & (torch.rand(C, generator=gen) < 0.1).to(device)

    def grad(k, s):
        if k == none_grad:
            return None
        g = randn(s, 1e-3)
        g[nan_rows] = float("nan")  # an inactive row's gradient enters as +0
        return g

    grads = gm.GaussianParams(**{k: grad(k, s) for k, s in shapes.items()})

    def stat(scale):
        return (torch.rand(C, generator=gen) * scale).to(device)

    state = gm.GaussianState(
        params=params, active=active, filter_3d=torch.zeros((C, 1), device=device),
        max_radii2d=torch.floor(stat(40.0)), grad_accum=stat(1.0), grad_abs_accum=stat(1.0),
        grad_abs_max=stat(1e-2), denom=torch.floor(stat(9.0)), adam_m=m, adam_v=v,
        adam_step=adam_step - 1, active_sh_degree=sh_degree, max_sh_degree=sh_degree)
    visible = (torch.rand(C, generator=gen) < 0.5).to(device)
    radii = torch.where(visible, torch.floor(stat(60.0)), 0.0)
    xy_grad = randn((C, 2), 1e-4)
    xy_abs = torch.stack([randn((C,), 1e-4).abs_(), torch.zeros(C, device=device)], 1)
    return state, grads, xy_grad, xy_abs, visible, radii


def plain_chain(state, grads, xy_grad, xy_abs, visible, radii):
    """The three plain calls in sequence, as the train step made them."""
    full = gm.GaussianParams(**{k: torch.zeros_like(p) if getattr(grads, k) is None
                                else getattr(grads, k) for k, p in state.params.items()})
    g = optim.adam_step(state, full, LRS)
    scale = torch.tensor([NDC[0], NDC[1]], dtype=torch.float32, device=state.device)
    g = gm.add_densification_stats(g, xy_grad * scale, xy_abs[:, 0], visible)
    return gm.update_max_radii(g, radii, visible)


def outputs(state):
    """Every tensor the update writes, by name."""
    out = {}
    for part in ("params", "adam_m", "adam_v"):
        out.update({f"{part}.{k}": t for k, t in getattr(state, part).items()})
    out.update({f: getattr(state, f) for f in optim.STATS_FIELDS})
    return out


def differing_bits(got, want):
    """Names whose tensors differ in any bit (NaN included), with counts."""
    a, b = outputs(got), outputs(want)
    assert a.keys() == b.keys()
    return {k: int((a[k].view(torch.int32) != b[k].view(torch.int32)).sum()) for k in a
            if not torch.equal(a[k].view(torch.int32), b[k].view(torch.int32))}


@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
@pytest.mark.parametrize("none_grad", [None, "opacity"])
def test_cpu_entry_is_the_plain_chain(sh_degree, none_grad):
    state, grads, xy, xy_abs, vis, radii = scene("cpu", 4099, sh_degree, 3, seed=sh_degree,
                                                 none_grad=none_grad)
    got = optim.adam_and_stats(state, grads, LRS, xy, xy_abs, vis, radii, NDC)
    assert differing_bits(got, plain_chain(state, grads, xy, xy_abs, vis, radii)) == {}
    assert got.adam_step == state.adam_step + 1


def test_cpu_entry_takes_none_screen_gradients_as_zeros():
    state, grads, xy, xy_abs, vis, radii = scene("cpu", 1031, 3, 1)
    got = optim.adam_and_stats(state, grads, LRS, None, None, vis, radii, NDC)
    want = plain_chain(state, grads, torch.zeros_like(xy), torch.zeros_like(xy_abs), vis, radii)
    assert differing_bits(got, want) == {}


def test_cpu_train_step_launches_no_kernel():
    pts = np.random.default_rng(3).normal(size=(200, 3)).astype(np.float32) * 0.5
    state = gm.create_from_points(pts, np.full((200, 3), 0.5, np.float32), capacity=256,
                                  device="cpu")
    cam = Camera.look_at([0.0, 0.3, -3.0], [0, 0, 0], [0, 1, 0], 0.9, 0.7, 32, 24, device="cpu")
    step = loop.make_train_step(ModelConfig(kernel_size=0.1), OptimizationConfig(),
                                PipelineConfig(max_per_tile=64, instance_budget=1 << 13), 1.0)
    optim.reset_launches()
    ts, _ = step(loop.init_train_state(state), cam, torch.rand((3, 24, 32)), torch.zeros(3), 0,
                 32, 24)
    assert dict(optim.LAUNCHES) == {"adam_stats": 0} and ts.gaussians.adam_step == 1


def test_kernel_wrapper_refuses_cpu_tensors():
    state, grads, xy, xy_abs, vis, radii = scene("cpu", 64, 0, 1)
    with pytest.raises(ValueError, match="cuda"):
        optim.adam_and_stats_kernel(state, grads, LRS, xy, xy_abs, vis, radii, NDC)


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Adam kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sh_degree,adam_step,none_grad,misaligned",
                         [(3, 1, "opacity", False), (3, 1000, None, False),
                          (0, 1000, "xyz", False), (0, 1, None, True), (3, 7, "f_rest", True)])
def test_kernel_is_the_plain_chain_bit_for_bit(sh_degree, adam_step, none_grad, misaligned):
    dev = card()
    state, grads, xy, xy_abs, vis, radii = scene(dev, 1_000_003, sh_degree, adam_step,
                                                 seed=adam_step, none_grad=none_grad,
                                                 misaligned=misaligned)
    optim.reset_launches()
    got = optim.adam_and_stats(state, grads, LRS, xy, xy_abs, vis, radii, NDC)
    want = plain_chain(state, grads, xy, xy_abs, vis, radii)
    torch.cuda.synchronize()
    assert optim.LAUNCHES["adam_stats"] == 1
    assert differing_bits(got, want) == {}
    # the inputs are left as they were
    again = optim.adam_and_stats(state, grads, LRS, xy, xy_abs, vis, radii, NDC)
    assert differing_bits(again, got) == {}


@pytest.mark.cuda
def test_kernel_refuses_a_non_contiguous_input():
    dev = card()
    state, grads, xy, xy_abs, vis, radii = scene(dev, 4099, 3, 1)
    strided = grads.replace(xyz=torch.zeros((4099, 6), device=dev)[:, ::2])
    with pytest.raises(ValueError, match="contiguous"):
        optim.adam_and_stats(state, strided, LRS, xy, xy_abs, vis, radii, NDC)
    with pytest.raises(ValueError, match="contiguous"):
        optim.adam_and_stats(state, grads, LRS, xy.t().contiguous().t(), xy_abs, vis, radii,
                             NDC)
    with pytest.raises(ValueError, match="contiguous"):
        optim.adam_and_stats(state.replace(grad_accum=state.grad_accum.double()), grads, LRS,
                             xy, xy_abs, vis, radii, NDC)


@pytest.mark.cuda
def test_a_train_step_launches_the_kernel_once(monkeypatch):
    dev = card()
    pts = np.random.default_rng(3).normal(size=(3000, 3)).astype(np.float32) * 0.5
    cols = np.random.default_rng(4).uniform(0.1, 0.9, (3000, 3)).astype(np.float32)
    state = gm.create_from_points(pts, cols, capacity=4096, device=dev)
    W, H = 160, 120
    cam = Camera.look_at([0.0, 0.3, -3.0], [0, 0, 0], [0, 1, 0], 0.9, 0.7, W, H, device=dev)
    gt = torch.rand((3, H, W), generator=torch.Generator().manual_seed(5)).to(dev)
    step = loop.make_train_step(ModelConfig(kernel_size=0.1),
                                OptimizationConfig(regularization_from_iter=0),
                                PipelineConfig(max_per_tile=1024, instance_budget=1 << 16), 1.0)
    calls = []

    def recorded(*args):
        calls.append(args)
        return optim.adam_and_stats(*args)

    monkeypatch.setattr(loop, "adam_and_stats", recorded)
    optim.reset_launches()
    events = []
    ts, _ = step(loop.init_train_state(state), cam, gt, torch.zeros(3, device=dev), 0, W, H,
                 events=events)
    torch.cuda.synchronize()
    assert optim.LAUNCHES["adam_stats"] == 1 and len(calls) == 1
    assert [n for n, _ in events][-2:] == ["adam", "stats"]
    # the step's own inputs through the plain chain give the step's state
    assert differing_bits(ts.gaussians, optim.adam_and_stats_torch(*calls[0])) == {}
    assert ts.gaussians.adam_step == 1
