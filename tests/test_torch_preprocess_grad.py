"""The preprocess backward kernel (``csrc/preprocess_bwd.cu`` behind
``ops/preprocess.preprocess_backward``, joined to the forward kernel in
``preprocess_train``) against autograd through the plain version
(``preprocess_torch``). Torch only, so the card's machine runs it:
``python -m pytest --noconftest tests/test_torch_preprocess_grad.py``; the
``cuda`` tests skip without a card.

The scene is tests/test_torch_preprocess_kernel.py's: rows behind the near
plane and past the frustum's edge, splats 1e-5 on every axis and flat ones
(one axis 1e-5) with no 3D filter, non-unit quaternions, inactive rows among
the active ones (whole blocks of 128 too); SH degrees 0-3 with an active
degree below the maximum, ``kernel_size`` 0 and 0.1, ``scale_modifier``
0.7, at capacities 4096 and 4999 and, on the card, 2^17 and 1,000,003.
A seeded random cotangent goes on the per-Gaussian table, contiguous or as
the (P, 24) view of a wider buffer of rows (as the blend's backward hands
it over); none reads as zeros.

The measure of truth is autograd in float64 on the CPU. Row by row and
field by field, the kernel's error (the largest of the row's components)
must be at most ``K`` = 16 times (the host build's 32 times, below) the
larger of float32 autograd's own error, at the inputs and at inputs one ulp
away (both on the kernel's device), and 16 ulps of the row's largest
component. Reasons: the kernel
adds the chain's terms in another order than autograd, and on rows whose
gradient cancels (flat and tiny splats, the 2D filter's compensation near 1,
rows behind the near plane) a few ulps of the terms are many ulps of the
result; one ulp of the inputs moves such a gradient as far, and the result's
own rounding after tens of terms is a few ulps. A wrong term or branch
moves a row by far more. Where float32 autograd is not finite the kernel
must not be either, and the other way round; an inactive row's gradient is
exact zeros.

On the CPU the kernel's source is compiled for the host (``g++ -x c++``:
the file's row arithmetic, with ``csrc/preprocess_common.cuh``, and a C
entry that loops over the rows), whose
libm and FMA order round the recomputed forward differently from PyTorch's
CPU kernels; on the card the recomputation has the forward's bits. The CPU
also runs the autograd Function's plumbing with the host build behind it.
On the card: the kernel pair through ``preprocess_train`` at every case,
and a whole ``make_train_step`` against the same step through the plain
chain: the loss the same bits, the gradients arriving at the preprocess
the same bits, the parameter gradients and the Adam moments held to the
float64 truth as above.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from radegs_torch import renderer
from radegs_torch.core.camera import Camera
from radegs_torch.core.projection import N_FEAT, PreprocessOut
from radegs_torch.models import gaussian_model as gm
from radegs_torch.native import build
from radegs_torch.ops import preprocess as pp
from radegs_torch.train import loop, optim
from radegs_torch.train.config import ModelConfig, OptimizationConfig, PipelineConfig
from test_torch_preprocess_kernel import H, W, camera, scene

torch.set_num_threads(1)
K = 16  # the multiple of float32 autograd's own error (see the module's note)
# the host build's: its recomputed forward rounds otherwise than PyTorch's
# CPU kernels (libm, the FMA order the kernel repeats), which moves rows whose
# forward cancels (the nearly singular 2D covariance of a flat splat) as far
# again; on the card the recomputation has the forward's bits
K_HOST = 2 * K
FLOOR_ULPS = 2.0 ** -19  # 16 ulps of the row's largest component
PARAMS = ["xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity"]
# the table's cotangent: contiguous, the view of a wider buffer of rows at
# the blend's row stride, none
LAYOUTS = ("contiguous", "blend_rows", "none")
# (SH degree, active degree, kernel_size, scale_modifier, capacity), as
# test_torch_preprocess_kernel.py's CASES; the CPU runs the first six
CASES = [(3, 3, 0.1, 1.0, 4096), (3, 1, 0.0, 0.7, 4096), (2, 2, 0.1, 0.7, 4096),
         (1, 0, 0.0, 1.0, 4096), (0, 0, 0.1, 1.0, 4096), (3, 3, 0.1, 1.0, 4999),
         (3, 0, 0.1, 1.0, 1 << 17), (3, 2, 0.1, 0.7, 1_000_003)]
HOST_CASES = [c for c in CASES if c[4] < 1 << 17]


def cotangent(state, seed, layout="contiguous"):
    """A seeded random cotangent of the (P, 24) table: contiguous, or the
    first 24 columns of a (P, 26) buffer of rows as the blend's backward
    hands it over (``blend_rows``), or None (``none``)."""
    if layout == "none":
        return None
    g = torch.Generator().manual_seed(seed)
    width = N_FEAT + 2 if layout == "blend_rows" else N_FEAT
    return torch.randn((state.capacity, width), generator=g)[:, :N_FEAT].to(state.device)


def autograd_grads(state, cam, cot, kernel_size, modifier):
    """The six parameter gradients of sum(table * cot) through the plain
    version (zeros for None), on the state's device and in its dtype."""
    params = state.params.map(lambda x: x.detach().clone().requires_grad_(True))
    prep = pp.preprocess_torch(state.replace(params=params), cam, kernel_size, modifier)
    prep.table.backward(torch.zeros_like(prep.table) if cot is None else cot.to(prep.table))
    return params.map(lambda x: torch.zeros_like(x) if x.grad is None else x.grad.detach())


def to_float64(state, cam):
    """The state and camera in float64 on the CPU."""
    def f64(x):
        return x.detach().cpu().double() if x.dtype == torch.float32 else x.cpu()
    state = state.replace(params=state.params.map(f64), filter_3d=f64(state.filter_3d),
                          active=state.active.cpu())
    return state, Camera(f64(cam.R), f64(cam.T), f64(cam.fovx), f64(cam.fovy), cam.width,
                         cam.height)


def one_ulp_away(state, seed):
    """The state with each parameter moved one ulp, up or down at random."""
    g = torch.Generator().manual_seed(seed)

    def nudge(x):
        up = (torch.rand(x.shape, generator=g) < 0.5).to(x.device)
        inf = torch.full_like(x, float("inf"))
        return torch.where(up, torch.nextafter(x, inf), torch.nextafter(x, -inf))
    return state.replace(params=state.params.map(nudge))


class Yardstick:
    """Float64 autograd's gradients (the truth) and float32 autograd's own
    error, at the inputs and one ulp away, for one state, view and table
    cotangent."""

    def __init__(self, state, cam, cot, kernel_size, modifier, plain32=None):
        s64, c64 = to_float64(state, cam)
        cot64 = None if cot is None else cot.cpu().double()
        self.truth = autograd_grads(s64, c64, cot64, kernel_size, modifier)
        self.plain = plain32 or autograd_grads(state, cam, cot, kernel_size, modifier)
        self.nudged = autograd_grads(one_ulp_away(state, 11), cam, cot, kernel_size,
                                     modifier)
        self.active = state.active.cpu()

    def check(self, got, label="", K=K):
        """Hold ``got`` (a GaussianParams of float32 gradients) to the
        truth, row by row and field by field."""
        act = self.active
        n = int(act.sum())
        for name in PARAMS:
            k = getattr(got, name).detach().cpu()
            assert (k[~act] == 0).all(), f"{label}{name}: an inactive row is not zeros"
            if k.numel() == 0:  # f_rest at SH degree 0
                continue
            rows = lambda t: t[act].reshape(n, -1)  # noqa: E731
            k, t = rows(k).double(), rows(getattr(self.truth, name))
            a, b = rows(getattr(self.plain, name).cpu()).double(), \
                rows(getattr(self.nudged, name).cpu()).double()
            fin_a = torch.isfinite(a).all(1)
            assert torch.equal(torch.isfinite(k).all(1), fin_a), \
                f"{label}{name}: non-finite rows differ from float32 autograd's"
            k, t, a, b = k[fin_a], t[fin_a], a[fin_a], b[fin_a]
            err = (k - t).abs().amax(1)
            own = torch.maximum((a - t).abs().amax(1), (b - t).abs().amax(1))
            floor = FLOOR_ULPS * t.abs().amax(1)
            bound = K * torch.maximum(own, floor)
            bad = err > bound
            if bad.any():
                i = int(torch.argmax(err / bound.clamp_min(1e-300)))
                pytest.fail(f"{label}{name}: {int(bad.sum())} of {len(err)} rows past {K}x "
                            f"float32 autograd's error; worst row {i}: kernel "
                            f"{k[i].tolist()}, truth {t[i].tolist()}, float32 autograd "
                            f"{a[i].tolist()}")


# ---- the host build of the kernel's source --------------------------------


@pytest.fixture(scope="module")
def host_entry(tmp_path_factory):
    """``radegs_preprocess_bwd`` of ``csrc/preprocess_bwd.cu`` compiled for
    the host, with the ctypes signature of the card's entry."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler for the host build of the backward kernel")
    so = tmp_path_factory.mktemp("preprocess_bwd") / "host.so"
    src = Path(build.CSRC) / "preprocess_bwd.cu"
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-Wall", "-Werror", "-o", str(so), str(src)], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(str(so)).radegs_preprocess_bwd
    fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("degree,active,kernel_size,modifier,capacity", HOST_CASES)
def test_host_build_matches_autograd(host_entry, degree, active, kernel_size, modifier,
                                     capacity, layout):
    state, cam = scene("cpu", degree, active, capacity=capacity), camera("cpu")
    cot = cotangent(state, 5 + degree, layout)
    got = pp.launch_backward(host_entry, state, cam, kernel_size, modifier, cot)
    Yardstick(state, cam, cot, kernel_size, modifier).check(got, K=K_HOST)


def test_the_scene_reaches_every_backward_branch():
    """The rows the chain's branches need, active: culled and clamped by the
    cone, cut by the 2D filter's compensation (det0 at its clamp) or not,
    ill-conditioned, and a colour channel clamped at 0."""
    state, cam = scene("cpu", 3, 3), camera("cpu")
    prep = pp.preprocess_torch(state, cam, 0.0)
    act = state.active
    assert (act & (prep.depth <= 0.2)).any() and (act & prep.valid).any()
    assert (act & ~prep.well_conditioned).any()
    limx = 1.3 * float(cam.tanfovx)
    assert (act & (prep.view_point[:, 0] / prep.depth).abs().gt(limx)).any()
    assert (act & prep.valid & (prep.opacity == 0)).any() and (act & (prep.opacity > 0)).any()
    assert (act[:, None] & (prep.rgb == 0)).any()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_table_gradient_checks_and_strides(host_entry, layout):
    """The table's gradient reaches the entry at its own pointer and row
    stride (a view of a wider buffer is read in place; one whose columns
    are not adjacent is copied first; None reads as zeros), and one of
    another dtype or shape raises."""
    state, cam = scene("cpu", 1, 1), camera("cpu")
    P = state.capacity
    cot = cotangent(state, 0, layout)
    want = pp.launch_backward(host_entry, state, cam, 0.1, 1.0,
                              torch.zeros((P, N_FEAT)) if cot is None else cot.contiguous())
    seen = []

    def entry(*a):
        seen.append((a[12], a[19]))
        return host_entry(*a)

    got = pp.launch_backward(entry, state, cam, 0.1, 1.0, cot)
    assert seen == [(None, 0) if cot is None else (cot.data_ptr(), cot.stride(0))]
    assert seen[0][1] == {"contiguous": N_FEAT, "blend_rows": N_FEAT + 2, "none": 0}[layout]
    for name in PARAMS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    if cot is not None:
        apart = cot.T.contiguous().T  # column stride P: read after a copy
        again = pp.launch_backward(host_entry, state, cam, 0.1, 1.0, apart)
        for name in PARAMS:
            assert torch.equal(getattr(again, name), getattr(want, name)), name
        with pytest.raises(ValueError, match="table's gradient"):
            pp.launch_backward(host_entry, state, cam, 0.1, 1.0, cot.double())
        with pytest.raises(ValueError, match="table's gradient"):
            pp.launch_backward(host_entry, state, cam, 0.1, 1.0, cot[:-1])


def test_backward_raises_off_the_card_and_for_invraycov():
    state, cam = scene("cpu", 0, 0), camera("cpu")
    with pytest.raises(ValueError, match="cuda tensors"):
        pp.preprocess_backward(state, cam, 0.1, 1.0, cotangent(state, 0))
    with pytest.raises(ValueError, match="inverse ray-space covariance"):
        pp.preprocess_train(state, cam, 0.1, 1.0, compute_invraycov=True)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_function_hands_each_field_gradient_to_the_backward(host_entry, monkeypatch, layout):
    """``PreprocessFunction`` on the CPU with the host build behind its
    backward (the forward's table from the plain version): it has one
    differentiable output, the table, whose gradient autograd hands the
    backward as it is (the same tensor: a view of a wider buffer stays
    one), and the parameters receive the host build's gradients. With
    ``none`` the table gets a zero cotangent by autograd, which reads as
    the entry's null."""
    state, cam = scene("cpu", 2, 1), camera("cpu")
    seen = []

    def forward(st, c, ks, mod, inv=False):
        with torch.no_grad():
            out = pp.preprocess_torch(st, c, ks, mod, inv)
        return PreprocessOut(out.table.contiguous(), out.valid, out.radius,
                             out.well_conditioned)

    def backward(st, c, ks, mod, grad):
        seen.append(grad)
        return pp.launch_backward(host_entry, st, c, ks, mod, grad)

    monkeypatch.setattr(pp, "preprocess_forward", forward)
    monkeypatch.setattr(pp, "preprocess_backward", backward)
    params = state.params.map(lambda x: x.clone().requires_grad_(True))
    prep = pp.preprocess_train(state.replace(params=params), cam, 0.1, 0.7)
    assert prep.table.grad_fn is not None and not prep.valid.requires_grad
    assert prep.radius.grad_fn is None and not prep.well_conditioned.requires_grad
    cot = cotangent(state, 3, layout)
    prep.table.backward(torch.zeros_like(prep.table) if cot is None else cot)
    (grad,) = seen
    if cot is None:
        assert not grad.any()
    else:
        assert grad is cot or (grad.data_ptr(), grad.stride()) == (cot.data_ptr(), cot.stride())
    want = pp.launch_backward(host_entry, state, cam, 0.1, 0.7, cot)
    for name in PARAMS:
        assert torch.equal(getattr(params, name).grad, getattr(want, name)), name


# ---- on the card ----------------------------------------------------------


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the preprocess kernels run on the card only")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS[:2])
@pytest.mark.parametrize("degree,active,kernel_size,modifier,capacity", CASES)
def test_kernel_matches_autograd(degree, active, kernel_size, modifier, capacity, layout):
    dev = card()
    state, cam = scene(dev, degree, active, capacity=capacity), camera(dev)
    cot = cotangent(state, 5 + degree, layout)
    params = state.params.map(lambda x: x.clone().requires_grad_(True))
    before = dict(pp.LAUNCHES)
    prep = pp.preprocess_train(state.replace(params=params), cam, kernel_size, modifier)
    prep.table.backward(cot)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in pp.LAUNCHES.items() if v != before[k]} == {
        f"preprocess_fwd[sh={degree},inv=0]": 1, f"preprocess_bwd[sh={degree}]": 1}
    Yardstick(state, cam, cot, kernel_size, modifier).check(
        params.map(lambda x: x.grad), f"sh={degree} capacity {capacity}: ")


@pytest.mark.cuda
def test_a_train_step_matches_the_plain_chain(monkeypatch):
    """One ``make_train_step`` through the kernel pair and one through the
    plain chain on the card (``preprocess_train`` swapped for
    ``preprocess_torch``): the loss the same bits, the gradients reaching
    the preprocess the same bits, and the parameter gradients and the Adam
    moments (from zero: m = 0.1 g, v = 0.001 g^2) held to the float64 truth
    for those gradients."""
    dev = card()
    state, cam = scene(dev), camera(dev)
    gt = torch.rand((3, H, W), generator=torch.Generator().manual_seed(4)).to(dev)
    step = loop.make_train_step(ModelConfig(kernel_size=0.1),
                                OptimizationConfig(regularization_from_iter=0),
                                PipelineConfig(max_per_tile=256, instance_budget=1 << 16), 1.0)
    kernel_pair, adam = pp.preprocess_train, optim.adam_and_stats

    def run(prepare_fn):
        arrived, grads = {}, []

        def keep(g):
            arrived["table"] = g.clone()

        def traced(*a, **kw):
            # the table through a view of its own, whose gradient is the
            # output's alone
            prep = prepare_fn(*a, **kw)
            table = prep.table.view_as(prep.table)
            table.register_hook(keep)
            return prep.replace(table=table)

        def adam_and_stats(st, g, lrs, *stats):
            grads.append(g)
            return adam(st, g, lrs, *stats)

        monkeypatch.setattr(pp, "preprocess_train", traced)
        monkeypatch.setattr(loop, "adam_and_stats", adam_and_stats)
        ts, metrics = step(loop.init_train_state(state), cam, gt, torch.zeros(3, device=dev),
                           0, W, H)
        torch.cuda.synchronize()
        return ts.gaussians, metrics["loss"], arrived, grads[0]

    plain = run(lambda st, c, ks, mod, inv=False: pp.preprocess_torch(st, c, ks, mod, inv))
    fused = run(kernel_pair)
    assert torch.equal(fused[1], plain[1])
    assert set(fused[2]) == set(plain[2]) and fused[2]
    for f in fused[2]:
        assert torch.equal(fused[2][f], plain[2][f]), f
    ys = Yardstick(state, cam, fused[2]["table"], 0.1, 1.0, plain32=plain[3])
    ys.check(fused[3], "gradient ")
    g = fused[0]
    ys.check(g.adam_m.map(lambda m: m / (1 - optim.BETA1)), "adam_m ")
    # the square root of the second moment, with the gradient's signs
    ys.check(gm.GaussianParams(**{
        k: torch.where(getattr(fused[3], k) < 0, -1.0, 1.0) * torch.sqrt(v / (1 - optim.BETA2))
        for k, v in g.adam_v.items()}), "adam_v ")
