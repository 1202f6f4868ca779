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
Seeded random cotangents go on every differentiable field, some of them
strided views of one table of rows (as the blend's backward hands them
over) and one an expanded zero stride; the second case sends None for
some fields.

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
the file's row arithmetic with a C entry that loops over the rows), whose
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
FIELDS = [f for f, _ in pp.GRAD_FIELDS]
PARAMS = ["xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity"]
# the fields the second case sends None for
ABSENT = ("depth", "conic", "camera_plane", "ts")
# (SH degree, active degree, kernel_size, scale_modifier, capacity), as
# test_torch_preprocess_kernel.py's CASES; the CPU runs the first six
CASES = [(3, 3, 0.1, 1.0, 4096), (3, 1, 0.0, 0.7, 4096), (2, 2, 0.1, 0.7, 4096),
         (1, 0, 0.0, 1.0, 4096), (0, 0, 0.1, 1.0, 4096), (3, 3, 0.1, 1.0, 4999),
         (3, 0, 0.1, 1.0, 1 << 17), (3, 2, 0.1, 0.7, 1_000_003)]
HOST_CASES = [c for c in CASES if c[4] < 1 << 17]


def cotangents(state, seed, absent=()):
    """Seeded random cotangents of the differentiable fields: xy, conic,
    rgb, view_point, ray_plane and normal as views of one (P, 25) table of
    rows, as the blend's backward hands them over; ``depth`` an expanded
    zero stride; the rest contiguous. ``absent`` fields are None."""
    P = state.capacity
    g = torch.Generator().manual_seed(seed)
    rows = torch.randn((P, 25), generator=g)
    cots = {"xy": rows[:, 0:2], "conic": rows[:, 3:6], "rgb": rows[:, 7:10],
            "view_point": rows[:, 10:13], "ray_plane": rows[:, 19:21],
            "normal": rows[:, 21:24], "depth": torch.randn((1,), generator=g).expand(P),
            "opacity": torch.randn((P,), generator=g), "ts": torch.randn((P,), generator=g),
            "camera_plane": torch.randn((P, 3, 2), generator=g)}
    return {f: None if f in absent else cots[f].to(state.device) for f in FIELDS}


def autograd_grads(state, cam, cots, kernel_size, modifier):
    """The six parameter gradients of sum(field * cotangent) through the
    plain version, on the state's device and in its dtype."""
    params = state.params.map(lambda x: x.detach().clone().requires_grad_(True))
    prep = pp.preprocess_torch(state.replace(params=params), cam, kernel_size, modifier)
    used = [(getattr(prep, f), c) for f, c in cots.items() if c is not None]
    torch.autograd.backward([o for o, _ in used],
                            [c.to(o.dtype).reshape(o.shape) for o, c in used])
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
    error, at the inputs and one ulp away, for one state, view and set of
    cotangents."""

    def __init__(self, state, cam, cots, kernel_size, modifier, plain32=None):
        s64, c64 = to_float64(state, cam)
        cots64 = {f: None if c is None else c.cpu().double() for f, c in cots.items()}
        self.truth = autograd_grads(s64, c64, cots64, kernel_size, modifier)
        self.plain = plain32 or autograd_grads(state, cam, cots, kernel_size, modifier)
        self.nudged = autograd_grads(one_ulp_away(state, 11), cam, cots, kernel_size,
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
    fn.argtypes = ([ctypes.c_void_p] * 20 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.parametrize("absent", [(), ABSENT], ids=["every_field", "some_none"])
@pytest.mark.parametrize("degree,active,kernel_size,modifier,capacity", HOST_CASES)
def test_host_build_matches_autograd(host_entry, degree, active, kernel_size, modifier,
                                     capacity, absent):
    state, cam = scene("cpu", degree, active, capacity=capacity), camera("cpu")
    cots = cotangents(state, 5 + degree, absent)
    got = pp.launch_backward(host_entry, state, cam, kernel_size, modifier, cots)
    Yardstick(state, cam, cots, kernel_size, modifier).check(got, K=K_HOST)


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
    assert (act & (prep.opacity == 0)).any() and (act & (prep.opacity > 0)).any()
    assert (act[:, None] & (prep.rgb == 0)).any()


def test_cotangents_checks_and_strides():
    state = scene("cpu", 1, 1)
    P = state.capacity
    cots = cotangents(state, 0, ("ts",))
    ptrs, strides = pp._cotangents(cots, P, torch.device("cpu"))
    k = FIELDS.index
    assert ptrs[k("ts")] is None and list(strides[3 * k("ts"):3 * k("ts") + 3]) == [0, 0, 0]
    assert ptrs[k("conic")] == cots["conic"].data_ptr()
    assert list(strides[3 * k("conic"):3 * k("conic") + 3]) == [25, 1, 0]
    assert list(strides[3 * k("depth"):3 * k("depth") + 3]) == [0, 0, 0]
    assert list(strides[3 * k("camera_plane"):3 * k("camera_plane") + 3]) == [6, 2, 1]
    with pytest.raises(ValueError, match="gradient of rgb"):
        pp._cotangents({**cots, "rgb": cots["rgb"].double()}, P, torch.device("cpu"))
    with pytest.raises(ValueError, match="gradient of xy"):
        pp._cotangents({**cots, "xy": cots["xy"][:-1]}, P, torch.device("cpu"))


def test_backward_raises_off_the_card_and_for_invraycov():
    state, cam = scene("cpu", 0, 0), camera("cpu")
    with pytest.raises(ValueError, match="cuda tensors"):
        pp.preprocess_backward(state, cam, 0.1, 1.0, cotangents(state, 0))
    with pytest.raises(ValueError, match="inverse ray-space covariance"):
        pp.preprocess_train(state, cam, 0.1, 1.0, compute_invraycov=True)


@pytest.mark.parametrize("absent", [(), ABSENT], ids=["every_field", "some_none"])
def test_function_hands_each_field_gradient_to_the_backward(host_entry, monkeypatch, absent):
    """``PreprocessFunction`` on the CPU with the host build behind its
    backward (the forward's table from the plain version): autograd hands
    the backward each field's gradient as it is (None for a field with none,
    never a table), and the parameters receive the host build's gradients."""
    state, cam = scene("cpu", 2, 1), camera("cpu")
    seen = []

    def forward(st, c, ks, mod, inv=False):
        with torch.no_grad():
            out = pp.preprocess_torch(st, c, ks, mod, inv)
        table = torch.zeros((st.capacity, pp.N_FEAT))
        for f, col in pp.COLUMNS.items():
            v = getattr(out, f)
            table[:, col] = (v.transpose(1, 2).flatten(1) if f == "camera_plane" else v)
        return pp.from_table(table, out.radius, out.valid, out.well_conditioned)

    def backward(st, c, ks, mod, grads):
        seen.append(grads)
        return pp.launch_backward(host_entry, st, c, ks, mod, grads)

    monkeypatch.setattr(pp, "preprocess_forward", forward)
    monkeypatch.setattr(pp, "preprocess_backward", backward)
    params = state.params.map(lambda x: x.clone().requires_grad_(True))
    prep = pp.preprocess_train(state.replace(params=params), cam, 0.1, 0.7)
    assert prep.xy.grad_fn is not None and not prep.valid.requires_grad
    cots = cotangents(state, 3, absent)
    used = [(getattr(prep, f), c) for f, c in cots.items() if c is not None]
    torch.autograd.backward([o for o, _ in used], [c for _, c in used])
    (grads,) = seen
    assert {f for f, g in grads.items() if g is None} == set(absent)
    for f, g in grads.items():
        if g is not None:
            assert torch.equal(g, cots[f]), f
    want = pp.launch_backward(host_entry, state, cam, 0.1, 0.7, cots)
    for name in PARAMS:
        assert torch.equal(getattr(params, name).grad, getattr(want, name)), name


# ---- on the card ----------------------------------------------------------


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the preprocess kernels run on the card only")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("absent", [(), ABSENT], ids=["every_field", "some_none"])
@pytest.mark.parametrize("degree,active,kernel_size,modifier,capacity", CASES)
def test_kernel_matches_autograd(degree, active, kernel_size, modifier, capacity, absent):
    dev = card()
    state, cam = scene(dev, degree, active, capacity=capacity), camera(dev)
    cots = cotangents(state, 5 + degree, absent)
    params = state.params.map(lambda x: x.clone().requires_grad_(True))
    before = dict(pp.LAUNCHES)
    prep = pp.preprocess_train(state.replace(params=params), cam, kernel_size, modifier)
    used = [(getattr(prep, f), c) for f, c in cots.items() if c is not None]
    torch.autograd.backward([o for o, _ in used], [c for _, c in used])
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in pp.LAUNCHES.items() if v != before[k]} == {
        f"preprocess_fwd[sh={degree},inv=0]": 1, f"preprocess_bwd[sh={degree}]": 1}
    Yardstick(state, cam, cots, kernel_size, modifier).check(
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
    kernel_pair, adam = pp.preprocess_train, optim.adam_step

    def run(prepare_fn):
        arrived, grads = {}, []

        def keep(f):
            def hook(g):  # autograd calls it with None for a field with no gradient
                if g is not None:
                    arrived[f] = g.clone()
            return hook

        def traced(*a, **kw):
            # each field through a view of its own, whose gradient is the
            # output's alone (the plain chain's view_point also feeds ts, u
            # and v inside it)
            prep = prepare_fn(*a, **kw)
            out = {f: getattr(prep, f).view_as(getattr(prep, f)) for f in FIELDS}
            for f, t in out.items():
                t.register_hook(keep(f))
            return prep.replace(**out)

        def adam_step(st, g, lrs):
            grads.append(g)
            return adam(st, g, lrs)

        monkeypatch.setattr(pp, "preprocess_train", traced)
        monkeypatch.setattr(loop, "adam_step", adam_step)
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
    cots = {f: fused[2].get(f) for f in FIELDS}
    ys = Yardstick(state, cam, cots, 0.1, 1.0, plain32=plain[3])
    ys.check(fused[3], "gradient ")
    g = fused[0]
    ys.check(g.adam_m.map(lambda m: m / (1 - optim.BETA1)), "adam_m ")
    # the square root of the second moment, with the gradient's signs
    ys.check(gm.GaussianParams(**{
        k: torch.where(getattr(fused[3], k) < 0, -1.0, 1.0) * torch.sqrt(v / (1 - optim.BETA2))
        for k, v in g.adam_v.items()}), "adam_v ")
