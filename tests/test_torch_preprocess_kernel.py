"""The preprocess kernel (``csrc/preprocess_fwd.cu`` behind
``ops/preprocess.preprocess_forward``) and the rule by which
``renderer.prepare`` takes it. Torch only, so the card's machine runs it:
``python -m pytest --noconftest tests/test_torch_preprocess_kernel.py``;
the ``cuda`` tests skip without a card.

On the CPU: ``prepare`` runs the plain version for CPU tensors; on a card
(a state that reports a CUDA device, its tensors on the CPU) it hands a
view that parameters a gradient can flow from to the kernel pair
(``preprocess_train``) and every other view to the kernel's wrapper. The
fields of a ``PreprocessOut`` (views of its table) read back through
``pack_table`` equal a seeded table bit for bit, cannot be replaced apart
from it, and have the plain version's shapes and dtypes.

On the card, the kernel against the plain version on a seeded scene with
inactive rows among the active ones, rows behind the near plane and beyond
the frustum's edge, ill-conditioned scales (1e-5, no 3D filter), non-unit
quaternions, SH degrees 0-3 with an active degree below the maximum,
``kernel_size`` 0 and 0.1, ``scale_modifier`` 0.7, the inverse ray-space
covariance on and off, at capacities 4096, 4999, 2^17 (the held 100k
cells') and 1,000,003: every float field the same bits on the rows valid
on both sides, ``radius``, ``valid`` and ``well_conditioned`` equal on
the active rows, ``invraycov`` finite on the ill-conditioned ones, an
inactive row zeros. The same bits, not a tolerance: the kernel rounds as
PyTorch does (``csrc/preprocess_fwd.cu``), and a last-bit difference in a
conic or an opacity moves a pixel's 1/255 alpha gate, a colour step of up
to 1/255 (the benchmark's ``rgb_max_gap`` limit is 1e-3). Then ``render``
under ``no_grad`` against ``render`` with parameters that require grad
through the plain version (every map the same), the syncs of a served view (3, binning's) under
``torch.cuda.set_sync_debug_mode``, and ``launches.preprocess``: one
launch a served view, one forward and one backward launch a train step,
and no plain preprocess (tests/test_torch_preprocess_grad.py holds the
backward's gradients); in that step the blend kernels read the preprocess
kernel's table, and the preprocess backward the blend's gradient buffer, by
pointer, with nothing copied between them.
"""

import warnings

import numpy as np
import pytest
import torch

from radegs_torch import renderer
from radegs_torch.core.camera import Camera
from radegs_torch.core.projection import COLUMNS, N_FEAT, PreprocessOut, pack_table
from radegs_torch.models import gaussian_model as gm
from radegs_torch.ops import blend
from radegs_torch.ops import preprocess as pp
from radegs_torch.train import loop
from radegs_torch.train.config import ModelConfig, OptimizationConfig, PipelineConfig
from radegs_torch.utils import trace

torch.set_num_threads(1)
W, H = 320, 240
CAPACITY = 4096
N_ACTIVE = 3000
FIELDS = ("xy", "depth", "view_point", "conic", "opacity", "rgb", "camera_plane",
          "ray_plane", "normal", "ts")
# (SH degree, active degree, kernel_size, scale_modifier, compute_invraycov,
# capacity): the last three at a capacity that is not a power of two (nor a
# multiple of the kernel's 128-row block), at the held 100k cells' (2^17,
# SH 3 at active degree 0) and at another irregular one of about 1M, for
# the cuBLAS product whose FMA order the kernel repeats
CASES = [(3, 3, 0.1, 1.0, False, CAPACITY), (3, 1, 0.0, 0.7, True, CAPACITY),
         (2, 2, 0.1, 0.7, True, CAPACITY), (1, 0, 0.0, 1.0, False, CAPACITY),
         (0, 0, 0.1, 1.0, True, CAPACITY), (3, 3, 0.1, 1.0, True, 4999),
         (3, 0, 0.1, 1.0, False, 1 << 17), (3, 2, 0.1, 0.7, True, 1_000_003)]


def camera(device):
    return Camera.look_at([0.0, 0.3, -4.0], [0, 0, 0], [0, 1, 0], 0.9, 0.7, W, H,
                          device=device)


def scene(device, sh_degree=3, active_sh_degree=3, seed=7, capacity=CAPACITY):
    """``capacity`` rows, N_ACTIVE of each CAPACITY of them active and
    scattered among the rest (whole blocks of 128 inactive rows too); centres around the origin, a
    tenth behind the camera (z = -4.5) and a tenth beyond the frustum's
    edge; log-scales N(-2.5, 0.5), a twentieth at 1e-5 on every axis and a
    twentieth flat (one axis 1e-5), neither with a 3D filter; quaternions
    of norm 0.5-2; SH coefficients N(0, 0.3)."""
    rng = np.random.default_rng(seed)
    C = capacity
    active = np.zeros(C, bool)
    active[rng.choice(np.r_[0:1024, 1280:C], n_active(C), replace=False)] = True  # 1024:1280 empty
    xyz = rng.normal(size=(C, 3)) * 0.8
    xyz[rng.random(C) < 0.1, 2] = -4.5  # behind the camera (at z = -4)
    edge = rng.random(C) < 0.1
    xyz[edge, 0] = rng.choice([-1, 1], edge.sum()) * rng.uniform(2.0, 6.0, edge.sum())
    scaling = rng.normal(-2.5, 0.5, (C, 3))
    tiny = rng.random(C) < 0.05
    flat = ~tiny & (rng.random(C) < 0.05)
    scaling[tiny] = np.log(1e-5)
    scaling[flat, rng.integers(0, 3, flat.sum())] = np.log(1e-5)
    q = rng.normal(size=(C, 4))
    q *= (rng.uniform(0.5, 2.0, C) / np.linalg.norm(q, axis=1))[:, None]
    M = (sh_degree + 1) ** 2
    state = gm.state_from_arrays(
        xyz, rng.normal(size=(C, 1, 3)) * 0.3 + 0.5, rng.normal(size=(C, M - 1, 3)) * 0.3,
        scaling, q, rng.normal(size=(C, 1)), active, np.zeros((C, 1)), active_sh_degree,
        sh_degree, device=device)
    state = gm.update_3d_filter(state, [camera(device)])
    filt = torch.where(torch.as_tensor(tiny | flat, device=device)[:, None], 0.0,
                       state.filter_3d)
    return state.replace(filter_3d=filt)


def n_active(capacity):
    return N_ACTIVE * capacity // CAPACITY


class OnCard(gm.GaussianState):
    """A CPU state that reports a CUDA device, for the rule alone."""

    @property
    def device(self):
        return torch.device("cuda")


def on_card(state):
    return OnCard(**{f: getattr(state, f) for f in state.__dataclass_fields__})


def test_counters_live_in_the_registry():
    assert trace.counters("launches.preprocess") is pp.LAUNCHES
    assert set(pp.LAUNCHES) == {f"preprocess_fwd[sh={d},inv={i}]" for d in range(4)
                                for i in (0, 1)} | {f"preprocess_bwd[sh={d}]" for d in range(4)}


def test_prepare_runs_the_plain_version_on_the_cpu():
    state, cam = scene("cpu"), camera("cpu")
    before, plain = dict(pp.LAUNCHES), dict(trace.counters("preprocess"))
    got = renderer.prepare(state, cam, 0.1, compute_invraycov=True)
    want = pp.preprocess_torch(state, cam, 0.1, compute_invraycov=True)
    for f in FIELDS + ("valid", "radius", "well_conditioned", "invraycov"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert dict(pp.LAUNCHES) == before
    assert dict(trace.counters("preprocess")) == plain  # counted on a card only


@pytest.mark.parametrize("grad", ["params", "none", "no_grad"])
def test_prepare_takes_the_kernel_where_no_gradient_can_flow(grad, monkeypatch):
    state, cam = scene("cpu"), camera("cpu")
    if grad != "none":
        state = state.replace(params=state.params.map(lambda x: x.requires_grad_(True)))
    calls = {"kernel": [], "pair": []}
    monkeypatch.setattr(pp, "preprocess_forward", lambda *a: calls["kernel"].append(a) or "kernel")
    monkeypatch.setattr(pp, "preprocess_train", lambda *a: calls["pair"].append(a) or "pair")
    if grad == "no_grad":
        with torch.no_grad():
            got = renderer.prepare(on_card(state), cam, 0.1, 0.7, True)
    else:
        got = renderer.prepare(on_card(state), cam, 0.1, 0.7, True)
    # a gradient flows from the parameters: the kernel pair; else the kernel
    want = "pair" if grad == "params" else "kernel"
    assert got == want and len(calls[want]) == 1 and calls[want][0][2:] == (0.1, 0.7, True)
    assert sum(map(len, calls.values())) == 1


def test_needs_grad():
    state = scene("cpu", 0, 0)
    assert not pp.needs_grad(state)
    state = state.replace(params=state.params.replace(
        rotation=state.params.rotation.requires_grad_(True)))
    assert pp.needs_grad(state)
    with torch.no_grad():
        assert not pp.needs_grad(state)


@pytest.mark.parametrize("seed", [0, 1])
def test_table_views_read_back_through_pack_features(seed):
    P = 300
    table = torch.randn((P, N_FEAT), generator=torch.Generator().manual_seed(seed))
    out = PreprocessOut(table, torch.ones(P, dtype=torch.bool), torch.zeros(P),
                        torch.ones(P, dtype=torch.bool))
    packed = pack_table(**{f: getattr(out, f) for f in COLUMNS})
    assert torch.equal(packed, table)
    assert torch.equal(out.depth, out.view_point[:, 2])
    for f in FIELDS:  # views of the table, not copies
        assert getattr(out, f).untyped_storage().data_ptr() == table.untyped_storage().data_ptr()
        with pytest.raises(TypeError):  # no field is held apart from the table
            out.replace(**{f: getattr(out, f) + 1})


def test_table_views_have_the_plain_shapes_and_dtypes():
    state, cam = scene("cpu", 2, 1), camera("cpu")
    want = pp.preprocess_torch(state, cam, 0.1, compute_invraycov=True)
    P = state.capacity
    got = PreprocessOut(torch.zeros((P, N_FEAT)), torch.zeros(P, dtype=torch.bool),
                        torch.zeros(P), torch.zeros(P, dtype=torch.bool), torch.zeros((P, 3, 3)))
    for f in FIELDS + ("valid", "radius", "well_conditioned", "invraycov"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a.shape, a.dtype) == (b.shape, b.dtype), f


def test_scene_exercises_every_branch():
    state, cam = scene("cpu"), camera("cpu")
    prep = pp.preprocess_torch(state, cam, 0.0)
    act = state.active
    assert (act & ~prep.valid).any() and (act & prep.valid).any()
    assert (act & (prep.depth <= 0.2)).any()  # behind the near plane
    limx = 1.3 * float(cam.tanfovx)
    assert (act & prep.valid & (prep.view_point[:, 0] / prep.depth).abs().gt(limx)).any()
    assert (act & ~prep.well_conditioned).any() and (act & prep.well_conditioned).any()
    assert not act[1024:1280].any() and not act.all()


# ---- on the card ----------------------------------------------------------


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the preprocess kernel has no CPU mode")
    return torch.device("cuda")


def same_bits(name, got, want, rows):
    a = getattr(got, name)[rows]
    b = getattr(want, name)[rows].reshape(a.shape)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name


@pytest.mark.cuda
@pytest.mark.parametrize("degree,active,kernel_size,modifier,inv,capacity", CASES)
def test_kernel_matches_plain(degree, active, kernel_size, modifier, inv, capacity):
    dev = card()
    state, cam = scene(dev, degree, active, capacity=capacity), camera(dev)
    with torch.no_grad():
        want = pp.preprocess_torch(state, cam, kernel_size, modifier, inv)
        got = pp.preprocess_forward(state, cam, kernel_size, modifier, inv)
    torch.cuda.synchronize()
    act = state.active
    for f in ("radius", "valid", "well_conditioned"):
        assert torch.equal(getattr(got, f)[act], getattr(want, f)[act]), f
    assert not (got.valid & ~act).any()
    both = got.valid & want.valid
    assert both.sum().item() > n_active(capacity) // 2
    for f in FIELDS:
        same_bits(f, got, want, both)
    # an inactive row is zeros
    off = ~act
    for f in FIELDS:
        assert (getattr(got, f)[off] == 0).all(), f
    assert (got.radius[off] == 0).all() and not got.well_conditioned[off].any()
    if inv:
        same_bits("invraycov", got, want, both)
        ill = both & ~want.well_conditioned
        assert ill.any() and torch.isfinite(got.invraycov[ill]).all()
        assert (got.invraycov[off] == 0).all()
    else:
        assert got.invraycov is None


@pytest.mark.cuda
def test_render_without_gradient_matches_render_with_it(monkeypatch):
    dev = card()
    state, cam = scene(dev), camera(dev)
    bg = torch.zeros(3, device=dev)
    kw = dict(kernel_size=0.1, max_per_tile=256, instance_budget=1 << 16, device=dev)
    before = dict(pp.LAUNCHES)
    with torch.no_grad():
        fused = renderer.render(state, cam, bg, **kw)
    assert pp.LAUNCHES["preprocess_fwd[sh=3,inv=0]"] == before["preprocess_fwd[sh=3,inv=0]"] + 1
    grad_state = state.replace(params=state.params.map(lambda x: x.clone().requires_grad_(True)))
    # the view with gradient through the plain version (on a card it takes
    # the kernel pair, whose forward is the kernel above)
    monkeypatch.setattr(pp, "preprocess_train", pp.preprocess_torch)
    plain = renderer.render(grad_state, cam, bg, **kw)
    assert dict(pp.LAUNCHES) == {k: v + (k == "preprocess_fwd[sh=3,inv=0]")
                                 for k, v in before.items()}
    assert int(fused["binning"].n_overflow) == 0
    for k in ("render", "mask", "expected_depth", "median_depth", "expected_coord",
              "median_coord", "normal"):
        assert torch.equal(fused[k], plain[k].detach()), k


@pytest.mark.cuda
def test_a_served_view_syncs_once_and_launches_once():
    dev = card()
    state, cam = scene(dev), camera(dev)
    bg = torch.zeros(3, device=dev)

    def view():
        return renderer.render(state, cam, bg, kernel_size=0.1, max_per_tile=256,
                               instance_budget=1 << 16, device=dev, events=[])

    view()
    torch.cuda.synchronize()
    trace.reset()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            view()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    n = sum("called a synchronizing CUDA operation" in str(w.message) for w in got)
    (u,) = trace.units()
    # the binning kernels' read of their totals is the view's one sync
    assert n == u["syncs"] == 1
    assert set(u["sites"]) == {"binning.total"}
    assert u["counts"]["launches.preprocess.preprocess_fwd[sh=3,inv=0]"] == 1
    assert "preprocess.plain" not in u["counts"]


@pytest.mark.cuda
def test_a_train_step_takes_the_plain_version():
    dev = card()
    state, cam = scene(dev), camera(dev)
    gt = torch.rand((3, H, W), generator=torch.Generator().manual_seed(4)).to(dev)
    step = loop.make_train_step(ModelConfig(kernel_size=0.1),
                                OptimizationConfig(regularization_from_iter=0),
                                PipelineConfig(max_per_tile=256, instance_budget=1 << 16), 1.0)
    trace.reset()
    step(loop.init_train_state(state), cam, gt, torch.zeros(3, device=dev), 0, W, H,
         events=[])
    torch.cuda.synchronize()
    (u,) = trace.units()
    launches = {k: v for k, v in u["counts"].items() if k.startswith("launches.preprocess")}
    assert launches == {"launches.preprocess.preprocess_fwd[sh=3,inv=0]": 1,
                        "launches.preprocess.preprocess_bwd[sh=3]": 1}
    assert "preprocess.plain" not in u["counts"]


@pytest.mark.cuda
def test_a_train_step_hands_the_table_over_by_pointer(monkeypatch):
    """One ``make_train_step`` step: both blend kernels read the table the
    preprocess kernel wrote, and the preprocess backward reads the blend
    backward's gradient buffer at its row stride, each at its own pointer."""
    dev = card()
    state, cam = scene(dev), camera(dev)
    gt = torch.rand((3, H, W), generator=torch.Generator().manual_seed(4)).to(dev)
    step = loop.make_train_step(ModelConfig(kernel_size=0.1),
                                OptimizationConfig(regularization_from_iter=0),
                                PipelineConfig(max_per_tile=256, instance_budget=1 << 16), 1.0)
    seen = {}

    def recorded(name, fn, picks):
        def call(*a):
            seen.setdefault(name, []).append(tuple(a[i] for i in picks))
            return fn(*a)
        return call

    fwd_entry, bwd_entry, blend_entry = pp._entry, pp._bwd_entry, blend._entry
    # preprocess_fwd: the table; preprocess_bwd: the gradient and its row
    # stride; blend_fwd: the table; blend_bwd: the table and the gradient
    monkeypatch.setattr(pp, "_entry", lambda: recorded("preprocess_fwd", fwd_entry(), (12,)))
    monkeypatch.setattr(pp, "_bwd_entry",
                        lambda: recorded("preprocess_bwd", bwd_entry(), (12, 19)))
    monkeypatch.setattr(blend, "_entry", lambda name: recorded(
        name, blend_entry(name), (0,) if name == "blend_fwd" else (0, 9)))
    step(loop.init_train_state(state), cam, gt, torch.zeros(3, device=dev), 0, W, H)
    torch.cuda.synchronize()
    ((table,),) = seen["preprocess_fwd"]
    assert seen["blend_fwd"] == [(table,)]
    # the walk and the segment sum, launched one at a time
    assert seen["blend_bwd"][0][0] == table and len(set(seen["blend_bwd"])) == 1
    grad = seen["blend_bwd"][0][1]
    assert seen["preprocess_bwd"] == [(grad, blend.GRAD_COLS)]
