"""The backward blend kernel (``csrc/blend_bwd.cu``) at the parameters of its
design, on a scene of the port alone (torch only, so the card's machine runs
it: ``python -m pytest --noconftest tests/test_torch_blend_kernel.py``; the
``cuda`` tests skip without a card). The scene is 72x50 (ragged tiles),
with empty tiles, pixels that end early and a starved ``max_per_tile``.

On the card, the kernel as the package builds it and copies of its source
with other constants (``build.build_copies``: 2 pixels a thread, a
2-stage ring, 1- and 32-instance rounds, unpadded 25-float instance rows,
one row at a time in the segment sum) each give, through
``blend.blend_backward``: every gradient field within 1e-4 x max |plain|
of ``blend_backward_torch`` (the kernel sums in another order), the same bits
at one and at two tiles per block, and the same bits run to run.
"""

import ctypes
import pathlib

import numpy as np
import pytest
import torch

from radegs_torch.core.camera import Camera
from radegs_torch.core.projection import COLUMNS, column, preprocess_gaussians
from radegs_torch.native import build
from radegs_torch.ops import blend
from radegs_torch.ops.rasterize import bin_prep

torch.set_num_threads(1)
W, H = 72, 50
MAX_PER_TILE = 48
REL = 1e-4
COPIES = {"K=2": {"K": 2}, "STAGES=2": {"STAGES": 2}, "RB=1": {"RB": 1}, "RB=32": {"RB": 32},
          "ROW=25": {"ROW": 25}, "SEG_BATCH=1": {"SEG_BATCH": 1}}
BUILD = pathlib.Path(__file__).resolve().parents[1] / "build" / "tests" / "blend_bwd"


def scene(device):
    """200 seeded Gaussians right of centre (the left tiles stay empty), a
    quarter of them near-opaque (pixels end), binned with a starved cut."""
    rng = np.random.default_rng(12)
    P = 200

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    q = rng.normal(size=(P, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    opac = rng.uniform(0.2, 0.9, (P, 1))
    opac[: P // 4] = 0.99
    cam = Camera.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0], 0.9, 0.9, W, H, device=device)
    prep = preprocess_gaussians(t(rng.normal(size=(P, 3)) * 0.4 + [0.9, 0, 0]),
                                t(np.exp(rng.normal(size=(P, 3)) * 0.4 - 2.0)), t(q), t(opac),
                                t(rng.uniform(0, 1, (P, 1, 3))), sh_degree=0, camera=cam,
                                kernel_size=0.1)
    binning = bin_prep(prep, W, H, instance_budget=1 << 12, max_per_tile=MAX_PER_TILE,
                       need_tile_gauss=True)
    fwd = blend.blend_forward(binning, prep.table, W, H)
    rng = np.random.default_rng(5)
    cot = {k: t(rng.normal(size=tuple(fwd[k].shape))) for k in blend.DIFF_KEYS}
    return binning, prep.table, fwd, cot


def fields_of(grad):
    """The gradient buffer as per-field views: the table's fields, xy_abs."""
    return {**{f: column(grad, f) for f in COLUMNS}, "xy_abs": grad[:, blend.XY_ABS:]}


def rel_err(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def test_scene_exercises_every_branch():
    binning, _, fwd, _ = scene("cpu")
    assert int(binning.n_overflow) == 0
    assert int(binning.tile_overflow) > 0  # the max_per_tile cut
    assert (binning.tile_count == 0).any()  # empty tiles
    assert (fwd["t_final"] < 1e-3).any()  # pixels end early
    assert (fwd["med_pos"] >= 0).any()


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the backward kernel has no CPU mode")
    binning, table, fwd, cot = scene("cuda")
    plain = fields_of(blend.blend_backward_torch(binning.tile_gauss, table, fwd, cot, W, H))
    return binning, table, fwd, cot, plain


@pytest.fixture(scope="module")
def copies():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernel copies build there")
    src = (build.CSRC / "blend_bwd.cu").read_text()
    built = build.build_copies({k: (build.with_constants(src, v), build.CSRC)
                                for k, v in COPIES.items()}, BUILD)
    fns = {}
    for k, (lib, _) in built.items():
        fn = lib.radegs_blend_bwd
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[k] = fn
    return fns


def check_kernel(card):
    binning, table, fwd, cot, plain = card
    g1, g2, g2b = (fields_of(blend.blend_backward(binning, table, fwd, cot, W, H,
                                                  tiles_per_block=g)) for g in (1, 2, 2))
    torch.cuda.synchronize()
    for k, v in plain.items():
        assert torch.equal(g1[k], g2[k]) and torch.equal(g2[k], g2b[k]), k
        assert rel_err(g2[k], v) <= REL, k


@pytest.mark.cuda
def test_kernel_matches_plain(card):
    check_kernel(card)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(COPIES))
def test_kernel_copy_matches_plain(card, copies, name, monkeypatch):
    monkeypatch.setattr(blend.build, "entry", lambda *a: copies[name])
    check_kernel(card)
