"""The forward blend kernel (``csrc/blend_fwd.cu``) at the parameters of its
design, on the 72x50 scene of ``test_torch_blend_kernel.py`` (ragged and
empty tiles, a starved ``max_per_tile``) with 24 of its Gaussians made large
and moved in front: no pixel of that scene ends (its T stays >= 1e-4), here
979 pixels do and every pixel of two tiles does, after 12 and 41 of their 64
contributors (a tile's early exit). Torch only, so the card's machine runs
it:
``python -m pytest --noconftest tests/test_torch_blend_fwd_kernel.py``; the
``cuda`` tests skip without a card.

On the CPU: ``count_work``'s counts of the least work of the bound equal
direct counts over each pixel's walk: ``n_alpha`` (the walked pairs whose
alpha reaches 1/255, the pairs that need the exp) and ``n_row`` / ``n_col``
/ ``n_col_incl`` (the (contributor, tile row) and (contributor, tile column)
pairs with a walked pixel, the columns with a blended one). Then two
integrate tests on this scene's gates (``test_integrate_*``: the integrate
kernels take the exp skip and the tile order, the forward kernel neither,
since it measured slower with them): every pair that
``ops/integrate.py:skip_below`` spares the exp has alpha < 1/255 under the
full gate (on the scene, and at the largest spared power of opacities over
(0, 1]); ``heaviest_first`` is a permutation of the tiles, heaviest first,
ties in tile order.

On the card, the kernel as the package builds it and copies of its source
with other constants (``build.build_copies``: 2 and 1 pixels a thread, 1- and
64-instance rounds, 2- and 4-stage rings) each give, through
``blend.blend_forward``: the float outputs within abs 1e-4 of
``blend_forward_torch`` (FMA contraction and the order of a few products
differ) with at most 1e-4 of the pixels on another median contributor and no
median error where it is the same, the same bits at one and at two tiles per
block, and the same bits run to run; its C entry refuses three tiles a
block.
"""

import ctypes
import pathlib

import numpy as np
import pytest
import torch

from radegs_torch.core.camera import Camera
from radegs_torch.core.projection import column, preprocess_gaussians
from radegs_torch.native import build
from radegs_torch.ops import blend
from radegs_torch.ops import integrate as ig
from radegs_torch.ops.rasterize import bin_prep

torch.set_num_threads(1)
W, H = 72, 50
MAX_PER_TILE = 64
N_FRONT = 24  # large near-opaque Gaussians in front
ABS_TOL, MED_POS_TOL = 1e-4, 1e-4
COPIES = {"K=2": {"K": 2, "MIN_TILES": 4}, "K=1": {"K": 1, "MIN_TILES": 4},
          "RB=1": {"RB": 1}, "RB=64": {"RB": 64}, "STAGES=2": {"STAGES": 2},
          "STAGES=4": {"STAGES": 4}}
BUILD = pathlib.Path(__file__).resolve().parents[1] / "build" / "tests" / "blend_fwd"


def scene(device):
    """The 200 seeded Gaussians of ``test_torch_blend_kernel.scene``, right
    of centre, a quarter near-opaque; the first N_FRONT of them at scale 0.5
    in front (z = -1.5) of the right half, so pixels and whole tiles end;
    binned with a starved cut."""
    rng = np.random.default_rng(12)
    P = 200

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    q = rng.normal(size=(P, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    opac = rng.uniform(0.2, 0.9, (P, 1))
    opac[: P // 4] = 0.99
    means = rng.normal(size=(P, 3)) * 0.4 + [0.9, 0, 0]
    scales = np.exp(rng.normal(size=(P, 3)) * 0.4 - 2.0)
    means[:N_FRONT] = np.stack([rng.uniform(0.4, 1.4, N_FRONT), rng.uniform(-0.4, 0.4, N_FRONT),
                                np.full(N_FRONT, -1.5)], 1)
    scales[:N_FRONT] = 0.5
    cam = Camera.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0], 0.9, 0.9, W, H, device=device)
    prep = preprocess_gaussians(t(means), t(scales), t(q), t(opac),
                                t(rng.uniform(0, 1, (P, 1, 3))), sh_degree=0, camera=cam,
                                kernel_size=0.1)
    binning = bin_prep(prep, W, H, instance_budget=1 << 12, max_per_tile=MAX_PER_TILE,
                       need_tile_gauss=True)
    return binning, prep.table


def pair_gates(binning, table):
    """Every (tile, contributor k, pixel) of the scene's ``tile_gauss``
    through the full gate in float32, as the plain walk computes it: ids
    (T, K), power and alpha (T, K, 256), the candidacy (power <= 0 and alpha
    >= 1/255) and the contributor's skip_below."""
    xy, conic, opacity = (column(table, f) for f in ("xy", "conic", "opacity"))
    tg = binning.tile_gauss.to(torch.int64)
    ids = tg.clamp_min(0)
    pix_x, pix_y = blend.tile_pixel_coords(W, H, xy.device)
    dx = xy[ids, 0, None] - pix_x[:, None, :]
    dy = xy[ids, 1, None] - pix_y[:, None, :]
    con = conic[ids]
    power = (-0.5 * (con[..., 0, None] * dx * dx + con[..., 2, None] * dy * dy)
             - con[..., 1, None] * dx * dy)
    alpha = torch.clamp_max(opacity[ids, None] * torch.exp(torch.clamp_max(power, 0.0)),
                            blend.MAX_ALPHA)
    cand = (tg >= 0)[..., None] & (power <= 0.0) & (alpha >= blend.ALPHA_EPS)
    return tg, power, alpha, cand, ig.skip_below(opacity)[ids]


def direct_walk(binning, alpha, cand):
    """Each pixel's walk, as (T, K, 256) masks: ``walked`` (the contributors
    up to and including the one whose alpha takes T below 1e-4: that one
    ends the pixel and is excluded), ``hit`` (walked, alpha >= 1/255) and
    ``blended``."""
    T = torch.ones(alpha.shape[0], alpha.shape[2])
    live = torch.ones_like(T, dtype=torch.bool)
    walked, hit, blended = [], [], []
    for k in range(alpha.shape[1]):
        walked.append(live & (binning.tile_gauss[:, k, None] >= 0))
        hit.append(walked[-1] & cand[:, k])
        next_t = T * (1.0 - alpha[:, k])
        ends = hit[-1] & (next_t < blend.T_EPS)
        blended.append(hit[-1] & ~ends)
        T = torch.where(blended[-1], next_t, T)
        live = live & ~ends
    return torch.stack(walked, 1), torch.stack(hit, 1), torch.stack(blended, 1)


def test_count_work_n_alpha_is_a_direct_count():
    binning, table = scene("cpu")
    work = blend.blend_forward_torch(binning.tile_gauss, table, W, H, count_work=True)
    _, _, alpha, cand, _ = pair_gates(binning, table)
    walked, hit, blended = direct_walk(binning, alpha, cand)
    n_alpha, n_eval = int(hit.sum()), int(walked.sum())
    assert int(work["n_alpha"]) == n_alpha > 0
    assert int(work["n_eval"]) == n_eval > n_alpha
    assert 0 < int(work["n_incl"]) == int(blended.sum()) < n_alpha  # n_alpha counts the last


def test_count_work_row_and_column_counts_are_direct_counts():
    """The terms of dx alone are needed once per walked (contributor, tile
    column), those of dy alone once per walked (contributor, tile row), the
    blend's dx halves once per (contributor, tile column) with a blended
    pixel (pixel i of a tile: row i // 16, column i % 16)."""
    binning, table = scene("cpu")
    work = blend.blend_forward_torch(binning.tile_gauss, table, W, H, count_work=True)
    _, _, alpha, cand, _ = pair_gates(binning, table)
    walked, _, blended = direct_walk(binning, alpha, cand)
    T, K = walked.shape[:2]
    grid = walked.view(T, K, 16, 16)  # [tile, contributor, pixel row, pixel column]
    n_row, n_col = int(grid.any(3).sum()), int(grid.any(2).sum())
    n_col_incl = int(blended.view(T, K, 16, 16).any(2).sum())
    assert int(work["n_row"]) == n_row and int(work["n_col"]) == n_col
    assert int(work["n_col_incl"]) == n_col_incl
    # a tile's walked pairs share rows and columns (up to 16 pairs each)
    assert 0 < n_col_incl < n_col and int(work["n_eval"]) > 4 * max(n_row, n_col)


def test_scene_exercises_every_branch():
    binning, table = scene("cpu")
    assert int(binning.n_overflow) == 0
    assert int(binning.tile_overflow) > 0  # the max_per_tile cut
    assert (binning.tile_count == 0).any()  # an empty tile
    work = blend.blend_forward_torch(binning.tile_gauss, table, W, H, count_work=True)
    assert int(work["n_alpha"] - work["n_incl"]) > 500  # pixels that end
    assert (work["med_pos"] >= 0).any()
    # every pixel of a tile with more than 32 rows (one round) ends in its first
    _, _, alpha, cand, _ = pair_gates(binning, table)
    walked, _, _ = direct_walk(binning, alpha, cand)
    assert ((~walked[:, 32:].any(2)).all(1) & (binning.tile_count > 32)).any()


# the integrate kernels' exp skip and tile order, on this scene's gates


def test_integrate_skip_below_spares_only_pairs_under_the_alpha_gate():
    binning, table = scene("cpu")
    tg, power, alpha, _, skip = pair_gates(binning, table)
    spared = (tg >= 0)[..., None] & (power < skip[..., None])
    assert spared.sum() > 1000  # the scene's pairs mostly lie far out
    assert (alpha[spared] < blend.ALPHA_EPS).all()
    assert (alpha[(tg >= 0)[..., None] & ~spared] >= blend.ALPHA_EPS).any()


def test_integrate_skip_below_holds_at_its_edge_for_any_opacity():
    """At the largest power it spares, alpha stays under 1/255, for 20001
    opacities over (0, 1] (0.99 included, 0 spared everywhere)."""
    o = torch.cat([torch.linspace(1e-4, 1.0, 20000), torch.tensor([0.99])])
    edge = torch.nextafter(ig.skip_below(o), torch.tensor(-torch.inf))
    alpha = torch.clamp_max(o * torch.exp(edge), blend.MAX_ALPHA)
    assert (alpha < blend.ALPHA_EPS).all()
    # the margin leaves the exp to pairs within ~0.1% of the 1/255 edge
    assert (alpha > blend.ALPHA_EPS * 0.998).all()
    assert torch.isinf(ig.skip_below(torch.zeros(3))).all()


def test_integrate_heaviest_first_is_a_stable_descending_permutation():
    binning, _ = scene("cpu")
    count = binning.tile_count
    order = ig.heaviest_first(count)
    assert order.dtype == torch.int32
    assert torch.equal(torch.sort(order).values, torch.arange(count.numel(), dtype=torch.int32))
    c = count[order.long()]
    assert (c[1:] <= c[:-1]).all()
    ties = c[1:] == c[:-1]
    assert ties.any() and (order[1:][ties] > order[:-1][ties]).all()
    assert (count == 0).any() and (c[-int((count == 0).sum()):] == 0).all()


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the forward kernel has no CPU mode")
    binning, table = scene("cuda")
    return binning, table, blend.blend_forward_torch(binning.tile_gauss, table, W, H)


@pytest.fixture(scope="module")
def copies():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernel copies build there")
    src = (build.CSRC / "blend_fwd.cu").read_text()
    texts = {k: (build.with_constants(src, v), build.CSRC) for k, v in COPIES.items()}
    fns = {}
    for k, (lib, _) in build.build_copies(texts, BUILD).items():
        fn = lib.radegs_blend_fwd
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[k] = fn
    return fns


def check_kernel(card):
    binning, table, plain = card
    k1 = blend.blend_forward(binning, table, W, H, tiles_per_block=1)
    k2 = blend.blend_forward(binning, table, W, H, tiles_per_block=2)
    k2b = blend.blend_forward(binning, table, W, H, tiles_per_block=2)
    torch.cuda.synchronize()
    for k, v in plain.items():
        assert torch.equal(k1[k], k2[k]) and torch.equal(k2[k], k2b[k]), k
    same = k2["med_pos"] == plain["med_pos"]
    assert 1.0 - same.float().mean().item() <= MED_POS_TOL
    for k, v in plain.items():
        if k == "med_pos":
            continue
        err = (k2[k] - v).abs()
        if k in ("med_t", "med_coord"):  # where the median contributor is the same
            err = err[..., same]
        assert err.max().item() <= ABS_TOL, k


@pytest.mark.cuda
def test_kernel_matches_plain(card):
    check_kernel(card)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(COPIES))
def test_kernel_copy_matches_plain(card, copies, name, monkeypatch):
    monkeypatch.setattr(blend, "_entry", lambda kernel: copies[name])
    check_kernel(card)


@pytest.mark.cuda
def test_entry_refuses_another_tiles_per_block(card):
    binning, table, _ = card
    T, tiles_x = blend._kernel_inputs(binning, table, W, H, 2)
    out = torch.empty((T, blend.N_OUT, 256), device="cuda")
    med = torch.empty((T, 256), dtype=torch.int32, device="cuda")
    rc = blend._entry("blend_fwd")(
        table.data_ptr(), binning.gauss_id.data_ptr(), binning.tile_start.data_ptr(),
        binning.tile_count.data_ptr(), out.data_ptr(), med.data_ptr(), T, tiles_x, 3,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 1  # cudaErrorInvalidValue
