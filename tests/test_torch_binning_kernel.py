"""Binning on a card (``csrc/binning.cu`` behind ``ops/binning.bin_gaussians``)
against the plain version ``bin_gaussians_torch``. Torch only, so the
card's machine runs it: ``python -m pytest --noconftest -q
tests/test_torch_binning_kernel.py``; the ``cuda`` tests skip without a card.

On the CPU: ``bin_gaussians`` is the plain version and makes no launch; the
kernels' wrapper refuses CPU tensors and reads the table's columns at their
strides; the kernels' order (each row's kept tiles in row order, then one
stable sort of the keys) gives the plain version's lists, ties in depth and
-0.0 / 0.0 included, and so does it under a short budget with each row cut
to its ``budget_allow`` share.

On the card: the kernels against the plain version on the same card
tensors, ``gauss_id``, ``tile_id``, ``tile_start``, ``tile_count`` and the
five counters equal: the dense 1.2M view at 1600x1200 and a 2^23-row view of
the 6.1M scene at 1237x822 (the cells' scenes, view 0), and seeded rows:
tied depths with -0.0 and 0.0, a row count that is not a multiple of the
block, rects of more than 32 tiles (walked by the warp), no instance, no
valid row, a ``max_per_tile`` cut, the radius rects without conic and
opacity, and the table's strided columns against contiguous copies. A
view whose demand passes the budget is cut by the kernels (``budget_path``
counts it, the count kernel runs twice) and gives the plain version's lists.
"""

import math
import warnings

import numpy as np
import pytest
import torch

from radegs_torch.core.projection import N_FEAT, column
from radegs_torch.ops import binning
from radegs_torch.ops.binning import (
    MAX_PER_TILE_CAP,
    bin_gaussians,
    bin_gaussians_kernel,
    bin_gaussians_torch,
    budget_cap,
)
from radegs_torch.utils import trace

torch.set_num_threads(1)
LISTS = ("gauss_id", "tile_id", "tile_start", "tile_count")
COUNTERS = ("n_instances", "n_overflow", "tile_overflow", "max_tile_count", "n_culled")
SEED = 2147483659  # the large-scene test's seed


def rows(P, W, H, seed, device="cpu", ties=False):
    """Seeded rows as a preprocess lays them out: a (P, N_FEAT) table (xy,
    conic, opacity and depth in their columns, noise elsewhere), radius
    (3 sigma, rounded up) and valid (90%). Sigmas of 0.5-80 pixels, some
    centres off the image, a tenth of the opacities below 1/255. ``ties``:
    depths on a grid of 1/4, a seventh of them -0.0 and a seventh 0.0."""
    g = torch.Generator().manual_seed(seed)
    table = torch.randn((P, N_FEAT), generator=g)
    xy = torch.rand((P, 2), generator=g) * torch.tensor([1.3 * W, 1.3 * H]) \
        - torch.tensor([0.15 * W, 0.15 * H])
    sig = torch.exp(torch.randn((P, 2), generator=g) * 0.9 + 1.0).clamp(0.5, 80.0)
    th = torch.rand(P, generator=g) * math.pi
    co, si = torch.cos(th), torch.sin(th)
    c00 = co * co * sig[:, 0] ** 2 + si * si * sig[:, 1] ** 2
    c11 = si * si * sig[:, 0] ** 2 + co * co * sig[:, 1] ** 2
    c01 = co * si * (sig[:, 0] ** 2 - sig[:, 1] ** 2)
    det = c00 * c11 - c01 * c01
    table[:, 0:2] = xy
    table[:, 2:5] = torch.stack([c11 / det, -c01 / det, c00 / det], 1)
    op = torch.rand(P, generator=g)
    op[torch.rand(P, generator=g) < 0.1] *= 1.0 / 255.0
    table[:, 5] = op
    depth = torch.rand(P, generator=g) * 10.0 + 0.2
    if ties:
        depth = torch.floor(depth * 4.0) / 4.0
        depth[::7] = -0.0
        depth[3::7] = 0.0
    table[:, 14] = depth
    radius = torch.ceil(3.0 * sig.max(1).values)
    valid = torch.rand(P, generator=g) < 0.9
    return table.to(device), radius.to(device), valid.to(device)


def args(table, radius, valid, precise=True):
    extra = dict(conic=column(table, "conic"), opacity=column(table, "opacity")) \
        if precise else {}
    return (column(table, "xy"), radius, column(table, "depth"), valid), extra


def assert_same(got, want):
    for f in LISTS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    for f in COUNTERS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape and int(a) == int(b), f
    if want.tile_gauss is not None:
        assert torch.equal(got.tile_gauss, want.tile_gauss)


# ---- the CPU ---------------------------------------------------------------


def test_kernel_wrapper_refuses_cpu_tensors():
    (xy, radius, depth, valid), extra = args(*rows(64, 64, 48, 1))
    with pytest.raises(ValueError, match="cuda"):
        bin_gaussians_kernel(xy, radius, depth, valid, 64, 48, 1 << 12, 64, **extra)


@pytest.mark.parametrize("precise", [True, False])
def test_cpu_binning_is_the_plain_version_and_launches_nothing(precise):
    (xy, radius, depth, valid), extra = args(*rows(300, 96, 64, 2), precise)
    binning.reset_launches()
    got = bin_gaussians(xy, radius, depth, valid, 96, 64, 1 << 14, 64, **extra)
    assert dict(binning.LAUNCHES) == {k: 0 for k in binning.STAGES}
    assert binning.BUDGET_PATH["budget_path"] == 0
    assert_same(got, bin_gaussians_torch(xy, radius, depth, valid, 96, 64, 1 << 14, 64,
                                         **extra))


def test_row_args_read_the_table_at_its_strides():
    table, radius, valid = rows(10, 64, 48, 3)
    (xy, radius, depth, valid), extra = args(table, radius, valid)
    ptrs, strides = binning._row_args(xy, radius, depth, valid, extra["conic"],
                                      extra["opacity"][:, None])
    assert strides == (N_FEAT, 1, 1, N_FEAT, 1, N_FEAT, 1, N_FEAT)
    base, f = table.data_ptr(), table.element_size()
    assert [ptrs[0], ptrs[2], ptrs[4], ptrs[5]] == [base, base + 14 * f, base + 2 * f,
                                                    base + 5 * f]
    ptrs, strides = binning._row_args(xy.contiguous(), radius, depth, valid, None, None)
    assert ptrs[4:] == [None, None] and strides == (2, 1, 1, N_FEAT, 1, 0, 0, 0)
    with pytest.raises(ValueError, match="depth"):
        binning._row_args(xy, radius, depth.double(), valid, None, None)


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("ties", [False, True])
def test_row_order_keys_give_the_plain_lists(precise, ties):
    """The kernels' order, emulated: every row's kept tiles (the plain
    version's pairs), written row by row with the key tile << 32 |
    depth-bits, then one stable sort of the keys; the sorted rows and tiles
    are the plain version's lists."""
    W, H = 120, 90
    (xy, radius, depth, valid), extra = args(*rows(2000, W, H, 4, ties=ties), precise)
    want = bin_gaussians_torch(xy, radius, depth, valid, W, H, 1 << 20, 1 << 16, **extra)
    pairs = torch.stack([want.gauss_id.long(), want.tile_id.long()], 1)
    pairs = pairs[torch.argsort(pairs[:, 0] * (1 << 20) + pairs[:, 1])]  # row order
    keys = (pairs[:, 1] << 32) | binning._depth_bits(depth[pairs[:, 0]])
    order = torch.sort(keys, stable=True).indices
    assert torch.equal(pairs[order, 0].to(torch.int32), want.gauss_id)
    assert torch.equal(pairs[order, 1].to(torch.int32), want.tile_id)
    # rows past the kernels' WIDE (32 tiles), which their warp walks together
    assert int(torch.bincount(want.gauss_id.long()).max()) > 32
    if ties:  # equal keys across rows, -0.0 beside 0.0
        same = keys[order][1:] == keys[order][:-1]
        assert int(same.sum()) > 100


def plain_rects(xy, radius, valid, conic, opacity, W, H):
    """The plain version's rects and pre-cut tile counts (its first lines,
    as ``_bin_plain`` computes them): x0, y0, w, touched."""
    tx, ty = binning.tile_grid(W, H)
    ext = {}
    if conic is not None:
        tau = torch.clamp_min(2.0 * torch.log(torch.clamp_min(opacity, 1e-12) / binning.ALPHA_EPS),
                              0.0)
        a, b, c = conic[:, 0], conic[:, 1], conic[:, 2]
        det = torch.clamp_min(a * c - b * b, 1e-24)
        ext = dict(extent_x=torch.minimum(torch.sqrt(tau * c / det), radius),
                   extent_y=torch.minimum(torch.sqrt(tau * a / det), radius))
    x0, y0, w, _, touched = binning.gaussian_rects(xy, radius, tx, ty, **ext)
    alive = valid & (radius > 0) & (touched > 0)
    return x0, y0, w, torch.where(alive, touched, 0)


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("share", [0.0, 0.37, 0.999])
def test_budget_allow_gives_the_plain_starved_lists(precise, share):
    """Under a short budget the kernels keep, of each row's kept pairs, the
    first ``budget_allow`` tiles of its rect (row-major); written in row
    order and stably sorted, those are the plain version's starved lists."""
    W, H = 120, 90
    (xy, radius, depth, valid), extra = args(*rows(2000, W, H, 5, ties=True), precise)
    full = bin_gaussians_torch(xy, radius, depth, valid, W, H, 1 << 22, 1 << 16, **extra)
    demand = int(full.n_instances)
    budget = int(share * demand)
    want = bin_gaussians_torch(xy, radius, depth, valid, W, H, budget, 1 << 16, **extra)
    x0, y0, w, touched = plain_rects(xy, radius, valid, extra.get("conic"),
                                     extra.get("opacity"), W, H)
    allow = binning.budget_allow(touched.to(torch.int32), depth, budget)
    assert allow.dtype == torch.int32 and int(allow.sum()) == budget
    g, t = full.gauss_id.long(), full.tile_id.long()
    tiles_x = binning.tile_grid(W, H)[0]
    at = (t // tiles_x - y0[g]) * w[g] + t % tiles_x - x0[g]  # row-major place in the rect
    pairs = torch.stack([g, t], 1)[at < allow[g]]
    pairs = pairs[torch.argsort(pairs[:, 0] * (1 << 20) + pairs[:, 1])]  # row order
    keys = (pairs[:, 1] << 32) | binning._depth_bits(depth[pairs[:, 0]])
    order = torch.sort(keys, stable=True).indices
    assert torch.equal(pairs[order, 0].to(torch.int32), want.gauss_id)
    assert torch.equal(pairs[order, 1].to(torch.int32), want.tile_id)
    assert int(want.n_culled) == budget - pairs.shape[0]
    assert int(want.n_overflow) == demand - budget > 0


# ---- the card --------------------------------------------------------------


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the binning kernels have no CPU mode")
    return torch.device("cuda")


def both(xy, radius, depth, valid, W, H, budget, max_per_tile, **kw):
    """The kernels' and the plain version's binning of the same card
    tensors; the kernels' launches and budget-path count."""
    binning.reset_launches()
    got = bin_gaussians(xy, radius, depth, valid, W, H, budget, max_per_tile, **kw)
    launches = dict(binning.LAUNCHES), binning.BUDGET_PATH["budget_path"]
    want = bin_gaussians_torch(xy, radius, depth, valid, W, H, budget, max_per_tile, **kw)
    torch.cuda.synchronize()
    return got, want, launches


FAST = ({k: 1 for k in binning.STAGES}, 0)


def cell_view(cell):
    """View 0 of a benchmark cell's scene and its configuration, as
    ``chip_smoke.py``'s binning phase bins it."""
    card()
    from chip_smoke import cell_view

    return cell_view(cell, SEED)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["train-surface-1.2M", "train-surface-6.1M"])
def test_card_cell_view_lists_are_the_plain_ones(cell):
    from radegs_torch.ops.rasterize import bin_prep

    cfg, prep = cell_view(cell)
    W, H, budget = cfg["width"], cfg["height"], budget_cap(cfg["capacity"])
    binning.reset_launches()
    got = bin_prep(prep, W, H, budget, MAX_PER_TILE_CAP, need_tile_gauss=False)
    assert (dict(binning.LAUNCHES), binning.BUDGET_PATH["budget_path"]) == FAST
    want = bin_gaussians_torch(column(prep.table, "xy"), prep.radius, column(prep.table, "depth"),
                               prep.valid, W, H, budget, MAX_PER_TILE_CAP,
                               conic=column(prep.table, "conic"),
                               opacity=column(prep.table, "opacity"))
    torch.cuda.synchronize()
    assert_same(got, want)
    assert int(got.n_instances) > 4_000_000 and int(got.n_culled) > 0
    assert int(got.tile_overflow) == 0 and int(got.n_overflow) == 0


CASES = {
    # name: (P, W, H, ties, max_per_tile, precise)
    "ties_and_signed_zeros": (20_000, 256, 192, True, 1 << 16, True),
    "ragged_rows": (1_000_003, 1237, 822, False, 1 << 16, True),
    "max_per_tile_cut": (50_000, 320, 240, False, 40, True),
    "radius_rects": (200_001, 640, 480, True, 1 << 16, False),
    "one_row": (1, 64, 48, False, 64, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_card_rows_lists_are_the_plain_ones(case):
    dev = card()
    P, W, H, ties, mpt, precise = CASES[case]
    table, radius, valid = rows(P, W, H, 7 + P, dev, ties)
    if case == "one_row":
        valid[:] = True
        table[0, 0:2] = torch.tensor([30.0, 20.0])
    (xy, radius, depth, valid), extra = args(table, radius, valid, precise)
    got, want, launches = both(xy, radius, depth, valid, W, H, 1 << 26, mpt, **extra)
    assert launches == FAST
    assert_same(got, want)
    assert int(got.gauss_id.numel()) > 0
    assert (int(got.tile_overflow) > 0) == (case == "max_per_tile_cut")
    assert (int(got.n_culled) > 0) == (precise and P > 1)
    if ties:
        keys = (got.tile_id.long() << 32) | binning._depth_bits(depth[got.gauss_id.long()])
        assert int((keys[1:] == keys[:-1]).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("empty", ["off_image", "none_valid", "no_rows"])
def test_card_no_instance(empty):
    dev = card()
    table, radius, valid = rows(0 if empty == "no_rows" else 5000, 128, 96, 8, dev)
    if empty == "off_image":
        table[:, 0:2] = -1e4
    if empty == "none_valid":
        valid[:] = False
    (xy, radius, depth, valid), extra = args(table, radius, valid)
    got, want, launches = both(xy, radius, depth, valid, 128, 96, 1 << 16, 64,
                               need_tile_gauss=True, **extra)
    assert_same(got, want)
    assert int(got.n_instances) == 0 and got.gauss_id.numel() == 0
    assert torch.equal(got.tile_start, torch.zeros_like(got.tile_start))
    assert got.tile_gauss.shape == want.tile_gauss.shape == (48, 0)


@pytest.mark.cuda
def test_card_strided_columns_read_as_contiguous_copies():
    dev = card()
    table, radius, valid = rows(30_001, 400, 300, 9, dev)
    (xy, radius, depth, valid), extra = args(table, radius, valid)
    got = bin_gaussians(xy, radius, depth, valid, 400, 300, 1 << 22, 1 << 12, **extra)
    radius_s = torch.stack([radius, radius], 1)[:, 0]  # stride 2
    valid_s = torch.stack([valid, valid], 1)[:, 1]
    again = bin_gaussians(xy.contiguous(), radius_s, depth.contiguous(), valid_s, 400, 300,
                          1 << 22, 1 << 12, conic=extra["conic"].contiguous(),
                          opacity=extra["opacity"].contiguous()[:, None])
    assert_same(again, got)
    assert_same(got, bin_gaussians_torch(xy, radius, depth, valid, 400, 300, 1 << 22, 1 << 12,
                                         **extra))


@pytest.mark.cuda
@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("share", [0.0, 0.5, 0.999])
def test_card_starved_budget_is_cut_by_the_kernels(precise, share):
    dev = card()
    table, radius, valid = rows(20_000, 256, 192, 10, dev)
    (xy, radius, depth, valid), extra = args(table, radius, valid, precise)
    n = int(bin_gaussians(xy, radius, depth, valid, 256, 192, 1 << 26, 1 << 16,
                          **extra).n_instances)
    budget = int(share * n)
    got, want, launches = both(xy, radius, depth, valid, 256, 192, budget, 1 << 16,
                               need_tile_gauss=True, **extra)
    assert launches == ({"binning_count": 2, "binning_duplicate": 1, "binning_ranges": 1}, 1)
    assert_same(got, want)
    assert int(got.n_overflow) == n - budget
    assert got.gauss_id.numel() == budget - int(got.n_culled)
    # at the demand itself nothing is cut: the kernels' path
    _, _, launches = both(xy, radius, depth, valid, 256, 192, n, 1 << 16, **extra)
    assert launches == FAST


@pytest.mark.cuda
def test_card_a_cut_view_syncs_twice():
    """A view the budget cuts reads the device twice, at ``binning.total``
    and at ``binning.budget`` (its kept total after the cut), as
    ``torch.cuda.set_sync_debug_mode`` counts them."""
    dev = card()
    table, radius, valid = rows(20_000, 256, 192, 10, dev)
    (xy, radius, depth, valid), extra = args(table, radius, valid)
    n = int(bin_gaussians(xy, radius, depth, valid, 256, 192, 1 << 26, 1 << 16,
                          **extra).n_instances)
    torch.cuda.synchronize()
    trace.reset()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with trace.unit("view", [], dev):
                bin_gaussians(xy, radius, depth, valid, 256, 192, n // 2, 1 << 16, **extra)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = sum("called a synchronizing CUDA operation" in str(w.message) for w in got)
    (u,) = trace.units()
    assert syncs == u["syncs"] == 2
    assert {k: v[0] for k, v in u["sites"].items()} == {"binning.total": 1, "binning.budget": 1}
    assert u["counts"]["binning.budget_path"] == 1
    assert u["gauges"] == {"binning.instances": n, "binning.budget_cut": n - n // 2}


@pytest.mark.cuda
def test_card_kernels_are_deterministic():
    dev = card()
    table, radius, valid = rows(400_000, 1237, 822, 11, dev, ties=True)
    (xy, radius, depth, valid), extra = args(table, radius, valid)
    runs = [bin_gaussians(xy, radius, depth, valid, 1237, 822, 1 << 24, 1 << 16, **extra)
            for _ in range(2)]
    assert_same(runs[0], runs[1])


def test_depth_bits_order_matches_float_order():
    d = torch.tensor([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, np.inf], dtype=torch.float32)
    bits = binning._depth_bits(d)
    assert torch.all(bits[1:] >= bits[:-1]) and int(bits[3]) == int(bits[4])
    assert int(bits.min()) >= 0 and int(bits.max()) < 1 << 32
