"""The blend, forward and backward: the CUDA kernels ``csrc/blend_fwd.cu``
behind ``blend_forward`` and ``csrc/blend_bwd.cu`` behind ``blend_backward``,
and their plain PyTorch versions ``blend_forward_torch`` /
``blend_backward_torch`` (ports of ``radegs_tpu/ops/rasterize.py``
``_blend_forward_scan`` / ``_blend_backward_scan``).

Both return the raw-accumulator dict of the JAX package, channels leading:
``color_raw`` (3,T,256), ``weight`` (T,256), ``dist_raw`` (T,256),
``coord_raw`` (3,T,256), ``normal_raw`` (3,T,256), ``t_final`` (T,256),
``med_t`` (T,256), ``med_coord`` (3,T,256) and ``med_pos`` (T,256) int32 —
for each 16x16 tile (row-major tiles, row-major pixels inside a tile).

Per contributor, front to back (forward.cu:550-611): power =
-0.5(a dx^2 + c dy^2) - b dx dy, skipped if > 0; alpha = min(0.99,
op exp(power)), skipped if < 1/255; if T (1 - alpha) < 1e-4 the pixel is
done and that contributor is excluded; otherwise it accumulates with
w = alpha T. The median is the last included contributor with T > 0.5.

``table`` is the per-Gaussian table of the preprocess (P, 24)
(``core/projection.py``: its columns, opacity 0 where a row is not valid).

The backward re-walks each pixel's contributors front to back with the
forward's gates, and gets each contributor's "everything behind me" term as
(total - inclusive prefix) + g_tf T_final, over 1 - alpha. The cotangents
are constant along a pixel's walk, so the per-channel prefixes collapse into
one prefix of w dL/dw (the identity of pallas_blend.py:738-743). It returns
one (P, GRAD_COLS) buffer: the gradient of the table in the table's column
order, then the GOF densification side channel ``xy_abs`` = sum |e_x| W/2 +
|e_y| H/2 (rasterize.py:344-347) at ``XY_ABS`` and a zero column, so
``[:, XY_ABS:]`` is xy_abs's (P, 2) gradient with column 1 zero.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from radegs_torch.core.projection import COLUMNS, N_FEAT, column
from radegs_torch.native import build
from radegs_torch.ops.binning import TILE, TileBinning, tile_grid
from radegs_torch.utils import trace
from radegs_torch.utils.device import on_device
from radegs_torch.utils.trace import mark

ALPHA_EPS = 1.0 / 255.0
T_EPS = 1e-4
MAX_ALPHA = 0.99
N_OUT = 17
XY_ABS = N_FEAT  # the gradient buffer: the table's columns, xy_abs, a zero
GRAD_COLS = N_FEAT + 2
N_AUX = 28
INST_ROW = 32  # floats per instance row of the backward kernel's scratch (ROW)
# the raw outputs that carry a cotangent (med_pos does not)
DIFF_KEYS = ("color_raw", "weight", "dist_raw", "coord_raw", "normal_raw", "t_final",
             "med_t", "med_coord")
# rows of the packed (T, 17, 256) forward output (pallas_blend.py:28-30);
# row 16 holds med_pos as a float value
RAW_ROWS = {"color_raw": slice(0, 3), "weight": 3, "dist_raw": 4, "coord_raw": slice(5, 8),
            "normal_raw": slice(8, 11), "med_t": 11, "med_coord": slice(12, 15),
            "t_final": 15}

# kernel launches per kernel and tiles-per-block variant, counted by the
# wrappers where they launch a kernel and nowhere else (the tracer's group
# "launches.blend")
LAUNCHES = trace.counters("launches.blend", ("blend_fwd[G=1]", "blend_fwd[G=2]",
                                             "blend_bwd[G=1]", "blend_bwd[G=2]"))


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def tile_pixel_coords(width: int, height: int, device, tile: int = TILE):
    """Two (T, 256) float32 tensors of pixel x / y for every tile."""
    tiles_x, tiles_y = tile_grid(width, height, tile)
    t = torch.arange(tiles_x * tiles_y, device=device)
    i = torch.arange(tile * tile, device=device)
    px = (t % tiles_x)[:, None] * tile + (i % tile)[None, :]
    py = (t // tiles_x)[:, None] * tile + (i // tile)[None, :]
    return px.to(torch.float32), py.to(torch.float32)


class _Walk(NamedTuple):
    """One contributor of every tile against every pixel (see ``_walk_step``)."""

    ids: torch.Tensor  # (T,) Gaussian ids, -1 clamped to 0
    live: torch.Tensor  # (T, 256) a contributor, and the pixel not done
    dx: torch.Tensor  # (T, 256) centre minus pixel
    dy: torch.Tensor
    conic: torch.Tensor  # (T, 3)
    fall: torch.Tensor  # (T, 256) exp(power)
    raw: torch.Tensor  # (T, 256) opacity x falloff, before the 0.99 clip
    alpha: torch.Tensor
    next_t: torch.Tensor
    term: torch.Tensor  # the pixel ends here; this contributor is excluded
    inc: torch.Tensor  # blended
    w: torch.Tensor  # alpha T where blended, else 0
    t_ray: torch.Tensor  # (T, 256)
    coord: torch.Tensor  # (3, T, 256)


def _walk_step(step, done, t_cur, table, pix_x, pix_y) -> _Walk:
    """Contributor ``step`` ((T,) ids, -1 for none) of every tile against
    every pixel, through the forward's gates. Both plain versions walk with
    it, so they take the same skip / blend / stop decisions."""
    xy, conic, ts = column(table, "xy"), column(table, "conic"), column(table, "ts")
    ray_plane, camera_plane = column(table, "ray_plane"), column(table, "camera_plane")
    ids = step.to(torch.int64)
    live = (ids >= 0)[:, None] & ~done
    ids = ids.clamp_min(0)
    dx = xy[ids, 0, None] - pix_x
    dy = xy[ids, 1, None] - pix_y
    con = conic[ids]
    power = (-0.5 * (con[:, 0, None] * dx * dx + con[:, 2, None] * dy * dy)
             - con[:, 1, None] * dx * dy)
    fall = torch.exp(torch.clamp_max(power, 0.0))
    raw = column(table, "opacity")[ids, None] * fall
    alpha = torch.clamp_max(raw, MAX_ALPHA)
    cand = live & (power <= 0.0) & (alpha >= ALPHA_EPS)
    next_t = t_cur * (1.0 - alpha)
    term = cand & (next_t < T_EPS)
    inc = cand & ~term
    t_ray = ts[ids, None] + ray_plane[ids, 0, None] * dx + ray_plane[ids, 1, None] * dy
    cp = camera_plane[ids].permute(1, 2, 0)  # (3, 2, T)
    coord = (column(table, "view_point")[ids].T[:, :, None] + cp[:, 0, :, None] * dx
             + cp[:, 1, :, None] * dy)  # (3, T, 256)
    return _Walk(ids, live, dx, dy, con, fall, raw, alpha, next_t, term, inc,
                 torch.where(inc, alpha * t_cur, 0.0), t_ray, coord)


def blend_forward_torch(tile_gauss, table, width: int, height: int,
                        count_work: bool = False):
    """Plain version of the kernel: every tile walks its (T, K) front-to-back
    id list (-1 padded) one contributor at a time, all pixels at once.

    ``count_work`` adds ``n_eval`` (pairs walked: each pixel's contributors up
    to and including the one that ends it), ``n_alpha`` (pairs walked whose
    alpha reaches 1/255: the only ones that need the exp), ``n_incl`` (pairs
    blended), ``n_row`` / ``n_col`` ((contributor, tile row) / (contributor,
    tile column) pairs with a walked pixel: the terms of one dy or one dx)
    and ``n_col_incl`` ((contributor, tile column) pairs with a blended
    pixel) — the work the kernel's operation count is taken from."""
    rgb, normal = column(table, "rgb"), column(table, "normal")
    dev = table.device
    T_tiles, K = tile_gauss.shape
    pix_x, pix_y = tile_pixel_coords(width, height, dev)
    f32 = torch.float32

    t_cur = torch.ones((T_tiles, TILE * TILE), dtype=f32, device=dev)
    done = torch.zeros(t_cur.shape, dtype=torch.bool, device=dev)
    acc_c = torch.zeros((3,) + t_cur.shape, dtype=f32, device=dev)
    acc_w = torch.zeros_like(t_cur)
    acc_d = torch.zeros_like(t_cur)
    acc_x = torch.zeros_like(acc_c)
    acc_n = torch.zeros_like(acc_c)
    med_t = torch.zeros_like(t_cur)
    med_x = torch.zeros_like(acc_c)
    med_pos = torch.full(t_cur.shape, -1, dtype=torch.int32, device=dev)
    n_eval = torch.zeros((), dtype=torch.int64, device=dev)
    n_alpha = torch.zeros((), dtype=torch.int64, device=dev)
    n_incl = torch.zeros((), dtype=torch.int64, device=dev)
    n_row = torch.zeros((), dtype=torch.int64, device=dev)
    n_col = torch.zeros((), dtype=torch.int64, device=dev)
    n_col_incl = torch.zeros((), dtype=torch.int64, device=dev)

    for k in range(K):
        s = _walk_step(tile_gauss[:, k], done, t_cur, table, pix_x, pix_y)
        acc_c += s.w * rgb[s.ids].T[:, :, None]
        acc_w += s.w
        acc_d += s.w * s.t_ray
        acc_x += s.w * s.coord
        acc_n += s.w * normal[s.ids].T[:, :, None]

        med = s.inc & (t_cur > 0.5)
        med_t = torch.where(med, s.t_ray, med_t)
        med_x = torch.where(med, s.coord, med_x)
        med_pos = torch.where(med, k, med_pos)
        t_cur = torch.where(s.inc, s.next_t, t_cur)
        done = done | s.term
        if count_work:
            n_eval += s.live.sum()
            n_alpha += (s.inc | s.term).sum()
            n_incl += s.inc.sum()
            live = s.live.view(T_tiles, TILE, TILE)  # [tile, pixel row, pixel column]
            n_row += live.any(2).sum()
            n_col += live.any(1).sum()
            n_col_incl += s.inc.view(T_tiles, TILE, TILE).any(1).sum()

    out = {
        "color_raw": acc_c,
        "weight": acc_w,
        "dist_raw": acc_d,
        "coord_raw": acc_x,
        "normal_raw": acc_n,
        "t_final": t_cur,
        "med_t": med_t,
        "med_coord": med_x,
        "med_pos": med_pos,
    }
    if count_work:
        out.update(n_eval=n_eval, n_alpha=n_alpha, n_incl=n_incl, n_row=n_row, n_col=n_col,
                   n_col_incl=n_col_incl)
    return out


def blend_backward_torch(tile_gauss, table, fwd_out, cot, width: int, height: int,
                         ndc_size=None):
    """Plain version of the backward kernel (port of ``_blend_backward_scan``,
    rasterize.py:219-405): every tile re-walks its (T, K) front-to-back id
    list one contributor at a time, all pixels at once, with the forward's
    gates; each contributor's pixel sums are added to its Gaussian's row of
    the (P, GRAD_COLS) gradient buffer with ``index_add_``. ``fwd_out`` is
    the forward's raw dict, ``cot`` a dict of cotangents for ``DIFF_KEYS``
    in the same layouts. ``ndc_size``: the
    (width, height) that scales the GOF abs gradient to NDC units (default
    the render's; a band passes the full image's)."""
    half_w, half_h = (0.5 * s for s in (ndc_size or (width, height)))
    op, rgb, normal = column(table, "opacity"), column(table, "rgb"), column(table, "normal")
    ray_plane, camera_plane = column(table, "ray_plane"), column(table, "camera_plane")
    dev = table.device
    P = table.shape[0]
    T_tiles, K = tile_gauss.shape
    pix_x, pix_y = tile_pixel_coords(width, height, dev)
    f32 = torch.float32

    g_c, g_w, g_d, g_x = cot["color_raw"], cot["weight"], cot["dist_raw"], cot["coord_raw"]
    g_n, g_tf, g_mt, g_mx = cot["normal_raw"], cot["t_final"], cot["med_t"], cot["med_coord"]
    med_pos = fwd_out["med_pos"]
    # sum over the channels of cotangent x forward total: the prefix of
    # w dL/dw is subtracted from it (pallas_blend.py:741-743)
    s_tot = g_w * fwd_out["weight"] + g_d * fwd_out["dist_raw"]
    for k in range(3):
        s_tot = (s_tot + g_c[k] * fwd_out["color_raw"][k] + g_n[k] * fwd_out["normal_raw"][k]
                 + g_x[k] * fwd_out["coord_raw"][k])
    s_fin = g_tf * fwd_out["t_final"]

    t_cur = torch.ones((T_tiles, TILE * TILE), dtype=f32, device=dev)
    done = torch.zeros(t_cur.shape, dtype=torch.bool, device=dev)
    pre = torch.zeros_like(t_cur)
    rows = torch.zeros((P + 1, GRAD_COLS), dtype=f32, device=dev)  # row P: padding

    for k in range(K):
        s = _walk_step(tile_gauss[:, k], done, t_cur, table, pix_x, pix_y)
        ids, w, inc, dx, dy = s.ids, s.w, s.inc, s.dx, s.dy
        ca, cb, cc = s.conic[:, 0, None], s.conic[:, 1, None], s.conic[:, 2, None]

        # dL/dw: the direct path through this contributor's weight
        dL_dw = ((g_c * rgb[ids].T[:, :, None]).sum(0) + (g_n * normal[ids].T[:, :, None]).sum(0)
                 + g_w + g_d * s.t_ray + (g_x * s.coord).sum(0))
        pre = pre + w * dL_dw  # inclusive prefix
        suffix = (s_tot - pre) + s_fin
        dL_dalpha = torch.where(inc, t_cur * dL_dw - suffix / (1.0 - s.alpha), 0.0)

        # median routing (backward.cu:909-936)
        is_med = inc & (med_pos == k)
        dL_dt = w * g_d + torch.where(is_med, g_mt, 0.0)
        dL_dcoord = w * g_x + torch.where(is_med, g_mx, 0.0)  # (3, T, 256)

        # alpha -> (opacity, falloff) through the 0.99 clip gate
        dL_draw = torch.where((s.raw < MAX_ALPHA) & inc, dL_dalpha, 0.0)
        dL_dG = dL_draw * op[ids, None]
        gdx, gdy = s.fall * dx, s.fall * dy
        e_x = dL_dG * (-gdx * ca - gdy * cb)
        e_y = dL_dG * (-gdy * cc - gdx * cb)

        # the pixel sums in the buffer's column order (the table's, then
        # xy_abs and a zero); xy still lacks the ray-plane and camera-plane
        # terms of d(xy)
        sums = torch.stack(
            [e_x, e_y, -0.5 * gdx * dx * dL_dG, -gdx * dy * dL_dG, -0.5 * gdy * dy * dL_dG,
             dL_draw * s.fall, *(w * g_c), dL_dt, dL_dt * dx, dL_dt * dy, *dL_dcoord,
             *(dL_dcoord * dx), *(dL_dcoord * dy), *(w * g_n),
             e_x.abs() * half_w + e_y.abs() * half_h, torch.zeros_like(e_x)],
            dim=1).sum(-1)  # (T, GRAD_COLS)
        s_t, s_co = sums[:, COLUMNS["ts"]], sums[:, COLUMNS["view_point"]]
        rp, cpx, cpy = ray_plane[ids], camera_plane[ids, :, 0], camera_plane[ids, :, 1]
        sums[:, 0] += rp[:, 0] * s_t + (cpx * s_co).sum(-1)
        sums[:, 1] += rp[:, 1] * s_t + (cpy * s_co).sum(-1)
        dump = torch.where(tile_gauss[:, k] >= 0, ids, P)
        rows.index_add_(0, dump, sums)

        t_cur = torch.where(inc, s.next_t, t_cur)
        done = done | s.term

    return rows[:P]


def pack_raw(raw):
    """The raw-output dict -> the kernel's packed (T, 17, 256) layout."""
    out = torch.empty((raw["weight"].shape[0], N_OUT, TILE * TILE), dtype=torch.float32,
                      device=raw["weight"].device)
    for k, r in RAW_ROWS.items():
        out[:, r] = raw[k].transpose(0, 1) if raw[k].dim() == 3 else raw[k]
    out[:, 16] = raw["med_pos"]
    return out


def unpack_raw(out, med_pos):
    """The packed (T, 17, 256) forward output -> the raw-output dict (views)."""
    raw = {k: out[:, r].transpose(0, 1) if isinstance(r, slice) else out[:, r]
           for k, r in RAW_ROWS.items()}
    raw["med_pos"] = med_pos
    return raw


def _kernel_inputs(binning: TileBinning, table, width: int, height: int,
                   tiles_per_block: int):
    """Checks shared by both kernels' wrappers; returns (T, tiles_x)."""
    dev = binning.tile_count.device
    if dev.type != "cuda":
        raise ValueError(f"the blend kernels run on cuda or cpu tensors, not {dev}")
    if tiles_per_block not in (1, 2):
        raise ValueError(f"tiles_per_block must be 1 or 2, got {tiles_per_block}")
    tiles_x, tiles_y = tile_grid(width, height)
    T = tiles_x * tiles_y
    build.check_tensor("table", table, torch.float32, (table.shape[0], N_FEAT), dev)
    build.check_tensor("gauss_id", binning.gauss_id, torch.int32, binning.gauss_id.shape, dev)
    build.check_tensor("tile_start", binning.tile_start, torch.int32, (T,), dev)
    build.check_tensor("tile_count", binning.tile_count, torch.int32, (T,), dev)
    if table.data_ptr() % 16:
        raise ValueError("blend kernel: the table must be 16-byte aligned")
    return T, tiles_x


def _plain_tile_gauss(binning: TileBinning):
    if binning.tile_gauss is None:
        raise ValueError("the plain blend walks binning.tile_gauss; "
                         "bin with need_tile_gauss=True")
    return binning.tile_gauss


@functools.lru_cache(maxsize=4)
def _resolved(name: str, entry):
    return entry(name, *{"blend_fwd": (6, 3), "blend_bwd": (10, 7)}[name])


def _entry(name: str):
    """The C entry of a blend kernel, built and resolved once per
    ``build.entry``. Unlike the ``_entry`` of ``ops/integrate.py`` and
    ``ops/bisect.py`` (one cache keyed by name), the cache is also keyed by
    ``build.entry`` itself, because ``tests/test_torch_blend_kernel.py``
    swaps that function for one returning a copy of the backward kernel and
    must launch the copy; four entries hold both kernels and one swap."""
    return _resolved(name, build.entry)


def blend_forward_packed(binning: TileBinning, table, width: int, height: int,
                         tiles_per_block: int = 2, events: list | None = None):
    """Forward blend of every tile as the packed (T, 17, 256) float32 output
    and the (T, 256) int32 ``med_pos``. On CUDA tensors it launches the
    kernel (``tiles_per_block`` tiles per block, 1 or 2) or raises; on CPU
    tensors it runs ``blend_forward_torch`` over ``binning.tile_gauss``.
    The kernel reads ``table`` as it stands. ``events``: a list that
    receives a "pack_features" mark after the input checks (CUDA only)."""
    with trace.span("blend_fwd"):
        if binning.tile_count.device.type == "cpu":
            raw = blend_forward_torch(_plain_tile_gauss(binning), table, width, height)
            return pack_raw(raw), raw["med_pos"]
        T, tiles_x = _kernel_inputs(binning, table, width, height, tiles_per_block)
        mark(events, "pack_features")
        dev = table.device
        out = torch.empty((T, N_OUT, TILE * TILE), dtype=torch.float32, device=dev)
        med_pos = torch.empty((T, TILE * TILE), dtype=torch.int32, device=dev)
        with on_device(dev):
            rc = _entry("blend_fwd")(
                table.data_ptr(), binning.gauss_id.data_ptr(), binning.tile_start.data_ptr(),
                binning.tile_count.data_ptr(), out.data_ptr(), med_pos.data_ptr(), T, tiles_x,
                tiles_per_block, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"blend_fwd kernel launch failed with CUDA error {rc}")
        trace.count("launches.blend", f"blend_fwd[G={tiles_per_block}]")
        return out, med_pos


def blend_forward(binning: TileBinning, table, width: int, height: int,
                  tiles_per_block: int = 2):
    """``blend_forward_packed`` as the raw-output dict."""
    return unpack_raw(*blend_forward_packed(binning, table, width, height, tiles_per_block))


def pack_aux(fwd_out, cot):
    """Per-tile cotangents and forward totals, (T, 28, 256) float32, the aux
    layout of pallas_blend.py:594-596 without its med_pos row: 0:3 g_c,
    3 g_w, 4 g_d, 5:8 g_x, 8:11 g_n, 11 g_tf, 12 g_mt, 13:16 g_mx, 16:19
    tot_c, 19 tot_w, 20 tot_d, 21:24 tot_x, 24:27 tot_n, 27 t_final."""

    def rows(x):
        return x.transpose(0, 1) if x.dim() == 3 else x[:, None]

    parts = [cot[k] for k in ("color_raw", "weight", "dist_raw", "coord_raw", "normal_raw",
                              "t_final", "med_t", "med_coord")]
    parts += [fwd_out[k] for k in ("color_raw", "weight", "dist_raw", "coord_raw",
                                   "normal_raw", "t_final")]
    return torch.cat([rows(x.to(torch.float32)) for x in parts], dim=1).contiguous()


def instance_segments(gauss_id, P: int):
    """Each Gaussian's instances together, in sorted-position order (a
    stable sort of ``gauss_id``): ``rank`` (N,) int32, the row of each
    instance in that order, and ``seg`` (P + 1,) int32, Gaussian g's first
    row."""
    gid_sorted, perm = torch.sort(gauss_id, stable=True)
    dev = gauss_id.device
    seg = torch.searchsorted(gid_sorted, torch.arange(P + 1, dtype=torch.int32, device=dev))
    rank = torch.empty(perm.shape, dtype=torch.int32, device=dev)
    rank[perm] = torch.arange(perm.numel(), dtype=torch.int32, device=dev)
    return rank, seg.to(torch.int32)


def blend_backward(binning: TileBinning, table, fwd_out, cot, width: int, height: int,
                   tiles_per_block: int = 2, ndc_size=None, events: list | None = None):
    """The blend's (P, GRAD_COLS) gradient buffer: the table's gradient, then
    xy_abs's. On CUDA tensors it launches the kernel pair of
    ``csrc/blend_bwd.cu`` or raises: the per-tile walk writes one row of 25
    sums per instance, the rows of each Gaussian together, then a segment
    sum adds each Gaussian's rows in sorted-position order (deterministic,
    no atomics) and writes them at their columns. ``tiles_per_block``
    (1 or 2) is the tiles per CUDA block of the walk; both give the same
    bits. On CPU tensors it runs ``blend_backward_torch`` over
    ``binning.tile_gauss``. ``ndc_size``: (width, height) of the GOF abs
    gradient's NDC scale (default the render's; the kernel reads its width
    and height for that scale alone). ``events``: a list that receives
    marks after the table's checks ("bwd_features"), ``pack_aux``,
    ``instance_segments``, the walk kernel ("bwd_walk") and the segment sum
    ("bwd_segment_sum"), which the C entry then launches one at a time
    (CUDA only)."""
    if binning.tile_count.device.type == "cpu":
        return blend_backward_torch(_plain_tile_gauss(binning), table, fwd_out, cot,
                                    width, height, ndc_size)
    ndc_w, ndc_h = ndc_size or (width, height)
    with trace.span("bwd_features"):
        T, tiles_x = _kernel_inputs(binning, table, width, height, tiles_per_block)
        mark(events, "bwd_features")
    dev = table.device
    P, N = table.shape[0], binning.gauss_id.numel()
    with trace.span("pack_aux"):
        aux = pack_aux(fwd_out, cot)
        med_pos = fwd_out["med_pos"].to(torch.int32).contiguous()
        build.check_tensor("aux", aux, torch.float32, (T, N_AUX, TILE * TILE), dev)
        build.check_tensor("med_pos", med_pos, torch.int32, (T, TILE * TILE), dev)
        mark(events, "pack_aux")
    with trace.span("instance_segments"):
        rank, seg = instance_segments(binning.gauss_id, P)
        mark(events, "instance_segments")
    inst_rows = torch.empty((N, INST_ROW), dtype=torch.float32, device=dev)
    grad = torch.empty((P, GRAD_COLS), dtype=torch.float32, device=dev)

    def launch(num_tiles, num_gauss):  # the walk alone (num_gauss 0), the sum alone (T 0)
        with on_device(dev):
            rc = _entry("blend_bwd")(
                table.data_ptr(), binning.gauss_id.data_ptr(), binning.tile_start.data_ptr(),
                binning.tile_count.data_ptr(), aux.data_ptr(), med_pos.data_ptr(),
                rank.data_ptr(), seg.data_ptr(), inst_rows.data_ptr(), grad.data_ptr(),
                num_tiles, tiles_x, N, num_gauss, ndc_w, ndc_h, tiles_per_block,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"blend_bwd kernel launch failed with CUDA error {rc}")

    with trace.span("walk"):
        launch(T, 0)
        mark(events, "bwd_walk")
    with trace.span("segment_sum"):
        launch(0, P)
        mark(events, "bwd_segment_sum")
    trace.count("launches.blend", f"blend_bwd[G={tiles_per_block}]")
    return grad
