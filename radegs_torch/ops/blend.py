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

``inputs`` is the tuple (xy, conic, opacity, rgb, view_point, camera_plane,
ray_plane, normal, ts) of per-Gaussian (P, k) tensors.

The backward re-walks each pixel's contributors front to back with the
forward's gates, and gets each contributor's "everything behind me" term as
(total - inclusive prefix) + g_tf T_final, over 1 - alpha. The cotangents
are constant along a pixel's walk, so the per-channel prefixes collapse into
one prefix of w dL/dw (the identity of pallas_blend.py:738-743). It returns
per-Gaussian gradients for the nine inputs plus the GOF densification side
channel ``xy_abs`` = sum |e_x| W/2 + |e_y| H/2 (rasterize.py:344-347), as
(P, 2) with column 1 zero.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from radegs_torch.native import build
from radegs_torch.ops.binning import TILE, TileBinning, tile_grid

ALPHA_EPS = 1.0 / 255.0
T_EPS = 1e-4
MAX_ALPHA = 0.99
N_OUT = 17
N_FEAT = 24

N_GRAD = 25
N_AUX = 28
# the raw outputs that carry a cotangent (med_pos does not)
DIFF_KEYS = ("color_raw", "weight", "dist_raw", "coord_raw", "normal_raw", "t_final",
             "med_t", "med_coord")
# rows of the packed (T, 17, 256) forward output (pallas_blend.py:28-30);
# row 16 holds med_pos as a float value
RAW_ROWS = {"color_raw": slice(0, 3), "weight": 3, "dist_raw": 4, "coord_raw": slice(5, 8),
            "normal_raw": slice(8, 11), "med_t": 11, "med_coord": slice(12, 15),
            "t_final": 15}

# kernel launches per kernel and tiles-per-block variant, counted by the
# wrappers where they launch a kernel and nowhere else
LAUNCHES = {"blend_fwd[G=1]": 0, "blend_fwd[G=2]": 0,
            "blend_bwd[G=1]": 0, "blend_bwd[G=2]": 0}


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


def _walk_step(column, done, t_cur, inputs, pix_x, pix_y) -> _Walk:
    """Contributor ``column`` ((T,) ids, -1 for none) of every tile against
    every pixel, through the forward's gates. Both plain versions walk with
    it, so they take the same skip / blend / stop decisions."""
    xy, conic, opacity, rgb, view_point, camera_plane, ray_plane, normal, ts = inputs
    ids = column.to(torch.int64)
    live = (ids >= 0)[:, None] & ~done
    ids = ids.clamp_min(0)
    dx = xy[ids, 0, None] - pix_x
    dy = xy[ids, 1, None] - pix_y
    con = conic[ids]
    power = (-0.5 * (con[:, 0, None] * dx * dx + con[:, 2, None] * dy * dy)
             - con[:, 1, None] * dx * dy)
    fall = torch.exp(torch.clamp_max(power, 0.0))
    raw = opacity.reshape(-1)[ids, None] * fall
    alpha = torch.clamp_max(raw, MAX_ALPHA)
    cand = live & (power <= 0.0) & (alpha >= ALPHA_EPS)
    next_t = t_cur * (1.0 - alpha)
    term = cand & (next_t < T_EPS)
    inc = cand & ~term
    t_ray = ts[ids, None] + ray_plane[ids, 0, None] * dx + ray_plane[ids, 1, None] * dy
    cp = camera_plane[ids].permute(1, 2, 0)  # (3, 2, T)
    coord = (view_point[ids].T[:, :, None] + cp[:, 0, :, None] * dx
             + cp[:, 1, :, None] * dy)  # (3, T, 256)
    return _Walk(ids, live, dx, dy, con, fall, raw, alpha, next_t, term, inc,
                 torch.where(inc, alpha * t_cur, 0.0), t_ray, coord)


def blend_forward_torch(tile_gauss, inputs, width: int, height: int,
                        count_work: bool = False):
    """Plain version of the kernel: every tile walks its (T, K) front-to-back
    id list (-1 padded) one contributor at a time, all pixels at once.

    ``count_work`` adds ``n_eval`` (pairs walked: each pixel's contributors up
    to and including the one that ends it) and ``n_incl`` (pairs blended) —
    the work the kernel's operation count is taken from."""
    _, _, _, rgb, _, _, _, normal, _ = inputs
    dev = rgb.device
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
    n_incl = torch.zeros((), dtype=torch.int64, device=dev)

    for k in range(K):
        s = _walk_step(tile_gauss[:, k], done, t_cur, inputs, pix_x, pix_y)
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
            n_incl += s.inc.sum()

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
        out.update(n_eval=n_eval, n_incl=n_incl)
    return out


def grads_from_rows(rows):
    """(P, 25) per-Gaussian gradient rows -> the gradient dict. Row layout
    (pallas_blend.py:579-581): 0:2 xy, 2 xy_abs, 3:6 conic, 6 opacity, 7:10
    rgb, 10:13 view_point, 13:16 camera_plane[:, :, 0], 16:19
    camera_plane[:, :, 1], 19:21 ray_plane, 21:24 normal, 24 ts."""
    return {
        "xy": rows[:, 0:2],
        "xy_abs": torch.stack([rows[:, 2], torch.zeros_like(rows[:, 2])], dim=-1),
        "conic": rows[:, 3:6],
        "opacity": rows[:, 6],
        "rgb": rows[:, 7:10],
        "view_point": rows[:, 10:13],
        "camera_plane": torch.stack([rows[:, 13:16], rows[:, 16:19]], dim=-1),
        "ray_plane": rows[:, 19:21],
        "normal": rows[:, 21:24],
        "ts": rows[:, 24],
    }


def blend_backward_torch(tile_gauss, inputs, fwd_out, cot, width: int, height: int):
    """Plain version of the backward kernel (port of ``_blend_backward_scan``,
    rasterize.py:219-405): every tile re-walks its (T, K) front-to-back id
    list one contributor at a time, all pixels at once, with the forward's
    gates; each contributor's 25 pixel sums are added to its Gaussian with
    ``index_add_``. ``fwd_out`` is the forward's raw dict, ``cot`` a dict of
    cotangents for ``DIFF_KEYS`` in the same layouts."""
    _, _, opacity, rgb, _, camera_plane, ray_plane, normal, _ = inputs
    op = opacity.reshape(-1)
    dev = op.device
    P = op.shape[0]
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
    rows = torch.zeros((P + 1, N_GRAD), dtype=f32, device=dev)  # row P: padding

    for k in range(K):
        s = _walk_step(tile_gauss[:, k], done, t_cur, inputs, pix_x, pix_y)
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

        # the kernel's 25 pixel sums, in grad-row order; rows 0:2 still lack
        # the ray-plane and camera-plane terms of d(xy)
        sums = torch.stack(
            [e_x, e_y, e_x.abs() * (width * 0.5) + e_y.abs() * (height * 0.5),
             -0.5 * gdx * dx * dL_dG, -gdx * dy * dL_dG, -0.5 * gdy * dy * dL_dG,
             dL_draw * s.fall, *(w * g_c), *dL_dcoord, *(dL_dcoord * dx), *(dL_dcoord * dy),
             dL_dt * dx, dL_dt * dy, *(w * g_n), dL_dt], dim=1).sum(-1)  # (T, 25)
        s_t, s_co = sums[:, 24], sums[:, 10:13]
        rp, cpx, cpy = ray_plane[ids], camera_plane[ids, :, 0], camera_plane[ids, :, 1]
        sums[:, 0] += rp[:, 0] * s_t + (cpx * s_co).sum(-1)
        sums[:, 1] += rp[:, 1] * s_t + (cpy * s_co).sum(-1)
        dump = torch.where(tile_gauss[:, k] >= 0, ids, P)
        rows.index_add_(0, dump, sums)

        t_cur = torch.where(inc, s.next_t, t_cur)
        done = done | s.term

    return grads_from_rows(rows[:P])


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


def pack_features(inputs):
    """(P, 24) float32 feature rows in the kernel's column order (the
    FEAT_LAYOUT of radegs_tpu/ops/pallas_blend.py)."""
    xy, conic, opacity, rgb, view_point, camera_plane, ray_plane, normal, ts = inputs
    return torch.cat(
        [xy, conic, opacity.reshape(-1, 1), rgb, ts[:, None], ray_plane, view_point,
         camera_plane[:, :, 0], camera_plane[:, :, 1], normal],
        dim=1,
    ).to(torch.float32).contiguous()


def _kernel_inputs(binning: TileBinning, inputs, width: int, height: int,
                   tiles_per_block: int):
    """Checks shared by both kernels' wrappers; returns (feat, T, tiles_x)."""
    dev = binning.tile_count.device
    if dev.type != "cuda":
        raise ValueError(f"the blend kernels run on cuda or cpu tensors, not {dev}")
    if tiles_per_block not in (1, 2):
        raise ValueError(f"tiles_per_block must be 1 or 2, got {tiles_per_block}")
    tiles_x, tiles_y = tile_grid(width, height)
    T = tiles_x * tiles_y
    feat = pack_features(inputs)
    P = feat.shape[0]
    build.check_tensor("features", feat, torch.float32, (P, N_FEAT), dev)
    build.check_tensor("gauss_id", binning.gauss_id, torch.int32, binning.gauss_id.shape, dev)
    build.check_tensor("tile_start", binning.tile_start, torch.int32, (T,), dev)
    build.check_tensor("tile_count", binning.tile_count, torch.int32, (T,), dev)
    if feat.data_ptr() % 16:
        raise ValueError("blend kernel: the feature table must be 16-byte aligned")
    return feat, T, tiles_x


def _plain_tile_gauss(binning: TileBinning):
    if binning.tile_gauss is None:
        raise ValueError("the plain blend walks binning.tile_gauss; "
                         "bin with need_tile_gauss=True")
    return binning.tile_gauss


def blend_forward_packed(binning: TileBinning, inputs, width: int, height: int,
                         tiles_per_block: int = 2):
    """Forward blend of every tile as the packed (T, 17, 256) float32 output
    and the (T, 256) int32 ``med_pos``. On CUDA tensors it launches the
    kernel (``tiles_per_block`` tiles per block, 1 or 2) or raises; on CPU
    tensors it runs ``blend_forward_torch`` over ``binning.tile_gauss``."""
    if binning.tile_count.device.type == "cpu":
        raw = blend_forward_torch(_plain_tile_gauss(binning), inputs, width, height)
        return pack_raw(raw), raw["med_pos"]
    feat, T, tiles_x = _kernel_inputs(binning, inputs, width, height, tiles_per_block)
    dev = feat.device
    out = torch.empty((T, N_OUT, TILE * TILE), dtype=torch.float32, device=dev)
    med_pos = torch.empty((T, TILE * TILE), dtype=torch.int32, device=dev)
    fn = build.entry("blend_fwd", 6, 3)
    with torch.cuda.device(dev):
        rc = fn(feat.data_ptr(), binning.gauss_id.data_ptr(),
                binning.tile_start.data_ptr(), binning.tile_count.data_ptr(),
                out.data_ptr(), med_pos.data_ptr(), T, tiles_x, tiles_per_block,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"blend_fwd kernel launch failed with CUDA error {rc}")
    LAUNCHES[f"blend_fwd[G={tiles_per_block}]"] += 1
    return out, med_pos


def blend_forward(binning: TileBinning, inputs, width: int, height: int,
                  tiles_per_block: int = 2):
    """``blend_forward_packed`` as the raw-output dict."""
    return unpack_raw(*blend_forward_packed(binning, inputs, width, height, tiles_per_block))


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


def blend_backward(binning: TileBinning, inputs, fwd_out, cot, width: int, height: int,
                   tiles_per_block: int = 2):
    """Per-Gaussian gradients of the blend (the dict of ``grads_from_rows``).
    On CUDA tensors it launches the kernel pair of ``csrc/blend_bwd.cu`` or
    raises: the per-tile walk writes one 25-float row per instance at its
    sorted position, then a segment sum adds each Gaussian's rows in
    sorted-position order (deterministic, no atomics). On CPU tensors it runs
    ``blend_backward_torch`` over ``binning.tile_gauss``."""
    if binning.tile_count.device.type == "cpu":
        return blend_backward_torch(_plain_tile_gauss(binning), inputs, fwd_out, cot,
                                    width, height)
    feat, T, tiles_x = _kernel_inputs(binning, inputs, width, height, tiles_per_block)
    dev = feat.device
    P, N = feat.shape[0], binning.gauss_id.numel()
    aux = pack_aux(fwd_out, cot)
    med_pos = fwd_out["med_pos"].to(torch.int32).contiguous()
    build.check_tensor("aux", aux, torch.float32, (T, N_AUX, TILE * TILE), dev)
    build.check_tensor("med_pos", med_pos, torch.int32, (T, TILE * TILE), dev)
    # each Gaussian's instances, in sorted-position order (a stable sort)
    gid_sorted, perm = torch.sort(binning.gauss_id, stable=True)
    perm = perm.to(torch.int32)
    seg = torch.searchsorted(gid_sorted, torch.arange(P + 1, dtype=torch.int32, device=dev))
    seg = seg.to(torch.int32)
    inst_rows = torch.empty((N, N_GRAD), dtype=torch.float32, device=dev)
    grad = torch.empty((P, N_GRAD), dtype=torch.float32, device=dev)
    fn = build.entry("blend_bwd", 10, 7)
    with torch.cuda.device(dev):
        rc = fn(feat.data_ptr(), binning.gauss_id.data_ptr(),
                binning.tile_start.data_ptr(), binning.tile_count.data_ptr(),
                aux.data_ptr(), med_pos.data_ptr(), perm.data_ptr(), seg.data_ptr(),
                inst_rows.data_ptr(), grad.data_ptr(), T, tiles_x, N, P, width, height,
                tiles_per_block, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"blend_bwd kernel launch failed with CUDA error {rc}")
    LAUNCHES[f"blend_bwd[G={tiles_per_block}]"] += 1
    return grads_from_rows(grad)
