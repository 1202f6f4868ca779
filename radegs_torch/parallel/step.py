"""The explicit multi-rank train step: visibility-compressed gather and
tile-band rendering (port of ``radegs_tpu/parallel/step.py``).

Each rank runs this step on its block of the Gaussians (``sharding.py``)
and its horizontal band of the image:

1. Preprocess (projection, covariance, SH, planes) of the rank's block,
   with no communication.
2. The frustum-visible, on-screen Gaussians are compacted into ``V``
   static slots (overflow counted in ``n_vis_overflow``, never dropped
   silently) and only those rows are gathered from every rank: the row of
   the per-Gaussian table and its side columns, 31 floats, one
   ``all_gather``.
3. Every rank bins and blends its own band of tile rows (``rasterize`` in
   band mode), through the same blend kernels as the single-rank path.
4. The losses are taken band by band: L1 locally, SSIM with a 5-row halo
   of the neighbouring bands, the depth-normal term with a 1-row halo; each
   rank's part is divided by the full image's size. The decoupled
   appearance branch gathers the bands and runs the CNN on every rank,
   counting its term once (``/ n``).
5. ``backward()``: the gather's and the halos' backward deliver the
   cross-rank terms, so the differentiated loss holds no sum over ranks;
   each rank receives exactly its own Gaussians' gradients. Adam and the
   densification statistics are rank-local; the appearance gradients
   (replicated parameters) are summed over ranks.

One difference from the JAX step: the GOF abs-gradient statistic
(``grad_abs_accum``) is scaled to NDC units by the full image's size, as the
single-rank step scales it; the JAX step scales it by the band's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from radegs_torch.core.geometry import depths_to_points, points_to_normal
from radegs_torch.core.projection import COLUMNS, N_FEAT, PreprocessOut
from radegs_torch.models.appearance import appearance_transform
from radegs_torch.ops.binning import TILE, default_instance_budget
from radegs_torch.ops.rasterize import rasterize
from radegs_torch.ops.ssim import l1_loss, ssim_map
from radegs_torch.parallel.comm import Mesh1D, all_gather_rows, all_reduce, pmax, psum, with_halo
from radegs_torch.renderer import prepare
from radegs_torch.train.optim import GroupLRs, adam_and_stats, appearance_adam, expon_lr

# a gathered row: the table's N_FEAT columns, then these side columns
RADIUS, VALID, WELL, XY_ABS, XY_OFFSET = (N_FEAT + k for k in (0, 1, 2, 3, 5))
ROW_WIDTH = N_FEAT + 7
# the columns an empty slot zeroes (opacity, radius, valid): it must neither
# bin nor blend
MASKED = torch.isin(torch.arange(ROW_WIDTH), torch.tensor([COLUMNS["opacity"], RADIUS, VALID]))
# the step's metrics: summed over ranks, then the worst rank's visible count
SUMMED = ("loss", "l1", "depth_normal_loss", "mse", "n_vis_overflow", "n_overflow",
          "tile_overflow", "n_instances", "n_vis")


def band_layout(height: int, n: int, tile: int = TILE):
    """(band tile rows, band pixel rows, padded height) of ``n`` bands."""
    tiles_y = (height + tile - 1) // tile
    band_tiles = (tiles_y + n - 1) // n
    band_px = band_tiles * tile
    return band_tiles, band_px, band_px * n


def pad_gt(gt, height_pad: int):
    """Zero-pad a (3, H, W) ground-truth image to the banded height."""
    return F.pad(gt, (0, 0, 0, height_pad - gt.shape[1]))


def _rows(gt_padded, first: int, count: int, height: int):
    """Global rows first .. first + count of the ground truth, zero outside
    [0, height): every rank holds the whole image, so the ground truth's
    halo needs no exchange."""
    pad = max(0, -first)
    g = F.pad(gt_padded[:, :height], (0, 0, pad, max(0, first + count - height)))
    return g[:, first + pad:first + pad + count]


def compact(vis, V: int):
    """The ascending indices of ``vis``'s True entries in ``V`` static slots,
    the rest filled with len(vis) (``jnp.nonzero(size=V)``), without a
    host synchronisation."""
    C = vis.shape[0]
    pos = torch.cumsum(vis.to(torch.int64), 0) - 1
    slot = torch.where(vis & (pos < V), pos, V)  # slot V collects the rest
    idx = torch.full((V + 1,), C, dtype=torch.int64, device=vis.device)
    idx.scatter_(0, slot, torch.arange(C, device=vis.device))
    return idx[:V]


def _pack_rows(prep: PreprocessOut, xy_abs, xy_offset, idx, masked):
    """The (V, ROW_WIDTH) rows of the compacted Gaussians ``idx`` (the
    rank's capacity marks an empty slot), gathered at once; empty slots get
    0 in the ``masked`` columns (opacity, radius, ``valid``). An empty slot
    reads the row of its own position (mod the capacity), not one shared
    row: the gather's backward adds the (zero) cotangents of a repeated
    index one after another."""
    cn = xy_abs.shape[0]
    full = torch.cat([prep.table, prep.radius[:, None], prep.valid[:, None].float(),
                      prep.well_conditioned[:, None].float(), xy_abs, xy_offset], dim=1)
    used = idx < cn
    spread = torch.arange(idx.shape[0], device=idx.device) % cn
    rows = full[torch.where(used, idx, spread)]
    return torch.where(used[:, None] | ~masked[None, :], rows, 0.0)


def _unpack_rows(rows, y0: int):
    """Gathered rows -> (PreprocessOut with band-local xy, xy_abs,
    xy_offset): the table's y column shifted by the band's first row."""
    shift = torch.zeros(N_FEAT, device=rows.device)
    shift[1] = float(y0)
    prep = PreprocessOut(rows[:, :N_FEAT] - shift, rows[:, VALID] > 0.5, rows[:, RADIUS],
                         rows[:, WELL] > 0.5)
    return prep, rows[:, XY_ABS:XY_ABS + 2], rows[:, XY_OFFSET:XY_OFFSET + 2]


def make_sharded_train_step(mcfg, ocfg, pcfg, spatial_lr_scale: float, mesh: Mesh1D,
                            width: int, height: int, vis_capacity: int | None = None):
    """The multi-rank train step of this rank for ``width`` x ``height``
    views: ``step(ts_local, camera, gt_padded, bg, view_idx=0) -> (ts_local,
    metrics)``. ``ts_local`` holds this rank's block of the Gaussians
    (``sharding.shard_train_state``); ``gt_padded`` is the whole view's
    ``pad_gt(gt, band_layout(height, world)[2])``.

    ``vis_capacity``: the static per-rank cap of the gather (None: the
    rank's capacity, lossless); what it drops is counted in
    ``n_vis_overflow``. The metrics (0-d tensors, the same on every rank)
    are the JAX step's: ``loss``, ``l1``, ``depth_normal_loss``, ``psnr``,
    ``n_vis_overflow``, ``n_overflow``, ``tile_overflow``, ``n_instances``,
    ``n_vis`` (rows carried), ``n_vis_max`` (the worst rank's visible count
    before the cap), ``gather_rows`` and ``full_gather_rows`` (the rows a
    gather of every Gaussian would move)."""
    n, d = mesh.world, mesh.rank
    band_tiles, band_px, _ = band_layout(height, n)
    y0 = d * band_tiles * TILE
    lam = ocfg.lambda_dssim
    dev = mesh.device
    rows_global = y0 + torch.arange(band_px, dtype=torch.float32, device=dev)
    row_ok = (rows_global < height).to(torch.float32)[None, :, None]
    border = ((rows_global <= 0) | (rows_global >= height - 1)).to(torch.float32)
    keep = (1.0 - border)[None, None, :, None] * row_ok[None]
    ndc_scale = (width * 0.5, height * 0.5)
    npix, hw = 3.0 * height * width, float(height * width)
    masked = MASKED.to(dev)

    def step(ts, camera, gt_padded, bg, view_idx=0):
        g = ts.gaussians
        cn = g.capacity
        V = min(vis_capacity, cn) if vis_capacity else cn
        it = ts.iteration + 1
        # the band holds ~1/n of the tiles, so 1/n of the budget (an explicit
        # pcfg.instance_budget, which the loop's autotune sets, is split too)
        budget = max(min((pcfg.instance_budget
                          or default_instance_budget(V * n, pcfg.instance_multiplier)) // n,
                         (1 << 24) // n), 1 << 12)
        params = g.params.map(lambda x: x.detach().requires_grad_(True))
        app = ts.app_params
        if app is not None:
            app = {"net": {k: v.detach().requires_grad_(True) for k, v in app["net"].items()},
                   "embeddings": app["embeddings"].detach().requires_grad_(True)}
        xy_offset = torch.zeros((cn, 2), device=dev, requires_grad=True)
        xy_abs = torch.zeros((cn, 2), device=dev, requires_grad=True)

        prep = prepare(g.replace(params=params), camera, mcfg.kernel_size)
        # the visibility compaction: valid (z > near) is not enough, a
        # Gaussian off the whole image would ride the gather for nothing
        x, y, rad = prep.xy[:, 0].detach(), prep.xy[:, 1].detach(), prep.radius.detach()
        on_screen = (x + rad > 0) & (x - rad < width) & (y + rad > 0) & (y - rad < height)
        vis = prep.valid & (rad > 0) & on_screen
        n_vis = vis.sum()
        rows = all_gather_rows(_pack_rows(prep, xy_abs, xy_offset, compact(vis, V), masked),
                               mesh)
        prep_all, xy_abs_all, xy_offset_all = _unpack_rows(rows, y0)

        out = rasterize(prep_all, camera, bg, max_per_tile=pcfg.max_per_tile,
                        instance_budget=budget, tiles_per_block=pcfg.tiles_per_block,
                        xy_abs=xy_abs_all, xy_offset=xy_offset_all, render_width=width,
                        render_height=band_px, band_row0=y0)
        img = out["render"] * row_ok
        gt_m = gt_padded[:, y0:y0 + band_px] * row_ok

        # each term below is this band's part over the whole image's size;
        # the reported loss is summed over ranks outside autograd
        if mcfg.use_decoupled_appearance and app is not None:
            # the CNN needs the whole image: gather the bands, run it on
            # every rank, count it once
            img_full = all_gather_rows(img.transpose(0, 1).contiguous(), mesh)
            img_full = img_full.transpose(0, 1)[:, :height]
            transformed, (top, left, hc, wc) = appearance_transform(app, img_full, view_idx)
            l1 = l1_loss(transformed, gt_padded[:, top:top + hc, left:left + wc]) / n
        else:
            l1 = torch.sum(torch.abs(img - gt_m)) / npix

        # SSIM over the band with 5 halo rows: interior windows see the
        # neighbours' rows, the image's edges zeros ('same' padding)
        h5 = 5
        smap = ssim_map(with_halo(img, h5, mesh),
                        _rows(gt_padded, y0 - h5, band_px + 2 * h5, height))[:, h5:-h5]
        ssim_part = torch.sum(smap * row_ok) / npix

        # depth-normal consistency (train.py:141-155) with 1 halo row
        reg_on = float(it >= ocfg.regularization_from_iter)
        if mcfg.use_coord_map:
            pts = torch.stack([with_halo(out["expected_coord"] * row_ok, 1, mesh),
                               with_halo(out["median_coord"] * row_ok, 1, mesh)])
        else:
            dep1 = with_halo(out["expected_depth"] * row_ok, 1, mesh)
            dep2 = with_halo(out["median_depth"] * row_ok, 1, mesh)
            pts = torch.stack([depths_to_points(camera, dep1, y0 - 1.0),
                               depths_to_points(camera, dep2, y0 - 1.0)])
        # the halo rows' normals dropped; the image's border rows zeroed
        ref_normals = points_to_normal(pts)[..., 1:-1, :] * keep
        err = 1.0 - torch.sum(out["normal"][None] * ref_normals, dim=1)
        dn_part = (0.4 * torch.sum(err[0] * row_ok[0]) + 0.6 * torch.sum(err[1] * row_ok[0])) / hw

        # this band's part of (1 - lam) l1 + lam (1 - ssim) + reg dn; the
        # constant lam is split as lam / n
        loss_part = ((1.0 - lam) * l1 + lam * (1.0 / n - ssim_part)
                     + reg_on * ocfg.lambda_depth_normal * dn_part)
        loss_part.backward()

        with torch.no_grad():
            lrs = GroupLRs(
                xyz=expon_lr(it, ocfg.position_lr_init * spatial_lr_scale,
                             ocfg.position_lr_final * spatial_lr_scale,
                             ocfg.position_lr_max_steps,
                             lr_delay_mult=ocfg.position_lr_delay_mult),
                f_dc=ocfg.feature_lr, f_rest=ocfg.feature_lr / 20.0,
                opacity=ocfg.opacity_lr, scaling=ocfg.scaling_lr, rotation=ocfg.rotation_lr)
            g = adam_and_stats(g, params.map(lambda p: p.grad), lrs, xy_offset.grad, xy_abs.grad,
                               vis, torch.where(vis, rad, 0.0), ndc_scale)
            app_state = {}
            if app is not None:
                _sum_app_grads(app, mesh)
                app_state = appearance_adam(app, ts.app_m, ts.app_v, it, ocfg.appearance_network_lr,
                                            ocfg.appearance_embeddings_lr)

            b = out["binning"]
            part = torch.stack([torch.as_tensor(v, device=dev).to(torch.float64) for v in (
                loss_part, l1, dn_part, torch.sum((img - gt_m) ** 2) / npix,
                torch.clamp_min(n_vis - V, 0), b.n_overflow, b.tile_overflow, b.n_instances,
                torch.clamp_max(n_vis, V))])
            sums = psum(part, mesh)
            metrics = dict(zip(SUMMED, sums))
            mse = metrics.pop("mse")
            metrics["psnr"] = -10.0 * torch.log10(mse)
            metrics["n_vis_max"] = pmax(n_vis.to(torch.float64), mesh)
            metrics["gather_rows"] = torch.tensor(float(n * V))
            metrics["full_gather_rows"] = torch.tensor(float(n * cn))
        return ts.replace(gaussians=g, iteration=it, **app_state), metrics

    return step


def _sum_app_grads(app, mesh: Mesh1D):
    """Sum the appearance gradients over ranks in place (one all_reduce):
    the parameters are replicated and no collective sits on their path, so
    each rank holds its band's share."""
    ps = list(app["net"].values()) + [app["embeddings"]]
    gs = [torch.zeros_like(p) if p.grad is None else p.grad for p in ps]
    flat = all_reduce(torch.cat([x.reshape(-1) for x in gs]), mesh)
    a = 0
    for p, gr in zip(ps, gs):
        p.grad = flat[a:a + gr.numel()].reshape(gr.shape)
        a += gr.numel()
