"""The differentiable rasterizer (port of ``radegs_tpu/ops/rasterize.py``
``rasterize``): tile binning on detached inputs, the blend as a
``torch.autograd.Function`` (forward ``blend_forward``, backward
``blend_backward``: the CUDA kernels on the card, their plain versions on
the CPU), and the output normalisation of rasterize.py:602-641 (weight
normalisation, distance -> depth through ``ln`` from the pixel rows,
background compositing, normal normalisation) in plain PyTorch, so autograd
supplies the corrections backward.cu:737-779 derives by hand.

As in the JAX package's custom VJP, the Function's boundary is drawn around
the raw accumulators only; ``med_pos`` is not differentiable. Its inputs
are the preprocess's per-Gaussian table as it stands and two zero side
channels: the gradient of ``xy_abs`` is the GOF densification statistic
(rasterize.py:457-497), that of ``xy_offset`` the screen-space mean
gradient (the table's xy gradient).

Band mode (``render_width``, ``render_height``, ``band_row0``) renders one
horizontal band of the image, as the multi-rank step does
(``parallel/step.py``): binning, the blend and ``untile`` use the band's
size; ``ln`` uses global rows and the full camera geometry.
"""

from __future__ import annotations

import torch

from radegs_torch.core.projection import PreprocessOut, column
from radegs_torch.ops.binning import (
    TILE,
    TileBinning,
    bin_gaussians,
    default_instance_budget,
    tile_grid,
)
from radegs_torch.ops.blend import (
    XY_ABS,
    blend_backward,
    blend_forward_packed,
    tile_pixel_coords,
    unpack_raw,
)
from radegs_torch.utils import trace
from radegs_torch.utils.trace import mark

NORMALIZE_EPS = 1e-12


def untile(x, width: int, height: int):
    """(C, T, 256) -> (C, H, W), cropping the tile padding."""
    tiles_x, tiles_y = tile_grid(width, height)
    C = x.shape[0]
    img = x.reshape(C, tiles_y, tiles_x, TILE, TILE).permute(0, 1, 3, 2, 4)
    return img.reshape(C, tiles_y * TILE, tiles_x * TILE)[:, :height, :width]


def bin_prep(prep: PreprocessOut, width: int, height: int, instance_budget: int,
             max_per_tile: int, need_tile_gauss: bool) -> TileBinning:
    """``bin_gaussians`` over a preprocess result, with the exact work cuts,
    on detached inputs (the JAX package's stop_gradients, rasterize.py:567-583)."""
    table = prep.table.detach()
    return bin_gaussians(
        column(table, "xy"), prep.radius.detach(), column(table, "depth"), prep.valid,
        width, height, instance_budget=instance_budget, max_per_tile=max_per_tile,
        conic=column(table, "conic"), opacity=column(table, "opacity"),
        need_tile_gauss=need_tile_gauss,
    )


class BlendFunction(torch.autograd.Function):
    """The blend between the per-Gaussian table (plus the zero side channels
    ``xy_abs`` and ``xy_offset``, each (P, 2) or None) and the packed raw
    outputs (T, 17, 256) and ``med_pos``. The backward's gradient buffer
    (``blend_backward``) hands out views: the table's, xy_abs's and, for
    xy_offset, the table's xy columns. ``events`` (a list or None) is
    carried to the backward, which marks "tail_backward" on entry (autograd
    has then run the backward of everything after the blend) and passes it
    to ``blend_backward``."""

    @staticmethod
    def forward(ctx, binning, width, height, tiles_per_block, ndc_size, events, table, xy_abs,
                xy_offset):
        out, med_pos = blend_forward_packed(binning, table, width, height, tiles_per_block,
                                            events=events)
        ctx.binning = binning
        ctx.events = events
        ctx.geometry = (width, height, tiles_per_block, ndc_size)
        ctx.save_for_backward(table, out, med_pos)
        ctx.mark_non_differentiable(med_pos)
        return out, med_pos

    @staticmethod
    def backward(ctx, g_out, _g_med_pos):
        # absent cotangents arrive as zeros (materialised by autograd)
        mark(ctx.events, "tail_backward")
        table, out, med_pos = ctx.saved_tensors
        width, height, tiles_per_block, ndc_size = ctx.geometry
        with trace.span("blend_bwd"):
            grad = blend_backward(ctx.binning, table, unpack_raw(out, med_pos),
                                  unpack_raw(g_out, None), width, height, tiles_per_block,
                                  ndc_size=ndc_size, events=ctx.events)
        need = ctx.needs_input_grad
        return (None, None, None, None, None, None, grad[:, :XY_ABS] if need[6] else None,
                grad[:, XY_ABS:] if need[7] else None, grad[:, 0:2] if need[8] else None)


def normalize(raw, camera, bg, width: int | None = None, height: int | None = None,
              band_row0: int = 0):
    """Raw accumulators -> the render() images (rasterize.py:602-641) of a
    ``width`` x ``height`` render (default the camera's) whose first row is
    global row ``band_row0``."""
    W, H = width or camera.width, height or camera.height
    pix_x, pix_y = tile_pixel_coords(W, H, raw["weight"].device)
    # ln uses the global image geometry (W/2-centred, forward.cu:466), also
    # for a band
    pnx = (pix_x - camera.width / 2.0) / camera.focal_x
    pny = (pix_y + band_row0 - camera.height / 2.0) / camera.focal_y
    ln = torch.sqrt(pnx * pnx + pny * pny + 1.0)  # (T, 256)

    weight = raw["weight"]
    any_contrib = weight > 0.0
    # double-where guards: an empty pixel yields zeros, never NaN
    w_safe = torch.where(any_contrib, weight, 1.0)
    inv_w = torch.where(any_contrib, 1.0 / w_safe, 0.0)

    color = raw["color_raw"] + raw["t_final"][None] * bg[:, None, None]
    out_depth = raw["dist_raw"] / ln * inv_w
    out_mdepth = raw["med_t"] / ln
    out_coord = raw["coord_raw"] * inv_w[None]
    n2 = torch.sum(torch.square(raw["normal_raw"]), dim=0)
    n_len = torch.sqrt(torch.where(any_contrib, n2, 1.0))
    out_normal = torch.where(any_contrib[None],
                             raw["normal_raw"] / torch.clamp_min(n_len, NORMALIZE_EPS)[None],
                             0.0)
    return {
        "render": untile(color, W, H),
        "mask": untile(weight[None], W, H),
        "expected_depth": untile(out_depth[None], W, H),
        "median_depth": untile(out_mdepth[None], W, H),
        "expected_coord": untile(out_coord, W, H),
        "median_coord": untile(raw["med_coord"], W, H),
        "normal": untile(out_normal, W, H),
    }


def rasterize(
    prep: PreprocessOut,
    camera,
    bg,
    binning: TileBinning | None = None,
    max_per_tile: int = 512,
    instance_budget: int | None = None,
    tiles_per_block: int = 2,
    xy_abs=None,
    xy_offset=None,
    events: list | None = None,
    render_width: int | None = None,
    render_height: int | None = None,
    band_row0: int = 0,
):
    """Binning + blend + output normalisation. Returns the render() dict of
    gaussian_renderer/__init__.py:85-95 (channels-first images) plus
    ``radii``, ``visibility_filter`` and the ``binning`` diagnostics.

    ``tiles_per_block``: tiles per CUDA block of the blend kernels (1 or 2).
    ``xy_abs`` / ``xy_offset``: optional (P, 2) zeros; their gradients are
    the GOF absolute screen-gradient densification statistic and the
    screen-space mean gradient (``prep.xy``'s).
    ``events``: a list that receives (stage, torch.cuda.Event) after the
    binning, blend and normalisation stages (CUDA only), for stage timing,
    and the blend wrappers' marks: forward and backward (``BlendFunction``).
    ``render_width`` / ``render_height`` / ``band_row0``: render only the
    band of global rows ``band_row0 ..`` (rasterize.py:529-539); the table's
    xy must already be shifted to band-local rows (y - band_row0). The camera
    keeps the full image: ``ln`` uses global rows, and the GOF statistic's
    NDC scale the full image size."""
    W, H = render_width or camera.width, render_height or camera.height
    on_cpu = prep.table.device.type == "cpu"

    if binning is None:
        if instance_budget is None:
            instance_budget = default_instance_budget(prep.table.shape[0])
        binning = bin_prep(prep, W, H, instance_budget, max_per_tile,
                           need_tile_gauss=on_cpu)
    mark(events, "binning")
    out, med_pos = BlendFunction.apply(binning, W, H, tiles_per_block,
                                       (camera.width, camera.height), events, prep.table, xy_abs,
                                       xy_offset)
    raw = unpack_raw(out, med_pos)
    mark(events, "blend")
    with trace.span("normalize"):
        out = normalize(raw, camera, bg, W, H, band_row0)
        mark(events, "normalize")
    out.update(radii=prep.radius, visibility_filter=prep.valid & (prep.radius > 0),
               binning=binning)
    return out
